"""COCO keypoint OKS-AP evaluation (pycocotools-equivalent, numpy).

A copy of `whmr_tpu/inference/coco_eval.py` (the port imports nothing of
whmr_tpu).

Replaces the reference's pycocotools dependency
(`datasets/coco_keypoint_dataset.py:16`, `datasets/JointsDataset.py`:
COCO keypoint mAP via `COCOeval(iouType='keypoints')`) with a
dependency-free implementation of the exact COCOeval protocol:

- OKS per (gt, dt) pair: mean over LABELED gt keypoints of
  exp(-d_i^2 / (2 s^2 k_i^2 * 2)) with the published per-keypoint sigmas;
  gts with no labeled keypoints fall back to the bbox-tolerance form
  (cocoeval.py `computeOks`).
- Greedy per-image matching: detections sorted by score, each matched to
  the best still-unmatched gt at each of the 10 thresholds .5:.05:.95
  (crowd/ignore gts can be rematched and don't count).
- Accumulation: global score sort, tp/fp cumsum, right-monotone precision
  envelope sampled at 101 recall points (cocoeval.py `accumulate`).

This is a host-side metric (runs once per eval epoch on numpy arrays); the
device side produced the keypoints.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# Per-keypoint falloff constants, COCO person category
# (pycocotools cocoeval.py:523 — published protocol constants).
COCO_SIGMAS = np.array(
    [
        0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
        0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
    ],
    np.float64,
)

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)


def compute_oks(
    gt_kps: np.ndarray,
    gt_areas: np.ndarray,
    dt_kps: np.ndarray,
    gt_bboxes: Optional[np.ndarray] = None,
    sigmas: np.ndarray = COCO_SIGMAS,
) -> np.ndarray:
    """OKS matrix between ground truths and detections of one image.

    Args:
      gt_kps: (G, K, 3) [x, y, v] — v > 0 marks a labeled keypoint.
      gt_areas: (G,) annotation areas (the `area` field, NOT bbox w*h).
      dt_kps: (D, K, 2|3) predicted [x, y(, score)].
      gt_bboxes: (G, 4) [x, y, w, h]; required for the unlabeled-gt
        fallback branch (cocoeval.py computeOks `k1 == 0`).

    Returns: (D, G) OKS values.
    """
    g = gt_kps.shape[0]
    d = dt_kps.shape[0]
    ious = np.zeros((d, g), np.float64)
    if g == 0 or d == 0:
        return ious
    vars_ = (sigmas * 2.0) ** 2
    k = sigmas.shape[0]
    for j in range(g):
        xg, yg, vg = gt_kps[j, :, 0], gt_kps[j, :, 1], gt_kps[j, :, 2]
        labeled = vg > 0
        n_lab = int(labeled.sum())
        for i in range(d):
            xd, yd = dt_kps[i, :, 0], dt_kps[i, :, 1]
            if n_lab > 0:
                dx = xd - xg
                dy = yd - yg
            else:
                # unlabeled gt: distance to the bbox expanded by one
                # width/height on each side (cocoeval.py computeOks k1==0:
                # window [x-w, x+2w] x [y-h, y+2h])
                assert gt_bboxes is not None, "bbox needed for unlabeled gt"
                x0, y0, w, h = gt_bboxes[j]
                z = np.zeros(k)
                dx = np.maximum(z, (x0 - w) - xd) + np.maximum(
                    z, xd - (x0 + 2 * w)
                )
                dy = np.maximum(z, (y0 - h) - yd) + np.maximum(
                    z, yd - (y0 + 2 * h)
                )
            e = (dx**2 + dy**2) / vars_ / (gt_areas[j] + np.spacing(1)) / 2.0
            if n_lab > 0:
                e = e[labeled]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
    return ious


def _match_image(
    oks: np.ndarray,
    gt_ignore: np.ndarray,
    dt_scores: np.ndarray,
    max_dets: int,
    gt_crowd: Optional[np.ndarray] = None,
):
    """Greedy matching of one image (cocoeval.py evaluateImg semantics).

    gts are pre-sorted ignore-last; dts are sorted by score desc and capped.
    Returns (dt_matched (T, D) bool, dt_ignore (T, D) bool, dt_scores (D,),
    n_nonignored_gt).
    """
    t_n = IOU_THRS.shape[0]
    order = np.argsort(-dt_scores, kind="mergesort")[:max_dets]
    oks = oks[order]
    scores = dt_scores[order]
    gt_order = np.argsort(gt_ignore, kind="mergesort")  # ignores last
    oks = oks[:, gt_order]
    gig = gt_ignore[gt_order]
    if gt_crowd is None:
        gt_crowd = np.zeros_like(gt_ignore)
    crowd = gt_crowd[gt_order].astype(bool)

    d_n, g_n = oks.shape
    dtm = np.zeros((t_n, d_n), np.int64) - 1
    gtm = np.zeros((t_n, g_n), np.int64) - 1
    dt_ig = np.zeros((t_n, d_n), bool)
    for ti, t in enumerate(IOU_THRS):
        for di in range(d_n):
            iou = min(t, 1 - 1e-10)
            m = -1
            for gi in range(g_n):
                # gt already matched — only CROWD gts may be rematched
                # (cocoeval.py: `if gtm[tind,gind]>0 and not iscrowd[gind]`;
                # a merely-ignored gt, e.g. all keypoints unlabeled, absorbs
                # ONE detection — further dts must fall through to the FP
                # cumsum, not pile onto it as ignored)
                if gtm[ti, gi] >= 0 and not crowd[gi]:
                    continue
                # non-ignored matches are exhausted once we reach ignores
                if m > -1 and not gig[m] and gig[gi]:
                    break
                if oks[di, gi] < iou:
                    continue
                iou = oks[di, gi]
                m = gi
            if m == -1:
                continue
            dtm[ti, di] = m
            gtm[ti, m] = di
            dt_ig[ti, di] = bool(gig[m])
    return dtm >= 0, dt_ig, scores, int((~gt_ignore.astype(bool)).sum())


def evaluate_oks_ap(
    gts_per_image: Dict,
    dts_per_image: Dict,
    max_dets: int = 20,
    sigmas: np.ndarray = COCO_SIGMAS,
) -> Dict[str, float]:
    """COCO keypoint AP over a dataset.

    Args:
      gts_per_image: {image_id: {"kps": (G,K,3), "areas": (G,),
        "bboxes": (G,4), "ignore": (G,) optional, "crowd": (G,) optional
        (iscrowd flags — the only gts multiple detections may match)}}
      dts_per_image: {image_id: {"kps": (D,K,2|3), "scores": (D,)}}

    Returns: {"AP", "AP50", "AP75", "AR"} — the headline COCO keypoint
    metrics (cocoeval.py summarize: areaRng 'all', maxDets=20).
    """
    t_n = IOU_THRS.shape[0]
    all_matched: List[np.ndarray] = []
    all_ignored: List[np.ndarray] = []
    all_scores: List[np.ndarray] = []
    n_gt = 0
    k = sigmas.shape[0]
    # Union of images: COCOeval iterates the full gt image set, and
    # detections on images WITHOUT annotations still enter the fp cumsum
    # (dropping them would inflate precision).
    empty_gt = {"kps": np.zeros((0, k, 3)), "areas": np.zeros((0,)),
                "bboxes": np.zeros((0, 4)), "ignore": np.zeros((0,))}
    img_ids = list(gts_per_image.keys()) + [
        i for i in dts_per_image.keys() if i not in gts_per_image
    ]
    for img_id in img_ids:
        gt = gts_per_image.get(img_id, empty_gt)
        dt = dts_per_image.get(img_id, {"kps": np.zeros((0, k, 2)),
                                        "scores": np.zeros((0,))})
        gt_kps = np.asarray(gt["kps"], np.float64)
        gt_ignore = np.asarray(
            gt.get("ignore", np.zeros(gt_kps.shape[0])), np.float64
        )
        # pycocotools: gts whose keypoints are all unlabeled are ignored
        if gt_kps.shape[0]:
            gt_ignore = np.where(
                (gt_kps[:, :, 2] > 0).sum(axis=1) == 0, 1.0, gt_ignore
            )
        dt_kps = np.asarray(dt["kps"], np.float64)
        dt_scores = np.asarray(dt["scores"], np.float64)
        oks = compute_oks(
            gt_kps,
            np.asarray(gt["areas"], np.float64),
            dt_kps,
            np.asarray(gt.get("bboxes"), np.float64) if gt.get("bboxes") is not None else None,
            sigmas,
        )
        gt_crowd = np.asarray(
            gt.get("crowd", np.zeros(gt_kps.shape[0])), np.float64
        )
        matched, ignored, scores, n = _match_image(
            oks, gt_ignore, dt_scores, max_dets, gt_crowd=gt_crowd
        )
        all_matched.append(matched)
        all_ignored.append(ignored)
        all_scores.append(scores)
        n_gt += n

    if n_gt == 0:
        return {"AP": float("nan"), "AP50": float("nan"),
                "AP75": float("nan"), "AR": float("nan")}

    matched = np.concatenate(all_matched, axis=1)
    ignored = np.concatenate(all_ignored, axis=1)
    scores = np.concatenate(all_scores)
    order = np.argsort(-scores, kind="mergesort")
    matched = matched[:, order]
    ignored = ignored[:, order]

    ap_per_thr = np.zeros(t_n)
    recall_per_thr = np.zeros(t_n)
    for ti in range(t_n):
        keep = ~ignored[ti]
        tps = (matched[ti] & keep).astype(np.float64)
        fps = (~matched[ti] & keep).astype(np.float64)
        tp_cum = np.cumsum(tps)
        fp_cum = np.cumsum(fps)
        rc = tp_cum / n_gt
        pr = tp_cum / np.maximum(tp_cum + fp_cum, np.spacing(1))
        recall_per_thr[ti] = rc[-1] if rc.size else 0.0
        # right-monotone precision envelope (cocoeval.py accumulate)
        pr = pr.tolist()
        for i in range(len(pr) - 1, 0, -1):
            if pr[i] > pr[i - 1]:
                pr[i - 1] = pr[i]
        inds = np.searchsorted(rc, REC_THRS, side="left")
        q = np.zeros(REC_THRS.shape[0])
        for ri, pi in enumerate(inds):
            if pi < len(pr):
                q[ri] = pr[pi]
        ap_per_thr[ti] = q.mean()

    return {
        "AP": float(ap_per_thr.mean()),
        "AP50": float(ap_per_thr[0]),
        "AP75": float(ap_per_thr[5]),
        "AR": float(recall_per_thr.mean()),
    }


def load_coco_gt(annotation_json: str, return_name_to_id: bool = False):
    """Parse a COCO person-keypoints json into evaluate_oks_ap's gt format.

    With `return_name_to_id`, also returns {basename(file_name): image_id}
    from the same parse (the json can be 100+ MB — parse it once).
    """
    import json
    import os

    with open(annotation_json) as f:
        coco = json.load(f)
    person_cat = {
        c["id"] for c in coco.get("categories", []) if c.get("name") == "person"
    }
    per_img: Dict = {}
    for ann in coco["annotations"]:
        if person_cat and ann.get("category_id") not in person_cat:
            continue
        kps = np.asarray(ann.get("keypoints", []), np.float64).reshape(-1, 3)
        entry = per_img.setdefault(
            ann["image_id"],
            {"kps": [], "areas": [], "bboxes": [], "ignore": [], "crowd": []},
        )
        entry["kps"].append(kps)
        entry["areas"].append(float(ann.get("area", ann["bbox"][2] * ann["bbox"][3])))
        entry["bboxes"].append(np.asarray(ann["bbox"], np.float64))
        entry["ignore"].append(float(ann.get("iscrowd", 0) or ann.get("ignore", 0)))
        # crowd rides separately: it alone grants rematch rights in the
        # greedy matcher (cocoeval.py evaluateImg iscrowd check)
        entry["crowd"].append(float(ann.get("iscrowd", 0)))
    gts = {
        img_id: {
            "kps": np.stack(e["kps"]),
            "areas": np.asarray(e["areas"]),
            "bboxes": np.stack(e["bboxes"]),
            "ignore": np.asarray(e["ignore"]),
            "crowd": np.asarray(e["crowd"]),
        }
        for img_id, e in per_img.items()
    }
    if return_name_to_id:
        name_to_id = {
            os.path.basename(im["file_name"]): im["id"]
            for im in coco.get("images", [])
        }
        return gts, name_to_id
    return gts


def spin49_to_coco17(kp49: np.ndarray, conf49: Optional[np.ndarray] = None):
    """Model 49-joint keypoints -> COCO-17 order via the kp-format registry."""
    from whmr_tpu_torch.data.kp_formats import convert_kps

    k = kp49 if kp49.shape[-1] == 3 else np.concatenate(
        [kp49, np.ones((*kp49.shape[:-1], 1), kp49.dtype)], axis=-1
    )
    out = convert_kps(k, src="spin", dst="coco")
    if conf49 is None:
        return out[..., :2], out[..., 2]
    return out[..., :2], conf49
