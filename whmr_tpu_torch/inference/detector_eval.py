"""Detector quality harness: composited synthetic frames with GT boxes.

Counterpart of `whmr_tpu/inference/detector_eval.py`; the bodies are posed
with the port's SMPL on the CPU in fp32. The reference demo's detection stage is an external YOLOv3
(`/root/reference/demo/tester.py:25,68-79`) whose quality is taken on
faith; this module measures the in-repo detector backends
(inference/detector.py) against ground truth the same way COCO scores
boxes — recall / precision at an IoU threshold plus the mean IoU of the
matched pairs — on frames we can label exactly: posed SMPL meshes
rendered onto textured backgrounds (the overfit-dataset compositing,
scripts/make_overfit_dataset.py) with the projected-vertex bbox as GT.

Both `whmr-demo --detector`'s backends and any external bbox source can
be scored; tests/test_detector_quality.py gates the contour backend on
its design domain (high-contrast synthetic frames) and PARITY.md records
the measured numbers.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from whmr_tpu_torch.inference.pipeline import Detection


def composite_frames(
    n_frames: int,
    people_per_frame: int = 1,
    width: int = 480,
    height: int = 360,
    seed: int = 0,
) -> Tuple[List[np.ndarray], List[List[Detection]]]:
    """Render posed SMPL meshes onto smooth random backgrounds.

    Returns (frames, gt) where gt[i] is a list of square GT boxes
    (Detection with score=1) from each person's projected-vertex bbox —
    the same square-crop convention the pipeline consumes (the demo's
    MPT detections are squares too, tester.py:86-99).

    Deliberately NOT shared with scripts/make_overfit_dataset.py even
    though the scene recipe matches: that script must stay byte-
    deterministic across rounds (recorded overfit curves depend on
    regenerating the identical dataset), so its RNG draw order cannot
    absorb refactors; and the GT conventions differ on purpose
    (detector GT = projected-VERTEX bbox, the tightest truth for box
    IoU; the dataset uses the GT-24-joint bbox with a 1.1 margin, the
    crop convention training consumes).
    """
    import cv2

    from whmr_tpu_torch.data.assets import synthetic_smpl_assets
    from whmr_tpu_torch.inference.renderer import render_overlay

    rng = np.random.RandomState(seed)
    focal = float(np.sqrt(width * width + height * height))
    assets = synthetic_smpl_assets()
    faces = np.asarray(assets.faces, np.int32)

    n = n_frames * people_per_frame
    pose = (rng.randn(n, 72) * 0.25).astype(np.float32)
    pose[:, :3] = rng.randn(n, 3) * 0.4
    betas = (rng.randn(n, 10) * 0.5).astype(np.float32)

    verts = posed_vertices(assets, pose, betas)

    frames: List[np.ndarray] = []
    gt: List[List[Detection]] = []
    k = 0
    for _ in range(n_frames):
        small = rng.randint(40, 215, (6, 8, 3), np.uint8)
        bg = cv2.resize(small, (width, height), interpolation=cv2.INTER_CUBIC)
        vlist, tlist, boxes = [], [], []
        for p in range(people_per_frame):
            tz = rng.uniform(5.5, 9.0)
            # spread people horizontally so boxes rarely overlap
            span = 0.45 * tz * (width / focal)
            tx = (p - (people_per_frame - 1) / 2.0) * span
            tx += rng.uniform(-0.05, 0.05) * tz
            ty = rng.uniform(-0.15, 0.15)
            cam_t = np.array([tx, ty, tz], np.float32)
            pj = verts[k] + cam_t
            pix = focal * pj[:, :2] / pj[:, 2:3] + np.array(
                [width / 2.0, height / 2.0]
            )
            lo, hi = pix.min(axis=0), pix.max(axis=0)
            cx, cy = (lo + hi) / 2.0
            size = float((hi - lo).max())
            boxes.append(Detection(float(cx), float(cy), size, 1.0))
            vlist.append(verts[k])
            tlist.append(cam_t)
            k += 1
        img = render_overlay(
            bg, vlist, tlist, faces, [focal] * people_per_frame,
            color=(0.65, 0.74, 0.86, 1.0),
        )
        frames.append(img)
        gt.append(boxes)
    return frames, gt


def posed_vertices(assets, pose: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """(N, 6890, 3) fp32 vertices of the SMPL bodies (N, 72) axis-angle
    `pose` and (N, 10) `betas`, on the CPU."""
    import torch

    from whmr_tpu_torch.models.smpl import smpl_forward, smpl_params_from_assets
    from whmr_tpu_torch.ops.rotation import batch_rodrigues

    with torch.no_grad():
        rm = batch_rodrigues(torch.from_numpy(pose).reshape(-1, 3)).reshape(-1, 24, 3, 3)
        return smpl_forward(smpl_params_from_assets(assets), torch.from_numpy(betas), rm).vertices.numpy()


def _square_iou(a: Detection, b: Detection) -> float:
    ha, hb = a.size / 2.0, b.size / 2.0
    x_ov = max(0.0, min(a.cx + ha, b.cx + hb) - max(a.cx - ha, b.cx - hb))
    y_ov = max(0.0, min(a.cy + ha, b.cy + hb) - max(a.cy - ha, b.cy - hb))
    inter = x_ov * y_ov
    union = a.size**2 + b.size**2 - inter
    return inter / union if union > 0 else 0.0


def score_detector(
    detector,
    frames: Sequence[np.ndarray],
    gt: Sequence[List[Detection]],
    iou_thresh: float = 0.5,
    margin: float = 1.1,
) -> Dict[str, float]:
    """Greedy IoU matching per frame -> recall / precision / mean IoU.

    `margin` divides predicted box sizes before matching: the in-repo
    detectors pad by BOX_MARGIN (detector.py:35) because the crop stage
    wants context, while GT here is the tight vertex bbox.
    """
    tp = 0
    n_gt = 0
    n_pred = 0
    ious: List[float] = []
    for img, boxes in zip(frames, gt):
        preds = [
            Detection(d.cx, d.cy, d.size / margin, d.score)
            for d in detector(img)
        ]
        n_gt += len(boxes)
        n_pred += len(preds)
        used = [False] * len(preds)
        for g in boxes:
            best, best_iou = -1, 0.0
            for j, p in enumerate(preds):
                if used[j]:
                    continue
                iou = _square_iou(g, p)
                if iou > best_iou:
                    best, best_iou = j, iou
            if best >= 0 and best_iou >= iou_thresh:
                used[best] = True
                tp += 1
                ious.append(best_iou)
    return {
        "recall": tp / n_gt if n_gt else 0.0,
        "precision": tp / n_pred if n_pred else 0.0,
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
        "n_gt": float(n_gt),
        "n_pred": float(n_pred),
    }
