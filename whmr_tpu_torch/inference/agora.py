"""AGORA leaderboard submission export and its runner (`whmr-agora` of the port).

Counterpart of `whmr_tpu/inference/agora.py`: the same file tree, names and
payloads, from the port's model (fp32, on `--device`, the card by default).
Run it as `python -m whmr_tpu_torch.inference.agora --checkpoint ... ` with
the options below.

Equivalent of reference `evaluate/val_results.py:40-157`: walk the AGORA
val/test crops (npz labels with detection scores), gate on det-score >=
0.75, run the model per crop, project the predicted SMPL kinematic joints
into the 1280x720 frame with the predicted focal length, scale x3 (->
3840x2160), and write the per-person pkl tree the AGORA evaluation platform
expects (README.md:82-88).

Payload parity (val_results.py:144-155):
  joints           (24, 2)  2D projection of smpl_kp_3d[:24], x3
  verts            (6890, 3) predicted mesh, SMPL frame (no cam_t added)
  allSmplJoints3d  (24, 3)  smpl_kp_3d[:24], SMPL frame

File naming: `<image-stem>_personId_<k>.pkl` with k counting persons of the
same image from 1; in 'val' mode the third-from-last underscore component of
the stem is dropped (val_results.py:104-108).
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from whmr_tpu_torch.data.loader import host_tensor

AGORA_RES = (720.0, 1280.0)  # (H, W) of the val/test frames
AGORA_UPSCALE = 3.0          # -> 3840x2160 (val_results.py:146-155)
DET_SCORE_THRESH = 0.75      # val_results.py:83


def result_filename(img_name: str, person_idx: int, mode: str = "test") -> str:
    """`<stem>_personId_<k>.pkl`, with the val-mode component drop
    (val_results.py:100-108)."""
    stem = os.path.splitext(os.path.basename(str(img_name)))[0]
    if mode == "val":
        # val_results.py:104-107 drops the last `_`-component of the stem
        # (the AGORA camera/frame suffix). Only applicable when the stem has
        # one: on underscore-poor names the reference expression would drop
        # the ENTIRE stem and collide every image onto 'personId_<k>.pkl'.
        parts = stem.split("_")
        if len(parts) >= 2:
            stem = "_".join(parts[:-1])
    return f"{stem}_personId_{person_idx}.pkl"


def export_person(
    out_dir: str,
    img_name: str,
    person_idx: int,
    verts: np.ndarray,           # (6890, 3) predicted mesh (SMPL frame)
    smpl_joints3d: np.ndarray,   # (>=24, 3) SMPL kinematic joints
    pred_cam: np.ndarray,        # (3,) weak-persp camera
    bbox_height: float,
    bbox_center: np.ndarray,     # (2,)
    focal_length: float,
    mode: str = "test",
) -> str:
    """Write one per-person pkl (val_results.py:127-157).

    All math is host-side numpy — the same formulas as
    ops/camera.convert_pare_to_full_img_cam / perspective_projection; per-
    person device ops in this host loop would each wait for the device.
    """
    h, w = AGORA_RES
    s, tx, ty = float(pred_cam[0]), float(pred_cam[1]), float(pred_cam[2])
    tz = 2.0 * focal_length / (bbox_height * s)
    cx = 2.0 * (float(bbox_center[0]) - w / 2.0) / (s * bbox_height)
    cy = 2.0 * (float(bbox_center[1]) - h / 2.0) / (s * bbox_height)
    cam_t = np.array([tx + cx, ty + cy, tz], np.float64)
    pts = np.asarray(smpl_joints3d, np.float64) + cam_t
    joints2d = (
        focal_length * pts[:, :2] / pts[:, 2:3]
        + np.array([w / 2.0, h / 2.0])
    )
    payload = {
        "joints": joints2d[:24].astype(np.float32) * AGORA_UPSCALE,
        "verts": np.asarray(verts),
        "allSmplJoints3d": np.asarray(smpl_joints3d)[:24],
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, result_filename(img_name, person_idx, mode))
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


@torch.no_grad()
def run_agora_submission(
    cfg,
    model,
    consts,
    dataset,
    out_dir: str,
    mode: str = "test",
    batch_size: int = 32,
    score_thresh: float = DET_SCORE_THRESH,
    make_zip: bool = False,
    log_every: int = 20,
) -> Dict[str, int]:
    """The whole export: dataset crops -> model -> per-person pkl tree (+zip).

    The reference loops batch=1 on GPU (val_results.py:74-80); here crops
    are packed into batches on the model's device, and the pkl writing
    streams on the host. The port's model holds its weights (whmr_tpu
    passes `variables` beside it).
    """
    from whmr_tpu_torch.data.loader import BatchLoader
    from whmr_tpu_torch.inference.eval_cli import _EVAL_MODEL_KEYS

    device = consts.smpl.v_template.device
    loader = BatchLoader(
        dataset, batch_size, shuffle=False, drop_last=False, num_workers=4
    )
    model.eval()
    person_count: Dict[str, int] = {}
    written = 0
    skipped = 0
    paths = []
    for bi, host_batch in enumerate(loader):
        b = {k: host_tensor(v).to(device) for k, v in host_batch.items() if k in _EVAL_MODEL_KEYS}
        last = model(
            consts, b["img"], b["center"], b["scale"], b["bbox_height"], b["orig_shape"],
            b["bbox_info"], train=False,
        )["smpl_out"][-1]
        out = {k: last[k].float().cpu().numpy() for k in ("verts", "smpl_kp_3d", "pred_cam", "focal_length")}
        n = host_batch["img"].shape[0]
        for i in range(n):
            idx = int(host_batch["sample_index"][i])
            score = (
                float(dataset.det_score[idx])
                if getattr(dataset, "det_score", None) is not None
                else 1.0
            )
            if score < score_thresh:
                skipped += 1
                continue
            img_name = str(dataset.imgname[idx])
            # per-image person counter starting at 1 (val_results.py:98-103)
            k = person_count.get(img_name, 0) + 1
            person_count[img_name] = k
            paths.append(
                export_person(
                    out_dir, img_name, k,
                    verts=out["verts"][i],
                    smpl_joints3d=out["smpl_kp_3d"][i],
                    pred_cam=out["pred_cam"][i],
                    bbox_height=float(host_batch["bbox_height"][i]),
                    bbox_center=host_batch["center"][i],
                    focal_length=float(out["focal_length"][i]),
                    mode=mode,
                )
            )
            written += 1
        if log_every and (bi + 1) % log_every == 0:
            print(f"[agora] {written} persons written, {skipped} gated out")
    if make_zip:
        zip_path = out_dir.rstrip("/") + ".zip"
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
            for p in paths:
                zf.write(p, arcname="predictions/" + os.path.basename(p))
        print(f"[agora] submission zip: {zip_path}")
    return {"written": written, "skipped": skipped, "images": len(person_count)}


def main(argv=None):
    """`whmr-agora` CLI (reference val_results.py __main__)."""
    import argparse

    p = argparse.ArgumentParser(description="AGORA submission writer")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--dataset_npz", required=True, help="AGORA crop labels npz")
    p.add_argument("--img_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--mode", choices=("val", "test"), default="test")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--score_thresh", type=float, default=DET_SCORE_THRESH)
    p.add_argument("--zip", action="store_true", dest="make_zip")
    p.add_argument("--wipe", action="store_true",
                   help="delete stale results in out_dir first (val_results.py:50-58)")
    p.add_argument("--cfg_file", default=None,
                   help="reference-style YAML config (e.g. configs/vit-l.yaml)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, or cpu); no fall back")
    p.add_argument("--misc", nargs="*", default=[])
    args = p.parse_args(argv)

    from whmr_tpu_torch.config import config_from_args
    from whmr_tpu_torch.data.npz_dataset import NpzDataset
    from whmr_tpu_torch.inference.eval_cli import load_model_state

    cfg = config_from_args(args)
    model, consts, _ = load_model_state(args, cfg)
    dataset = NpzDataset(cfg, args.dataset_npz, args.img_dir, is_train=False)

    if args.wipe and os.path.isdir(args.out_dir):
        import shutil

        shutil.rmtree(args.out_dir)

    stats = run_agora_submission(
        cfg, model, consts, dataset, args.out_dir,
        mode=args.mode, batch_size=args.batch_size,
        score_thresh=args.score_thresh, make_zip=args.make_zip,
    )
    print(
        f"done: {stats['written']} persons over {stats['images']} images "
        f"({stats['skipped']} below det-score {args.score_thresh})"
    )


if __name__ == "__main__":
    main()
