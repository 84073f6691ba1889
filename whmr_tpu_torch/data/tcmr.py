"""TCMR/VIBE `db` file -> reference npz label schema.

A copy of `whmr_tpu/data/tcmr.py` (the port imports nothing of whmr_tpu).

The reference can read TCMR-style `db` files for 3DPW video evaluation
(`datasets/data_utils/ThreeDPW_dataset.py:16-57` loads `3dpw_test_db.pt`
with joblib). Two flavors exist in the wild:

1. the reference's own trivial flavor — a joblib'd LIST of image paths
   (ThreeDPW_dataset.load_db, :28-30), with center/scale derived at read
   time from the "person centered, scale = max(h, w)/200" convention
   (:44-46);
2. the standard TCMR/VIBE dict-of-arrays flavor (what TCMR's
   lib/data_utils/*_utils.py write): img_name, bbox (cx, cy, w, h),
   pose (72), shape (10), joints2D/joints3D in the SPIN 49-joint layout,
   vid_name, frame_id, valid.

`tcmr_to_npz` converts either into the npz schema `NpzDataset` consumes
(npz_dataset.py:90-128): the 49-joint arrays split into openpose (rows
:25) + part (rows 25:49), bbox becomes center/scale (h/200 convention),
valid becomes has_smpl. vid_name/frame_id ride along as extra keys for
video grouping (the loader ignores unknown keys).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _as_str_array(x) -> np.ndarray:
    return np.array([str(v) for v in np.asarray(x).reshape(-1)])


def _append_conf(j: np.ndarray) -> np.ndarray:
    """Append a confidence column to (n, K, C) coordinate-only joints.

    TCMR/VIBE dbs zero-fill missing/undetected joints (the OpenPose
    convention), so conf must be 0 exactly where the coordinate row is
    all-zero — fabricating conf 1.0 there would turn every occluded
    joint into a full-weight training target at pixel/point 0."""
    conf = (np.abs(j).sum(axis=-1) > 0).astype(np.float32)
    return np.concatenate([j, conf[..., None]], axis=-1)


def tcmr_to_npz(
    db_path: str,
    out_npz: str,
    img_dir: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """Convert a TCMR `db` file to the npz label schema; returns the dict.

    For the path-list flavor, center/scale need the image sizes: they are
    probed from disk when `img_dir` (or the stored absolute paths) resolve,
    mirroring the reference's read-time convention; otherwise conversion
    fails with a clear error instead of writing unusable geometry.
    """
    import joblib

    db = joblib.load(db_path)

    out: Dict[str, np.ndarray] = {}
    if isinstance(db, dict):
        names_key = next(
            (k for k in ("img_name", "imgname", "img_paths") if k in db), None
        )
        if names_key is None:
            raise ValueError(
                f"{db_path}: dict db without an image-name field "
                f"(keys: {sorted(db.keys())})"
            )
        out["imgname"] = _as_str_array(db[names_key])
        n = len(out["imgname"])

        if "bbox" in db:
            bbox = np.asarray(db["bbox"], np.float32).reshape(n, -1)
            # TCMR/VIBE bbox = (cx, cy, w, h)
            out["center"] = bbox[:, :2]
            out["scale"] = bbox[:, 2:4].max(axis=1) / 200.0
        else:
            raise ValueError(f"{db_path}: dict db without 'bbox'")

        # TCMR's `valid` marks frames whose SMPL fit failed — their pose/
        # joints entries are garbage. It gates has_smpl AND the GT-derived
        # joint confidences below (part/S); detector keypoints (openpose
        # rows) are independent of fit validity and keep their own conf.
        valid = (
            np.asarray(db["valid"], np.float32).reshape(n)
            if "valid" in db
            else np.ones(n, np.float32)
        )
        if "pose" in db and "shape" in db:
            out["pose"] = np.asarray(db["pose"], np.float32).reshape(n, 72)
            out["shape"] = np.asarray(db["shape"], np.float32).reshape(n, 10)
            out["has_smpl"] = valid

        if "joints2D" in db:
            j2d = np.asarray(db["joints2D"], np.float32)
            if j2d.shape[1] == 49:  # SPIN layout: 25 openpose + 24 GT
                if j2d.shape[2] == 2:
                    j2d = _append_conf(j2d)
                out["openpose"] = j2d[:, :25]
                out["part"] = j2d[:, 25:].copy()
                out["part"][:, :, 2] *= valid[:, None]
            elif j2d.shape[1] == 25:
                if j2d.shape[2] == 2:
                    j2d = _append_conf(j2d)
                out["openpose"] = j2d

        if "joints3D" in db:
            j3d = np.asarray(db["joints3D"], np.float32)
            if j3d.shape[1] == 49:
                j3d = j3d[:, 25:]
            if j3d.shape[1] == 24:
                if j3d.shape[2] == 3:
                    j3d = _append_conf(j3d)
                j3d = j3d.copy()
                j3d[:, :, 3] *= valid[:, None]
                out["S"] = j3d

        for extra in ("vid_name", "frame_id"):
            if extra in db:
                arr = np.asarray(db[extra])
                out[extra] = (
                    _as_str_array(arr) if arr.dtype.kind in "OSU" else arr
                )
    else:
        # Path-list flavor (the reference's 3dpw_test_db.pt shape):
        # center/scale from the image per ThreeDPW_dataset.py:44-46.
        import cv2

        paths = [str(p) for p in db]
        names, centers, scales = [], [], []
        for p in paths:
            cand = name = None
            if img_dir is not None:
                # Longest path-preserving suffix first: 3DPW basenames
                # (image_00000.jpg) collide across sequence subfolders, so
                # a bare-basename probe can silently pick the wrong image.
                parts = p.lstrip("/").split("/")
                for k in range(len(parts)):
                    rel = os.path.join(*parts[k:])
                    if os.path.exists(os.path.join(img_dir, rel)):
                        cand, name = os.path.join(img_dir, rel), rel
                        break
            elif os.path.exists(p):
                cand, name = p, p
            if cand is None:
                raise FileNotFoundError(
                    f"path-list db: cannot probe image size for {p!r} "
                    f"(pass --img_dir with the image root)"
                )
            img = cv2.imread(cand)
            if img is None:
                raise ValueError(f"unreadable image {cand!r}")
            h, w = img.shape[:2]
            names.append(name)
            centers.append([w // 2, h // 2])
            scales.append(max(h, w) / 200.0)
        out["imgname"] = np.array(names)
        out["center"] = np.asarray(centers, np.float32)
        out["scale"] = np.asarray(scales, np.float32)

    os.makedirs(os.path.dirname(os.path.abspath(out_npz)), exist_ok=True)
    np.savez(out_npz, **out)
    return out
