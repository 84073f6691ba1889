"""COCO keypoint annotations -> reference-format npz labels.

A copy of `whmr_tpu/data/coco.py` (the port imports nothing of whmr_tpu).

Equivalent of reference `datasets/coco_keypoint_dataset.py` /
`datasets/JointsDataset.py` (COCO person-keypoint eval/train datasets via
pycocotools): parses the COCO person_keypoints json directly (no
pycocotools dependency) and emits the npz schema `NpzDataset` consumes,
mapping COCO's 17 keypoints into the 49-joint SPIN layout by name.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from whmr_tpu_torch.data.kp_formats import FORMATS

# SPIN GT-slice (indices 25:49) names in order.
_SPIN_GT_NAMES = FORMATS["spin"][25:]
_COCO_NAMES = FORMATS["coco"]

# COCO keypoint order in the annotation arrays (x,y,v triplets).
_COCO_ANN_ORDER = [
    "nose", "leye", "reye", "lear", "rear", "lshoulder", "rshoulder",
    "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip", "lknee",
    "rknee", "lankle", "rankle",
]


def coco_to_npz(
    annotation_json: str,
    out_path: str,
    min_keypoints: int = 6,
    bbox_scale_factor: float = 1.2,
) -> Dict[str, np.ndarray]:
    """Convert a COCO person_keypoints json to an NpzDataset label file.

    Keeps persons with >= min_keypoints visible keypoints; bbox center/scale
    follow the h/200 convention with the reference's context margin.
    """
    with open(annotation_json) as f:
        coco = json.load(f)

    images = {im["id"]: im for im in coco["images"]}
    person_cat = {c["id"] for c in coco.get("categories", []) if c.get("name") == "person"}

    imgnames, centers, scales, parts = [], [], [], []
    for ann in coco["annotations"]:
        if person_cat and ann.get("category_id") not in person_cat:
            continue
        kps = np.asarray(ann.get("keypoints", []), np.float32).reshape(-1, 3)
        if kps.shape[0] != 17 or (kps[:, 2] > 0).sum() < min_keypoints:
            continue
        x, y, w, h = ann["bbox"]
        center = np.array([x + w / 2.0, y + h / 2.0], np.float32)
        scale = bbox_scale_factor * max(w, h) / 200.0

        # map COCO order -> 24 GT joints by name; conf = visibility > 0
        gt24 = np.zeros((24, 3), np.float32)
        for ci, name in enumerate(_COCO_ANN_ORDER):
            if name in _SPIN_GT_NAMES:
                gi = _SPIN_GT_NAMES.index(name)
                gt24[gi, :2] = kps[ci, :2]
                gt24[gi, 2] = float(kps[ci, 2] > 0)
        imgnames.append(images[ann["image_id"]]["file_name"])
        centers.append(center)
        scales.append(scale)
        parts.append(gt24)

    out = {
        "imgname": np.array(imgnames),
        "center": np.stack(centers) if centers else np.zeros((0, 2), np.float32),
        "scale": np.asarray(scales, np.float32),
        "part": np.stack(parts) if parts else np.zeros((0, 24, 3), np.float32),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **out)
    return out
