"""Mask / part-segmentation evaluation (LSP protocol).

Counterpart of `whmr_tpu/inference/part_segm.py` (reference
`utils/part_utils.py:8-52`, a PartRenderer over neural_renderer's CUDA
rasterizer): render the predicted mesh's body-part labels into the crop
frame and score foreground mask accuracy / F1 and 6-part segmentation
accuracy against GT annotations.

The render goes through `ops/rasterizer.py::rasterize` on every device, the
port of the rasterizer whmr_tpu uses here on every backend. K2
(`ops/rasterizer_kernel.py`) is not used: it averages exact depth ties where
`rasterize` keeps the first winner, so it would change the tie rule against
whmr_tpu.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from whmr_tpu_torch.data.assets import SMPLAssets
from whmr_tpu_torch.ops.rasterizer import project_weak_perspective_to_pixels, rasterize

# SMPL kinematic joint -> LSP 6-part grouping (head, torso, L/R arm, L/R leg)
_JOINT_TO_PART6 = np.array(
    [
        2,  # 0 pelvis -> torso
        6, 5,  # hips -> legs (L, R)
        2,  # spine1
        6, 5,  # knees
        2,  # spine2
        6, 5,  # ankles
        2,  # spine3
        6, 5,  # feet
        2,  # neck -> torso
        2, 2,  # collars
        1,  # head
        4, 3,  # shoulders -> arms (L, R)
        4, 3,  # elbows
        4, 3,  # wrists
        4, 3,  # hands
    ],
    np.int32,
)


def vertex_part_labels(assets: SMPLAssets) -> np.ndarray:
    """(V,) 6-part labels from the dominant LBS joint per vertex."""
    joint = assets.lbs_weights.argmax(axis=1)
    return _JOINT_TO_PART6[joint]


def render_part_segmentation(
    assets: SMPLAssets,
    verts: torch.Tensor,
    camera: torch.Tensor,
    resolution: Tuple[int, int] = (256, 256),
) -> torch.Tensor:
    """(B, H, W) int32 part map (0 = background, 1..6 = LSP parts), on the
    device of `verts`."""
    vp, vz = project_weak_perspective_to_pixels(verts.float(), camera.float(), resolution)
    labels = vertex_part_labels(assets)
    # One-hot label channels + per-pixel argmax: barycentric interpolation
    # of the INTEGER label would let a face spanning non-adjacent parts
    # paint a third, unrelated label (torso(2)/right-leg(5) corners blend
    # to 3.4 -> rounds to right-arm). Interpolating the 6 indicator
    # channels and taking the dominant one always returns a label carried
    # by one of the face's own corners.
    onehot = torch.from_numpy(np.eye(7, dtype=np.float32)[labels][:, 1:]).to(verts.device)  # (V, 6)
    attrs = onehot[None].expand(verts.shape[0], *onehot.shape)
    out = rasterize(vp, vz, attrs, assets.faces, resolution=resolution)
    part = out.attrs.argmax(dim=-1).to(torch.int32) + 1
    return part * out.mask


def segmentation_metrics(
    pred_parts: np.ndarray, gt_parts: np.ndarray
) -> Dict[str, float]:
    """Mask accuracy/F1 + 6-part accuracy (reference eval protocol)."""
    pred_fg = pred_parts > 0
    gt_fg = gt_parts > 0
    tp = float((pred_fg & gt_fg).sum())
    fp = float((pred_fg & ~gt_fg).sum())
    fn = float((~pred_fg & gt_fg).sum())
    acc = float((pred_fg == gt_fg).mean())
    f1 = 2 * tp / max(2 * tp + fp + fn, 1.0)
    parts_acc = float((pred_parts[gt_fg] == gt_parts[gt_fg]).mean()) if gt_fg.any() else 0.0
    return {"mask_accuracy": acc, "mask_f1": f1, "parts_accuracy": parts_acc}
