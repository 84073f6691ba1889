"""Camera models: weak-perspective and full-image perspective projection.

Counterpart of `whmr_tpu/ops/camera.py` (reference `utils/geometry.py`
projection :289, perspective_projection :310, convert_pare_to_full_img_cam
:139, estimate_translation :386, and `utils/cam_utils.py` bin decoding).
Geometry runs in fp32 with TF32 off, the torch form of whmr_tpu's
`precision=HIGHEST`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from whmr_tpu_torch.config import FOCAL_LENGTH


def perspective_projection(
    points: torch.Tensor,
    translation: torch.Tensor,
    focal_length,
    camera_center: torch.Tensor,
) -> torch.Tensor:
    """Project (B, N, 3) points: x' = K ((p + t) / z) (geometry.py:310-341,
    with the identity rotation every caller passes).

    focal_length is a scalar or (B,); camera_center is (B, 2).
    """
    points = points + translation[:, None, :]
    xy = points[..., :2] / points[..., 2:3]
    if isinstance(focal_length, torch.Tensor):
        f = torch.atleast_1d(focal_length.to(points.dtype)).expand(points.shape[0])[:, None, None]
    else:
        f = float(focal_length)  # no tensor built on the host and copied over
    return xy * f + camera_center[:, None, :]


def weak_perspective_projection(
    joints: torch.Tensor,
    camera: torch.Tensor,
    img_res: Tuple[int, int] = (256, 256),
) -> torch.Tensor:
    """Crop-frame weak-perspective projection normalized to [-1, 1]
    (geometry.py:289-307): [s, tx, ty] -> t = [tx, ty, 2f/(H s)]."""
    w, h = img_res
    cam_t = torch.stack(
        [camera[:, 1], camera[:, 2], 2 * FOCAL_LENGTH / (h * camera[:, 0] + 1e-9)],
        dim=-1,
    )
    center = torch.zeros(joints.shape[0], 2, dtype=joints.dtype, device=joints.device)
    kp = perspective_projection(joints, cam_t, FOCAL_LENGTH, center)
    return torch.stack([kp[..., 0] / (w / 2.0), kp[..., 1] / (h / 2.0)], dim=-1)


def convert_pare_to_full_img_cam(
    pare_cam: torch.Tensor,
    bbox_height: torch.Tensor,
    bbox_center: torch.Tensor,
    img_w: torch.Tensor,
    img_h: torch.Tensor,
    tz: torch.Tensor,
) -> torch.Tensor:
    """Weak-perspective bbox camera -> full-image translation with the
    predicted depth `tz` (geometry.py:139-157, the Tz form W-HMR uses)."""
    s, tx, ty = pare_cam[:, 0], pare_cam[:, 1], pare_cam[:, 2]
    cx = 2 * (bbox_center[:, 0] - (img_w / 2.0)) / (s * bbox_height)
    cy = 2 * (bbox_center[:, 1] - (img_h / 2.0)) / (s * bbox_height)
    return torch.stack([tx + cx, ty + cy, tz], dim=-1)


def estimate_translation(
    joints_3d: torch.Tensor,
    joints_2d: torch.Tensor,
    focal_length: float = 5000.0,
    img_size: Tuple[float, float] = (224.0, 224.0),
    use_joints_slice: bool = True,
) -> torch.Tensor:
    """Batched weighted least-squares camera translation (geometry.py:344-408
    as one (B, 3, 3) solve, whmr_tpu/ops/camera.py:122-175).

    Two rows per joint, weighted by sqrt(conf):
        [f, 0, cx - u] t = (u - cx) z - f X
        [0, f, cy - v] t = (v - cy) z - f Y
    joints_3d: (B, J, 3); joints_2d: (B, J, 3) pixels with confidence last.

    A singular system gives non-finite values, as `jnp.linalg.solve` does,
    and neither raises nor waits for the device (`solve_ex`, not `solve`);
    `gt_camera_from_cam_t` maps them to its far default.
    """
    if use_joints_slice:
        joints_3d = joints_3d[:, 25:]
        joints_2d = joints_2d[:, 25:]
    conf = joints_2d[..., 2]
    p2d = joints_2d[..., :2]
    f = float(focal_length)
    z = joints_3d[..., 2]
    xy = joints_3d[..., :2]
    w = torch.sqrt(conf.clamp(min=0.0))[..., None]  # (B, J, 1)
    # p2d - center from Python scalars: no host tensor is copied to the card.
    d = torch.stack([p2d[..., 0] - img_size[0] / 2.0, p2d[..., 1] - img_size[1] / 2.0], dim=-1)

    b, j = z.shape
    q = torch.zeros(b, j, 2, 3, dtype=joints_3d.dtype, device=joints_3d.device)
    q[:, :, 0, 0] = f
    q[:, :, 1, 1] = f
    q[..., 2] = -d
    rhs = d * z[..., None] - f * xy  # (B, J, 2)
    q_flat = (q * w[..., None]).reshape(b, 2 * j, 3)
    r_flat = (rhs * w).reshape(b, 2 * j)
    a_mat = torch.einsum("bnk,bnl->bkl", q_flat, q_flat)
    b_vec = torch.einsum("bnk,bn->bk", q_flat, r_flat)
    sol, info = torch.linalg.solve_ex(a_mat, b_vec[..., None])
    # solve_ex leaves whatever the factorisation produced where a pivot is 0.
    return torch.where(info[:, None] == 0, sol[..., 0], float("nan"))


# CamCalib bin ranges (reference cam_utils.py:39,55,103,127-135).
VFOV_RANGE = (0.2617, 2.1)
PITCH_RANGE = (-0.6, 0.6)
ROLL_RANGE = (-0.6, 0.6)


def softargmax_1d(heatmap: torch.Tensor) -> torch.Tensor:
    """Softmax-expected bin index over the last axis, scaled to [-1, 1]."""
    n = heatmap.shape[-1]
    probs = torch.exp(heatmap - heatmap.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    idx = torch.arange(n, dtype=heatmap.dtype, device=heatmap.device)
    return (probs * idx).sum(dim=-1) / (n - 1) * 2.0 - 1.0


def soft_idx_to_angle(soft_idx: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """[-1, 1] soft index -> angle (reference cam_utils.py:110-111)."""
    return (hi - lo) * ((soft_idx + 1) / 2.0) + lo


def decode_cam_angles(
    vfov_logits: torch.Tensor, pitch_logits: torch.Tensor, roll_logits: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """256-bin logits -> (vfov, pitch, roll) in radians (cam_utils.py:122-135)."""
    vfov = soft_idx_to_angle(softargmax_1d(vfov_logits), *VFOV_RANGE)
    pitch = soft_idx_to_angle(softargmax_1d(pitch_logits), *PITCH_RANGE)
    roll = soft_idx_to_angle(softargmax_1d(roll_logits), *ROLL_RANGE)
    return vfov, pitch, roll
