"""Seeded inputs, made on the device in a few large draws.

Crops are smooth random images at the network's normalisation (a 1/8-size
field upsampled, plus grain); the bbox context follows the reference's
`bbox_info` (datasets/base_dataset.py:368-373) for crops of a 1280x720
frame; every crop has its own camera rotation (pitch and roll as CamCalib
gives them). Training batches add SMPL pose and shape (each row with its
own spread of joint angles, 0.05-0.5 rad, and of shape, 0.3-1.5), 3D
joint targets (each row with its own spread, 0.1-0.5), and 2D keypoints
that are the GT joints through a plausible crop camera, so that the step's
least-squares GT camera frames a body-sized mesh. A training batch lays
its rows out in four strata (see `stratified_order`), so that each half of
it reads another loss.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

IMG_H, IMG_W = 720.0, 1280.0
FOCAL_LENGTH = 1000.0


def generator(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator for each use of one seed."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % (1 << 63))


def _u(g, shape, lo, hi, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def euler_rotmat(pitch: torch.Tensor, roll: torch.Tensor) -> torch.Tensor:
    """R = Rz(roll) @ Rx(pitch): the camera's tilt as CamCalib estimates it."""
    cp, sp, cr, sr = torch.cos(pitch), torch.sin(pitch), torch.cos(roll), torch.sin(roll)
    z, o = torch.zeros_like(cp), torch.ones_like(cp)
    rx = torch.stack([o, z, z, z, cp, -sp, z, sp, cp], -1).reshape(-1, 3, 3)
    rz = torch.stack([cr, -sr, z, sr, cr, z, z, z, o], -1).reshape(-1, 3, 3)
    return rz @ rx


def crops(batch: int, hw, g, device) -> torch.Tensor:
    """(B, H, W, 3) normalised NHWC crops."""
    h, w = hw
    low = torch.randn((batch, 3, h // 8, w // 8), generator=g, device=device)
    img = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    img = img + 0.3 * torch.randn((batch, 3, h, w), generator=g, device=device)
    return img.permute(0, 2, 3, 1).contiguous()


def infer_batch(batch: int, hw, seed: int, index: int, device) -> Dict[str, torch.Tensor]:
    g = generator(seed, 100 + index, device)
    bbox_h = _u(g, (batch,), 150.0, 500.0, device)
    center = torch.stack([_u(g, (batch,), 200.0, 1080.0, device), _u(g, (batch,), 150.0, 570.0, device)], -1)
    focal = math.sqrt(IMG_H ** 2 + IMG_W ** 2)
    bbox_info = torch.stack([center[:, 0] - IMG_W / 2, center[:, 1] - IMG_H / 2, bbox_h,
                             torch.full_like(bbox_h, IMG_W), torch.full_like(bbox_h, IMG_H)], -1) / focal
    angles = _u(g, (2, batch), -0.3, 0.3, device)
    return {
        "x": crops(batch, hw, g, device),
        "center": center, "scale": bbox_h / 200.0, "bbox_height": bbox_h,
        "orig_shape": torch.tensor([[IMG_H, IMG_W]], device=device).expand(batch, 2).contiguous(),
        "bbox_info": bbox_info,
        "cam_rotmat": euler_rotmat(angles[0], angles[1]),
    }


def stratified_order(score: torch.Tensor) -> torch.Tensor:
    """A permutation of the rows that puts the quarter of lowest `score` at
    the positions of stratum 0, the next quarter at stratum 1's, and so on,
    where row i's stratum is 2 * (i >= B / 2) + i % 2. So the first and the
    second half of the batch, and its even and its odd rows, each hold other
    strata than the whole: a mean over half of the rows is another mean."""
    b = score.shape[0]
    pos = torch.arange(b, device=score.device)
    stratum = 2 * (pos >= b // 2).long() + pos % 2
    slots = torch.cat([pos[stratum == q] for q in range(4)])
    order = torch.empty_like(pos)
    order[slots] = torch.argsort(score, stable=True)
    return order


def train_batch(batch: int, hw, seed: int, index: int, device, joints_fn, cam_range) -> Dict[str, torch.Tensor]:
    """`joints_fn(pose, betas)` gives the GT 49 joints (the benchmark's SMPL);
    `cam_range` the crop camera's (scale lo, scale hi, shift). The rows come
    in `stratified_order` of the spread of their 3D joint targets plus their
    share of the crop."""
    g = generator(seed, 200 + index, device)
    x = infer_batch(batch, hw, seed, 1000 + index, device)
    # Rows differ as the people of a mixed-dataset batch do: each its own
    # spread of joint angles and of body shape.
    pose = torch.randn((batch, 72), generator=g, device=device) * _u(g, (batch, 1), 0.05, 0.5, device)
    betas = torch.randn((batch, 10), generator=g, device=device) * _u(g, (batch, 1), 0.3, 1.5, device)
    joints = joints_fn(pose, betas)
    s_lo, s_hi, shift = cam_range
    s = _u(g, (batch, 1, 1), s_lo, s_hi, device)
    t = torch.cat([_u(g, (batch, 1, 2), -shift, shift, device), 2.0 * FOCAL_LENGTH / (256.0 * s)], -1)
    pj = joints + t
    pix = FOCAL_LENGTH * pj[..., :2] / pj[..., 2:3] + 128.0
    ones = torch.ones((batch, 49, 1), device=device)
    # The 3D joint targets' spread, 0.1-0.5, from a stream of its own.
    spread_3d = _u(generator(seed, 300 + index, device), (batch, 1, 1), 0.1, 0.5, device)
    rows = {
        "img": x["x"], "center": x["center"], "scale": x["scale"], "bbox_height": x["bbox_height"],
        "bbox_width": x["bbox_height"] * 0.75, "orig_shape": x["orig_shape"], "bbox_info": x["bbox_info"],
        "keypoints": torch.cat([2.0 * pix / 256.0 - 1.0, ones], -1),
        "keypoints_world": torch.cat([_u(g, (batch, 49, 2), -1.0, 1.0, device), ones], -1),
        "pose": pose, "betas": betas,
        "pose_3d": torch.cat([torch.randn((batch, 24, 3), generator=g, device=device) * spread_3d,
                              torch.ones((batch, 24, 1), device=device)], -1),
        "has_smpl": torch.ones(batch, device=device), "has_pose_3d": torch.ones(batch, device=device),
        "focal": torch.full((batch,), 1469.0, device=device),
    }
    score = (spread_3d[:, 0, 0] - 0.1) / 0.4 + (s[:, 0, 0] - s_lo) / max(s_hi - s_lo, 1e-6)
    order = stratified_order(score)
    return {k: v[order] for k, v in rows.items()}
