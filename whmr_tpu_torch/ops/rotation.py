"""Rotation representation conversions, batched, in torch.

Counterpart of `whmr_tpu/ops/rotation.py` (the reference's
`utils/geometry.py` rotation zoo and pare's `batch_euler2matrix`). Branches
stay branch-free selections (`torch.where`), as in whmr_tpu, so one formula
covers every input and the two packages agree element for element.
Geometry: callers pass fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EPS = 1e-8


def _normalize(v: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """L2-normalize the last axis, clamping the norm (F.normalize semantics)."""
    return F.normalize(v, dim=-1, eps=eps)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) (reference geometry.py:31-51)."""
    q = _normalize(quat)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def batch_rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> (..., 3, 3), with the reference's +1e-8 norm bias."""
    angle = torch.linalg.norm(theta + 1e-8, dim=-1, keepdim=True)
    normalized = theta / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=-1)
    return quat_to_rotmat(quat)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D (interleaved, reference geometry.py:243-257) -> (N, 3, 3)."""
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) -> (B, 6): first two columns flattened (geometry.py:275-286)."""
    return x[:, :, :2].reshape(x.shape[0], 6)


def unbiased_gram_schmidt(x: torch.Tensor) -> torch.Tensor:
    """Symmetrized column orthonormalization (reference geometry.py:260-272).

    Input (..., 3, 3); output the same shape.
    """
    orig_shape = x.shape
    x = x.reshape(-1, 3, 3)
    t1, t2, t3 = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    r1 = _normalize((torch.linalg.cross(t2, t3, dim=-1) + t1) / 2.0)
    r2_ = (torch.linalg.cross(t3, r1, dim=-1) + t2) / 2.0
    r2 = _normalize(r2_ - (r2_ * r1).sum(-1, keepdim=True) * r1)
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    return torch.stack([r1, r2, r3], dim=-1).reshape(orig_shape)


def rotmat_to_quat(rotmat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(N, 3, 3) -> (N, 4) wxyz, the branch-free four-case kornia algorithm
    (reference geometry.py:160-240), on the entries of R^T."""
    m = rotmat.transpose(-1, -2)
    mask_d2 = m[:, 2, 2] < eps
    mask_d0_d1 = m[:, 0, 0] > m[:, 1, 1]
    mask_d0_nd1 = m[:, 0, 0] < -m[:, 1, 1]

    t0 = 1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2]
    q0 = torch.stack(
        [m[:, 1, 2] - m[:, 2, 1], t0, m[:, 0, 1] + m[:, 1, 0], m[:, 2, 0] + m[:, 0, 2]], -1
    )
    t1 = 1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2]
    q1 = torch.stack(
        [m[:, 2, 0] - m[:, 0, 2], m[:, 0, 1] + m[:, 1, 0], t1, m[:, 1, 2] + m[:, 2, 1]], -1
    )
    t2 = 1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]
    q2 = torch.stack(
        [m[:, 0, 1] - m[:, 1, 0], m[:, 2, 0] + m[:, 0, 2], m[:, 1, 2] + m[:, 2, 1], t2], -1
    )
    t3 = 1 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    q3 = torch.stack(
        [t3, m[:, 1, 2] - m[:, 2, 1], m[:, 2, 0] - m[:, 0, 2], m[:, 0, 1] - m[:, 1, 0]], -1
    )

    c0 = mask_d2 & mask_d0_d1
    c1 = mask_d2 & ~mask_d0_d1
    c2 = ~mask_d2 & mask_d0_nd1
    q = torch.where(c0[:, None], q0, torch.where(c1[:, None], q1, torch.where(c2[:, None], q2, q3)))
    t = torch.where(c0, t0, torch.where(c1, t1, torch.where(c2, t2, t3)))
    return q * (0.5 / torch.sqrt(torch.clamp(t, min=eps)))[:, None]


def quat_to_angle_axis(quaternion: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3) axis-angle (reference geometry.py:86-136)."""
    q1, q2, q3 = quaternion[..., 1], quaternion[..., 2], quaternion[..., 3]
    sin_sq = q1 * q1 + q2 * q2 + q3 * q3
    sin_theta = torch.sqrt(torch.clamp(sin_sq, min=0.0))
    cos_theta = quaternion[..., 0]
    two_theta = 2.0 * torch.where(
        cos_theta < 0.0,
        torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta),
    )
    k_pos = two_theta / torch.clamp(sin_theta, min=_EPS)
    k = torch.where(sin_sq > 0.0, k_pos, torch.full_like(sin_theta, 2.0))
    return torch.nan_to_num(torch.stack([q1 * k, q2 * k, q3 * k], dim=-1))


def rotmat_to_angle_axis(rotmat: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) -> (N, 3) axis-angle (reference geometry.py:54-83)."""
    return quat_to_angle_axis(rotmat_to_quat(rotmat))


def euler_to_rotmat(euler: torch.Tensor) -> torch.Tensor:
    """(B, 3) euler (x=pitch, y=yaw, z=roll) -> (B, 3, 3), pare's
    `batch_euler2matrix` as used for CamCalib (whmr.py:521-522)."""
    half = euler * 0.5
    cx, cy, cz = torch.cos(half[..., 0]), torch.cos(half[..., 1]), torch.cos(half[..., 2])
    sx, sy, sz = torch.sin(half[..., 0]), torch.sin(half[..., 1]), torch.sin(half[..., 2])
    quat = torch.stack(
        [
            cx * cy * cz - sx * sy * sz,
            cx * sy * sz + cy * cz * sx,
            cx * cz * sy - sx * cy * sz,
            cx * cy * sz + sx * cz * sy,
        ],
        dim=-1,
    )
    return quat_to_rotmat(quat)
