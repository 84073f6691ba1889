"""Batched Procrustes alignment and pose metrics (MPJPE / PA-MPJPE / PVE).

Counterpart of `whmr_tpu/ops/procrustes.py`, which replaces the reference's
per-sample numpy SVD loop (`utils/pose_utils.py:10-75`) with one batched SVD
over (B, 3, 3) covariance matrices. Geometry: everything runs in fp32 with
full-precision products (TF32 off), whatever dtype comes in.
"""

from __future__ import annotations

import torch


def batch_compute_similarity_transform(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Align each (J, 3) point set in `s1` to `s2` with a similarity transform.

    Same math as reference utils/pose_utils.py:10-58 (umeyama / orthogonal
    Procrustes with scale), batched: returns s1_hat = s*R s1 + t, with the
    reflection removed through sign(det(U V^T)).

    Args:
      s1, s2: (B, J, 3).
    """
    x1 = s1.float().transpose(-1, -2)  # (B, 3, J)
    x2 = s2.float().transpose(-1, -2)

    mu1 = x1.mean(dim=-1, keepdim=True)
    mu2 = x2.mean(dim=-1, keepdim=True)
    x1c = x1 - mu1
    x2c = x2 - mu2

    var1 = (x1c ** 2).sum(dim=(-1, -2))  # (B,)
    k = x1c @ x2c.transpose(-1, -2)  # (B, 3, 3)

    u, _, vh = torch.linalg.svd(k)
    v = vh.transpose(-1, -2)
    det = torch.linalg.det(u @ v.transpose(-1, -2))  # det(U V^T)
    z = torch.eye(3, dtype=k.dtype, device=k.device).repeat(k.shape[0], 1, 1)
    z[:, -1, -1] = torch.sign(det)
    r = v @ z @ u.transpose(-1, -2)  # V Z U^T

    scale = torch.diagonal(r @ k, dim1=-2, dim2=-1).sum(-1) / var1
    t = mu2 - scale[:, None, None] * (r @ mu1)
    s1_hat = scale[:, None, None] * (r @ x1) + t
    return s1_hat.transpose(-1, -2)


def _reduce(err: torch.Tensor, reduce: str) -> torch.Tensor:
    return err.mean() if reduce == "mean" else err


def mpjpe(pred: torch.Tensor, gt: torch.Tensor, reduce: str = "mean") -> torch.Tensor:
    """Mean per-joint position error over (B, J, 3) in input units: sqrt of
    the squared coordinate error summed over xyz, averaged over joints
    (evaluate/eval.py:222-223)."""
    return _reduce(torch.sqrt(((pred - gt) ** 2).sum(dim=-1)).mean(dim=-1), reduce)


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor, reduce: str = "mean") -> torch.Tensor:
    """Procrustes-aligned MPJPE (reference pose_utils.py:68-75)."""
    return mpjpe(batch_compute_similarity_transform(pred, gt), gt.float(), reduce=reduce)


def per_vertex_error(pred_verts: torch.Tensor, gt_verts: torch.Tensor, reduce: str = "mean") -> torch.Tensor:
    """PVE: mean euclidean vertex error (evaluate/eval.py:208-210)."""
    return mpjpe(pred_verts, gt_verts, reduce=reduce)
