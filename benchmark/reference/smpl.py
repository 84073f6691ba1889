"""SMPL in plain float32 PyTorch, from the model's equations (Loper et al.
2015, eq. 2-7): shape blend, rest joints, pose blend, a 24-step chain of
homogeneous transforms and linear blend skinning, then the 49-joint set
[24 kinematic | 21 surface vertices | 9 regressed][joint map].

The per-sample numpy body of the test suite's `numpy_lbs_reference`,
batched; it reads the benchmark's asset arrays and nothing of the port.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


class SMPLArrays(NamedTuple):
    v_template: torch.Tensor
    shapedirs: torch.Tensor      # (V, 3, 10)
    posedirs: torch.Tensor       # (207, 3V)
    j_regressor: torch.Tensor    # (24, V)
    lbs_weights: torch.Tensor    # (V, 24)
    j_regressor_extra: torch.Tensor
    vertex_joint_ids: torch.Tensor
    joint_map: torch.Tensor
    parents: tuple
    dmap0: torch.Tensor
    dmap1: torch.Tensor
    ssm: torch.Tensor
    mean_rotmat: torch.Tensor    # (24, 3, 3) from the interleaved rot6d mean pose
    mean_shape: torch.Tensor     # (10,)
    mean_cam: torch.Tensor       # (3,)


def smpl_arrays(assets: Dict[str, np.ndarray], device) -> SMPLArrays:
    def f(k):
        return torch.as_tensor(np.asarray(assets[k]), dtype=torch.float32, device=device)

    def i(k):
        return torch.as_tensor(np.asarray(assets[k]), dtype=torch.int64, device=device)

    return SMPLArrays(
        f("v_template"), f("shapedirs"), f("posedirs"), f("j_regressor"), f("lbs_weights"),
        f("j_regressor_extra"), i("vertex_joint_ids"), i("joint_map"),
        tuple(int(p) for p in assets["parents"]), f("dmap0"), f("dmap1"), i("ssm"),
        rot6d_to_rotmat(f("mean_pose_rot6d")), f("mean_shape"), f("mean_cam"),
    )


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """Interleaved 6D (geometry.py:243-257: a1 = x[0::2], a2 = x[1::2]) ->
    (N, 3, 3) by Gram-Schmidt."""
    x = x.reshape(-1, 3, 2)
    b1 = torch.nn.functional.normalize(x[:, :, 0], dim=-1)
    a2 = x[:, :, 1]
    b2 = torch.nn.functional.normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1, dim=-1)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def lbs(s: SMPLArrays, betas: torch.Tensor, rotmats: torch.Tensor):
    """betas (B, 10), rotmats (B, 24, 3, 3) -> vertices (B, V, 3), posed
    kinematic joints (B, 24, 3)."""
    b = betas.shape[0]
    v_shaped = s.v_template + (s.shapedirs[None] * betas[:, None, None, :]).sum(-1)
    j_rest = torch.matmul(s.j_regressor, v_shaped)                       # (B, 24, 3)
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feat = (rotmats[:, 1:] - eye).reshape(b, -1)
    v_posed = v_shaped + torch.matmul(pose_feat, s.posedirs).reshape(b, -1, 3)

    transforms = []
    for k, p in enumerate(s.parents):
        local = torch.zeros(b, 4, 4, dtype=rotmats.dtype, device=rotmats.device)
        local[:, :3, :3] = rotmats[:, k]
        local[:, 3, 3] = 1.0
        local[:, :3, 3] = j_rest[:, k] if p < 0 else j_rest[:, k] - j_rest[:, p]
        transforms.append(local if p < 0 else torch.matmul(transforms[p], local))
    t = torch.stack(transforms, dim=1)                                    # (B, 24, 4, 4)
    j_posed = t[:, :, :3, 3]
    rel_t = t[:, :, :3, 3] - torch.matmul(t[:, :, :3, :3], j_rest[..., None])[..., 0]
    rel = torch.cat([t[:, :, :3, :3], rel_t[..., None]], dim=-1)          # (B, 24, 3, 4)
    t_per_v = torch.einsum("vk,bkij->bvij", s.lbs_weights, rel)
    vh = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvij,bvj->bvi", t_per_v, vh)
    return verts, j_posed


def smpl49(s: SMPLArrays, betas: torch.Tensor, rotmats: torch.Tensor):
    """(vertices, 49 joints, 45 SMPL joints)."""
    verts, jkin = lbs(s, betas, rotmats)
    joints_smpl = torch.cat([jkin, verts[:, s.vertex_joint_ids]], dim=1)
    extra = torch.matmul(s.j_regressor_extra, verts)
    joints49 = torch.cat([joints_smpl, extra], dim=1)[:, s.joint_map]
    return verts, joints49, joints_smpl


def batch_rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """(N, 3) axis-angle -> (N, 3, 3) by the Rodrigues formula, with the
    angle taken as |theta + 1e-8| (SPIN's form)."""
    angle = torch.linalg.vector_norm(theta + 1e-8, dim=1, keepdim=True)
    axis = theta / angle
    c, s = torch.cos(angle)[:, :, None], torch.sin(angle)[:, :, None]
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    zero = torch.zeros_like(x)
    k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)[None]
    return eye + s * k + (1 - c) * torch.matmul(k, k)
