"""SMPL body model as a function over a constant tensor bundle.

Counterpart of `whmr_tpu/models/smpl.py` (smplx.lbs.lbs + pare's 49-joint
head): shape blend, rest joints, pose blend, a fixed 24-step kinematic chain,
skinning, and the joint sets. It is geometry: callers pass fp32 tensors, and
with TF32 off every product below runs in full fp32, as whmr_tpu's
`precision=HIGHEST` einsums do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from whmr_tpu_torch.data.assets import H36M_TO_J14, SMPL_PARENTS, SMPLAssets


class SMPLOutput(NamedTuple):
    vertices: torch.Tensor     # (B, 6890, 3)
    joints: torch.Tensor       # (B, 49, 3) pare-style joint set
    joints_smpl: torch.Tensor  # (B, 45, 3) 24 kinematic + 21 vertex joints
    joints_kin: torch.Tensor   # (B, 24, 3) posed kinematic joints


class SMPLParams(NamedTuple):
    """Constant model bundle on the device."""

    v_template: torch.Tensor
    shapedirs: torch.Tensor         # (6890, 3, 10)
    posedirs: torch.Tensor          # (207, 6890*3)
    j_regressor: torch.Tensor       # (24, 6890)
    lbs_weights: torch.Tensor       # (6890, 24)
    j_regressor_extra: torch.Tensor  # (9, 6890)
    vertex_joint_ids: torch.Tensor   # (21,) int64
    joint_map: torch.Tensor          # (49,) int64


def smpl_params_from_assets(
    assets: SMPLAssets, dtype=torch.float32, device=None
) -> SMPLParams:
    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return SMPLParams(
        v_template=t(assets.v_template),
        shapedirs=t(assets.shapedirs),
        posedirs=t(assets.posedirs),
        j_regressor=t(assets.j_regressor),
        lbs_weights=t(assets.lbs_weights),
        j_regressor_extra=t(assets.j_regressor_extra),
        vertex_joint_ids=t(assets.vertex_joint_ids, torch.int64),
        joint_map=t(assets.joint_map, torch.int64),
    )


_PARENTS = [int(p) for p in SMPL_PARENTS]


def smpl_forward(params: SMPLParams, betas: torch.Tensor, rotmats: torch.Tensor) -> SMPLOutput:
    """Batched SMPL LBS from betas (B, 10) and rotmats (B, 24, 3, 3)
    (the reference's pose2rot=False path, whmr.py:132-137)."""
    b = betas.shape[0]
    v_shaped = params.v_template[None] + torch.einsum("bl,mkl->bmk", betas, params.shapedirs)
    j_rest = torch.einsum("jv,bvk->bjk", params.j_regressor, v_shaped)

    eye = torch.eye(3, dtype=betas.dtype, device=betas.device)
    pose_feature = (rotmats[:, 1:] - eye).reshape(b, 207)
    v_posed = v_shaped + torch.matmul(pose_feature, params.posedirs).reshape(b, -1, 3)

    # Integer slices only: no index tensor is built on the host per call.
    rots, transls = [], []
    for k, p in enumerate(_PARENTS):
        if p < 0:
            rots.append(rotmats[:, 0])
            transls.append(j_rest[:, 0])
        else:
            rots.append(torch.matmul(rots[p], rotmats[:, k]))
            rel_j = j_rest[:, k] - j_rest[:, p]
            transls.append(torch.einsum("bij,bj->bi", rots[p], rel_j) + transls[p])
    rot_w = torch.stack(rots, dim=1)       # (B, 24, 3, 3)
    j_posed = torch.stack(transls, dim=1)  # (B, 24, 3)

    t_rel = j_posed - torch.einsum("bkij,bkj->bki", rot_w, j_rest)
    packed = torch.cat([rot_w.reshape(b, 24, 9), t_rel], dim=-1)  # (B, 24, 12)
    blended = torch.einsum("vk,bkm->bvm", params.lbs_weights, packed)
    rot_v = blended[..., :9].reshape(b, -1, 3, 3)
    vertices = torch.einsum("bvij,bvj->bvi", rot_v, v_posed) + blended[..., 9:]

    extra_vtx = vertices[:, params.vertex_joint_ids]
    joints_smpl = torch.cat([j_posed, extra_vtx], dim=1)
    extra_reg = torch.einsum("jv,bvk->bjk", params.j_regressor_extra, vertices)
    joints49 = torch.cat([joints_smpl, extra_reg], dim=1)[:, params.joint_map]
    return SMPLOutput(vertices=vertices, joints=joints49, joints_smpl=joints_smpl, joints_kin=j_posed)


def vertices2joints(j_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("jv,bvk->bjk", j_regressor, vertices)


def joints_from_vertices(params: SMPLParams, vertices: torch.Tensor):
    """(joints49, joints_smpl45) regressed from arbitrary vertices."""
    j24 = vertices2joints(params.j_regressor, vertices)
    joints_smpl = torch.cat([j24, vertices[:, params.vertex_joint_ids]], dim=1)
    extra_reg = vertices2joints(params.j_regressor_extra, vertices)
    return torch.cat([joints_smpl, extra_reg], dim=1)[:, params.joint_map], joints_smpl


def select_h36m_joints(j_regressor_h36m: torch.Tensor, vertices: torch.Tensor, mapper) -> torch.Tensor:
    """17 H36M joints from vertices, `mapper` subset, pelvis (joint 0) subtracted."""
    joints = vertices2joints(j_regressor_h36m, vertices)
    return joints[:, list(mapper)] - joints[:, :1]


def select_h36m_j14(j_regressor_h36m: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Pelvis-centered 14 LSP joints (the default eval protocol)."""
    return select_h36m_joints(j_regressor_h36m, vertices, H36M_TO_J14)
