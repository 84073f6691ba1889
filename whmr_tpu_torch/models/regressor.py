"""Iterative SMPL regressor and world-frame global-orient regressor.

Counterpart of `whmr_tpu/models/regressor.py` (reference `Regressor`
whmr.py:42-269 and `Global_Orient_Regressor` :272-305), eval mode: one
residual MLP step over [point features | bbox_info | pose | shape | cam],
eval-time Gram-Schmidt, an SMPL forward and the projection bundle.

Dtypes follow whmr_tpu: the MLPs run in the compute dtype, while the pose,
shape and camera carries and all geometry stay fp32. Where JAX promotes a
compute-dtype decoder output against an fp32 carry, the code casts
explicitly.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from whmr_tpu_torch.data.assets import SMPLAssets
from whmr_tpu_torch.models.layers import Linear
from whmr_tpu_torch.models.smpl import (
    SMPLParams,
    select_h36m_j14,
    smpl_forward,
    smpl_params_from_assets,
    vertices2joints,
)
from whmr_tpu_torch.ops.camera import (
    convert_pare_to_full_img_cam,
    perspective_projection,
    weak_perspective_projection,
)
from whmr_tpu_torch.ops.rotation import (
    rot6d_to_rotmat,
    rotmat_to_angle_axis,
    rotmat_to_rot6d,
    unbiased_gram_schmidt,
)

NPOSE = 24 * 9


class BodyConsts(NamedTuple):
    """Constants shared by all regressor steps, fp32 on the device."""

    smpl: SMPLParams
    dmap0: torch.Tensor             # (1723, 6890)
    dmap1: torch.Tensor             # (431, 1723)
    ssm: torch.Tensor               # (67,) int64
    j_regressor_h36m: torch.Tensor  # (17, 6890)
    mean_pose: torch.Tensor         # (1, 216) rotmat entries of the mean pose
    mean_shape: torch.Tensor        # (1, 10)
    mean_cam: torch.Tensor          # (1, 3)
    # Graphormer's 431-vertex adjacency; the Graphormer slice fills it.
    adj431: Optional[torch.Tensor] = None


def body_consts_from_assets(assets: SMPLAssets, device=None) -> BodyConsts:
    """The constant bundle in fp32 (mean rot6d -> rotmat as whmr.py:64-65)."""

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    mean_rotmat = rot6d_to_rotmat(t(assets.mean_pose_rot6d).reshape(1, -1))
    return BodyConsts(
        smpl=smpl_params_from_assets(assets, device=device),
        dmap0=t(assets.dmap0),
        dmap1=t(assets.dmap1),
        ssm=t(assets.ssm, torch.int64),
        j_regressor_h36m=t(assets.j_regressor_h36m),
        mean_pose=mean_rotmat.reshape(1, NPOSE),
        mean_shape=t(assets.mean_shape).reshape(1, 10),
        mean_cam=t(assets.mean_cam).reshape(1, 3),
    )


class CamState(NamedTuple):
    """Per-sample camera and bbox context threaded through every step."""

    bbox_info: torch.Tensor    # (B, 5)
    center: torch.Tensor       # (B, 2) bbox center in full-image px
    scale: torch.Tensor        # (B,)
    bbox_height: torch.Tensor  # (B,)
    orig_shape: torch.Tensor   # (B, 2) full image (H, W)
    tz: torch.Tensor           # (B,) predicted body depth


def _smpl_out_bundle(
    consts: BodyConsts,
    pred_rotmat: torch.Tensor,
    pred_shape: torch.Tensor,
    pred_cam: torch.Tensor,
    cam_state: Optional[CamState],
    img_res: Tuple[int, int],
    j_regressor: Optional[torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """SMPL forward + the output dict of one eval step (whmr.py:132-208);
    without `cam_state`, the forward_init subset."""
    out = smpl_forward(consts.smpl, pred_shape, pred_rotmat)
    verts, joints = out.vertices, out.joints
    pred_kp_2d = weak_perspective_projection(joints, pred_cam, img_res)
    pose_aa = rotmat_to_angle_axis(pred_rotmat.reshape(-1, 3, 3)).reshape(-1, 72)
    kp3d = joints if j_regressor is None else select_h36m_j14(j_regressor, verts)
    sub_verts = torch.einsum("sv,bvk->bsk", consts.dmap0, verts)
    temp_verts = torch.einsum("ts,bsk->btk", consts.dmap1, sub_verts)
    # smpl_kp_3d is regressed from the final vertices (whmr.py:185-187).
    smpl_kp_3d = torch.cat(
        [vertices2joints(consts.smpl.j_regressor, verts), verts[:, consts.smpl.vertex_joint_ids]],
        dim=1,
    )
    output = {
        "theta": torch.cat([pred_cam, pred_shape, pose_aa], dim=1),
        "verts": verts,
        "sub_verts": sub_verts,
        "temp_verts": temp_verts,
        "kp_2d": pred_kp_2d,
        "kp_3d": kp3d,
        "smpl_kp_3d": smpl_kp_3d,
        "rotmat": pred_rotmat,
        "pred_cam": pred_cam,
        "pred_shape": pred_shape,
        "pose": pose_aa,
        "pelvis": smpl_kp_3d[:, :1, :],
        "markers": verts[:, consts.ssm],
    }
    if cam_state is not None:
        cam = pred_cam.detach()
        focal_length = cam[:, 0] * cam_state.bbox_height * cam_state.tz / 2.0  # whmr.py:149
        img_h = cam_state.orig_shape[:, 0]
        img_w = cam_state.orig_shape[:, 1]
        camera_center = torch.stack([img_w, img_h], dim=-1) / 2.0
        pred_cam_t = convert_pare_to_full_img_cam(
            cam, cam_state.bbox_height, cam_state.center, img_w, img_h, cam_state.tz
        )
        kp_2d_w = perspective_projection(joints, pred_cam_t, focal_length, camera_center)
        output.update(
            {
                "kp_2d_w": kp_2d_w / camera_center[:, None, :] - 1.0,
                "pred_cam_t": pred_cam_t,
                "focal_length": focal_length,
                "scale": cam_state.scale,
            }
        )
    return output, verts


class Regressor(nn.Module):
    """One MAF-step residual SMPL regressor, eval mode (keys fc1, fc2,
    decpose, decshape, deccam)."""

    def __init__(self, feat_dim: int, img_res: Tuple[int, int] = (256, 256), dtype=torch.float32):
        super().__init__()
        self.img_res = tuple(img_res)
        self.compute_dtype = dtype
        self.fc1 = Linear(feat_dim + 5 + NPOSE + 10 + 3, 1024, dtype=dtype)
        self.fc2 = Linear(1024, 1024, dtype=dtype)
        self.decpose = Linear(1024, NPOSE, dtype=dtype)
        self.decshape = Linear(1024, 10, dtype=dtype)
        self.deccam = Linear(1024, 3, dtype=dtype)

    def forward(self, consts, feat, cam_state, init_pose, init_shape, init_cam, j_regressor=None):
        """One step (WHMR runs each regressor once, as the reference).
        Returns (output dict, body_feat = [feat | bbox_info])."""
        dt = self.compute_dtype
        x = torch.cat([feat.to(dt), cam_state.bbox_info.to(dt)], dim=1)
        init_pose = init_pose.reshape(x.shape[0], -1)
        xc = torch.cat([x, init_pose.to(dt), init_shape.to(dt), init_cam.to(dt)], dim=1)
        xc = self.fc2(self.fc1(xc))  # dropout is the identity at eval
        pred_pose = self.decpose(xc).to(init_pose.dtype) + init_pose
        pred_shape = self.decshape(xc).to(init_shape.dtype) + init_shape
        pred_cam = self.deccam(xc).to(init_cam.dtype) + init_cam
        # Eval-time orthonormalization (whmr.py:129-130).
        pred_rotmat = unbiased_gram_schmidt(pred_pose.reshape(-1, 24, 3, 3))
        output, _ = _smpl_out_bundle(
            consts, pred_rotmat, pred_shape, pred_cam, cam_state, self.img_res, j_regressor
        )
        output["pred_pose"] = pred_pose
        return output, x


def forward_init(consts: BodyConsts, batch_size: int, img_res=(256, 256), j_regressor=None):
    """Mean-parameter SMPL state seeding the MAF loop (whmr.py:211-269)."""
    pred_pose = consts.mean_pose.expand(batch_size, NPOSE)
    pred_shape = consts.mean_shape.expand(batch_size, 10)
    pred_cam = consts.mean_cam.expand(batch_size, 3)
    output, _ = _smpl_out_bundle(
        consts, pred_pose.reshape(batch_size, 24, 3, 3), pred_shape, pred_cam,
        None, img_res, j_regressor,
    )
    output["pred_pose"] = pred_pose
    return output


class GlobalOrientRegressor(nn.Module):
    """World-frame global orientation, eval mode (keys fc1, fc2, decrot).

    The reference's 3-step loop never feeds its prediction back, so at eval
    one pass gives the same result (whmr.py:296-303).
    """

    def __init__(self, feat_dim: int, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.fc1 = Linear(feat_dim + 6 + 9, 2048, dtype=dtype)
        self.fc2 = Linear(2048, 2048, dtype=dtype)
        self.decrot = Linear(2048, 9, dtype=dtype)

    def forward(self, body_feat, cam_rotmat, local_orient):
        dt = self.compute_dtype
        b = body_feat.shape[0]
        local = local_orient.reshape(b, 9)
        xc = torch.cat([body_feat.to(dt), rotmat_to_rot6d(cam_rotmat).to(dt), local.to(dt)], dim=1)
        pred_rot = self.decrot(self.fc2(self.fc1(xc))).to(local.dtype) + local
        return unbiased_gram_schmidt(pred_rot.reshape(-1, 1, 3, 3))
