"""The W-HMR multi-term training loss, batched and mask-based.

Counterpart of `whmr_tpu/training/losses.py` (reference core/trainer.py:
203-320 definitions, :466-609 assembly). Where the reference selects the
valid samples and reduces (`pred_vertices[has_smpl]`, trainer.py:236-238),
this takes a masked mean: the same value at static shapes.

Per MAF step l_i >= 1 (step 0, the mean-parameter init, is skipped):
pose/betas MSE on valid-SMPL samples, 2D crop and world keypoints
(conf-weighted, when kp_2d_w > 0), pelvis-aligned 3D keypoints, per-vertex
L1 at three mesh scales (l_i > 2 only), the camera depth regulariser and
the focal-length MSE (focal_supv_on); plus the IUV cross-entropies and
smooth-L1 U/V of the aux heads and the depth smooth-L1. The appended
Graphormer stage (pymaf.grph_on) is scored on its vertices and keypoints
only: its rotmat, shape and camera are the last parametric step's, which
would otherwise be scored twice. `hmr_loss` is the HMR baseline's subset.

Under data parallelism (`group`, the data group) each rank holds its rows
of the global batch, and the gradients are averaged over the group. A mean
over the rows stays as it is (the average of equal shares' means is the
global mean). A masked mean divides by the GLOBAL mask count (one
all_reduce of the counts a step) and is scaled by R, so the average of the
ranks' losses, and of their gradients, is the global batch's (whmr_tpu's
global denominators, losses.py:41-42, :114-133, :169-171); the gates read
the global count too. At one rank the scale is 1 and the numbers are those
without a group.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from whmr_tpu_torch.config import WHMRConfig
from whmr_tpu_torch.ops.rotation import batch_rodrigues


class GlobalCount(NamedTuple):
    """A mask's count over the data group's global batch, and the group's
    size R, by which a rank's masked sum is scaled."""

    total: torch.Tensor
    ranks: int


def global_counts(masks, group=None):
    """One GlobalCount a mask, the counts summed over `group` in one
    all_reduce (each rank's own count without a group)."""
    totals = torch.stack([m.float().sum() for m in masks])
    ranks = 1
    if group is not None:
        dist.all_reduce(totals, group=group)
        ranks = dist.get_world_size(group)
    return [GlobalCount(t, ranks) for t in totals.unbind()]


def _share(num: torch.Tensor, count: GlobalCount) -> torch.Tensor:
    """A rank's masked sum over the global count (gated at 0 valid)."""
    total = count.total.to(num.dtype)
    if count.ranks != 1:
        num = num * count.ranks
    return num / total.clamp(min=1.0) * total.clamp(max=1.0)


def _masked_mean(err: torch.Tensor, mask: torch.Tensor, count: Optional[GlobalCount] = None) -> torch.Tensor:
    """Mean over the samples where mask = 1 of each sample's mean (0 if
    none is valid): the reference's `err[mask].mean()`. `count`: the mask's
    global count (the local one when None)."""
    per_sample = err.reshape(err.shape[0], -1).mean(dim=1)
    mask = mask.to(per_sample.dtype)
    if count is None:
        count = GlobalCount(mask.sum(), 1)
    return _share((per_sample * mask).sum(), count)


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 as optax.losses.huber_loss computes it."""
    abs_err = (pred - target).abs()
    quadratic = abs_err.clamp(max=delta)
    return 0.5 * quadratic * quadratic + delta * (abs_err - quadratic)


def keypoint_loss(pred_kp, gt_kp, openpose_weight: float, gt_weight: float, scale=None):
    """Confidence-weighted 2D MSE (trainer.py:203-213); gt_kp (B, 49, 3)."""
    conf = gt_kp[..., 2:3]
    conf = torch.cat([conf[:, :25] * openpose_weight, conf[:, 25:] * gt_weight], dim=1)
    err = conf * (pred_kp - gt_kp[..., :2]) ** 2
    if scale is not None:
        err = err * scale
    return err.mean()


def keypoint_3d_loss(pred_kp3d, gt_kp3d, has_pose_3d, count=None):
    """Pelvis-aligned 3D keypoint MSE on the 24 GT joints (trainer.py:
    217-234); the pelvis is the mean of the hips (joints 2 and 3)."""
    pred = pred_kp3d[:, 25:]
    conf = gt_kp3d[..., 3:4]
    gt = gt_kp3d[..., :3]
    gt_pelvis = (gt[:, 2:3] + gt[:, 3:4]) / 2
    pred_pelvis = (pred[:, 2:3] + pred[:, 3:4]) / 2
    err = conf * (pred - pred_pelvis - (gt - gt_pelvis)) ** 2
    return _masked_mean(err, has_pose_3d, count)


def smpl_param_loss(pred_rotmat, pred_betas, gt_pose_aa, gt_betas, has_smpl, count=None):
    """MSE on rotation matrices and betas of valid samples (trainer.py:244-258)."""
    gt_rotmat = batch_rodrigues(gt_pose_aa.reshape(-1, 3)).reshape(-1, 24, 3, 3)
    return (
        _masked_mean((pred_rotmat - gt_rotmat) ** 2, has_smpl, count),
        _masked_mean((pred_betas - gt_betas) ** 2, has_smpl, count),
    )


def vertex_loss(pred_verts, gt_verts, has_smpl, count=None):
    """Per-vertex L1 (criterion_shape = nn.L1Loss, trainer.py:236-242)."""
    return _masked_mean((pred_verts - gt_verts).abs(), has_smpl, count)


def iuv_losses(u_pred, v_pred, index_pred, ann_pred, uvia_gt: Dict[str, torch.Tensor], has_iuv,
               point_regression_weight: float, count: Optional[GlobalCount] = None):
    """DensePose-style aux losses on NHWC maps (trainer.py:260-301).

    uvia_gt: 'u', 'v' (B, H, W, 25), 'index' (B, H, W, 25 one-hot), 'ann'
    (B, H, W, 15 one-hot). Returns (loss_u, loss_v, loss_index, loss_ann).
    `count`: has_iuv's global count (the local one when None).
    """
    b = index_pred.shape[0]
    mask = has_iuv.float()
    if count is None:
        count = GlobalCount(mask.sum(), 1)

    def onehot_ce(logits, onehot_target):
        # The GT maps are exact one-hots, so the cross-entropy is
        # logsumexp(logits) minus the picked logit.
        logits = logits.float()
        picked = (logits * onehot_target.float()).sum(dim=-1)
        return (torch.logsumexp(logits, dim=-1) - picked).reshape(b, -1).mean(dim=1)

    loss_index = _share((onehot_ce(index_pred, uvia_gt["index"]) * mask).sum(), count)
    loss_ann = _share((onehot_ce(ann_pred, uvia_gt["ann"]) * mask).sum(), count)
    if point_regression_weight > 0 and u_pred is not None:
        # Smooth-L1 at each pixel's GT channel (channel 0, target 0, on the
        # background), summed and divided by the FULL batch: the reference
        # takes batch_size before masking (trainer.py:256, 282-283).
        fg = (uvia_gt["index"] > 0).to(u_pred.dtype)
        valid4 = mask[:, None, None, None]
        loss_u = (huber_loss(u_pred, uvia_gt["u"]) * fg * valid4).sum() / b * point_regression_weight
        loss_v = (huber_loss(v_pred, uvia_gt["v"]) * fg * valid4).sum() / b * point_regression_weight
    else:
        loss_u = loss_v = index_pred.new_zeros((), dtype=torch.float32)
    return loss_u, loss_v, loss_index, loss_ann


def depth_loss(pred_depth, gt_depth, has_depth, point_regression_weight: float, count=None):
    """Smooth-L1 inverse-depth loss (trainer.py:301-318): summed over the
    valid samples' pixels, divided by the FULL batch, gated on the global
    count of valid samples (`count`; the local one when None)."""
    mask = has_depth.float()
    total = mask.sum() if count is None else count.total
    per = huber_loss(pred_depth, gt_depth).reshape(pred_depth.shape[0], -1).sum(dim=1)
    return (per * mask).sum() / pred_depth.shape[0] * point_regression_weight * total.clamp(max=1.0)


def hmr_loss(
    cfg: WHMRConfig,
    pred_rotmat: torch.Tensor,
    pred_betas: torch.Tensor,
    pred_cam: torch.Tensor,
    pred_kp_2d: torch.Tensor,
    pred_kp_3d: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    group=None,
) -> Dict[str, torch.Tensor]:
    """The HMR baseline's loss (`--regressor hmr`, whmr_tpu losses.py:174-217):
    the reference's assembly loop run once (trainer.py:498 `len_loop = 1`)
    — SMPL parameter MSE, crop-frame 2D keypoints, pelvis-aligned 3D
    keypoints and the positive-depth camera regulariser; no world, aux,
    focal or vertex terms. `group` as in `whmr_loss`."""
    w = cfg.loss
    n_smpl, n_pose_3d = global_counts([batch["has_smpl"], batch["has_pose_3d"]], group)
    loss_dict: Dict[str, torch.Tensor] = {}
    lp, lb = smpl_param_loss(pred_rotmat, pred_betas, batch["pose"], batch["betas"], batch["has_smpl"], n_smpl)
    loss_dict["loss_regr_pose_0"] = lp * w.pose_w
    loss_dict["loss_regr_betas_0"] = lb * w.shape_w
    if w.kp_2d_w > 0:
        loss_dict["loss_keypoints_0"] = keypoint_loss(
            pred_kp_2d, batch["keypoints"], w.openpose_train_weight, w.gt_train_weight,
        ) * w.kp_2d_w
    loss_dict["loss_keypoints_3d_0"] = keypoint_3d_loss(
        pred_kp_3d, batch["pose_3d"], batch["has_pose_3d"], n_pose_3d
    ) * w.kp_3d_w
    loss_dict["loss_cam_0"] = (torch.exp(-pred_cam[:, 0] * 10) ** 2).mean()
    loss_dict["loss"] = sum(loss_dict.values())
    return loss_dict


def whmr_loss(
    cfg: WHMRConfig,
    preds: Dict,
    batch: Dict[str, torch.Tensor],
    gt_vertices: torch.Tensor,
    gt_sub_vertices: torch.Tensor,
    gt_temp_vertices: torch.Tensor,
    uvia_gt: Optional[Dict[str, torch.Tensor]] = None,
    depth_gt: Optional[torch.Tensor] = None,
    group=None,
) -> Dict[str, torch.Tensor]:
    """The full loss over all MAF steps (trainer.py:466-609); 'loss' is the
    sum of the terms. preds: the WHMR forward's output; batch: the GT fields
    (keypoints, keypoints_world, pose, betas, pose_3d, has_smpl,
    has_pose_3d, focal, bbox_height, bbox_width, orig_shape). `group`: the
    data group, over which the masked denominators are global."""
    w = cfg.loss
    n_smpl, n_pose_3d = global_counts([batch["has_smpl"], batch["has_pose_3d"]], group)
    loss_dict: Dict[str, torch.Tensor] = {}
    # World-keypoint rescale (trainer.py:501-508): orig / bbox, x and y swapped.
    kp_scale = batch["orig_shape"] / torch.stack([batch["bbox_height"], batch["bbox_width"]], dim=1)
    kp_scale = kp_scale.flip(1)[:, None, :]

    smpl_out = preds["smpl_out"]
    for l_i in range(1, len(smpl_out)):
        out = smpl_out[l_i]
        # The appended Graphormer stage carries the last parametric step's
        # rotmat/shape/cam (whmr_tpu losses.py:253-263).
        nonparam = cfg.pymaf.grph_on and l_i == len(smpl_out) - 1
        if not nonparam:
            lp, lb = smpl_param_loss(out["rotmat"], out["pred_shape"], batch["pose"], batch["betas"],
                                     batch["has_smpl"], n_smpl)
            loss_dict[f"loss_regr_pose_{l_i}"] = lp * w.pose_w
            loss_dict[f"loss_regr_betas_{l_i}"] = lb * w.shape_w
        if w.kp_2d_w > 0:
            loss_dict[f"loss_keypoints_{l_i}"] = keypoint_loss(
                out["kp_2d"], batch["keypoints"], w.openpose_train_weight, w.gt_train_weight,
            ) * w.kp_2d_w
            loss_dict[f"loss_keypoints_world_{l_i}"] = keypoint_loss(
                out["kp_2d_w"], batch["keypoints_world"], w.openpose_train_weight,
                w.gt_train_weight, scale=kp_scale,
            ) * w.kp_2d_w
        if cfg.pymaf.focal_supv_on and not nonparam:
            loss_dict[f"loss_focal_length_{l_i}"] = (
                ((out["focal_length"] - batch["focal"]) ** 2).mean() * w.focal_weights
            )
        loss_dict[f"loss_keypoints_3d_{l_i}"] = keypoint_3d_loss(
            out["kp_3d"], batch["pose_3d"], batch["has_pose_3d"], n_pose_3d
        ) * w.kp_3d_w
        if w.vert_w > 0 and l_i > 2:
            for key, gt in (("", gt_vertices), ("_sub", gt_sub_vertices), ("_temp", gt_temp_vertices)):
                name = "verts" if not key else f"{key[1:]}_verts"
                loss_dict[f"loss_shape{key}_{l_i}"] = vertex_loss(out[name], gt, batch["has_smpl"], n_smpl) * w.vert_w
        # Positive-depth camera regulariser (trainer.py:586-588).
        if not nonparam:
            loss_dict[f"loss_cam_{l_i}"] = (torch.exp(-out["pred_cam"][:, 0] * 10) ** 2).mean()

    if uvia_gt is not None and preds["dp_out"]:
        dp = preds["dp_out"][-1]
        lu, lv, lidx, lann = iuv_losses(
            dp["predict_u"], dp["predict_v"], dp["predict_uv_index"], dp["predict_ann_index"],
            uvia_gt, batch["has_smpl"], w.point_regression_weights, n_smpl,
        )
        loss_dict["loss_U"] = lu
        loss_dict["loss_V"] = lv
        loss_dict["loss_IndexUV"] = lidx * w.index_weights
        loss_dict["loss_segAnn"] = lann * w.part_weights
    if depth_gt is not None and preds.get("dpth_out"):
        loss_dict["loss_Depth"] = depth_loss(
            preds["dpth_out"][-1], depth_gt, batch["has_smpl"], w.point_regression_weights, n_smpl
        )
    loss_dict["loss"] = sum(loss_dict.values())
    return loss_dict
