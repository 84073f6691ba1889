"""The training step: forward, loss, gradients and the optimizer update.

Counterpart of `whmr_tpu/training/train_step.py` (reference `Trainer.
train_step`, core/trainer.py:380-636). Each step fits the GT camera from the
2D keypoints by least squares, renders the GT IUV maps of the GT mesh (K2 on
the card), runs the train-mode forward, the loss and its gradients, and
applies Adam. The GT SMPL forward, mesh downsampling, camera fit and render
are loss targets and run without autograd.

PyTorch updates in place where JAX returns new trees: the `TrainState`
holds the model's own parameter and BatchNorm-buffer tensors, so the
optimizer writes into the model (and into Adam's moments), and train-mode
BatchNorm updates its running statistics during the forward. The step
counter and Adam's count live on the host, so nothing in the step waits for
the card. Gradients accumulate in the parameters' `.grad` (FSDP2 reduces
them there) and are taken out after the backward.

On a mesh (`TrainState.mesh`, `parallel.shard_params`), each rank holds its
rows of the global batch. After the backward (the last microbatch's, under
grad_accum) the gradients that FSDP does not reduce are averaged over the
data group in flat buckets (the psum GSPMD inserts in whmr_tpu); the
global-norm clip counts each shard once over the mesh; Adam and the EMA
update each rank's shards; and the metrics are the group's means, so
every rank reads the global batch's losses. At one rank the numbers are
those without a mesh, bit for bit, except that FSDP's reductions may
round differently.

`hmr_train_step` is the HMR baseline's step (`regressor="hmr"`): no GT
render, the `hmr_loss` subset, no gradient accumulation. `train.fused_adam`
selects the flat-buffer Adam of training/optim.py.

Spans (utils/profiling.py): each step is a `train.step` root holding
`train.targets` (`gt_targets`), `train.forward` (the model's forward, whose
`whmr.*` spans nest here, and the loss), `train.backward` (autograd's
dispatch) and `train.optimizer` (the gradient norm, Adam, the clip and the
EMA).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from whmr_tpu_torch.config import FOCAL_LENGTH, IMG_NORM_MEAN, IMG_NORM_STD, WHMRConfig
from whmr_tpu_torch.models.regressor import BodyConsts
from whmr_tpu_torch.parallel.mesh import (
    all_reduce_mean,
    data_group,
    fsdp_managed,
    local_tensors,
    sharded_global_norm,
    sharded_over,
)
from whmr_tpu_torch.models.smpl import smpl_forward
from whmr_tpu_torch.models.whmr import WHMR
from whmr_tpu_torch.ops.camera import estimate_translation, weak_perspective_projection
from whmr_tpu_torch.ops.iuv import iuv_img2map
from whmr_tpu_torch.ops.rotation import batch_rodrigues
from whmr_tpu_torch.training.gt_renderer import RenderConsts, gt_camera_from_cam_t, render_gt_maps
from whmr_tpu_torch.training.losses import hmr_loss, whmr_loss
from whmr_tpu_torch.utils import profiling

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamState:
    count: int                 # updates applied so far (host)
    mu: List[torch.Tensor]     # first moments, one per parameter
    nu: List[torch.Tensor]     # second moments


class Optimizer:
    """optax's `chain(clip_by_global_norm(c), adam(schedule))` as tensor code.

    - Clip (when `clip_norm` > 0) BEFORE Adam, optax's rule: gradients stay
      as they are below the limit and are scaled by clip_norm / norm above
      it (not `clip_grad_norm_`'s clip_norm / (norm + 1e-6)).
    - Adam: mu = 0.1 g + 0.9 mu, nu = 0.001 g^2 + 0.999 nu, update
      -lr * mu_hat / (sqrt(nu_hat) + 1e-8) with the bias corrections at the
      incremented count, and the learning rate read at the PRE-increment
      count (optax's scale_by_schedule keeps its own counter from 0).
    - Schedule: `base_lr`, times `gamma` at each step in `boundaries` and
      after (optax.piecewise_constant_schedule), computed in fp32.
    """

    def __init__(self, base_lr: float, boundaries=(), gamma: float = 0.1, clip_norm: float = 0.0):
        self.base_lr = base_lr
        self.boundaries = sorted({int(b) for b in boundaries})
        self.gamma = gamma
        self.clip_norm = clip_norm

    def learning_rate(self, count: int) -> float:
        v = np.float32(self.base_lr)
        for threshold in self.boundaries:
            if count >= threshold:
                v = np.float32(np.float32(self.gamma) * v)
        return float(v)

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(
            count=0,
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
        )

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: AdamState,
             norm: Optional[torch.Tensor] = None) -> AdamState:
        """Updates `params` and the moments in place from `grads`; returns
        the new state. Sharded tensors (DTensors) update their local
        shards; `norm` is then the gradients' global norm over the mesh
        (computed here when None)."""
        if self.clip_norm > 0:
            if norm is None:
                norm = global_norm(grads)
            factor = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
            grads = torch._foreach_mul(local_tensors(grads), factor)
        grads = local_tensors(grads)
        params = local_tensors(params)
        count = state.count + 1
        mu = local_tensors(state.mu)
        torch._foreach_mul_(mu, _B1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - _B1))
        nu = local_tensors(state.nu)
        torch._foreach_mul_(nu, _B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - _B2))
        # Bias corrections in fp32, as optax's `1 - decay**count`.
        bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(count))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -self.learning_rate(state.count))
        with torch.no_grad():
            torch._foreach_add_(params, upd)
        return AdamState(count=count, mu=state.mu, nu=state.nu)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def make_optimizer(cfg: WHMRConfig, steps_per_epoch: int = 1) -> Optimizer:
    """Adam at base_lr, decayed by lr_gamma at each epoch of
    lr_decay_epochs (the reference's decay at epoch boundaries,
    core/trainer.py:330-338, keyed by step through `steps_per_epoch`), with
    global-norm clipping before it when grad_clip_norm > 0; with
    train.fused_adam, the same on flat moment buffers (training/optim.py)."""
    cls = Optimizer
    if cfg.train.fused_adam:
        from whmr_tpu_torch.training.optim import FusedAdam as cls
    return cls(
        cfg.train.base_lr,
        boundaries=[int(e) * int(steps_per_epoch) for e in cfg.train.lr_decay_epochs],
        gamma=cfg.train.lr_gamma,
        clip_norm=cfg.train.grad_clip_norm,
    )


@dataclass
class TrainState:
    """What a step updates. `params` and `batch_stats` are the model's own
    tensors, by state_dict name, so the step writes into the model."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    batch_stats: Dict[str, torch.Tensor]  # BatchNorm running_mean / running_var
    opt_state: AdamState
    tx: Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_decay: float = 0.0
    mesh: Optional[object] = None  # the DeviceMesh of a sharded step

    @property
    def sharded(self) -> bool:
        """Whether any parameter is split over the mesh (FSDP or TP)."""
        return any(sharded_over(p) for p in self.params.values())

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """optax.global_norm of the (synchronised) gradients, each shard
        counted once when the parameters are split over the mesh."""
        if self.mesh is not None and self.sharded:
            return sharded_global_norm(grads, self.mesh)
        return global_norm(grads)

    def apply_gradients(self, grads: Dict[str, torch.Tensor], norm: Optional[torch.Tensor] = None) -> "TrainState":
        names = list(self.params)
        params = [self.params[k] for k in names]
        grads = [grads[k] for k in names]
        if norm is None and self.tx.clip_norm > 0:
            norm = self.grad_norm(grads)
        self.opt_state = self.tx.step(params, grads, self.opt_state, norm)
        if self.ema_params is not None:
            d = self.ema_decay
            ema = local_tensors(self.ema_params[k] for k in names)
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, torch._foreach_mul(local_tensors(p.detach() for p in params), 1.0 - d))
        self.step += 1
        return self


def create_train_state(cfg: WHMRConfig, model: torch.nn.Module, steps_per_epoch: int = 1, mesh=None) -> TrainState:
    """Puts `model` (WHMR, or the HMR baseline for `hmr_train_step`) in
    train mode and wraps its tensors with a fresh Adam (the fused one under
    `train.fused_adam`).
    On a `mesh`, call it after `parallel.shard_params`: the moments and EMA
    weights are made like the (sharded) parameters."""
    model.train()
    params = dict(model.named_parameters())
    batch_stats = {
        k: v for k, v in model.named_buffers() if k.endswith(("running_mean", "running_var"))
    }
    tx = make_optimizer(cfg, steps_per_epoch)
    ema_decay = float(cfg.train.ema_decay)
    return TrainState(
        step=0,
        params=params,
        batch_stats=batch_stats,
        opt_state=tx.init([p.detach() for p in params.values()]),
        tx=tx,
        ema_params=({k: p.detach().clone() for k, p in params.items()} if ema_decay > 0 else None),
        ema_decay=ema_decay,
        mesh=mesh,
    )


def device_normalize(img: torch.Tensor, pixel_noise: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC crop with per-channel noise -> normalized fp32 on the
    device: crop * noise, clipped to [0, 255], / 255, ImageNet mean/std (the
    host finalize_crop chain, so the loader can ship uint8)."""
    out = img.float() * pixel_noise[:, None, None, :]
    out = out.clamp(0.0, 255.0) / 255.0
    mean = torch.tensor(IMG_NORM_MEAN, dtype=torch.float32).to(img.device, non_blocking=True)
    std = torch.tensor(IMG_NORM_STD, dtype=torch.float32).to(img.device, non_blocking=True)
    return (out - mean) / std


def _model_input(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch['img'] as normalized fp32: as it is, or device_normalize for
    the uint8 feed."""
    img = batch["img"]
    if img.dtype == torch.uint8:
        return device_normalize(img, batch["pixel_noise"])
    return img


def gt_render_camera(cfg: WHMRConfig, gt_joints: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
    """The weak GT camera of the render: the least-squares translation that
    takes the GT joints onto the 2D keypoints (normalised crop coordinates
    in, pixels for the fit), clamped to the physical range."""
    w, h = cfg.img_res
    kp_orig = torch.cat([0.5 * h * (keypoints[..., :2] + 1.0), keypoints[..., 2:]], dim=-1)
    cam_t = estimate_translation(gt_joints, kp_orig, FOCAL_LENGTH, (float(w), float(h)))
    return gt_camera_from_cam_t(cam_t)


@torch.no_grad()
def gt_targets(cfg: WHMRConfig, consts: BodyConsts, batch: Dict[str, torch.Tensor],
               render_consts: Optional[RenderConsts] = None):
    """The loss targets of a batch: GT vertices at three mesh scales
    (trainer.py:414-423) and, with aux or depth supervision on, the GT IUV
    maps and inverse depth rendered with the least-squares GT camera
    (trainer.py:428-464). Returns (gt_vertices, gt_sub, gt_temp, uvia_gt,
    depth_gt)."""
    gt_rotmats = batch_rodrigues(batch["pose"].reshape(-1, 3)).reshape(-1, 24, 3, 3)
    gt_out = smpl_forward(consts.smpl, batch["betas"], gt_rotmats)
    gt_vertices = gt_out.vertices
    gt_sub = torch.einsum("sv,bvk->bsk", consts.dmap0, gt_vertices)
    gt_temp = torch.einsum("ts,bsk->btk", consts.dmap1, gt_sub)

    uvia_gt, depth_gt = batch.get("uvia_gt"), batch.get("depth_gt")
    want_render = cfg.pymaf.aux_supv_on or cfg.pymaf.depth_supv_on
    if uvia_gt is None and render_consts is not None and want_render:
        expect = consts.dmap0.shape[0] if cfg.pymaf.gt_render_mesh == "sub" else gt_vertices.shape[1]
        if render_consts.source_verts != expect:
            raise ValueError(
                f"render_consts sources {render_consts.source_verts} vertices but "
                f"cfg.pymaf.gt_render_mesh={cfg.pymaf.gt_render_mesh!r} expects {expect}: "
                "build_render_consts(mesh=...) and the config disagree"
            )
        maps = render_gt_maps(
            render_consts,
            gt_vertices if expect == gt_vertices.shape[1] else gt_sub,
            gt_render_camera(cfg, gt_out.joints, batch["keypoints"]),
            heatmap_size=cfg.pymaf.dp_heatmap_size,
            vitpose_slice=cfg.pymaf.backbone == "vitpose",
            with_depth=cfg.pymaf.depth_supv_on,
            valid=batch["has_smpl"],
        )
        if cfg.pymaf.aux_supv_on:
            uvia_gt = iuv_img2map(maps["iuv_image_gt"])
        if cfg.pymaf.depth_supv_on:
            depth_gt = maps["depth_image_gt"]
    return gt_vertices, gt_sub, gt_temp, uvia_gt, depth_gt


def _backward(
    cfg: WHMRConfig,
    model: WHMR,
    state: TrainState,
    consts: BodyConsts,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    render_consts: Optional[RenderConsts] = None,
) -> Dict[str, torch.Tensor]:
    """Forward, loss and backward of one (micro)batch: the gradients add
    into the parameters' `.grad`, the BatchNorm running statistics update in
    place. Returns the losses (this rank's, on a mesh)."""
    with profiling.span("train.targets"):
        gt_vertices, gt_sub, gt_temp, uvia_gt, depth_gt = gt_targets(cfg, consts, batch, render_consts)
    with profiling.span("train.forward"):
        preds = model(
            consts, _model_input(batch), batch["center"], batch["scale"], batch["bbox_height"],
            batch["orig_shape"], batch["bbox_info"], train=True, meta_masks=batch.get("meta_mask"),
            generator=generator,
        )
        losses = whmr_loss(cfg, preds, batch, gt_vertices, gt_sub, gt_temp, uvia_gt=uvia_gt,
                           depth_gt=depth_gt, group=data_group(state.mesh))
    with profiling.span("train.backward"):
        losses["loss"].backward()
    return {k: v.detach() for k, v in losses.items()}


def _zero_grads(state: TrainState) -> None:
    for p in state.params.values():
        p.grad = None


def _take_grads(state: TrainState) -> Dict[str, torch.Tensor]:
    """The accumulated gradients (zeros for parameters the loss does not
    reach, as JAX gives), each in its parameter's placement; clears `.grad`."""
    grads = {}
    for k, p in state.params.items():
        g = p.grad
        if g is None:
            g = torch.zeros_like(p.detach())
        elif getattr(g, "placements", None) is not None and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        grads[k] = g
        p.grad = None
    return grads


def _sync(state: TrainState, grads: Dict[str, torch.Tensor], losses: Dict[str, torch.Tensor]):
    """On a mesh: the gradients FSDP does not reduce, averaged over the data
    group (bucketed), and the losses as the group's means (one all_reduce)."""
    group = data_group(state.mesh)
    if group is None:
        return losses
    all_reduce_mean(local_tensors(g for k, g in grads.items() if not fsdp_managed(state.params[k])), group)
    stacked = torch.stack([v.float() for v in losses.values()])
    all_reduce_mean([stacked], group)
    return {k: v.to(losses[k].dtype) for k, v in zip(losses, stacked.unbind())}


def _set_fsdp_sync(model: WHMR, sync: bool) -> None:
    """Whether FSDP reduces gradients in this backward (off for all but the
    last grad_accum microbatch)."""
    for m in model.modules():
        if hasattr(m, "set_requires_gradient_sync"):
            m.set_requires_gradient_sync(sync, recurse=False)


def _microbatch_grads(
    cfg: WHMRConfig,
    model: WHMR,
    state: TrainState,
    consts: BodyConsts,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    render_consts: Optional[RenderConsts] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Gradients (zeros for parameters the loss does not reach, as JAX
    gives) and losses of one (micro)batch, this rank's; BatchNorm running
    statistics update in place."""
    _zero_grads(state)
    losses = _backward(cfg, model, state, consts, batch, generator, render_consts)
    return _take_grads(state), losses


def train_step(
    cfg: WHMRConfig,
    model: WHMR,
    state: TrainState,
    consts: BodyConsts,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    render_consts: Optional[RenderConsts] = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step; metrics are the losses and the pre-clip
    gradient norm, as device scalars (the global batch's on a mesh)."""
    with profiling.span("train.step"):
        grads, losses = _microbatch_grads(cfg, model, state, consts, batch, generator, render_consts)
        metrics = _sync(state, grads, losses)
        return _update(state, grads, metrics)


def _update(state: TrainState, grads: Dict[str, torch.Tensor], metrics: Dict[str, torch.Tensor]):
    """The optimizer's part of a step: the pre-clip gradient norm into
    `metrics`, then Adam, the clip and the EMA."""
    with profiling.span("train.optimizer"):
        norm = state.grad_norm(list(grads.values()))
        metrics["grad_norm"] = norm
        return state.apply_gradients(grads, norm), metrics


def train_step_accum(
    cfg: WHMRConfig,
    model: WHMR,
    state: TrainState,
    consts: BodyConsts,
    batches: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    render_consts: Optional[RenderConsts] = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step from K sequential microbatches (`batches` leaves
    shaped (K, micro, ...)). Gradients and losses are averaged over the K
    microbatches (the mean of per-group means, as the reference's DDP
    all-reduce across ranks, trainer.py:614); BatchNorm statistics chain from
    one microbatch to the next. On a mesh the gradients are synchronised
    once, after the last microbatch."""
    with profiling.span("train.step"):
        accum = next(iter(batches.values())).shape[0]
        _zero_grads(state)
        lsum = None
        try:
            for i in range(accum):
                _set_fsdp_sync(model, i == accum - 1)
                losses = _backward(cfg, model, state, consts, {k: v[i] for k, v in batches.items()}, generator,
                                   render_consts)
                lsum = losses if lsum is None else {k: lsum[k] + v for k, v in losses.items()}
        finally:
            _set_fsdp_sync(model, True)
        inv = 1.0 / accum
        gsum = _take_grads(state)
        metrics = _sync(state, gsum, lsum)
        grads = {k: g * inv for k, g in gsum.items()}
        metrics = {k: v * inv for k, v in metrics.items()}
        return _update(state, grads, metrics)


def hmr_train_step(
    cfg: WHMRConfig,
    model,
    state: TrainState,
    consts: BodyConsts,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step of the HMR baseline (whmr_tpu train_step.py:384-414,
    reference trainer.py:406-409 and the single-pass loss loop at :498-590):
    the train-mode forward, an SMPL forward of its prediction, the
    crop-frame projection and `hmr_loss`; the same optimizer, EMA and mesh
    handling as `train_step`. `state` is `create_train_state` of the HMR
    model."""
    with profiling.span("train.step"):
        _zero_grads(state)
        with profiling.span("train.forward"):
            rotmat, betas, cam = model(consts, _model_input(batch), train=True, generator=generator)
            # Geometry in at least fp32, whatever the compute dtype.
            rotmat, betas, cam = (v.to(torch.promote_types(v.dtype, torch.float32)) for v in (rotmat, betas, cam))
            joints = smpl_forward(consts.smpl, betas, rotmat).joints
            kp_2d = weak_perspective_projection(joints, cam, cfg.img_res)
            losses = hmr_loss(cfg, rotmat, betas, cam, kp_2d, joints, batch, group=data_group(state.mesh))
        with profiling.span("train.backward"):
            losses["loss"].backward()
        grads = _take_grads(state)
        metrics = _sync(state, grads, {k: v.detach() for k, v in losses.items()})
        return _update(state, grads, metrics)
