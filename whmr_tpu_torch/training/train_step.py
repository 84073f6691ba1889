"""The training step: forward, loss, gradients and the optimizer update.

Counterpart of `whmr_tpu/training/train_step.py` (reference `Trainer.
train_step`, core/trainer.py:380-636). Each step fits the GT camera from the
2D keypoints by least squares, renders the GT IUV maps of the GT mesh (K2 on
the card), runs the train-mode forward, the loss and its gradients, and
applies Adam. The GT SMPL forward, mesh downsampling, camera fit and render
are loss targets and run without autograd.

PyTorch updates in place where JAX returns new trees: the `TrainState`
holds the model's own parameter and BatchNorm-buffer tensors, so the
optimizer writes into the model, and train-mode BatchNorm updates its
running statistics during the forward. The step counter and Adam's count
live on the host, so nothing in the step waits for the card.

The sharded step (`make_jitted_train_step`'s mesh arguments), the HMR
baseline's `hmr_train_step` and `fused_adam` wait for later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from whmr_tpu_torch.config import FOCAL_LENGTH, IMG_NORM_MEAN, IMG_NORM_STD, WHMRConfig
from whmr_tpu_torch.models.regressor import BodyConsts
from whmr_tpu_torch.models.smpl import smpl_forward
from whmr_tpu_torch.models.whmr import WHMR
from whmr_tpu_torch.ops.camera import estimate_translation
from whmr_tpu_torch.ops.iuv import iuv_img2map
from whmr_tpu_torch.ops.rotation import batch_rodrigues
from whmr_tpu_torch.training.gt_renderer import RenderConsts, gt_camera_from_cam_t, render_gt_maps
from whmr_tpu_torch.training.losses import whmr_loss

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

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: AdamState) -> AdamState:
        """Updates `params` in place from `grads`; returns the new state."""
        if self.clip_norm > 0:
            norm = global_norm(grads)
            factor = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
            grads = torch._foreach_mul(grads, factor)
        count = state.count + 1
        mu = torch._foreach_mul(state.mu, _B1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - _B1))
        nu = torch._foreach_mul(state.nu, _B2)
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
        return AdamState(count=count, mu=mu, nu=nu)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def make_optimizer(cfg: WHMRConfig, steps_per_epoch: int = 1) -> Optimizer:
    """Adam at base_lr, decayed by lr_gamma at each epoch of
    lr_decay_epochs (the reference's decay at epoch boundaries,
    core/trainer.py:330-338, keyed by step through `steps_per_epoch`), with
    global-norm clipping before it when grad_clip_norm > 0."""
    if cfg.train.fused_adam:
        raise NotImplementedError("train.fused_adam is not ported yet (see ROADMAP.md)")
    return Optimizer(
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

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> "TrainState":
        names = list(self.params)
        params = [self.params[k] for k in names]
        self.opt_state = self.tx.step(params, [grads[k] for k in names], self.opt_state)
        if self.ema_params is not None:
            d = self.ema_decay
            ema = [self.ema_params[k] for k in names]
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, torch._foreach_mul([p.detach() for p in params], 1.0 - d))
        self.step += 1
        return self


def create_train_state(cfg: WHMRConfig, model: WHMR, steps_per_epoch: int = 1) -> TrainState:
    """Puts `model` in train mode and wraps its tensors with a fresh Adam."""
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
    gives) and losses of one (micro)batch; BatchNorm running statistics
    update in place."""
    gt_vertices, gt_sub, gt_temp, uvia_gt, depth_gt = gt_targets(cfg, consts, batch, render_consts)
    preds = model(
        consts, _model_input(batch), batch["center"], batch["scale"], batch["bbox_height"],
        batch["orig_shape"], batch["bbox_info"], train=True, meta_masks=batch.get("meta_mask"),
        generator=generator,
    )
    losses = whmr_loss(cfg, preds, batch, gt_vertices, gt_sub, gt_temp, uvia_gt=uvia_gt,
                       depth_gt=depth_gt)
    names = list(state.params)
    grads = torch.autograd.grad(losses["loss"], [state.params[k] for k in names], allow_unused=True)
    grads = {
        k: torch.zeros_like(state.params[k]) if g is None else g for k, g in zip(names, grads)
    }
    return grads, {k: v.detach() for k, v in losses.items()}


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
    gradient norm, as device scalars."""
    grads, losses = _microbatch_grads(cfg, model, state, consts, batch, generator, render_consts)
    metrics = dict(losses)
    metrics["grad_norm"] = global_norm(list(grads.values()))
    return state.apply_gradients(grads), metrics


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
    one microbatch to the next."""
    accum = next(iter(batches.values())).shape[0]
    gsum, lsum = None, None
    for i in range(accum):
        grads, losses = _microbatch_grads(
            cfg, model, state, consts, {k: v[i] for k, v in batches.items()}, generator,
            render_consts,
        )
        if gsum is None:
            gsum, lsum = grads, losses
        else:
            gsum = {k: gsum[k] + g for k, g in grads.items()}
            lsum = {k: lsum[k] + v for k, v in losses.items()}
    inv = 1.0 / accum
    grads = {k: g * inv for k, g in gsum.items()}
    metrics = {k: v * inv for k, v in lsum.items()}
    metrics["grad_norm"] = global_norm(list(grads.values()))
    return state.apply_gradients(grads), metrics
