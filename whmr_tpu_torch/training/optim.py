"""Fused flat-buffer Adam (`train.fused_adam`).

Counterpart of `whmr_tpu/training/optim.py`: Adam's two moments live in
two flat fp32 buffers of all N parameter elements, and a step is one
update over them — the gradients gathered into a third flat fp32 buffer,
kept from step to step, the moments, the bias corrections and the update
computed in whole-buffer passes, and the update added to the parameters
through views. The formulas are optax's Adam, as the foreach
`Optimizer`'s (training/train_step.py): mu = 0.9 mu + 0.1 g, nu = 0.999
nu + 0.001 g^2, update -lr * mu_hat / (sqrt(nu_hat) + 1e-8), bias
corrections at the incremented count, the learning rate at the
pre-increment count; the global-norm clip, when on, scales the flat
gradient first. Each update is cast to its parameter's dtype (bf16 leaves
stay bf16). The work buffer costs N fp32 elements (0.55 GB for the
full-width model) beside the moments.

The per-parameter moments (`AdamState.mu` / `.nu`) are views into the
flat buffers, so a checkpoint holds them by parameter name in the foreach
optimizer's layout, and a resume copies into them in place.

The flat buffers do not follow a parameter's sharding, so they cannot
serve FSDP or tensor parallelism: `init` refuses sharded parameters and
the Trainer refuses `train.fused_adam` with `--fsdp` or
`model_parallel > 1`, as whmr_tpu's does (trainer.py:111-116). Plain
data parallelism keeps whole parameters on every rank and works.

whmr_tpu recorded this layout as a loss on the v5e (154.1 ms against
136.1 ms a step); the port's numbers are in PERF.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from whmr_tpu_torch.parallel.mesh import sharded_over
from whmr_tpu_torch.training.train_step import _B1, _B2, _EPS, AdamState, Optimizer, global_norm


@dataclass
class FusedAdamState(AdamState):
    flat_mu: Optional[torch.Tensor] = None  # (N,) fp32; `mu` holds views of it
    flat_nu: Optional[torch.Tensor] = None
    flat_work: Optional[torch.Tensor] = None  # (N,) fp32: the gradient, then the update


class FusedAdam(Optimizer):
    """`Optimizer` (clip, Adam, step schedule) on flat moment buffers."""

    def init(self, params: List[torch.Tensor]) -> FusedAdamState:
        if any(sharded_over(p) for p in params):
            raise ValueError(
                "train.fused_adam keeps flat (unsharded) Adam moments and cannot hold "
                "FSDP or tensor-parallel shards; disable one of them"
            )
        sizes = [p.numel() for p in params]
        device = params[0].device if params else None
        flat_mu = torch.zeros(sum(sizes), dtype=torch.float32, device=device)
        flat_nu = torch.zeros_like(flat_mu)
        return FusedAdamState(
            count=0, mu=_views(flat_mu, params), nu=_views(flat_nu, params),
            flat_mu=flat_mu, flat_nu=flat_nu, flat_work=torch.empty_like(flat_mu),
        )

    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: FusedAdamState,
             norm: Optional[torch.Tensor] = None) -> FusedAdamState:
        """One update in place, in whole-buffer passes over one work buffer
        kept from step to step (no N-sized allocation a step)."""
        w = state.flat_work
        torch.cat([t.reshape(-1).float() for t in grads], out=w)
        if self.clip_norm > 0:
            if norm is None:
                norm = global_norm(grads)
            w.mul_(torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm))
        count = state.count + 1
        mu, nu = state.flat_mu, state.flat_nu
        mu.mul_(_B1).add_(w, alpha=1.0 - _B1)
        nu.mul_(_B2).addcmul_(w, w, value=1.0 - _B2)
        bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(count))
        # w <- sqrt(nu / bc2) + eps, then -lr * (mu / bc1) / w
        torch.div(nu, bc2, out=w).sqrt_().add_(_EPS)
        torch.div(mu, w, out=w).mul_(-self.learning_rate(state.count) / bc1)
        with torch.no_grad():
            torch._foreach_add_(params, [u.to(p.dtype) for u, p in zip(_views(w, params), params)])
        return FusedAdamState(count=count, mu=state.mu, nu=state.nu, flat_mu=mu, flat_nu=nu, flat_work=w)


def _views(flat: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    """`flat` cut into views shaped like `params`, in order."""
    return [v.view(p.shape) for v, p in zip(flat.split([p.numel() for p in params]), params)]

