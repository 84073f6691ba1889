"""The plain HMR baseline: ResNet-50 + iterative rot6d SMPL regressor.

Counterpart of `whmr_tpu/models/hmr.py` (reference `models/hmr.py:164-277`,
the SPIN-style HMR that `--regressor hmr` selects, core/trainer.py:407-409):
the globally pooled backbone feature, 3 refinement iterations over
[feature | pose (rot6d) | shape | cam] from the mean parameters, and rot6d
-> rotation matrices. As in whmr_tpu, the carries are in the compute dtype.

The network is a `ResNetBackbone` with the regressor on top, so the
state_dict keys are the reference's: `conv1`, `bn1`, `layer1-4`, `fc1`,
`fc2`, `decpose`, `decshape`, `deccam`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from whmr_tpu_torch.models.layers import Dropout, Linear
from whmr_tpu_torch.models.regressor import BodyConsts
from whmr_tpu_torch.models.resnet import ResNetBackbone
from whmr_tpu_torch.ops.rotation import rot6d_to_rotmat

NPOSE6 = 24 * 6


class HMR(ResNetBackbone):
    """(B, H, W, 3) crops -> (rotmat (B, 24, 3, 3), betas (B, 10), cam (B, 3))."""

    def __init__(self, n_iter: int = 3, dtype=torch.float32):
        super().__init__(dtype=dtype)
        self.n_iter = n_iter
        self.compute_dtype = dtype
        self.fc1 = Linear(2048 + NPOSE6 + 13, 1024, dtype=dtype)
        self.drop1 = Dropout(0.5)
        self.fc2 = Linear(1024, 1024, dtype=dtype)
        self.drop2 = Dropout(0.5)
        self.decpose = Linear(1024, NPOSE6, dtype=dtype)
        self.decshape = Linear(1024, 10, dtype=dtype)
        self.deccam = Linear(1024, 3, dtype=dtype)

    def forward(self, consts: BodyConsts, x: torch.Tensor, train: bool = False,
                generator=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """`train` must match the module's mode; `generator` draws the
        dropout masks in training."""
        if train != self.training:
            raise ValueError(
                f"forward(train={train}) on a module in {'train' if self.training else 'eval'} "
                "mode: call model.train() or model.eval() first"
            )
        b = x.shape[0]
        _, feat = super().forward(x.permute(0, 3, 1, 2))
        dt = feat.dtype
        # Mean init in rot6d (hmr.py:186-192): the first two columns of the
        # mean pose's rotation matrices.
        init_pose = consts.mean_pose.reshape(1, 24, 3, 3)[..., :2].reshape(1, NPOSE6)
        pred_pose = init_pose.expand(b, NPOSE6).to(dt)
        pred_shape = consts.mean_shape.expand(b, 10).to(dt)
        pred_cam = consts.mean_cam.expand(b, 3).to(dt)
        for _ in range(self.n_iter):
            xc = torch.cat([feat, pred_pose, pred_shape, pred_cam], dim=1)
            xc = self.drop1(self.fc1(xc), generator)
            xc = self.drop2(self.fc2(xc), generator)
            pred_pose = self.decpose(xc) + pred_pose
            pred_shape = self.decshape(xc) + pred_shape
            pred_cam = self.deccam(xc) + pred_cam
        return rot6d_to_rotmat(pred_pose).reshape(b, 24, 3, 3), pred_shape, pred_cam
