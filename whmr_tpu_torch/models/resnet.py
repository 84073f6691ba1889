"""CamCalib network (counterpart of `whmr_tpu/models/resnet.py::CamCalibNet`).

Full image -> ResNet-50 trunk -> global average pool -> three 256-bin heads
for vfov, pitch and roll (reference models/cam_model.py:24-81), under the
reference names `backbone.*` and `fc_{vfov,pitch,roll}`. `PoseResNetEncoder`
and `ResNetBackbone` arrive with the res50 and HMR branches.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from whmr_tpu_torch.models.layers import Linear, ResNetTrunk


class CamCalibNet(nn.Module):
    """(B, 3, H, W) full frames -> ((vfov, pitch, roll) logits, pooled feature)."""

    def __init__(self, num_bins: int = 256, dtype=torch.float32):
        super().__init__()
        self.backbone = ResNetTrunk(dtype=dtype)
        self.fc_vfov = Linear(2048, num_bins, dtype=dtype)
        self.fc_pitch = Linear(2048, num_bins, dtype=dtype)
        self.fc_roll = Linear(2048, num_bins, dtype=dtype)

    def forward(self, x):
        pooled = self.backbone(x).mean(dim=(2, 3))
        return (self.fc_vfov(pooled), self.fc_pitch(pooled), self.fc_roll(pooled)), pooled
