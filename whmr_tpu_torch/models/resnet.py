"""ResNet-family networks (counterpart of `whmr_tpu/models/resnet.py`).

All three are the port's `ResNetTrunk` (torchvision ResNet-50 names
`conv1`, `bn1`, `layer1-4`) with the group-statistics `BatchNorm2d`, so a
data-parallel step normalises with the global batch's statistics, as
whmr_tpu's `bn_axis_name` does:

- `PoseResNetEncoder`: the COCO PoseResNet encoder of the res50 PyMAF mode
  (reference models/pose_resnet.py:103-305), the feature map only; the
  deconv head is WHMR's pyramid.
- `ResNetBackbone`: the SPIN encoder (reference models/hmr.py:57-161),
  returning the map and its global average; the HMR baseline is one.
- `CamCalibNet`: full image -> trunk -> global pool -> three 256-bin heads
  for vfov, pitch and roll (reference models/cam_model.py:24-81), under the
  reference names `backbone.*` and `fc_{vfov,pitch,roll}`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from whmr_tpu_torch.models.layers import Linear, ResNetTrunk


# (B, 3, H, W) -> (B, 2048, H/32, W/32): the trunk itself.
PoseResNetEncoder = ResNetTrunk


class ResNetBackbone(ResNetTrunk):
    """(B, 3, H, W) -> ((B, 2048, H/32, W/32) map, (B, 2048) global average)."""

    def forward(self, x):
        feat = super().forward(x)
        return feat, feat.mean(dim=(2, 3))


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
