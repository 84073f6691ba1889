"""Mesh-aligned feature (MAF) extractor (counterpart of `whmr_tpu/models/maf.py`).

Projects mesh markers through the weak-perspective camera, samples the
feature map at the projected points, and reduces the per-point channels with
the reference's skip-concat 1x1-conv MLP (maf_extractor.py:17-143). The
convs keep the reference's Conv1d parameters (O, I, 1), applied pointwise on
(B, N, C) features.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from whmr_tpu_torch.ops.camera import weak_perspective_projection
from whmr_tpu_torch.ops.grid_sample import grid_sample_2d


class PointwiseConv1d(nn.Conv1d):
    """Conv1d(k=1) applied to (B, N, C) point features, in the compute dtype."""

    def __init__(self, in_ch, out_ch, dtype=torch.float32):
        super().__init__(in_ch, out_ch, 1)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight[:, :, 0].to(dt), self.bias.to(dt))


class MAFExtractor(nn.Module):
    def __init__(self, mlp_dim: Sequence[int] = (256, 128, 64, 32),
                 img_res: Tuple[int, int] = (256, 256), dtype=torch.float32):
        super().__init__()
        self.img_res = tuple(img_res)
        self.n_layers = len(mlp_dim) - 1
        for i in range(self.n_layers):
            in_ch = mlp_dim[0] if i == 0 else mlp_dim[i] + mlp_dim[0]
            setattr(self, f"conv{i}", PointwiseConv1d(in_ch, mlp_dim[i + 1], dtype=dtype))

    def reduce_dim(self, point_feat: torch.Tensor) -> torch.Tensor:
        """(B, N, C0) -> (B, C_last * N), flattened CHANNEL-major as the
        reference's (B, C, N) view (maf_extractor.py:100): the regressor's
        fc1 weights index features as c * N + n."""
        y = point_feat
        for i in range(self.n_layers):
            y = getattr(self, f"conv{i}")(y if i == 0 else torch.cat([y, point_feat], dim=-1))
            if i != self.n_layers - 1:
                y = F.leaky_relu(y, negative_slope=0.01)
        y = F.relu(y)
        return y.transpose(1, 2).reshape(y.shape[0], -1)

    def sampling(self, im_feat: torch.Tensor, points: torch.Tensor):
        """Sample NHWC `im_feat` at normalized points (B, N, 2).

        Returns (reduced (B, N * C_last), raw point features (B, N, C))."""
        point_feat = grid_sample_2d(im_feat, points)
        return self.reduce_dim(point_feat), point_feat

    def forward(self, im_feat: torch.Tensor, points_3d: torch.Tensor, cam: torch.Tensor):
        p2d = weak_perspective_projection(points_3d, cam, self.img_res)
        return self.sampling(im_feat, p2d.to(im_feat.dtype))
