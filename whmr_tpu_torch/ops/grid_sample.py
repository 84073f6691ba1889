"""Bilinear point sampling from feature maps (grid_sample, align_corners=True).

Counterpart of `whmr_tpu/ops/grid_sample.py`, the reference's
`F.grid_sample(im_feat, points, align_corners=True)` (maf_extractor.py:117-121)
with zero padding. The same four-corner gather as whmr_tpu: the corner
weights are fp32 whatever the feature dtype, the gathered features are summed
in fp32 and the result is cast back. Only 63-67 points are sampled per crop,
so this gathers (B, N, C) rows instead of touching the whole map.
"""

from __future__ import annotations

import torch


def grid_sample_2d(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Sample `feat` (B, H, W, C) at normalized xy `points` (B, N, 2) in [-1, 1]
    (x indexes W, y indexes H). Returns (B, N, C) in feat's dtype."""
    b, h, w, c = feat.shape
    flat = feat.reshape(b, h * w, c)
    x = points[..., 0].float()
    y = points[..., 1].float()
    fx = (x + 1.0) * 0.5 * (w - 1)
    fy = (y + 1.0) * 0.5 * (h - 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1 = fx - x0
    wx0 = 1.0 - wx1
    wy1 = fy - y0
    wy0 = 1.0 - wy1

    def corner(xi, yi, wxi, wyi):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xi_c = xi.clamp(0, w - 1).long()
        yi_c = yi.clamp(0, h - 1).long()
        idx = (yi_c * w + xi_c)[..., None].expand(-1, -1, c)
        gathered = torch.gather(flat, 1, idx).float()
        return gathered * (wxi * wyi * inb.float())[..., None]

    out = (
        corner(x0, y0, wx0, wy0)
        + corner(x1, y0, wx1, wy0)
        + corner(x0, y1, wx0, wy1)
        + corner(x1, y1, wx1, wy1)
    )
    return out.to(feat.dtype)
