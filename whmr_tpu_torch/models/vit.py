"""ViTPose-style ViT backbone (counterpart of `whmr_tpu/models/vit.py`).

The vendored mmpose ViT (reference vit.py:200-341) with its torch names:
padded patch embed (Conv k16 s16 pad 4 -> 16x12 tokens at 256x192), learned
position embedding with the cls row folded into every token, pre-LN blocks
with LayerNorm eps 1e-6, and a final LayerNorm. Drop-path is the identity
at eval, the only mode of this slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from whmr_tpu_torch.config import ViTConfig
from whmr_tpu_torch.models.layers import MLP, Attention, Conv2d, LayerNorm


class ViTBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, qkv_bias, dtype=torch.float32, attn_impl="einsum"):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype=dtype, impl=attn_impl)
        self.norm2 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype=torch.float32):
        super().__init__()
        p = cfg.patch_size
        self.proj = Conv2d(3, cfg.embed_dim, p, stride=p, padding=cfg.patch_padding, dtype=dtype)

    def forward(self, x):
        return self.proj(x)


class ViTBackbone(nn.Module):
    """(B, 3, H, W) image -> (B, embed_dim, Hp, Wp) features (channels-last memory)."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32):
        super().__init__()
        hp, wp = cfg.grid_hw
        self.compute_dtype = dtype
        self.patch_embed = PatchEmbed(cfg, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, hp * wp + 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                     dtype=dtype, attn_impl=cfg.attn_impl)
            for _ in range(cfg.depth)
        )
        self.last_norm = LayerNorm(cfg.embed_dim, 1e-6, dtype=dtype)

    def forward(self, x):
        x = self.patch_embed(x)
        b, c, hp, wp = x.shape
        x = x.flatten(2).transpose(1, 2)  # (B, N, C)
        pos = self.pos_embed.to(self.compute_dtype)
        x = x + pos[:, 1:] + pos[:, :1]  # cls-slot folding (vit.py:317-320)
        for blk in self.blocks:
            x = blk(x)
        x = self.last_norm(x)
        return x.reshape(b, hp, wp, c).permute(0, 3, 1, 2)


class ViTFeatureExtractor(nn.Module):
    """The reference's pose_vit.py:8-14 wrapper: the ViT under `.backbone`, so
    keys read `feature_extractor.backbone.*` as in the published checkpoint."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32):
        super().__init__()
        self.backbone = ViTBackbone(cfg, dtype=dtype)

    def forward(self, x):
        return self.backbone(x)
