"""ViTPose-style ViT backbone (counterpart of `whmr_tpu/models/vit.py`).

The vendored mmpose ViT (reference vit.py:200-341) with its torch names:
padded patch embed (Conv k16 s16 pad 4 -> 16x12 tokens at 256x192), learned
position embedding with the cls row folded into every token, pre-LN blocks
with LayerNorm eps 1e-6, and a final LayerNorm. In training each block's
residual branches pass through stochastic depth (drop path) at a rate rising
linearly from 0 at the first block to `drop_path_rate` at the last.

With `remat` (whmr_tpu's `nn.remat` of each block, the memory knob of the
ViT-L/H presets) each block runs under `torch.utils.checkpoint` while
autograd records: its activations are recomputed in the backward instead of
stored. A block's two drop-path masks are drawn before the checkpointed call
and passed in, so the recompute reuses them (checkpoint's RNG-state
preservation does not cover an explicit `torch.Generator`) and the
generator's stream is the plain path's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from whmr_tpu_torch.config import ViTConfig
from whmr_tpu_torch.models.layers import MLP, Attention, Conv2d, LayerNorm, batch_rand


class DropPath(nn.Module):
    """Per-sample stochastic depth in training (vendored vit.py:47-58): keep
    a sample's branch with 1 - p and scale it by 1/(1 - p). The draws are
    fp32 uniforms from the given `torch.Generator` (a compute-dtype draw
    would quantize the keep probability); with a `data_group`, this rank's
    rows of the global batch's draw (`layers.batch_rand`)."""

    data_group = None

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def draw(self, x, generator=None):
        """The keep mask for a branch shaped like `x`, or None when the
        branch passes unchanged (eval, or p = 0)."""
        if not self.training or self.p == 0.0:
            return None
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return batch_rand(shape, generator, x.device, self.data_group) < 1.0 - self.p

    def apply(self, x, mask):
        return x if mask is None else x / (1.0 - self.p) * mask.to(x.dtype)

    def forward(self, x, generator=None):
        return self.apply(x, self.draw(x, generator))


class ViTBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, qkv_bias, drop_path=0.0, dtype=torch.float32,
                 attn_impl="einsum"):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype=dtype, impl=attn_impl)
        self.norm2 = LayerNorm(dim, 1e-6, dtype=dtype)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, dtype=dtype)
        self.drop_path = DropPath(drop_path)

    def draw_masks(self, x, generator=None):
        """The block's drop-path masks, attention's then the MLP's, in the
        order the plain forward draws them."""
        return self.drop_path.draw(x, generator), self.drop_path.draw(x, generator)

    def forward(self, x, generator=None, masks=None):
        m_attn, m_mlp = masks if masks is not None else self.draw_masks(x, generator)
        x = x + self.drop_path.apply(self.attn(self.norm1(x)), m_attn)
        return x + self.drop_path.apply(self.mlp(self.norm2(x)), m_mlp)


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
        self.remat = cfg.remat
        self.patch_embed = PatchEmbed(cfg, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, hp * wp + 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias,
                     drop_path=cfg.drop_path_rate * i / max(cfg.depth - 1, 1),
                     dtype=dtype, attn_impl=cfg.attn_impl)
            for i in range(cfg.depth)
        )
        self.last_norm = LayerNorm(cfg.embed_dim, 1e-6, dtype=dtype)

    def forward(self, x, generator=None):
        x = self.patch_embed(x)
        b, c, hp, wp = x.shape
        x = x.flatten(2).transpose(1, 2)  # (B, N, C)
        pos = self.pos_embed.to(self.compute_dtype)
        x = x + pos[:, 1:] + pos[:, :1]  # cls-slot folding (vit.py:317-320)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x = checkpoint(blk, x, None, blk.draw_masks(x, generator), use_reentrant=False)
            else:
                x = blk(x, generator)
        x = self.last_norm(x)
        return x.reshape(b, hp, wp, c).permute(0, 3, 1, 2)


class ViTFeatureExtractor(nn.Module):
    """The reference's pose_vit.py:8-14 wrapper: the ViT under `.backbone`, so
    keys read `feature_extractor.backbone.*` as in the published checkpoint."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32):
        super().__init__()
        self.backbone = ViTBackbone(cfg, dtype=dtype)

    def forward(self, x, generator=None):
        return self.backbone(x, generator)
