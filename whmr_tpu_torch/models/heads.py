"""Auxiliary heads (counterpart of `whmr_tpu/models/heads.py`).

- Tz head (reference whmr.py:404-430, :566-577): VALID conv stack to 5
  token maps, one bare timm Block (qkv_bias=False, LayerNorm eps 1e-5, einsum
  attention) over the 5 tokens, token mean, Linear -> Linear -> BatchNorm ->
  sigmoid, x10.
- IUV head (iuv_predictor.py:14-91) and depth head (depth_predictor.py:12-27):
  3x3 convs on the finest pyramid level. They take NCHW and return NHWC maps,
  the layout of whmr_tpu's `dp_out` / `dpth_out`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from whmr_tpu_torch.models.layers import BatchNorm1d, Conv2d, Linear, TransformerBlock


def tz_tokens(feat_h: int, feat_w: int, first_stride: int) -> int:
    """Token width of the Tz head for a (feat_h, feat_w) input map."""
    h1, w1 = (feat_h - 7) // first_stride + 1, (feat_w - 7) // first_stride + 1
    return ((h1 - 7) // 2 + 1) * ((w1 - 7) // 2 + 1)


def tz_head_forward(conv: nn.Module, decoder: nn.Module, est_tz: nn.Module, feat: torch.Tensor):
    """(B, C, H, W) -> (B,) body depth in (0, 10). Shared by `TzHead` and
    `WHMR`, which keeps the three parts under the reference's flat names."""
    x = conv(feat)
    x = x.reshape(x.shape[0], 5, -1)  # 5 tokens, one per channel (whmr.py:571)
    x = decoder(x).mean(dim=1)        # AvgPool1d(k=5) over the tokens (:575)
    return 10.0 * est_tz(x)[:, 0]


class TzHead(nn.Module):
    """Keys `conv.{0,1}`, `transformer_decoder.*`, `est_Tz.{0,1,2}`."""

    def __init__(self, in_ch: int, tokens: int, first_stride: int = 3, hidden: int = 12,
                 dtype=torch.float32):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(in_ch, 64, 7, stride=first_stride, bias=False, dtype=dtype),
            Conv2d(64, 5, 7, stride=2, bias=False, dtype=dtype),
        )
        self.transformer_decoder = TransformerBlock(
            tokens, num_heads=2, qkv_bias=False, ln_eps=1e-5, dtype=dtype
        )
        self.est_Tz = nn.Sequential(
            Linear(tokens, hidden, dtype=dtype),
            Linear(hidden, 1, dtype=dtype),
            BatchNorm1d(1, dtype=dtype),
            nn.Sigmoid(),
        )

    def forward(self, feat):
        return tz_head_forward(self.conv, self.transformer_decoder, self.est_Tz, feat)


class IUVHead(nn.Module):
    def __init__(self, in_ch: int, with_uv: bool = True, dtype=torch.float32):
        super().__init__()
        self.with_uv = with_uv
        if with_uv:
            self.predict_u = Conv2d(in_ch, 25, 3, padding=1, dtype=dtype)
            self.predict_v = Conv2d(in_ch, 25, 3, padding=1, dtype=dtype)
        self.predict_ann_index = Conv2d(in_ch, 15, 3, padding=1, dtype=dtype)
        self.predict_uv_index = Conv2d(in_ch, 25, 3, padding=1, dtype=dtype)

    def forward(self, feat) -> Dict[str, Optional[torch.Tensor]]:
        def nhwc(conv):
            return conv(feat).permute(0, 2, 3, 1)

        out: Dict[str, Optional[torch.Tensor]] = {
            "predict_uv_index": nhwc(self.predict_uv_index),
            "predict_ann_index": nhwc(self.predict_ann_index),
            "predict_u": None,
            "predict_v": None,
        }
        if self.with_uv:
            out["predict_u"] = nhwc(self.predict_u)
            out["predict_v"] = nhwc(self.predict_v)
        return out


class DepthHead(nn.Module):
    def __init__(self, in_ch: int, dtype=torch.float32):
        super().__init__()
        self.predict_depth = Conv2d(in_ch, 1, 3, padding=1, dtype=dtype)

    def forward(self, feat):
        return self.predict_depth(feat).permute(0, 2, 3, 1)
