"""Shared building blocks (counterpart of `whmr_tpu/models/layers.py`).

Dtype contract, as flax's `dtype`: parameters stay fp32 and every layer
computes in its compute dtype `dtype` (bf16 on the card). The primitives
below cast input, weight and bias to it at call time; LayerNorm and eval
BatchNorm normalise in fp32 and return the compute dtype, as flax does.

Convolutional modules take and return NCHW, PyTorch's habit; `WHMR.forward`
keeps whmr_tpu's NHWC at its boundary. Attribute names are the reference's
torch names (timm/mmpose ViT, torchvision ResNet), so `state_dict()` keys
match a published reference checkpoint.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from whmr_tpu_torch.ops.attention import attention


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    def __init__(self, in_features, out_features, bias=True, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), _cast(self.bias, dt), self.stride,
            self.padding, self.output_padding, self.groups, self.dilation,
        )


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim, eps, dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class _FP32BatchNorm:
    """Normalise in fp32 (running statistics in eval), return the compute dtype."""

    def forward(self, x):
        y = F.batch_norm(
            x.float(), self.running_mean, self.running_var, self.weight, self.bias,
            self.training, self.momentum, self.eps,
        )
        return y.to(self.compute_dtype)


class BatchNorm2d(_FP32BatchNorm, nn.BatchNorm2d):
    def __init__(self, features, dtype=torch.float32):
        nn.BatchNorm2d.__init__(self, features)
        self.compute_dtype = dtype


class BatchNorm1d(_FP32BatchNorm, nn.BatchNorm1d):
    def __init__(self, features, dtype=torch.float32):
        nn.BatchNorm1d.__init__(self, features)
        self.compute_dtype = dtype


class ConvBN(nn.Sequential):
    """Conv (no bias) -> BatchNorm -> optional ReLU; keys `0.*`, `1.*` (the
    torchvision `downsample` layout)."""

    def __init__(self, in_ch, features, kernel, stride=1, use_relu=True, dtype=torch.float32):
        layers = [
            Conv2d(in_ch, features, kernel, stride=stride, bias=False, dtype=dtype),
            BatchNorm2d(features, dtype=dtype),
        ]
        if use_relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class Bottleneck(nn.Module):
    """ResNet bottleneck with torchvision names. The stride-2 3x3 conv pads
    (1, 1), as whmr_tpu spells out (layers.py:68-79)."""

    def __init__(self, in_ch, planes, stride=1, downsample=False, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(planes, dtype=dtype)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(planes * 4, dtype=dtype)
        self.downsample = (
            ConvBN(in_ch, planes * 4, 1, stride=stride, use_relu=False, dtype=dtype)
            if downsample else None
        )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNetTrunk(nn.Module):
    """ResNet-50 trunk (stem + 4 stages) -> the stage-4 map, torchvision names."""

    def __init__(self, layers=(3, 4, 6, 3), dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype=dtype)
        in_ch = 64
        for stage, (n_blocks, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
            blocks = []
            for block in range(n_blocks):
                stride = 2 if (block == 0 and stage > 0) else 1
                blocks.append(Bottleneck(in_ch, planes, stride, downsample=(block == 0), dtype=dtype))
                in_ch = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x


class MLP(nn.Module):
    """Linear -> exact GELU -> Linear (keys fc1, fc2)."""

    def __init__(self, dim, hidden, out, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, out, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


# whmr_tpu's other Attention.impl names; each waits for its port (ROADMAP.md).
# "xla_dpa" would map onto a library attention kernel, which the port does
# not call.
UNPORTED_ATTN_IMPLS = ("split", "bf16sm", "bhnd", "bhnd_bf16sm", "xla_dpa")


class Attention(nn.Module):
    """Fused-qkv multi-head self-attention (keys qkv, proj).

    impl "einsum": whmr_tpu's default formulation in plain torch (q scaled in
    the compute dtype, fp32 softmax). impl "pallas": the hand-written CUDA
    kernel K1 (ops/attention.py), with whmr_tpu's kernel numerics.
    """

    def __init__(self, dim, num_heads, qkv_bias=True, dtype=torch.float32, impl="einsum"):
        super().__init__()
        if impl in UNPORTED_ATTN_IMPLS:
            raise ValueError(f"attention impl {impl!r} is not ported yet (see ROADMAP.md); use 'einsum' or 'pallas'")
        if impl not in ("einsum", "pallas"):
            raise ValueError(f"unknown attention impl {impl!r}")
        self.num_heads = num_heads
        self.impl = impl
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        b, n, c = x.shape
        head_dim = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, head_dim)
        if self.impl == "einsum":
            q, k, v = qkv.unbind(2)  # (B, N, H, D)
            attn = torch.einsum("bnhd,bmhd->bhnm", q * head_dim**-0.5, k)
            attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
        else:
            # One copy to (3, B, H, N, D) makes q, k and v each contiguous BHND.
            q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
            out = attention(q, k, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class TransformerBlock(nn.Module):
    """Pre-LN transformer block (timm Block names). Used bare by the Tz head,
    where LayerNorm eps is 1e-5 and attention is always einsum (layers.py:226)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=True, ln_eps=1e-6,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, ln_eps, dtype=dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype=dtype)
        self.norm2 = LayerNorm(dim, ln_eps, dtype=dtype)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class DeconvBlock(nn.Sequential):
    """ConvTranspose(k, s2) -> BatchNorm -> ReLU; keys `0.*`, `1.*`.

    Flax ConvTranspose(k, s2, "SAME") equals torch's with padding (k-2)/2 on
    spatially flipped taps (utils/convert.py does the flip).
    """

    def __init__(self, in_ch, features, kernel=4, use_bias=False, dtype=torch.float32):
        if kernel % 2:
            raise ValueError(f"DeconvBlock takes an even kernel, got {kernel}")
        super().__init__(
            ConvTranspose2d(in_ch, features, kernel, stride=2, padding=(kernel - 2) // 2,
                            bias=use_bias, dtype=dtype),
            BatchNorm2d(features, dtype=dtype),
            nn.ReLU(),
        )

