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
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn as nn
import torch.nn.functional as F

from whmr_tpu_torch.ops.attention import attention_qkv


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


def batch_rand(shape, generator, device, group=None) -> torch.Tensor:
    """fp32 uniforms of `shape`, dim 0 the batch. With a data `group`, this
    rank's rows of the draw for the global batch (the group's ranks hold
    equal shares, in rank order), so one rank and R ranks draw the same
    masks from the same generator state, as whmr_tpu's global draw does."""
    if group is None:
        return torch.rand(shape, generator=generator, device=device)
    rank, ranks = dist.get_rank(group), dist.get_world_size(group)
    b = shape[0]
    full = torch.rand((b * ranks, *shape[1:]), generator=generator, device=device)
    return full[rank * b:(rank + 1) * b]


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
        y = F.layer_norm(x.to(torch.promote_types(x.dtype, torch.float32)), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


# flax's BatchNorm momentum: running = 0.9 * running + 0.1 * batch statistic.
BN_MOMENTUM = 0.9


class _FP32BatchNorm:
    """Normalise in fp32, return the compute dtype.

    Eval normalises with the running statistics. Training normalises with
    the batch's mean and BIASED variance, computed as flax does (fp32,
    E[x^2] - E[x]^2 clipped at 0), and updates the running statistics with
    them at flax's momentum. `F.batch_norm(training=True)` is not used: it
    updates the running variance with the unbiased variance, which would
    drift from whmr_tpu's by n/(n-1).

    With a `data_group` (`parallel.shard_params`), training takes the mean
    and E[x^2] over the group's global batch: one differentiable all_reduce
    sums each rank's pair weighted by 1/R (the ranks hold equal shares), so
    every rank normalises with, and moves its running statistics by, the
    global batch's statistics (whmr_tpu's "a mean over the sharded batch
    axis IS a global mean"). At one rank the weights are 1 and the numbers
    are those without a group, bit for bit. nn.SyncBatchNorm is not used:
    it refuses CPU tensors.
    """

    data_group = None

    def forward(self, x):
        # at least fp32: a float64 model (a test's) keeps float64
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            y = F.batch_norm(
                xf, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            )
            return y.to(self.compute_dtype)
        dims = [0] + list(range(2, x.dim()))
        mean = xf.mean(dims)
        mean_sq = (xf * xf).mean(dims)
        if self.data_group is not None:
            stats = torch.cat([mean, mean_sq]) * (1.0 / dist.get_world_size(self.data_group))
            mean, mean_sq = dist_nn.all_reduce(stats, group=self.data_group).chunk(2)
        var = (mean_sq - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
            self.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
        shape = [1, -1] + [1] * (x.dim() - 2)
        y = (xf - mean.view(shape)) * (torch.rsqrt(var + self.eps) * self.weight).view(shape)
        return (y + self.bias.view(shape)).to(self.compute_dtype)


class BatchNorm2d(_FP32BatchNorm, nn.BatchNorm2d):
    def __init__(self, features, dtype=torch.float32):
        nn.BatchNorm2d.__init__(self, features)
        self.compute_dtype = dtype


class BatchNorm1d(_FP32BatchNorm, nn.BatchNorm1d):
    def __init__(self, features, dtype=torch.float32):
        nn.BatchNorm1d.__init__(self, features)
        self.compute_dtype = dtype


class Dropout(nn.Module):
    """Element dropout in training (flax `nn.Dropout`): keep with 1 - p,
    scale kept values by 1/(1 - p). The keep draws are fp32 uniforms from
    the given `torch.Generator` (nn.Dropout takes none), so a bf16 and an
    fp32 model with the same generator state drop the same elements; with a
    `data_group`, this rank's rows of the global batch's draw
    (`batch_rand`)."""

    data_group = None

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generator=None):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = batch_rand(x.shape, generator, x.device, self.data_group) < keep
        return torch.where(mask, x / keep, 0.0)


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


# whmr_tpu's Attention.impl names (layers.py:140-198), each resolved to the
# body that computes it here. whmr_tpu's "split" and "bhnd" variants only
# change the layout XLA sees on the TPU (layers.py:150-151); in PyTorch they
# are the same ops as "einsum" and "bf16sm". "pallas" is the hand-written
# kernel K1. The formulations are held against whmr_tpu's in
# tests/test_torch_attention.py.
ATTN_BODIES = {
    "einsum": "fp32_softmax", "split": "fp32_softmax", "bhnd": "fp32_softmax",
    "bf16sm": "dtype_softmax", "bhnd_bf16sm": "dtype_softmax",
    "xla_dpa": "sdpa", "pallas": "pallas",
}


class Attention(nn.Module):
    """Fused-qkv multi-head self-attention (keys qkv, proj).

    `impl` names whmr_tpu's formulation; it runs one of four bodies
    (`ATTN_BODIES`):
    - "fp32_softmax" ("einsum", whmr_tpu's default; "split", "bhnd"):
      scores from the (B, N, H, D) qkv slices, q scaled in the compute
      dtype, fp32 softmax.
    - "dtype_softmax" ("bf16sm", "bhnd_bf16sm"): the softmax in the compute
      dtype.
    - "sdpa" ("xla_dpa"): whmr_tpu's `jax.nn.dot_product_attention`, an XLA
      composition and not a TPU kernel; here its PyTorch counterpart
      `scaled_dot_product_attention`.
    - "pallas": the hand-written CUDA kernel K1 (ops/attention.py), with
      whmr_tpu's kernel numerics, on the fused projection
      (`attention_qkv`).

    Under tensor parallelism (`parallel.shard_params`) `qkv` yields this
    rank's [q_r | k_r | v_r] columns, so the forward runs on the local heads
    (the width it is given over `head_dim`) and the row-parallel `proj`
    sums over the model group.
    """

    def __init__(self, dim, num_heads, qkv_bias=True, dtype=torch.float32, impl="einsum"):
        super().__init__()
        if impl not in ATTN_BODIES:
            raise ValueError(f"unknown attention impl {impl!r}; one of {tuple(ATTN_BODIES)}")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.impl = impl
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        b, n, _ = x.shape
        head_dim = self.head_dim
        qkv = self.qkv(x)
        heads = qkv.shape[-1] // (3 * head_dim)  # num_heads, or the local heads under TP
        c = heads * head_dim
        qkv = qkv.reshape(b, n, 3, heads, head_dim)
        body = ATTN_BODIES[self.impl]
        if body == "pallas":
            # (B, N, H, D): in bf16 K1 reads q, k and v in place and writes
            # token-major, so the reshape for `proj` copies nothing.
            out = attention_qkv(qkv)
        elif body == "sdpa":
            q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
            out = F.scaled_dot_product_attention(q, k, v).transpose(1, 2)
        else:
            q, k, v = qkv.unbind(2)  # (B, N, H, D)
            attn = torch.einsum("bnhd,bmhd->bhnm", q * head_dim**-0.5, k)
            attn = torch.softmax(attn if body == "dtype_softmax" else attn.float(), dim=-1).to(x.dtype)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        return self.proj(out.reshape(b, n, c))


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

