"""K1 and K3: fused multi-head self-attention, hand-written CUDA kernels for Hopper.

`attention` (K1) replaces `fused_attention_heads` of
whmr_tpu/ops/attention_pallas.py:79 (the Pallas kernel reached by
`vit.attn_impl="pallas"`); `fused_attention` (K3) replaces `fused_attention`
of attention_pallas.py:108, the same function with one program per batch row.
Both kernels are in `csrc/attention.cu`, whose comments state their bound on
an H100 and what each design does about it. `attention_reference` below is
the plain PyTorch version of exactly the same steps, for both: the CPU tests
use it, and chip_smoke.py holds each kernel against it on the card.

Each wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors; it never falls back from one to the other. Both are
forward-only: whmr_tpu defines no VJP for its kernels, and the backward here
raises rather than dropping gradients.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from whmr_tpu_torch.ops import cuda_build

# Per-block dynamic shared memory an H100 grants (232,448 bytes).
_MAX_SMEM = 232448
_MAX_D = 128
_DTYPES = (torch.float32, torch.bfloat16)

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("attention")
        lib.whmr_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.whmr_attention_fwd.restype = ctypes.c_int
        lib.whmr_attention_batch_fwd.argtypes = lib.whmr_attention_fwd.argtypes
        lib.whmr_attention_batch_fwd.restype = ctypes.c_int
        lib.whmr_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.whmr_attention_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _scale(d: int) -> float:
    # whmr_tpu multiplies fp32 q by 1/np.sqrt(d) rounded to fp32.
    return float(np.float32(1.0 / np.sqrt(d)))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: the steps of `_kernel_heads` (attention_pallas.py:61-76).

    q is widened to fp32 and scaled, QK^T and the max-subtracted softmax are
    fp32, P is rounded to the input dtype before P.V, P.V accumulates in fp32
    and the output is cast to the input dtype.
    """
    s = torch.matmul(q.float() * _scale(q.shape[-1]), k.float().transpose(-1, -2))
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"attention takes fp32 or bf16 q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention takes (B, H, N, D) q, k, v of one shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, n, d = q.shape
    if min(b, h, n) < 1 or not 1 <= d <= _MAX_D:
        raise ValueError(f"attention takes B, H, N >= 1 and 1 <= D <= {_MAX_D}, got {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention takes contiguous q, k, v")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, per_batch: bool = False) -> torch.Tensor:
    """K1, or K3 with `per_batch` (one block per batch row)."""
    b, h, n, d = q.shape
    lib = _kernel_lib()
    esize = q.element_size()
    smem = lib.whmr_attention_smem_bytes(n, d, esize, int(per_batch))
    if smem > _MAX_SMEM:
        raise ValueError(
            f"attention: N={n}, D={d} in {q.dtype} needs {smem} B of shared memory, "
            f"more than the {_MAX_SMEM} B a block may use"
        )
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fwd = lib.whmr_attention_batch_fwd if per_batch else lib.whmr_attention_fwd
        err = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, n, d, _scale(d), int(q.dtype == torch.bfloat16), stream,
        )
    name = "fused_attention (K3)" if per_batch else "attention (K1)"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    if per_batch:
        fused_attention.launches += 1
    else:
        attention.launches += 1
    return o


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, per_batch):
        ctx.per_batch = per_batch
        if q.device.type == "cuda":
            return _launch(q, k, v, per_batch)
        if q.device.type == "cpu":
            return attention_reference(q, k, v)
        raise ValueError(f"attention runs on cuda or cpu tensors, got {q.device}")

    @staticmethod
    def backward(ctx, grad):
        name = "fused_attention (K3)" if ctx.per_batch else "attention (K1)"
        raise NotImplementedError(
            f"{name} is forward-only: whmr_tpu defines no VJP for its Pallas kernel, "
            'and its train step runs vit.attn_impl="einsum"'
        )


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax((q/sqrt(D)) k^T) v over (B, H, N, D) tensors, in their dtype.

    CUDA tensors go through the hand-written kernel (counted in
    `attention.launches`); CPU tensors through `attention_reference`.
    """
    _check(q, k, v)
    return _Attention.apply(q, k, v, False)


attention.launches = 0


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K3: the same function as `attention`, with the TPU kernel's launch
    shape of one block per batch row looping over the H heads.

    CUDA tensors go through K3 (counted in `fused_attention.launches`); CPU
    tensors through `attention_reference`, which is K3's plain version too,
    since K3 computes K1's function with K1's numerics step for step.
    """
    _check(q, k, v)
    return _Attention.apply(q, k, v, True)


fused_attention.launches = 0
