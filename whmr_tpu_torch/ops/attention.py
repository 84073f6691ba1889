"""K1 and K3: fused multi-head self-attention, hand-written CUDA kernels for Hopper.

`attention` (K1) replaces `fused_attention_heads` of
whmr_tpu/ops/attention_pallas.py:79 (the Pallas kernel reached by
`vit.attn_impl="pallas"`); `fused_attention` (K3) replaces `fused_attention`
of attention_pallas.py:108, the same function with one program per batch row.
Both kernels are in `csrc/attention.cu`, whose comments state their bound on
an H100 and what each design does about it. `attention_reference` below is
the plain PyTorch version of exactly the same steps, for both: the CPU tests
use it, and chip_smoke.py holds each kernel against it on the card.

Each kernel has two variants, which the wrappers choose by dtype and shape
only (`_variant`): "mma", on tensor cores, and "rows", the CUDA-core row
kernels. "mma" takes bf16 with N <= 256 and D a multiple of 8 (TMA reads
16-byte rows), and fp32 with N <= 192 and D a multiple of 4; in fp32 it
computes each product in 3xTF32 (every operand split into two TF32 parts,
three products accumulated in fp32), which keeps about 21 mantissa bits
and the 2e-5 contract that one TF32 product would not: by wgmma for D <=
64, by mma.sync above. "rows" takes every other shape. Both variants
compute the same function with the same numerics contract and the same
plain version.

Each wrapper launches its kernel for CUDA tensors and takes the plain version
only for CPU tensors; it never falls back from one to the other, nor from one
variant to the other. Both are forward-only: whmr_tpu defines no VJP for its
kernels, and the backward here raises rather than dropping gradients.

`attention_qkv` is K1 on a ViT block's fused projection: it takes the
(B, N, 3, H, D) qkv tensor as the projection writes it and returns (B, N,
H, D), token-major, as `proj` reads it. In bf16 on tensor cores it stages q,
k and v straight from the projection and stores O token-major, through 4-D
tensor maps over each tensor's own strides (csrc/attention.cu, "Packed
staging"): the same staged values as `attention` on contiguous copies, so
the same output bits, without the two layout copies around the kernel
(counted in `k1.packed_launches` besides `k1.launches`). Every other case
(fp32, the CUDA-core variant) makes the contiguous (B, H, N, D) copies
those variants read, by the same rule of dtype and shape as `_variant`.

K1 is also the operators `torch.ops.whmr.attention` (`attention_op`) and
`torch.ops.whmr.attention_qkv` (`attention_qkv_op`), `torch.library.custom_op`s
that `attention` and `attention_qkv` call while a trace runs (`torch.export`,
`torch.compile`): the trace keeps K1 in a serving program as one node,
where it could trace neither the ctypes launch nor an autograd.Function.
Eager calls launch through the wrapper directly, without the dispatcher's
host cost. The variant follows from N, D and the dtype, never from the
batch, so a program with a symbolic batch stays symbolic.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from whmr_tpu_torch.ops import cuda_build
from whmr_tpu_torch.utils import profiling

# Per-block dynamic shared memory an H100 grants (232,448 bytes).
_MAX_SMEM = 232448
_MAX_D = 128
_MMA_MAX_N = 256
_F32_MMA_MAX_N = 192
_MMA_ROWS = 64  # K1's query rows a block in the "mma" variant (kMmaRows)
_DTYPES = (torch.float32, torch.bfloat16)

_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("attention")
        lib.whmr_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.whmr_attention_fwd.restype = ctypes.c_int
        lib.whmr_attention_batch_fwd.argtypes = lib.whmr_attention_fwd.argtypes
        lib.whmr_attention_batch_fwd.restype = ctypes.c_int
        lib.whmr_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.whmr_attention_smem_bytes.restype = ctypes.c_size_t
        lib.whmr_attention_qkv_fwd.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        lib.whmr_attention_qkv_fwd.restype = ctypes.c_int
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


def _padded_keys(n: int) -> int:
    """The key count the "mma" kernels are instantiated for (`padded_keys`)."""
    return 64 if n <= 64 else 128 if n <= 128 else 192 if n <= 192 else 256


def _variant(shape, dtype: torch.dtype) -> str:
    """The kernel variant for (B, H, N, D) inputs of `dtype`: "mma" (tensor
    cores) for bf16 at N <= 256 with D % 8 == 0 and for fp32 (3xTF32) at N
    <= 192 with D % 4 == 0, else "rows" (CUDA cores). Shape and dtype alone
    decide; nothing at run time switches variants."""
    n, d = shape[2], shape[3]
    if dtype == torch.bfloat16:
        mma = n <= _MMA_MAX_N and d % 8 == 0
    else:
        mma = n <= _F32_MMA_MAX_N and d % 4 == 0
    return "mma" if mma else "rows"


def _smem_bytes(shape, dtype: torch.dtype, per_batch: bool, variant: str | None = None) -> int:
    """Dynamic shared memory of one block of K1 (or K3 with `per_batch`) in
    `variant` (by default the one `_variant` picks); csrc/attention.cu's
    `whmr_attention_smem_bytes` gives the same figures.

    "mma" in bf16: 128-byte rows, one set per 64 columns of D, plus 1024
    bytes to align the swizzled layout (csrc/attention.cu). K1 holds its 64
    query rows, and K and V with N padded to the kernel's key count (64,
    128, 192 or 256); K3 holds Q, K and V of one (b, h) item with that many
    rows, and two such items when they fit in a block (it loads the next
    while the current one computes). "mma" in fp32 at D <= 64 (wgmma): K and
    V^T of one head, each split into two TF32 parts, padded_keys(N) x 64
    floats a part, plus 1024 bytes of alignment, for K1 and for K3. At 64 <
    D <= 128 (mma.sync): K and V of one head, padded_keys(N) rows of 132
    floats, for K1, and for K3 two such stages when they fit.
    "rows": K with rows padded to an odd number of 32-bit words and V in
    the input dtype, and an fp32 score row (N) and query row (D) for each of
    the block's warps (8 for K1, 16 for K3).
    """
    n, d = shape[2], shape[3]
    variant = variant or _variant(shape, dtype)
    if variant == "mma" and dtype == torch.float32:
        if d <= 64:
            return 4 * _padded_keys(n) * 64 * 4 + 1024
        item = 2 * _padded_keys(n) * 132 * 4
        return 2 * item if per_batch and 2 * item <= _MAX_SMEM else item
    if variant == "mma":
        nkp = _padded_keys(n)
        row = 128 * -(-d // 64)
        if not per_batch:
            return (_MMA_ROWS + 2 * nkp) * row + 1024
        item = 3 * nkp * row
        return (2 * item if 2 * item + 1024 <= _MAX_SMEM else item) + 1024
    esize = torch.finfo(dtype).bits // 8
    if esize == 4:
        ks = d if d % 2 else d + 1
    else:
        even = d + d % 2
        ks = even if (even // 2) % 2 else even + 2
    kv = n * (ks + d) * esize
    kv = (kv + 15) // 16 * 16
    return kv + (16 if per_batch else 8) * (n + d) * 4


def _check_sizes(b, h, n, d, shape) -> None:
    # Each size on its own: `min()` over a symbolic batch (torch.export)
    # would guard the batch against the head count.
    if b < 1 or h < 1 or n < 1 or not 1 <= d <= _MAX_D:
        raise ValueError(f"attention takes B, H, N >= 1 and 1 <= D <= {_MAX_D}, got {tuple(shape)}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"attention takes fp32 or bf16 q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attention takes (B, H, N, D) q, k, v of one shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _check_sizes(*q.shape, q.shape)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention takes contiguous q, k, v")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, per_batch: bool = False,
            variant: str | None = None) -> torch.Tensor:
    """K1, or K3 with `per_batch`, in `variant` (by default `_variant`'s
    choice; chip_smoke.py names "rows" to time the CUDA-core kernel at a
    shape beside the tensor-core one)."""
    b, h, n, d = q.shape
    variant = variant or _variant(q.shape, q.dtype)
    lib = _kernel_lib()
    smem = _smem_bytes(q.shape, q.dtype, per_batch, variant)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"attention: N={n}, D={d} in {q.dtype} needs {smem} B of shared memory, "
            f"more than the {_MAX_SMEM} B a block may use"
        )
    if variant == "mma":
        # The tensor-core kernels read 16-byte rows from 16-byte boundaries
        # (TMA, cp.async, float4 loads); a contiguous view off one (an offset
        # into a larger tensor) is copied, with the same result.
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fwd = lib.whmr_attention_batch_fwd if per_batch else lib.whmr_attention_fwd
        err = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, n, d, _scale(d), int(q.dtype == torch.bfloat16), int(variant == "mma"), stream,
        )
    name = "fused_attention (K3)" if per_batch else "attention (K1)"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed ({variant} variant): cudaError {err}")
    launches, mma_launches = ("k3.launches", "k3.mma_launches") if per_batch else ("k1.launches", "k1.mma_launches")
    profiling.count(launches)
    if variant == "mma":
        profiling.count(mma_launches)
    return o


def _packed(qkv: torch.Tensor) -> bool:
    """Whether K1 reads this (B, N, 3, H, D) projection in place: bf16 on
    tensor cores, by `_variant`'s rule. fp32 and the CUDA-core variant read
    contiguous (B, H, N, D) copies."""
    b, n, _, h, d = qkv.shape
    return qkv.dtype == torch.bfloat16 and _variant((b, h, n, d), qkv.dtype) == "mma"


def _launch_qkv(qkv: torch.Tensor) -> torch.Tensor:
    """K1 on the (B, N, 3, H, D) projection, returning (B, N, H, D)."""
    b, n, _, h, d = qkv.shape
    if not _packed(qkv):
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        return _launch(q, k, v).transpose(1, 2).contiguous()
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        # TMA reads 16-byte rows from 16-byte boundaries at the projection's
        # strides: one copy makes it so, with the same result.
        qkv = qkv.clone(memory_format=torch.contiguous_format)
    o = qkv.new_empty((b, n, h, d))
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = _kernel_lib().whmr_attention_qkv_fwd(qkv.data_ptr(), o.data_ptr(), b, h, n, d, _scale(d), stream)
    if err != 0:
        raise RuntimeError(f"attention_qkv (K1) kernel launch failed (mma variant): cudaError {err}")
    profiling.count("k1.launches")
    profiling.count("k1.mma_launches")
    profiling.count("k1.packed_launches")
    return o


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, per_batch: bool) -> torch.Tensor:
    if q.device.type == "cuda":
        return _launch(q, k, v, per_batch)
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    raise ValueError(f"attention runs on cuda or cpu tensors, got {q.device}")


def _forward_qkv(qkv: torch.Tensor) -> torch.Tensor:
    if qkv.device.type == "cuda":
        return _launch_qkv(qkv)
    if qkv.device.type == "cpu":
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        return attention_reference(q, k, v).transpose(1, 2).contiguous()
    raise ValueError(f"attention runs on cuda or cpu tensors, got {qkv.device}")


class _ForwardOnly(torch.autograd.Function):
    """Runs `fn(*args)`; its backward raises rather than dropping
    gradients."""

    @staticmethod
    def forward(ctx, name, fn, *args):
        ctx.name = name
        return fn(*args)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            f"{ctx.name} is forward-only: whmr_tpu defines no VJP for its Pallas kernel, "
            'and its train step runs vit.attn_impl="einsum"'
        )


@torch.library.custom_op("whmr::attention", mutates_args=())
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K1 as the operator `torch.ops.whmr.attention`, so that `torch.export`
    keeps it in an exported graph as one node (it cannot trace the ctypes
    launch). Importing this module registers it; a program that holds it is
    loaded after that import (`inference/export.py::load_exported`). Its
    body is the wrapper's: K1 on CUDA tensors, counted, and the plain
    version on CPU tensors."""
    return _forward(q, k, v, False)


@attention_op.register_fake
def _attention_fake(q, k, v):
    return torch.empty_like(q)


@torch.library.custom_op("whmr::attention_qkv", mutates_args=())
def attention_qkv_op(qkv: torch.Tensor) -> torch.Tensor:
    """K1 on the fused projection as the operator
    `torch.ops.whmr.attention_qkv`, kept by a trace as one node, like
    `attention_op` (which stays registered for the programs that hold it)."""
    return _forward_qkv(qkv)


@attention_qkv_op.register_fake
def _attention_qkv_fake(qkv):
    b, n, _, h, d = qkv.shape
    return qkv.new_empty((b, n, h, d))


def _apply(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, per_batch: bool) -> torch.Tensor:
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        name = "fused_attention (K3)" if per_batch else "attention (K1)"
        return _ForwardOnly.apply(name, _forward, q, k, v, per_batch)  # its backward raises
    if not per_batch and torch.compiler.is_compiling():
        return attention_op(q, k, v)  # a trace records K1 as one node
    # No graph to build: skip autograd's and the dispatcher's per-call cost.
    return _forward(q, k, v, per_batch)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax((q/sqrt(D)) k^T) v over (B, H, N, D) tensors, in their dtype.

    CUDA tensors go through the hand-written kernel (counted in the
    tracer's `k1.launches`, and its tensor-core launches, the "mma" variant
    in either dtype, also in `k1.mma_launches`); CPU tensors through
    `attention_reference`. The variant follows from dtype and shape alone
    (`_variant`).
    """
    return _apply(q, k, v, False)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K3: the same function as `attention`, with the TPU kernel's launch
    shape of one block per batch row looping over the H heads.

    CUDA tensors go through K3 (counted in the tracer's `k3.launches`, its
    tensor-core launches also in `k3.mma_launches`), in the
    variant `_variant` picks from dtype and shape; CPU tensors through
    `attention_reference`, which is K3's plain version too, since K3 runs
    K1's device routines: on the card its output equals K1's bit for bit.
    """
    return _apply(q, k, v, True)


def attention_qkv(qkv: torch.Tensor) -> torch.Tensor:
    """`attention` over a fused projection: qkv (B, N, 3, H, D), q, k and v
    along dim 2, as a ViT block's `qkv` Linear writes them; returns
    softmax((q/sqrt(D)) k^T) v as (B, N, H, D), token-major.

    CUDA tensors go through K1, in bf16 on tensor cores read in place
    (counted in `k1.packed_launches` besides `k1.launches` and
    `k1.mma_launches`), otherwise on contiguous (B, H, N, D) copies in the
    variant `_variant` picks; CPU tensors through `attention_reference` on
    the projection's (B, H, N, D) views. The output equals `attention` on
    contiguous copies of q, k and v, transposed, bit for bit on the card.
    """
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"attention_qkv takes fp32 or bf16 qkv, got {qkv.dtype}")
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"attention_qkv takes a (B, N, 3, H, D) qkv, got {tuple(qkv.shape)}")
    b, n, _, h, d = qkv.shape
    _check_sizes(b, h, n, d, qkv.shape)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _ForwardOnly.apply("attention_qkv (K1)", _forward_qkv, qkv)  # its backward raises
    if torch.compiler.is_compiling():
        return attention_qkv_op(qkv)  # a trace records K1 as one node
    return _forward_qkv(qkv)
