"""K1 and K3 (whmr_tpu_torch.ops.attention) against whmr_tpu's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
`fused_attention_heads` (K1) or `fused_attention` (K3) in interpret mode, as
whmr_tpu's own tests do. The CUDA kernels themselves are held against the
plain version on a card by tests/test_torch_kernels_cuda.py and
chip_smoke.py.
"""

import sys
import threading
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whmr_tpu.models import layers as jlayers
from whmr_tpu.ops.attention_pallas import fused_attention, fused_attention_heads
from whmr_tpu_torch.models import layers as tlayers
from whmr_tpu_torch.ops import attention as tattn
from whmr_tpu_torch.ops import cuda_build
from whmr_tpu_torch.utils import profiling
from whmr_tpu_torch.utils.convert import linear_from_flax

from torch_port_util import release_memory, n, t  # noqa: F401 (autouse fixture)

# ViT-B's head width, a narrow one, and ViT-H's 80 (not a power of two).
SHAPES = [(2, 4, 192, 64), (2, 4, 64, 32), (2, 4, 192, 80)]


def _qkv(shape, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_fp32(shape):
    q, k, v = _qkv(shape)
    want = fused_attention_heads(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = tattn.attention(t(q), t(k), t(v))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(n(got), n(want), atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_bf16(shape):
    # Both sides round P and the output to bf16; the fp32 sums differ only
    # in order, which can flip a rounding of P or of the output: one bf16
    # ulp at |o| < 2 is 2**-7.
    q, k, v = (x.astype(jnp.bfloat16) for x in map(jnp.asarray, _qkv(shape, 1)))
    want = fused_attention_heads(q, k, v, interpret=True)
    got = tattn.attention(*(t(np.asarray(x, np.float32), torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got), n(want), atol=2 ** -7)
    assert np.mean(n(got) == n(want)) > 0.99


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_attention_plain_matches_pallas(shape, dtype):
    """K3 on the CPU against whmr_tpu's `fused_attention(interpret=True)`, at
    K1's tolerances: fp32 2e-5; bf16 one ulp (2**-7 at |o| < 2), with 99 %
    of the outputs equal."""
    q, k, v = map(jnp.asarray, _qkv(shape, 2))
    if dtype == "bf16":
        q, k, v = (x.astype(jnp.bfloat16) for x in (q, k, v))
    want = fused_attention(q, k, v, interpret=True)
    tdtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    got = tattn.fused_attention(*(t(np.asarray(x, np.float32), tdtype) for x in (q, k, v)))
    assert got.dtype == tdtype and got.shape == shape
    if dtype == "fp32":
        np.testing.assert_allclose(n(got), n(want), atol=2e-5)
    else:
        np.testing.assert_allclose(n(got), n(want), atol=2 ** -7)
        assert np.mean(n(got) == n(want)) > 0.99
    with pytest.raises(ValueError):
        tattn.fused_attention(got[0], got[0], got[0])


def test_wrapper_checks_and_forward_only():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    out = tattn.attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()
    with pytest.raises(TypeError):
        tattn.attention(q.detach().half(), q.detach().half(), q.detach().half())
    with pytest.raises(ValueError):
        tattn.attention(q.detach()[0], q.detach()[0], q.detach()[0])
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.randn(1, 8, 2, 16).transpose(1, 2)
        tattn.attention(x, x, x)
    with pytest.raises(ValueError):
        x = torch.randn(1, 2, 8, 130)
        tattn.attention(x, x, x)
    before = profiling.counter("k1.launches")
    tattn.attention(q.detach(), q.detach(), q.detach())
    assert profiling.counter("k1.launches") == before  # the CPU path launches no kernel
    out = tattn.fused_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="fused_attention .K3. is forward-only"):
        out.sum().backward()
    assert profiling.counter("k3.launches") == 0


def _packed_qkv(shape, seed, dtype=torch.float32):
    """A (B, N, 3, H, D) projection holding `_qkv(shape, seed)`'s q, k and v."""
    return torch.stack([t(x) for x in _qkv(shape, seed)], 0).permute(1, 3, 0, 2, 4).contiguous().to(dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_qkv_plain_matches_reference_and_pallas(shape, dtype):
    """`attention_qkv` on the CPU is `attention_reference` on the
    projection's (B, H, N, D) views, transposed to (B, N, H, D), bit for
    bit; it equals `attention` on contiguous copies and holds whmr_tpu's
    `fused_attention_heads(interpret=True)` at K1's tolerances."""
    tdtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    qkv = _packed_qkv(shape, 4, tdtype)
    got = tattn.attention_qkv(qkv)
    b, h, n_, d = shape
    assert got.shape == (b, n_, h, d) and got.dtype == tdtype and got.is_contiguous()
    views = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    assert torch.equal(got, tattn.attention_reference(*views).transpose(1, 2))
    copies = [x.contiguous() for x in views]
    assert torch.equal(got, tattn.attention(*copies).transpose(1, 2))
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    want = n(fused_attention_heads(*(jnp.asarray(n(x)).astype(jdt) for x in copies), interpret=True))
    want = np.swapaxes(want, 1, 2)
    if dtype == "fp32":
        np.testing.assert_allclose(n(got), want, atol=2e-5)
    else:
        np.testing.assert_allclose(n(got), want, atol=2 ** -7)
        assert np.mean(n(got) == want) > 0.99


@pytest.mark.parametrize("shape, dtype, packed", [
    # bf16 on tensor cores (N <= 256, D % 8 == 0): read in place. The infer
    # cells' heads, the serving batch, a tensor-parallel rank's 8 heads,
    # ragged N and D = 32.
    ((192, 16, 192, 64), torch.bfloat16, True), ((192, 12, 192, 64), torch.bfloat16, True),
    ((8, 8, 192, 64), torch.bfloat16, True), ((4, 4, 130, 32), torch.bfloat16, True),
    ((2, 3, 256, 128), torch.bfloat16, True),
    # fp32 (3xTF32 or CUDA cores alike) and bf16 past the tensor-core
    # range: contiguous (B, H, N, D) copies.
    ((192, 12, 192, 64), torch.float32, False), ((2, 3, 100, 68), torch.float32, False),
    ((2, 3, 257, 64), torch.bfloat16, False), ((2, 3, 50, 20), torch.bfloat16, False),
])
def test_attention_qkv_adapts_by_dtype_and_shape(shape, dtype, packed, monkeypatch):
    """Whether K1 reads the projection in place follows from dtype and
    shape alone, by `_variant`'s rule: bf16 on tensor cores is packed; every
    other case hands `_launch` contiguous (B, H, N, D) copies (here a stand-in
    recording what it is given, since this host has no card)."""
    b, h, n_, d = shape
    qkv = torch.empty(b, n_, 3, h, d, dtype=dtype, device="meta")
    assert tattn._packed(qkv) == packed
    assert packed == (dtype == torch.bfloat16 and tattn._variant(shape, dtype) == "mma")
    if packed:
        return
    seen = []

    def launch(q, k, v, per_batch=False, variant=None):
        seen.append((q.shape, q.is_contiguous(), k.is_contiguous(), v.is_contiguous(), per_batch))
        return tattn.attention_reference(q, k, v)

    monkeypatch.setattr(tattn, "_launch", launch)
    qkv = _packed_qkv((2, h, n_, d), 5, dtype)
    got = tattn._launch_qkv(qkv)
    assert seen == [((2, h, n_, d), True, True, True, False)]
    assert got.shape == (2, n_, h, d) and got.is_contiguous()
    assert torch.equal(got, tattn.attention_qkv(qkv))


def test_attention_qkv_checks_and_forward_only():
    qkv = torch.randn(1, 8, 3, 2, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="attention_qkv .K1. is forward-only"):
        tattn.attention_qkv(qkv).sum().backward()
    with pytest.raises(TypeError):
        tattn.attention_qkv(qkv.detach().half())
    with pytest.raises(ValueError, match="B, N, 3, H, D"):
        tattn.attention_qkv(qkv.detach()[:, :, :2])
    with pytest.raises(ValueError, match="B, N, 3, H, D"):
        tattn.attention_qkv(qkv.detach()[0])
    with pytest.raises(ValueError):
        tattn.attention_qkv(torch.randn(1, 8, 3, 2, 130))
    before = (profiling.counter("k1.launches"), profiling.counter("k1.packed_launches"))
    tattn.attention_qkv(qkv.detach())
    assert (profiling.counter("k1.launches"), profiling.counter("k1.packed_launches")) == before  # no kernel on the CPU


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_attention_module_matches_flax(impl):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 24, 64).astype(np.float32)
    flax_attn = jlayers.Attention(num_heads=4, impl=impl)
    variables = flax_attn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = flax_attn.apply(variables, jnp.asarray(x))

    port = tlayers.Attention(64, 4, impl=impl)
    p = variables["params"]
    port.load_state_dict({
        "qkv.weight": t(linear_from_flax(p["qkv"]["kernel"])),
        "qkv.bias": t(p["qkv"]["bias"]),
        "proj.weight": t(linear_from_flax(p["proj"]["kernel"])),
        "proj.bias": t(p["proj"]["bias"]),
    })
    with torch.no_grad():
        got = port(t(x))
    np.testing.assert_allclose(n(got), n(want), atol=2e-5)


# The five formulations are ported now: the cases keep the ids they had
# while they raised; each builds, and an unknown name still raises.
@pytest.mark.parametrize("impl", ["split", "bf16sm", "bhnd", "bhnd_bf16sm", "xla_dpa", "nope"])
def test_unported_impls_raise(impl):
    if impl == "nope":
        with pytest.raises(ValueError, match="unknown"):
            tlayers.Attention(64, 4, impl=impl)
    else:
        assert tlayers.Attention(64, 4, impl=impl).impl == impl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["split", "bf16sm", "bhnd", "bhnd_bf16sm", "xla_dpa"])
def test_attention_formulations_match_flax(impl, dtype):
    """whmr_tpu's other formulations (layers.py:167-196; "xla_dpa" is
    `jax.nn.dot_product_attention`, here `scaled_dot_product_attention`)
    in fp32 (atol 2e-5) and in bf16 on bf16 inputs (within one bf16 ulp of
    the output's largest element: the compute-dtype softmaxes and SDPA
    round in other places than XLA)."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 24, 64).astype(np.float32)
    flax_attn = jlayers.Attention(num_heads=4, impl=impl, dtype=jdt)
    variables = flax_attn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = n(flax_attn.apply(variables, jnp.asarray(x, jdt)))
    port = tlayers.Attention(64, 4, impl=impl, dtype=tdt)
    p = variables["params"]
    port.load_state_dict({
        "qkv.weight": t(linear_from_flax(p["qkv"]["kernel"])),
        "qkv.bias": t(p["qkv"]["bias"]),
        "proj.weight": t(linear_from_flax(p["proj"]["kernel"])),
        "proj.bias": t(p["proj"]["bias"]),
    })
    with torch.no_grad():
        got = port(t(x).to(tdt))
    assert got.dtype == tdt
    atol = 2e-5 if dtype == "float32" else 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(n(got), want, atol=atol, rtol=0)



@pytest.mark.parametrize("shape, dtype, variant, k1_smem, k3_smem", [
    # bf16 at N <= 256: tensor cores. 128-byte rows per 64 columns of D,
    # plus 1024 bytes of alignment: K1 stages its 64 query rows, and K and V
    # padded to the kernel's key count (64, 128, 192 or 256); K3 Q, K and V
    # of an item at that count, twice when two items fit in a block.
    ((48, 12, 192, 64), torch.bfloat16, "mma", (64 + 2 * 192) * 128 + 1024, 2 * 3 * 192 * 128 + 1024),
    ((2, 16, 192, 80), torch.bfloat16, "mma", (64 + 2 * 192) * 256 + 1024, 3 * 192 * 256 + 1024),
    ((2, 3, 200, 128), torch.bfloat16, "mma", (64 + 2 * 256) * 256 + 1024, 3 * 256 * 256 + 1024),
    ((1, 1, 1, 8), torch.bfloat16, "mma", (64 + 2 * 64) * 128 + 1024, 2 * 3 * 64 * 128 + 1024),
    ((3, 2, 63, 32), torch.bfloat16, "mma", (64 + 2 * 64) * 128 + 1024, 2 * 3 * 64 * 128 + 1024),
    # fp32 at N <= 192 with D % 4 == 0: tensor cores (3xTF32). D <= 64
    # (wgmma): K and V^T of a head split into two TF32 parts each,
    # padded_keys(N) x 64 floats a part, plus 1024 bytes of alignment, for K1
    # and K3. 64 < D <= 128 (mma.sync): K and V, padded_keys(N) rows of 132
    # floats; K3 twice when two fit. The forward's and whmr-eval's heads,
    # the edge D = 128 at N = 192, N = 1 and D = 4, D = 20, and D = 68.
    ((48, 12, 192, 64), torch.float32, "mma", 4 * 192 * 64 * 4 + 1024, 4 * 192 * 64 * 4 + 1024),
    ((32, 12, 192, 64), torch.float32, "mma", 4 * 192 * 64 * 4 + 1024, 4 * 192 * 64 * 4 + 1024),
    ((1, 1, 1, 4), torch.float32, "mma", 4 * 64 * 64 * 4 + 1024, 4 * 64 * 64 * 4 + 1024),
    ((3, 2, 50, 20), torch.float32, "mma", 4 * 64 * 64 * 4 + 1024, 4 * 64 * 64 * 4 + 1024),
    ((2, 4, 192, 128), torch.float32, "mma", 2 * 192 * 132 * 4, 2 * 192 * 132 * 4),
    ((2, 16, 192, 80), torch.float32, "mma", 2 * 192 * 132 * 4, 2 * 192 * 132 * 4),
    ((2, 3, 100, 68), torch.float32, "mma", 2 * 128 * 132 * 4, 2 * 128 * 132 * 4),
    ((1, 2, 64, 128), torch.float32, "mma", 2 * 64 * 132 * 4, 2 * 2 * 64 * 132 * 4),
    # bf16 above N = 256 or with D % 8 != 0 (TMA reads 16-byte rows), and
    # fp32 above N = 192 or with D % 4 != 0: CUDA cores. K (rows padded to an
    # odd number of words) and V, rounded up to 16 B, then an fp32 score and
    # query row a warp.
    ((1, 2, 257, 64), torch.bfloat16, "rows", 66832 + 8 * 321 * 4, 66832 + 16 * 321 * 4),
    ((2, 3, 50, 20), torch.bfloat16, "rows", 4208 + 8 * 70 * 4, 4208 + 16 * 70 * 4),
    ((1, 2, 257, 64), torch.float32, "rows", 132624 + 8 * 321 * 4, 132624 + 16 * 321 * 4),
    ((1, 1, 193, 64), torch.float32, "rows", 99600 + 8 * 257 * 4, 99600 + 16 * 257 * 4),
    ((2, 3, 64, 18), torch.float32, "rows", 64 * (19 + 18) * 4 + 8 * 82 * 4, 64 * (19 + 18) * 4 + 16 * 82 * 4),
    ((2, 4, 256, 96), torch.float32, "rows", 256 * (97 + 96) * 4 + 8 * 352 * 4,
     256 * (97 + 96) * 4 + 16 * 352 * 4),
    ((2, 4, 200, 128), torch.float32, "rows", 200 * (129 + 128) * 4 + 8 * 328 * 4,
     200 * (129 + 128) * 4 + 16 * 328 * 4),
])
def test_variant_choice_and_smem(shape, dtype, variant, k1_smem, k3_smem):
    """The wrappers pick the kernel variant from dtype and shape alone."""
    assert tattn._variant(shape, dtype) == variant
    assert tattn._smem_bytes(shape, dtype, False) == k1_smem
    assert tattn._smem_bytes(shape, dtype, True) == k3_smem
    assert max(k1_smem, k3_smem) <= tattn._MAX_SMEM


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """fp32 to the nearest TF32 value (10 mantissa bits), ties away from
    zero, as `cvt.rna.tf32.f32` rounds: add half of the 13 dropped bits to
    the magnitude, then drop them."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul_tf32(a: np.ndarray, b: np.ndarray, products: int) -> np.ndarray:
    """a @ b as the fp32 tensor-core kernels compute it, per k8 step (one
    mma.sync.m16n8k8) into an fp32 accumulator. products=3 is 3xTF32: each
    operand x split into big = RNA(x) and small = RNA(x - big), and a_small
    b_big + a_big b_small + a_big b_big, in that order; products=1 is one
    TF32 product, a_big b_big. The products of TF32 parts are exact in
    fp64; each mma's sum is rounded once into the accumulator. This models
    the operands' rounding only, not the tensor core's adder (whose
    alignment and rounding inside an mma are the hardware's)."""
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    a_small, b_small = _tf32_rna(a - a_big), _tf32_rna(b - b_big)  # x - big is exact in fp32
    terms = [(a_small, b_big), (a_big, b_small), (a_big, b_big)] if products == 3 else [(a_big, b_big)]
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            step = x[..., k0:k0 + 8].astype(np.float64) @ y[..., k0:k0 + 8, :].astype(np.float64)
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def _attention_tf32(q, k, v, products):
    """K1's fp32 tensor-core arithmetic in numpy: q scaled in fp32 before
    the split, S and P.V through `_matmul_tf32`, the max-subtracted softmax
    and its division in fp32."""
    qs = q * np.float32(tattn._scale(q.shape[-1]))
    s = _matmul_tf32(qs, np.swapaxes(k, -1, -2), products)
    e = np.exp(s - s.max(axis=-1, keepdims=True))
    p = e / e.sum(axis=-1, keepdims=True, dtype=np.float32)
    return _matmul_tf32(p, v, products)


@pytest.mark.parametrize("shape", [(1, 2, 192, 64), (1, 2, 192, 80), (3, 2, 63, 32), (3, 2, 50, 20),
                                   (1, 1, 129, 68), (1, 1, 192, 128)])
def test_3xtf32_arithmetic_matches_pallas_fp32(shape):
    """The fp32 tensor-core variant's arithmetic (3xTF32, modelled in numpy
    by `_matmul_tf32`) holds whmr_tpu's `fused_attention_heads(interpret=
    True)` within the fp32 contract of 2e-5, at the fp32 shapes chip_smoke.py
    runs the kernels at (the forward's and ViT-H's heads, a ragged one, D =
    20) and the range's edges, with a smaller batch; one TF32 product
    would not."""
    q, k, v = _qkv(shape, 3)
    want = n(fused_attention_heads(*map(jnp.asarray, (q, k, v)), interpret=True))
    got = _attention_tf32(q, k, v, products=3)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert tattn._variant(shape, torch.float32) == "mma"
    if shape[-1] >= 32:
        assert np.abs(_attention_tf32(q, k, v, products=1) - want).max() > 2e-5


def test_tf32_rounding_is_rna():
    """`_tf32_rna` rounds to 10 mantissa bits, to nearest, ties away from
    zero, and the split's small part holds what big drops."""
    ulp = 2.0 ** -10
    x = np.array([1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23, -(1 + ulp / 2), 1 + 3 * ulp / 2, 3.0], np.float32)
    np.testing.assert_array_equal(_tf32_rna(x), np.array([1 + ulp, 1, -(1 + ulp), 1 + 2 * ulp, 3.0], np.float32))
    y = np.random.RandomState(0).randn(1000).astype(np.float32)
    big = _tf32_rna(y)
    small = _tf32_rna(y - big)
    assert np.all(np.abs(y - big) <= np.abs(big) * ulp / 2)
    assert np.all(np.abs((big.astype(np.float64) + small) - y) <= np.abs(y) * 2.0 ** -21)


def _rn32(v: Fraction) -> Fraction:
    """v rounded to the nearest fp32 value, ties to even (normal range)."""
    if v == 0:
        return Fraction(0)
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    e += (Fraction(2) ** (e + 1) <= a) - (Fraction(2) ** e > a)
    scaled = a / Fraction(2) ** (e - 23)
    m = scaled.numerator // scaled.denominator
    rest = scaled - m
    m += rest > Fraction(1, 2) or (rest == Fraction(1, 2) and m % 2 == 1)
    return (1 if v > 0 else -1) * m * Fraction(2) ** (e - 23)


def test_kernel_division_is_correctly_rounded():
    """The tensor-core kernels divide e by the row sum l as RN(q + RN(e - q l)
    r) with r = RN(1 / l) and q = RN(e r) (two FMAs, csrc/attention.cu
    `div_rn`). In exact arithmetic that equals RN(e / l), the IEEE quotient
    the plain version takes, for every e in [0, 1] and l in [1, 256] whose
    quotient is 0 or normal: the kernel's P is the plain version's."""
    rng = np.random.RandomState(0)
    n = 6000
    e = np.exp2(-rng.uniform(0, 118, n)).astype(np.float32)
    l = rng.uniform(1, 256, n).astype(np.float32)
    # Divisors with all-ones mantissas, powers of two, e = 1 (the row max),
    # e just below 1, and e = 0 (a pad key).
    l[:300] = np.nextafter(np.float32(2.0) ** rng.randint(1, 9, 300), np.float32(0))
    l[300:400] = np.float32(2.0) ** rng.randint(0, 9, 100)
    e[400:500], e[500:600], e[600:620] = 1.0, np.nextafter(np.float32(1), np.float32(0)), 0.0
    for x, y in zip(e.tolist(), l.tolist()):
        x, y = Fraction(x), Fraction(y)
        r = _rn32(1 / y)
        q = _rn32(x * r)
        assert _rn32(q + _rn32(x - q * y) * r) == _rn32(x / y), (x, y)


def test_ptxas_report():
    text = """ptxas info    : Compiling entry function '_Z20attention_mma_kernelILi192EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z20attention_mma_kernelILi192EEvv
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6rows_kv' for 'sm_90a'
ptxas info    : Function properties for _Z6rows_kv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 400 bytes cmem[0]
"""
    assert cuda_build.ptxas_report(text) == {
        "_Z20attention_mma_kernelILi192EEvv": {"registers": 168, "spill_stores": 8, "spill_loads": 4},
        "_Z6rows_kv": {"registers": 32, "spill_stores": 0, "spill_loads": 0},
    }


def test_concurrent_first_use_builds_each_kernel_once(tmp_path, monkeypatch):
    """Eight threads reach a kernel's first use together (a server's request
    threads, its batching worker and a warm-up do): exactly one compile
    runs, and the library installed is whole. The compiler is a script that
    writes its -o file slowly, so no toolchain is needed."""
    calls = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> {calls}\n"
        'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then out="$2"; fi; shift; done\n'
        'for i in 1 2 3 4 5; do echo "part $i" >> "$out"; sleep 0.05; done\n'
    )
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    start, errors = threading.Barrier(8), []

    def first_use():
        start.wait()
        try:
            cuda_build.build_all(["attention"])
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=first_use) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert calls.read_text().count("run") == 1
    lib = cuda_build.library_path("attention")
    assert lib.parent == tmp_path / "build"
    assert lib.read_text() == "".join(f"part {i}\n" for i in range(1, 6))
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_custom_op_is_k1_and_export_keeps_it():
    """`torch.ops.whmr.attention` and `torch.ops.whmr.attention_qkv` are K1's
    wrappers (on CPU tensors the plain version); eager calls of `attention`
    and `attention_qkv` launch without them, and torch.export keeps each as
    one node a call, with the batch symbolic: the variant depends on N and
    D alone."""
    q, k, v = (t(a) for a in _qkv((3, 2, 16, 8)))
    assert torch.equal(torch.ops.whmr.attention(q, k, v), tattn.attention_reference(q, k, v))
    assert torch.equal(tattn.attention(q, k, v), tattn.attention_reference(q, k, v))
    with pytest.MonkeyPatch.context() as mp:  # eager calls launch without the dispatcher
        mp.setattr(tattn, "attention_op", None)
        assert torch.equal(tattn.attention(q, k, v), tattn.attention_reference(q, k, v))

    class Block(torch.nn.Module):
        def forward(self, x):
            return tattn.attention(x, x * 0.5, x + 1.0) + 1.0

    program = torch.export.export(Block(), (torch.randn(3, 2, 16, 8),),
                                  dynamic_shapes=({0: torch.export.Dim("B")},), strict=False)
    assert [str(n.target) for n in program.graph.nodes].count("whmr.attention.default") == 1
    (batch,) = program.range_constraints.values()
    assert batch.lower <= 1 and batch.upper > 2**31
    x = torch.randn(5, 2, 16, 8)
    assert torch.equal(program.module()(x), Block()(x))

    # The packed entry point: its own operator, one node a call, the batch
    # symbolic; `torch.ops.whmr.attention` stays registered beside it.
    qkv = _packed_qkv((3, 2, 16, 8), 6)
    views = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    assert torch.equal(torch.ops.whmr.attention_qkv(qkv), tattn.attention_reference(*views).transpose(1, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tattn, "attention_qkv_op", None)
        assert torch.equal(tattn.attention_qkv(qkv), torch.ops.whmr.attention_qkv(qkv))

    class PackedBlock(torch.nn.Module):
        def forward(self, x):
            return tattn.attention_qkv(x * 0.5).reshape(x.shape[0], x.shape[1], -1) + 1.0

    program = torch.export.export(PackedBlock(), (torch.randn(3, 16, 3, 2, 8),),
                                  dynamic_shapes=({0: torch.export.Dim("B")},), strict=False)
    targets = [str(n.target) for n in program.graph.nodes]
    assert targets.count("whmr.attention_qkv.default") == 1 and "whmr.attention.default" not in targets
    (batch,) = program.range_constraints.values()
    assert batch.lower <= 1 and batch.upper > 2**31
    x = torch.randn(5, 16, 3, 2, 8)
    assert torch.equal(program.module()(x), PackedBlock()(x))
