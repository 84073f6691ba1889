"""K1 and K3 (whmr_tpu_torch.ops.attention) against whmr_tpu's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
`fused_attention_heads` (K1) or `fused_attention` (K3) in interpret mode, as
whmr_tpu's own tests do. The CUDA kernels themselves are held against the
plain version on a card by tests/test_torch_kernels_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whmr_tpu.models import layers as jlayers
from whmr_tpu.ops.attention_pallas import fused_attention, fused_attention_heads
from whmr_tpu_torch.models import layers as tlayers
from whmr_tpu_torch.ops import attention as tattn
from whmr_tpu_torch.utils.convert import linear_from_flax

from torch_port_util import release_memory, n, t  # noqa: F401 (autouse fixture)

SHAPES = [(2, 4, 192, 64), (2, 4, 64, 32)]


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
    before = tattn.attention.launches
    tattn.attention(q.detach(), q.detach(), q.detach())
    assert tattn.attention.launches == before  # the CPU path launches no kernel
    out = tattn.fused_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="fused_attention .K3. is forward-only"):
        out.sum().backward()
    assert tattn.fused_attention.launches == 0


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


@pytest.mark.parametrize("impl", ["split", "bf16sm", "bhnd", "bhnd_bf16sm", "xla_dpa", "nope"])
def test_unported_impls_raise(impl):
    with pytest.raises(ValueError, match="not ported yet" if impl != "nope" else "unknown"):
        tlayers.Attention(64, 4, impl=impl)

