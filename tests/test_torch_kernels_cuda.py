"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips where no CUDA device exists. This
file imports neither JAX nor whmr_tpu, so it also runs on a machine without
them: `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_kernels_cuda.py -m cuda` (tests/conftest.py imports JAX).
"""

import pytest
import torch

from whmr_tpu_torch.ops import attention as tattn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 12, 192, 64), (3, 2, 63, 32), (1, 1, 1, 128)])
def test_attention_kernel_matches_plain(cuda_device, dtype, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(*shape, device=cuda_device, generator=g, dtype=dtype) for _ in range(3))
    before = tattn.attention.launches
    got = tattn.attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.attention.launches == before + 1
    want = tattn.attention_reference(q, k, v)
    # fp32: sums in another order. bf16: one output ulp (2**-8 relative).
    err = (got.float() - want.float()).abs()
    tol = 2e-5 if dtype == torch.float32 else 2**-7 * want.float().abs().clamp(min=1.0)
    assert bool((err <= tol).all()), err.max().item()


@pytest.mark.cuda
def test_attention_kernel_backward_raises(cuda_device):
    q = torch.randn(1, 2, 16, 32, device=cuda_device, requires_grad=True)
    out = tattn.attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()
