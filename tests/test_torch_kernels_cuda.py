"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips where no CUDA device exists. This
file imports neither JAX nor whmr_tpu, so it also runs on a machine without
them: `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_kernels_cuda.py -m cuda` (tests/conftest.py imports JAX).
"""

import numpy as np
import pytest
import torch

from whmr_tpu_torch.data.assets import synthetic_smpl_assets
from whmr_tpu_torch.ops import attention as tattn
from whmr_tpu_torch.ops import rasterizer_kernel as k2
from whmr_tpu_torch.training.gt_renderer import build_render_consts, raster_inputs
from whmr_tpu_torch.utils.testing import make_ragged_raster_case


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


def _check_k2(got, want):
    # Each operation rounded once on both sides: mask and zbuf bit for bit.
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(got.zbuf, want.zbuf)
    assert (got.attrs - want.attrs).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("tile_hw", [(16, 8), (8, 8), (4, 32)])
def test_rasterizer_kernel_ragged(cuda_device, tile_hw):
    arrays, kw = make_ragged_raster_case()
    verts, z, attrs = (torch.from_numpy(a).to(cuda_device) for a in arrays[:3])
    faces = arrays[3]
    before = k2.rasterize_kernel.launches
    got = k2.rasterize_kernel(verts, z, attrs, faces, tile_hw=tile_hw, **kw)
    torch.cuda.synchronize()
    assert k2.rasterize_kernel.launches == before + 1
    _check_k2(got, k2.rasterize_kernel_reference(verts, z, attrs, faces, **kw))
    assert got.mask.any() and not got.mask.all()


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.9, 7.8])
def test_rasterizer_kernel_gt_render(cuda_device, scale):
    """The train step's render (13,776-face topology, 128x96 window at
    origin (16, 0)) of posed bodies, and with the largest GT camera scale,
    which covers every tile."""
    rc = build_render_consts(synthetic_smpl_assets(0), device=cuda_device)
    g = np.random.RandomState(1)
    verts = torch.tensor(synthetic_smpl_assets(0).v_template[None] + 0.02 * g.randn(4, 6890, 3),
                         dtype=torch.float32, device=cuda_device)
    cam = torch.tensor([[scale, 0.02, -0.03]] * 4, dtype=torch.float32, device=cuda_device)
    vp, vz, attrs, res, origin = raster_inputs(rc, verts, cam)
    got = k2.rasterize_kernel(vp, vz, attrs, rc.faces, resolution=res, origin=origin)
    torch.cuda.synchronize()
    _check_k2(got, k2.rasterize_kernel_reference(vp, vz, attrs, rc.faces, resolution=res, origin=origin))
    assert got.mask.all() if scale > 5 else not got.mask.all()
