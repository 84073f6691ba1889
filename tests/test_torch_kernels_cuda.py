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
from whmr_tpu_torch.ops import cuda_build
from whmr_tpu_torch.ops import rasterizer_kernel as k2
from whmr_tpu_torch.training.gt_renderer import build_render_consts, raster_inputs
from whmr_tpu_torch.utils.profiling import counter
from whmr_tpu_torch.utils.testing import make_ragged_raster_case


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card)")
    return torch.device("cuda")


# The tracer's counter prefix of each attention wrapper's kernel.
KERNEL = {"attention": "k1", "fused_attention": "k3"}

# The forward's head (ViT-B), ViT-H's head (D = 80, not a power of 4, so
# the fp32 scale is not exact in bf16), the tensor-core edge N = 256,
# ragged shapes, and D = 20 (no multiple of 8) and N = 300, where bf16
# takes the CUDA-core variant. fp32 takes the tensor cores (3xTF32) at N <=
# 192, and the CUDA-core variant at (2, 4, 256, 96), (2, 3, 200, 128) and
# N = 300.
ATTENTION_SHAPES = [
    (2, 12, 192, 64), (2, 16, 192, 80), (2, 4, 256, 96), (3, 2, 63, 32), (1, 1, 1, 128),
    (2, 3, 200, 128), (2, 3, 50, 20), (1, 2, 300, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES)
def test_attention_kernel_matches_plain(cuda_device, dtype, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(*shape, device=cuda_device, generator=g, dtype=dtype) for _ in range(3))
    before = counter("k1.launches")
    got = tattn.attention(q, k, v)
    torch.cuda.synchronize()
    assert counter("k1.launches") == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES)
def test_fused_attention_kernel_matches_plain(cuda_device, dtype, shape):
    """K3 (one block per batch row, looping over the heads) against the plain
    version it shares with K1, at K1's tolerance."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(*shape, device=cuda_device, generator=g, dtype=dtype) for _ in range(3))
    before = (counter("k1.launches"), counter("k3.launches"))
    got = tattn.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert (counter("k1.launches"), counter("k3.launches")) == (before[0], before[1] + 1)
    want = tattn.attention_reference(q, k, v)
    err = (got.float() - want.float()).abs()
    tol = 2e-5 if dtype == torch.float32 else 2**-7 * want.float().abs().clamp(min=1.0)
    assert bool((err <= tol).all()), err.max().item()


@pytest.mark.cuda
def test_fused_attention_kernel_backward_raises(cuda_device):
    q = torch.randn(1, 2, 16, 32, device=cuda_device, requires_grad=True)
    out = tattn.fused_attention(q, q.detach(), q.detach())
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 12, 192, 64), (2, 16, 192, 80), (2, 4, 256, 128), (3, 2, 63, 32),
                                   (1, 2, 300, 64)])
def test_fused_attention_equals_attention_bf16(cuda_device, shape):
    """K3 runs K1's device routine on the same staged values, so in bf16 its
    output equals K1's bit for bit, in both variants."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(*shape, device=cuda_device, generator=g, dtype=torch.bfloat16) for _ in range(3))
    assert torch.equal(tattn.fused_attention(q, k, v), tattn.attention(q, k, v))


# fp32 shapes on tensor cores: the forward's and whmr-eval's heads, ViT-H's,
# the edge D = 128 at N = 192, ragged N and D = 4, 20 and 68 (wgmma at D <=
# 64, mma.sync above).
F32_MMA_SHAPES = [(2, 12, 192, 64), (2, 16, 192, 80), (2, 3, 192, 128), (3, 2, 63, 32), (2, 3, 129, 4),
                  (3, 2, 50, 20), (1, 1, 1, 128), (2, 3, 100, 68)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_MMA_SHAPES)
def test_fused_attention_equals_attention_fp32(cuda_device, shape):
    """In fp32 on tensor cores K3 runs K1's warp routine (3xTF32) on the same
    staged values, so its output equals K1's bit for bit; both are within
    2e-5 of the plain version and counted as tensor-core launches."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = (torch.randn(*shape, device=cuda_device, generator=g) for _ in range(3))
    assert tattn._variant(shape, torch.float32) == "mma"
    before = (counter("k1.mma_launches"), counter("k3.mma_launches"))
    a, b = tattn.attention(q, k, v), tattn.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert (counter("k1.mma_launches"), counter("k3.mma_launches")) == (before[0] + 1, before[1] + 1)
    assert torch.equal(a, b)
    assert (a - tattn.attention_reference(q, k, v)).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["attention", "fused_attention"])
def test_tensor_core_kernels_take_unaligned_inputs(cuda_device, wrapper):
    """Contiguous inputs 2 bytes off a 16-byte boundary (TMA cannot read
    them) are copied by the wrapper: the same output, bit for bit, as from
    aligned copies."""
    shape = (2, 12, 192, 64)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    numel = int(np.prod(shape))
    aligned = [torch.randn(*shape, device=cuda_device, generator=g, dtype=torch.bfloat16) for _ in range(3)]
    shifted = []
    for x in aligned:
        buf = torch.empty(numel + 1, device=cuda_device, dtype=torch.bfloat16)
        buf[1:] = x.reshape(-1)
        shifted.append(buf[1:].view(shape))
    assert all(x.is_contiguous() and x.data_ptr() % 16 == 2 for x in shifted)
    fn, kernel = getattr(tattn, wrapper), KERNEL[wrapper]
    before = counter(kernel + ".mma_launches")
    got = fn(*shifted)
    assert counter(kernel + ".mma_launches") == before + 1
    assert torch.equal(got, fn(*aligned))
    want = tattn.attention_reference(*aligned)
    assert bool(((got.float() - want.float()).abs() <= 2**-7 * want.float().abs().clamp(min=1.0)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["attention", "fused_attention"])
def test_tensor_core_launches_counted(cuda_device, wrapper):
    """bf16 at N <= 256 (D % 8 == 0) and fp32 at N <= 192 (D % 4 == 0)
    launch the tensor-core variant (counted in the tracer's `<kernel>.mma_launches`
    and `<kernel>.launches`); bf16 above N = 256 or with D % 8 != 0, and fp32
    above N = 192 or with D % 4 != 0, launch the CUDA-core variant
    (`<kernel>.launches` only)."""
    fn, kernel = getattr(tattn, wrapper), KERNEL[wrapper]
    cases = [((2, 3, 256, 64), torch.bfloat16, 1), ((2, 3, 1, 64), torch.bfloat16, 1),
             ((2, 3, 192, 64), torch.float32, 1), ((2, 3, 192, 128), torch.float32, 1),
             ((2, 3, 64, 20), torch.float32, 1), ((2, 3, 257, 64), torch.bfloat16, 0),
             ((2, 3, 64, 20), torch.bfloat16, 0), ((2, 3, 193, 64), torch.float32, 0),
             ((2, 3, 256, 64), torch.float32, 0), ((2, 3, 64, 18), torch.float32, 0)]
    for shape, dtype, mma in cases:
        x = torch.randn(*shape, device=cuda_device, dtype=dtype)
        before = (counter(kernel + ".launches"), counter(kernel + ".mma_launches"))
        fn(x, x, x)
        assert (counter(kernel + ".launches"), counter(kernel + ".mma_launches")) == (before[0] + 1, before[1] + mma), \
            (shape, dtype)
        assert tattn._variant(shape, dtype) == ("mma" if mma else "rows")


@pytest.mark.cuda
def test_smem_figures_match_the_kernel_source(cuda_device):
    """The wrapper's shared-memory figures are the ones the launch sets, in
    both variants and both dtypes."""
    lib = tattn._kernel_lib()
    for shape in ATTENTION_SHAPES + F32_MMA_SHAPES + [(1, 1, 193, 64), (1, 1, 64, 18)]:
        for dtype in (torch.float32, torch.bfloat16):
            for per_batch in (False, True):
                for variant in {"rows", tattn._variant(shape, dtype)}:
                    want = lib.whmr_attention_smem_bytes(shape[2], shape[3], torch.finfo(dtype).bits // 8,
                                                         int(per_batch), int(variant == "mma"))
                    assert tattn._smem_bytes(shape, dtype, per_batch, variant) == want, (shape, dtype, variant)


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
    before = counter("k2.launches")
    got = k2.rasterize_kernel(verts, z, attrs, faces, tile_hw=tile_hw, **kw)
    torch.cuda.synchronize()
    assert counter("k2.launches") == before + 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [0.9, 7.8])
def test_rasterizer_kernel_res50_render(cuda_device, scale):
    """The res50 model's train render (`pymaf.dp_heatmap_size` (64, 64), no
    ViT slice): the whole 64x64 map at origin (0, 0)."""
    rc = build_render_consts(synthetic_smpl_assets(0), device=cuda_device)
    g = np.random.RandomState(2)
    verts = torch.tensor(synthetic_smpl_assets(0).v_template[None] + 0.02 * g.randn(4, 6890, 3),
                         dtype=torch.float32, device=cuda_device)
    cam = torch.tensor([[scale, -0.02, 0.03]] * 4, dtype=torch.float32, device=cuda_device)
    vp, vz, attrs, res, origin = raster_inputs(rc, verts, cam, heatmap_size=(64, 64), vitpose_slice=False)
    assert res == (64, 64) and origin == (0.0, 0.0)
    got = k2.rasterize_kernel(vp, vz, attrs, rc.faces, resolution=res, origin=origin)
    torch.cuda.synchronize()
    _check_k2(got, k2.rasterize_kernel_reference(vp, vz, attrs, rc.faces, resolution=res, origin=origin))
    assert got.mask.any()


def make_covering_case(n_faces=3000, seed=0):
    """Large triangles that each cover the whole 40x56 window at origin
    (2, 3): every face's bbox holds every pixel centre, so every face has
    pairs with every pixel, so the kernel's warps share out 2,240 pairs a face. A
    thin band nearer than the rest (depth 1) repeats at faces 0, 100, ...,
    500 (six ties in chunk 0, walked in face order) and at 1100 and 2100
    (ties across chunks, which chunk 0 wins)."""
    rng = np.random.RandomState(seed)
    h, w, ox, oy = 40, 56, 2.0, 3.0
    lo, hi = np.array([ox, oy]), np.array([ox + w, oy + h])
    r = rng.uniform(5, 60, size=(n_faces, 3))
    tri = np.stack([lo - r[:, :1], [hi[0], lo[1]] + r[:, 1:2] * [1, -1], [lo[0], hi[1]] + r[:, 2:3] * [-1, 1]], 1)
    tri[:, 1, 0] += r[:, 1]
    tri[:, 2, 1] += r[:, 2]
    band = np.array([[lo[0] - 5, lo[1] - 5], [hi[0] + 5, hi[1] + 5], [lo[0] - 5, lo[1] + 10]])
    verts = np.concatenate([tri.reshape(-1, 2), band]).astype(np.float32)
    z = np.concatenate([rng.uniform(2, 8, size=3 * n_faces), [1.0, 1.0, 1.0]]).astype(np.float32)
    attrs = rng.rand(len(verts), 3).astype(np.float32)
    faces = np.arange(3 * n_faces).reshape(-1, 3)
    faces[[0, 100, 200, 300, 400, 500, 1100, 2100]] = 3 * n_faces + np.arange(3)
    return (verts[None], z[None], attrs[None], faces.astype(np.int32)), {
        "resolution": (h, w), "chunk": 1024, "origin": (ox, oy)}


def make_tiled_plane_case(seed=0):
    """Exact ties on tile edges: squares of side 8 on the 8-pixel grid and of
    side 16 on two grids offset by 8, all in the plane z = 2, each split into
    two right triangles along a diagonal that passes through pixel centres.
    Every product and sum is exact in fp32, so each pixel is covered by two
    to six faces at exactly z = 2; the faces are shuffled over chunks of 64,
    so the winners are the covering faces of the earliest chunk, up to six
    of them, summed in face order. Every face has its own attributes."""
    rng = np.random.RandomState(seed)
    h, w = 48, 64
    tris = []
    for side, off in ((8, 0), (16, 0), (16, 8)):
        for y in range(off, h - side + 1, side):
            for x in range(off, w - side + 1, side):
                a, b, c, d = (x, y), (x + side, y), (x + side, y + side), (x, y + side)
                tris += [[a, b, c], [a, c, d]] if rng.rand() < 0.5 else [[a, b, d], [b, c, d]]
    tris = np.asarray(tris, np.float32)[rng.permutation(len(tris))]
    verts = tris.reshape(-1, 2)
    z = np.full(len(verts), 2.0, np.float32)
    attrs = rng.rand(len(verts), 3).astype(np.float32)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    return (verts[None], z[None], attrs[None], faces), {"resolution": (h, w), "chunk": 64, "origin": (0.0, 0.0)}


@pytest.mark.cuda
def test_rasterizer_kernel_faces_cover_the_window(cuda_device):
    arrays, kw = make_covering_case()
    verts, z, attrs = (torch.from_numpy(a).to(cuda_device) for a in arrays[:3])
    _, fbox = k2.kernel_inputs(verts, z, attrs, arrays[3], kw["chunk"])
    pairs, live, _ = k2.raster_work(fbox, kw["resolution"], kw["origin"], 3)
    (h, w), n_faces = kw["resolution"], len(arrays[3])
    assert (pairs, live) == (n_faces * h * w, n_faces)
    got = k2.rasterize_kernel(verts, z, attrs, arrays[3], tile_hw=(16, 8), **kw)
    torch.cuda.synchronize()
    _check_k2(got, k2.rasterize_kernel_reference(verts, z, attrs, arrays[3], **kw))
    assert bool(got.mask.all())


@pytest.mark.cuda
def test_rasterizer_kernel_ties_on_tile_edges(cuda_device):
    """At the three tilings, equal to the plain version, and the attributes
    equal bit for bit across tilings and runs: the winners are summed in
    face order whatever thread found them first."""
    arrays, kw = make_tiled_plane_case()
    verts, z, attrs = (torch.from_numpy(a).to(cuda_device) for a in arrays[:3])
    want = k2.rasterize_kernel_reference(verts, z, attrs, arrays[3], **kw)
    assert bool(want.mask.all()) and bool((want.zbuf == 2.0).all())
    outs = []
    for tile_hw in ((16, 8), (8, 8), (4, 32), (16, 8)):
        got = k2.rasterize_kernel(verts, z, attrs, arrays[3], tile_hw=tile_hw, **kw)
        torch.cuda.synchronize()
        _check_k2(got, want)
        outs.append(got.attrs)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.cuda
def test_attention_tensor_core_kernels_build_without_spills(cuda_device):
    """ptxas's report of the tensor-core attention kernels: in fp32
    (3xTF32) K1's and K3's for 64, 128 and 192 padded keys, by wgmma (D <=
    64) and by mma.sync (64 < D <= 128); in bf16 one per key count up to
    256. No spill."""
    text = cuda_build.build_all(["attention"], force=True)["attention"]
    report = {fn: r for fn, r in cuda_build.ptxas_report(text).items() if "mma_kernel" in fn}
    f32 = [fn for fn in report if "_f32_" in fn]
    assert (len(f32), len(report)) == (12, 20), sorted(report)
    for fn, r in report.items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (fn, r)


@pytest.mark.cuda
def test_rasterizer_kernel_builds_without_spills(cuda_device):
    """ptxas's report of K2's kernels (the face pass and the resolve
    step): no spill."""
    text = cuda_build.build_all(["rasterizer"], force=True)["rasterizer"]
    report = {fn: r for fn, r in cuda_build.ptxas_report(text).items() if "raster_" in fn}
    assert len(report) == 2, report
    for fn, r in report.items():
        assert r["spill_stores"] == 0 and r["spill_loads"] == 0, (fn, r)


@pytest.mark.cuda
def test_rasterizer_kernel_refuses_windows_past_the_pair_count(cuda_device):
    """The kernel's own check, past the wrapper's: a window of more than
    (2^31 - 1) / 32 pixels, or more than 8 channels, is refused before
    anything is read or launched."""
    lib = k2._kernel_lib()
    nul = [None] * 9
    for h, w, c in ((8192, 8192, 3), (1, k2._MAX_WINDOW + 1, 3), (8, 8, 9)):
        assert lib.whmr_raster_fwd(*nul, 1, h, w, 1024, 1024, c, 0.0, 0.0, None) == 1, (h, w, c)  # cudaErrorInvalidValue


@pytest.mark.cuda
def test_attention_custom_op_is_the_kernel(cuda_device):
    """`torch.ops.whmr.attention` (what bundles exported from the
    (B, H, N, D) entry call) launches K1, counted, and gives attention()'s
    result bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(2, 12, 192, 64, device=cuda_device, generator=g, dtype=torch.bfloat16) for _ in range(3))
    before = (counter("k1.launches"), counter("k1.mma_launches"))
    a = tattn.attention(q, k, v)
    b = torch.ops.whmr.attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert (counter("k1.launches"), counter("k1.mma_launches")) == (before[0] + 2, before[1] + 2)


@pytest.mark.cuda
def test_exported_vit_block_keeps_k1(cuda_device):
    """torch.export of a one-block ViT-B in bf16 under attn_impl="pallas":
    the program holds K1 as one `whmr::attention_qkv` node and launches it
    once a call on tensor cores, reading the projection in place (the
    operator, not a traced plain version), and equals the live module."""
    from whmr_tpu_torch.config import ViTConfig
    from whmr_tpu_torch.models.vit import ViTBackbone

    vit = ViTBackbone(ViTConfig(depth=1, attn_impl="pallas"), dtype=torch.bfloat16).to(cuda_device).eval()
    vit.requires_grad_(False)
    x = torch.randn(2, 3, 256, 192, device=cuda_device)
    with torch.no_grad():
        program = torch.export.export(vit, (x,), dynamic_shapes=({0: torch.export.Dim("B")},), strict=False)
    run = program.module()
    x = torch.randn(3, 3, 256, 192, device=cuda_device)
    names = ("k1.launches", "k1.mma_launches", "k1.packed_launches")
    before = [counter(c) for c in names]
    with torch.no_grad():
        got = run(x)
        torch.cuda.synchronize()
        launched = tuple(counter(c) - b for c, b in zip(names, before))
        want = vit(x)
    assert [str(n.target) for n in program.graph.nodes].count("whmr.attention_qkv.default") == 1
    assert launched == (1, 1, 1)
    assert torch.equal(got, want)


def _qkv_copies(qkv):
    """Contiguous (B, H, N, D) q, k and v of a (B, N, 3, H, D) projection."""
    return qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)


# (B, H, N, D): ViT-L's and ViT-B's heads at the infer cells' batch, the
# serving batch, and a tensor-parallel rank's local heads (ViT-B at m = 2
# with 16 heads: 8 a rank).
QKV_SHAPES = [(192, 16, 192, 64), (192, 12, 192, 64), (8, 12, 192, 64), (8, 8, 192, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QKV_SHAPES)
def test_attention_qkv_equals_attention_bit_for_bit(cuda_device, shape):
    """K1 reading q, k and v in place from the (B, N, 3, H, D) projection and
    storing (B, N, H, D) gives `attention`'s bits on contiguous copies,
    transposed; each call is one launch, counted as packed."""
    b, h, n, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn(b, n, 3, h, d, device=cuda_device, generator=g, dtype=torch.bfloat16)
    names = ("k1.launches", "k1.mma_launches", "k1.packed_launches")
    before = [counter(c) for c in names]
    got = tattn.attention_qkv(qkv)
    torch.cuda.synchronize()
    assert tuple(counter(c) - x for c, x in zip(names, before)) == (1, 1, 1)
    assert got.shape == (b, n, h, d) and got.is_contiguous()
    assert torch.equal(got, tattn.attention(*_qkv_copies(qkv)).transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 4, 130, 64), (4, 4, 200, 64), (4, 4, 130, 32), (3, 6, 200, 32)])
def test_attention_qkv_ragged_reads_zeros_past_n_and_d(cuda_device, shape):
    """At ragged N the kernel stages K and V padded to 192 or 256 rows, and
    at D = 32 Q and K padded to 64 columns; in the packed projection the
    memory past N is the next sample's tokens and past D the next head's
    columns. Every other sample holds NaN in token 0 and every other head
    NaN in all its tokens, in q, k and v, and the sample after the last is
    NaN: a padding row or column read from them instead of zeros would turn
    the clean samples' heads to NaN. The output equals `attention` on
    contiguous copies bit for bit (NaN included), and the clean heads are
    finite and within one bf16 ulp of the plain version."""
    b, h, n, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(6)
    buf = torch.full((b + 1, n, 3, h, d), float("nan"), device=cuda_device, dtype=torch.bfloat16)
    qkv = buf[:b]
    qkv.copy_(torch.randn(b, n, 3, h, d, device=cuda_device, generator=g, dtype=torch.bfloat16))
    qkv[1::2, 0] = float("nan")
    qkv[:, :, :, 1::2] = float("nan")
    assert qkv.is_contiguous() and qkv.data_ptr() % 16 == 0
    before = counter("k1.packed_launches")
    got = tattn.attention_qkv(qkv)
    torch.cuda.synchronize()
    assert counter("k1.packed_launches") == before + 1
    copies = _qkv_copies(qkv)
    want = tattn.attention(*copies).transpose(1, 2)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    clean = got[0::2, :, 0::2].float()
    assert bool(torch.isfinite(clean).all())
    plain = tattn.attention_reference(*copies).transpose(1, 2)[0::2, :, 0::2].float()
    assert bool(((clean - plain).abs() <= 2**-7 * plain.abs().clamp(min=1.0)).all())


@pytest.mark.cuda
def test_attention_qkv_copies_strided_unaligned_fp32_and_rows(cuda_device):
    """A strided or misaligned bf16 projection is copied once and then read
    in place (packed); fp32, and bf16 past the tensor-core range (N = 300,
    D = 20), take contiguous (B, H, N, D) copies through `attention`'s
    variants, unpacked. Each equals `attention` on contiguous copies bit
    for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    b, h, n, d = 3, 4, 192, 64
    wide = torch.randn(b, n, 3, h, d + 8, device=cuda_device, generator=g, dtype=torch.bfloat16)
    flat = torch.randn(b * n * 3 * h * d + 1, device=cuda_device, generator=g, dtype=torch.bfloat16)
    cases = [(wide[..., :d], 1), (flat[1:].view(b, n, 3, h, d), 1),
             (torch.randn(b, n, 3, h, d, device=cuda_device, generator=g), 0),
             (torch.randn(2, 300, 3, 2, 64, device=cuda_device, generator=g, dtype=torch.bfloat16), 0),
             (torch.randn(2, 50, 3, 3, 20, device=cuda_device, generator=g, dtype=torch.bfloat16), 0)]
    for qkv, packed in cases:
        before = (counter("k1.launches"), counter("k1.packed_launches"))
        got = tattn.attention_qkv(qkv)
        torch.cuda.synchronize()
        assert (counter("k1.launches") - before[0], counter("k1.packed_launches") - before[1]) == (1, packed)
        assert torch.equal(got, tattn.attention(*_qkv_copies(qkv)).transpose(1, 2)), (qkv.shape, qkv.dtype)


@pytest.mark.cuda
def test_attention_qkv_custom_op_is_the_kernel(cuda_device):
    """`torch.ops.whmr.attention_qkv` (what an exported ViT block calls)
    launches the packed K1, counted, and gives attention_qkv()'s bits."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    qkv = torch.randn(2, 192, 3, 12, 64, device=cuda_device, generator=g, dtype=torch.bfloat16)
    before = counter("k1.packed_launches")
    a = tattn.attention_qkv(qkv)
    b = torch.ops.whmr.attention_qkv(qkv)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert counter("k1.packed_launches") == before + 2


@pytest.mark.cuda
def test_attention_qkv_backward_raises(cuda_device):
    qkv = torch.randn(1, 16, 3, 2, 32, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tattn.attention_qkv(qkv).sum().backward()
