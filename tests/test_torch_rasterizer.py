"""whmr_tpu_torch's rasterizers against whmr_tpu's: K2's plain version
(`rasterize_kernel_reference`) against `rasterize_pallas(interpret=True)`,
the CPU path `rasterize` against whmr_tpu's `rasterize`, and the tables and
topology sort both share.

On the CPU, whmr_tpu runs the Pallas body and the scan through XLA, which
contracts products and sums into FMAs; the port rounds each operation, as K2
does on the card. So:
- on "exact" meshes (integer vertices, power-of-two legs, depths of few
  bits: every product and sum is exact in fp32) the results must agree bit
  for bit in mask and zbuf, attrs within 1e-6; these meshes carry the tie
  rules (duplicate faces, coplanar overlaps at one depth, inside a chunk and
  across chunks) and padding faces;
- on random triangles and the SMPL mesh, mask is equal, zbuf within 1e-4
  relative and attrs within 1e-4 (the fp32 conditioning of the edge
  functions of small, far-from-origin faces; whmr_tpu's own tolerance for
  this comparison, tests/test_rasterizer_pallas.py).
The tables (eager JAX rounds each operation too) must agree bit for bit.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.ops import rasterizer as jr
from whmr_tpu.ops import rasterizer_pallas as jp
from whmr_tpu_torch.ops import rasterizer as tr
from whmr_tpu_torch.ops import rasterizer_kernel as k2
from whmr_tpu_torch.utils import profiling

from torch_port_util import release_memory, n, t  # noqa: F401 (autouse fixture)


def _exact_mesh(rng, b=2):
    """Right triangles with legs 4, 8 or 16 on integer vertices in a 32x32
    frame, depths in eighths: every barycentric and depth is exact. Faces
    repeat (exact ties) and half the triangles share one depth plane, so
    overlaps tie exactly too."""
    tris, depths = [], []
    for _ in range(8):
        x, y = rng.randint(0, 24, size=2)
        leg = int(rng.choice([4, 8, 16]))
        sx, sy = rng.choice([-1, 1], size=2)
        tris.append([[x, y], [x + sx * leg, y], [x, y + sy * leg]])
    verts = np.asarray(tris, np.float32).reshape(-1, 2)
    verts = np.tile(verts[None], (b, 1, 1)) + rng.randint(0, 4, size=(b, 1, 2)).astype(np.float32)
    z = rng.randint(16, 64, size=(b, verts.shape[1])) / 8.0
    z[:, :12] = 3.0  # the first four triangles in one plane
    faces = np.arange(verts.shape[1]).reshape(-1, 3)
    faces = np.concatenate([faces, faces[[0, 2, 5]], faces[:1]]).astype(np.int32)  # 11: pads to 12 or 16
    attrs = rng.rand(b, verts.shape[1], 3).astype(np.float32)
    return verts, z.astype(np.float32), attrs, faces


def _random_mesh(rng, b=2):
    verts = rng.uniform(2, 30, size=(b, 12, 2)).astype(np.float32)
    z = rng.uniform(2, 8, size=(b, 12)).astype(np.float32)
    attrs = rng.rand(b, 12, 3).astype(np.float32)
    faces = rng.randint(0, 12, size=(6, 3)).astype(np.int32)
    faces = np.concatenate([faces, faces[:3], faces[1:2]])
    return verts, z, attrs, faces


def _smpl_mesh():
    assets = j_assets(0)
    vp, vz = jr.project_weak_perspective_to_pixels(
        jnp.asarray(assets.v_template[None]), jnp.asarray([[0.9, 0.05, 0.0]], jnp.float32), (64, 64)
    )
    faces = jp.spatial_sort_faces(np.asarray(assets.faces), np.asarray(assets.v_template), 512)
    return n(vp), n(vz), assets.v_template[None].astype(np.float32), faces


def _check(got, want, exact):
    np.testing.assert_array_equal(n(got.mask), np.asarray(want.mask))
    if exact:
        np.testing.assert_array_equal(n(got.zbuf), n(want.zbuf))
        np.testing.assert_allclose(n(got.attrs), n(want.attrs), atol=1e-6)
    else:
        np.testing.assert_allclose(n(got.zbuf), n(want.zbuf), rtol=1e-4)
        np.testing.assert_allclose(n(got.attrs), n(want.attrs), atol=1e-4)


_CASES = {
    # name: (mesh, resolution, chunk, tile_p, tile_hw, origin, exact)
    "exact_chunk4": (_exact_mesh, (32, 16), 4, 64, (8, 8), (8.0, 0.0), True),
    "exact_chunk8": (_exact_mesh, (32, 16), 8, 64, (8, 8), (8.0, 0.0), True),
    "random_chunk4": (_random_mesh, (32, 16), 4, 64, (8, 8), (8.0, 0.0), False),
    "smpl_64": (None, (64, 64), 512, 512, None, (0.0, 0.0), False),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_reference_matches_rasterize_pallas(case):
    make, res, chunk, tile_p, tile_hw, origin, exact = _CASES[case]
    verts, z, attrs, faces = _smpl_mesh() if make is None else make(np.random.RandomState(0))
    want = jp.rasterize_pallas(
        jnp.asarray(verts), jnp.asarray(z), jnp.asarray(attrs), faces, resolution=res, chunk=chunk,
        tile_p=tile_p, tile_hw=tile_hw, origin=origin, interpret=True,
    )
    got = k2.rasterize_kernel_reference(t(verts), t(z), t(attrs), faces, resolution=res, chunk=chunk,
                                        origin=origin)
    _check(got, want, exact)
    assert n(got.mask).any() and not n(got.mask).all()
    # The wrapper takes the plain version for CPU tensors, and counts no launch.
    before = profiling.counter("k2.launches")
    wrapped = k2.rasterize_kernel(t(verts), t(z), t(attrs), faces, resolution=res, chunk=chunk,
                                  tile_p=tile_p, tile_hw=tile_hw, origin=origin)
    assert profiling.counter("k2.launches") == before
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["exact", "random"])
def test_rasterize_matches_whmr_tpu(case):
    make = _exact_mesh if case == "exact" else _random_mesh
    verts, z, attrs, faces = make(np.random.RandomState(1))
    for chunk in (4, 8):
        want = jr.rasterize(jnp.asarray(verts), jnp.asarray(z), jnp.asarray(attrs), faces,
                            resolution=(32, 32), chunk=chunk)
        got = tr.rasterize(t(verts), t(z), t(attrs), faces, resolution=(32, 32), chunk=chunk)
        _check(got, want, case == "exact")
    # A window at an origin is the full frame's render, sliced, bit for bit.
    win = tr.rasterize(t(verts), t(z), t(attrs), faces, resolution=(32, 16), chunk=4, origin=(8.0, 0.0))
    full = tr.rasterize(t(verts), t(z), t(attrs), faces, resolution=(32, 32), chunk=4)
    assert torch.equal(win.zbuf, full.zbuf[:, :, 8:24])
    assert torch.equal(win.attrs, full.attrs[:, :, 8:24])


def test_projection_matches_whmr_tpu():
    rng = np.random.RandomState(2)
    verts = rng.randn(2, 50, 3).astype(np.float32) * 0.4
    cam = np.array([[0.9, 0.05, -0.1], [1.1, -0.02, 0.03]], np.float32)
    want = jr.project_weak_perspective_to_pixels(jnp.asarray(verts), jnp.asarray(cam), (128, 96))
    got = tr.project_weak_perspective_to_pixels(t(verts), t(cam), (128, 96))
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-6)


def test_sort_and_tables_match_whmr_tpu():
    assets = j_assets(0)
    faces, vt = np.asarray(assets.faces), np.asarray(assets.v_template)
    for chunk in (512, 1024):
        np.testing.assert_array_equal(k2.spatial_sort_faces(faces, vt, chunk), jp.spatial_sort_faces(faces, vt, chunk))
    for h, w, tile_p in ((128, 96, 128), (64, 64, 512), (32, 32, 64), (16, 48, 32)):
        assert k2._pick_tile_hw(h, w, tile_p) == jp._pick_tile_hw(h, w, tile_p)
    with pytest.raises(ValueError):
        k2._pick_tile_hw(30, 30, 64)

    verts, z, attrs, faces = _exact_mesh(np.random.RandomState(3))
    verts = verts + np.random.RandomState(4).uniform(0, 1, verts.shape).astype(np.float32)
    chunk = 4
    faces_pad = jr._face_chunks(faces, chunk).reshape(-1, 3)
    want = jp._face_tables(jnp.asarray(verts), jnp.asarray(z), jnp.asarray(attrs), jnp.asarray(faces_pad))
    got = k2._face_tables(t(verts), t(z), t(attrs), torch.from_numpy(faces_pad.astype(np.int64)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), n(b))
    # The chunk bboxes (rasterizer_pallas.py:296-305), padding faces included,
    # and the face bboxes, each whmr_tpu's face extremum -/+ the pad.
    tables, bbox, face_bbox = k2.raster_tables(t(verts), t(z), t(attrs), faces, chunk)
    lo_hi = [n(b).reshape(2, -1, chunk) for b in want[5:]]
    expect = np.stack([lo_hi[0].min(-1) - 0.0625, lo_hi[1].max(-1) + 0.0625,
                       lo_hi[2].min(-1) - 0.0625, lo_hi[3].max(-1) + 0.0625], axis=1)
    np.testing.assert_array_equal(n(bbox), expect)
    assert face_bbox.shape == (2, 4, faces_pad.shape[0])
    for i, (extremum, sign) in enumerate(zip(want[5:], (-1, 1, -1, 1))):
        np.testing.assert_array_equal(n(face_bbox)[:, i], n(extremum) + np.float32(sign * 0.0625))
    for a, b in zip(tables, want[:5]):
        np.testing.assert_array_equal(n(a), n(b))


def test_tile_hits_cover_every_covered_pixel():
    """The cull is conservative: every (tile, chunk) with a face covering a
    pixel centre of the tile is a hit."""
    verts, z, attrs, faces = _random_mesh(np.random.RandomState(5))
    res, chunk, tile_hw, origin = (32, 16), 4, (8, 8), (8.0, 0.0)
    _, bbox, _ = k2.raster_tables(t(verts), t(z), t(attrs), faces, chunk)
    hits = n(k2.tile_hits(bbox, res, tile_hw, origin)).astype(bool)  # (B, tiles, K)
    faces_pad = jr._face_chunks(faces, chunk).reshape(-1, 3)
    for ci in range(faces_pad.shape[0] // chunk):
        sub = faces_pad[ci * chunk:(ci + 1) * chunk]
        cov = n(tr.rasterize(t(verts), t(z), t(attrs), sub, resolution=res, chunk=chunk, origin=origin).mask)
        tiles = cov.reshape(2, 4, 8, 2, 8).any(axis=(2, 4)).reshape(2, -1)
        assert not (tiles & ~hits[:, :, ci]).any(), ci
    assert not hits.all()


def test_face_bboxes_hold_every_covered_pixel():
    """K2's per-face cull is conservative: every pixel centre that a face
    covers (by the plain rasterizer on that face alone) lies in the face's
    padded bbox, the only pixels K2 tests it against; padding faces hold no
    pixel centre. `raster_work` counts fewer pairs than the chunk cull
    leaves."""
    verts, z, attrs, faces = _random_mesh(np.random.RandomState(5))
    res, chunk, origin = (32, 16), 4, (8.0, 0.0)
    _, bbox, face_bbox = k2.raster_tables(t(verts), t(z), t(attrs), faces, chunk)
    fb = n(face_bbox)  # (B, 4, F)
    xs = np.arange(res[1], dtype=np.float32) + np.float32(0.5) + np.float32(origin[0])
    ys = np.arange(res[0], dtype=np.float32) + np.float32(0.5) + np.float32(origin[1])
    faces_pad = jr._face_chunks(faces, chunk).reshape(-1, 3)
    covered = 0
    for i, face in enumerate(faces_pad):
        inside = (((xs >= fb[:, 0, i, None]) & (xs <= fb[:, 1, i, None]))[:, None, :]
                  & ((ys >= fb[:, 2, i, None]) & (ys <= fb[:, 3, i, None]))[:, :, None])  # (B, H, W)
        if i >= len(faces):
            assert not inside.any(), i
            continue
        cov = n(tr.rasterize(t(verts), t(z), t(attrs), face[None], resolution=res, chunk=1, origin=origin).mask).astype(bool)
        assert not (cov & ~inside).any(), i
        covered += int(cov.sum())
    pairs, _, _ = k2.raster_work(face_bbox, res, origin, attrs.shape[-1])
    chunk_pairs = int(n(k2.tile_hits(bbox, res, (8, 8), origin)).sum()) * 64 * chunk
    assert 0 < covered <= pairs < chunk_pairs


def test_raster_work_matches_brute_force():
    """`raster_work` (K2's bound) against a count by hand: each face's bbox
    from its vertices, padded, against every pixel centre of an origin
    window, with faces partly and wholly outside it and degenerate faces."""
    rng = np.random.RandomState(6)
    b, c, res, origin = 2, 3, (20, 28), (5.0, 3.0)
    verts = rng.uniform(-10, 45, size=(b, 30, 2)).astype(np.float32)
    z = rng.uniform(2, 8, size=(b, 30)).astype(np.float32)
    attrs = rng.rand(b, 30, c).astype(np.float32)
    faces = rng.randint(0, 30, size=(37, 3)).astype(np.int32)
    faces[:3] = [[4, 4, 9], [7, 7, 7], [1, 2, 1]]  # degenerate
    _, _, face_bbox = k2.raster_tables(t(verts), t(z), t(attrs), faces, 8)

    pad = np.float32(0.0625)
    xs = (np.arange(res[1], dtype=np.float32) + np.float32(0.5)) + np.float32(origin[0])
    ys = (np.arange(res[0], dtype=np.float32) + np.float32(0.5)) + np.float32(origin[1])
    pairs = live = 0
    for img in range(b):
        for face in faces:
            p = verts[img, face]
            e1, e2 = p[1] - p[0], p[2] - p[0]
            if abs(float(e1[0]) * float(e2[1]) - float(e1[1]) * float(e2[0])) <= 1e-9:
                continue
            lo, hi = p.min(axis=0) - pad, p.max(axis=0) + pad
            inside = ((xs >= lo[0]) & (xs <= hi[0]))[None, :] & ((ys >= lo[1]) & (ys <= hi[1]))[:, None]
            pairs += int(inside.sum())
            live += int(inside.any())
    assert 0 < live < b * len(faces) - 6  # some faces lie outside the window
    n_bytes = 4 * (live * (12 + 3 * c) + b * res[0] * res[1] * (1 + c))
    assert k2.raster_work(face_bbox, res, origin, c) == (pairs, live, n_bytes)


def test_launch_rejects_windows_past_the_pair_count():
    """K2 counts a warp's pairs in int32, so a window holds at most
    (2^31 - 1) / 32 pixels, in the wrapper as in the kernel's own check;
    the wrapper refuses a larger one before it builds or launches."""
    src = (Path(k2.__file__).parent.parent / "csrc" / "rasterizer.cu").read_text()
    assert "constexpr long long kMaxWindow = 0x7fffffffLL / 32;" in src
    assert k2._MAX_WINDOW == 0x7FFFFFFF // 32 == 8192 * 8192 - 1
    verts, z, attrs, faces = _random_mesh(np.random.RandomState(5))
    tables, face_bbox = k2.kernel_inputs(t(verts), t(z), t(attrs), faces, 4)
    for res in ((8192, 8192), (1, k2._MAX_WINDOW + 1)):
        with pytest.raises(ValueError, match="windows of 1 to"):
            k2._launch(tables, face_bbox, res, 4, (0.0, 0.0))
