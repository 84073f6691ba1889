"""The GT supervision path against whmr_tpu's: the render chart and topology
(`build_render_consts`, full and sub, synthetic and DensePose), the CPU
render (`render_gt_maps`), the GT camera (`estimate_translation`,
`gt_camera_from_cam_t`) and the IUV codec.

Tolerances: the chart, topology, codec and camera clamps are exact; the
least-squares translation within 1e-4. The render's edge functions are
evaluated as a*x + b*y + c, whose c grows with the square of the pixel
coordinates: at 128x128, a face of 0.03 px^2 carries absolute barycentric
errors near 1e-2 in fp32, and whmr_tpu's XLA scan rounds them otherwise
(FMAs) than the port. So the maps are compared by share of pixels: mask
and part labels agree on 99.9% of pixels, U/V (and inverse depth) within
1e-2 on 99.5% of the foreground and within 1e-4 on half of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.models.smpl import smpl_forward, smpl_params_from_assets
from whmr_tpu.ops import camera as jcam
from whmr_tpu.ops import iuv as jiuv
from whmr_tpu.ops.rotation import batch_rodrigues
from whmr_tpu.training import gt_renderer as jgt
from whmr_tpu_torch.data.assets import synthetic_smpl_assets as t_assets
from whmr_tpu_torch.ops import camera as tcam
from whmr_tpu_torch.ops import iuv as tiuv
from whmr_tpu_torch.training import gt_renderer as tgt

from torch_port_util import release_memory, n, t  # noqa: F401 (autouse fixture)


def _same_consts(got, want):
    np.testing.assert_array_equal(n(got.vertex_iuv), n(want.vertex_iuv))
    np.testing.assert_array_equal(got.faces, np.asarray(want.faces))
    np.testing.assert_array_equal(got.vertex_map.numpy(), np.asarray(want.vertex_map))
    assert got.source_verts == want.source_verts


@pytest.mark.parametrize("mesh", ["full", "sub"])
def test_build_render_consts_matches_whmr_tpu(mesh):
    _same_consts(tgt.build_render_consts(t_assets(0), mesh=mesh), jgt.build_render_consts(j_assets(0), mesh=mesh))


def test_densepose_chart_matches_whmr_tpu(tmp_path):
    """A part-pure DensePose-style .mat (as tests/test_real_assets.py makes
    it), an impure one, a missing one, and an unknown mesh name."""
    v = j_assets(0).v_template.shape[0]
    rng = np.random.RandomState(0)
    groups = [np.arange(1, 6), np.arange(6, 11)]
    part = rng.choice(np.arange(1, 25), 2, replace=False)
    mat = str(tmp_path / "UV_Processed.mat")
    scipy.io.savemat(mat, {
        "All_vertices": (rng.choice(v, 10, replace=False) + 1).reshape(1, -1),
        "All_FaceIndices": np.array([part[i % 2] for i in range(4)]).reshape(-1, 1),
        "All_U_norm": rng.uniform(0, 1, (10, 1)),
        "All_V_norm": rng.uniform(0, 1, (10, 1)),
        "All_Faces": np.stack([rng.choice(groups[i % 2], 3, replace=False) for i in range(4)]),
    })
    _same_consts(tgt.build_render_consts(t_assets(0), densepose_mat=mat),
                 jgt.build_render_consts(j_assets(0), densepose_mat=mat))
    bad = str(tmp_path / "bad.mat")
    scipy.io.savemat(bad, {
        "All_vertices": np.arange(1, 4).reshape(1, -1), "All_FaceIndices": np.array([[1], [9]]),
        "All_U_norm": np.zeros((3, 1)), "All_V_norm": np.zeros((3, 1)),
        "All_Faces": np.array([[1, 2, 3], [1, 3, 2]]),
    })
    with pytest.raises(ValueError, match="part-pure"):
        tgt.build_render_consts(t_assets(0), densepose_mat=bad)
    with pytest.raises(FileNotFoundError):
        tgt.build_render_consts(t_assets(0), densepose_mat=str(tmp_path / "missing.mat"))
    with pytest.raises(ValueError, match="mesh"):
        tgt.build_render_consts(t_assets(0), mesh="bogus")


@pytest.fixture(scope="module")
def posed():
    """Three posed bodies and body-framing GT cameras (s about 0.9)."""
    assets = j_assets(0)
    rng = np.random.RandomState(3)
    pose = jnp.asarray(rng.randn(3, 72).astype(np.float32) * 0.2)
    betas = jnp.asarray(rng.randn(3, 10).astype(np.float32) * 0.5)
    rotmats = batch_rodrigues(pose.reshape(-1, 3)).reshape(-1, 24, 3, 3)
    verts = n(smpl_forward(smpl_params_from_assets(assets), betas, rotmats).vertices)
    cam = np.stack([rng.uniform(0.75, 1.05, 3), rng.uniform(-0.1, 0.1, 3), rng.uniform(-0.1, 0.1, 3)], -1)
    return verts, cam.astype(np.float32)


@pytest.mark.parametrize("with_depth", [False, True])
def test_render_gt_maps_matches_whmr_tpu(posed, with_depth):
    verts, cam = posed
    valid = np.array([1.0, 0.0, 1.0], np.float32)
    want = jgt.render_gt_maps(jgt.build_render_consts(j_assets(0)), jnp.asarray(verts), jnp.asarray(cam),
                              with_depth=with_depth, valid=jnp.asarray(valid))
    got = tgt.render_gt_maps(tgt.build_render_consts(t_assets(0)), t(verts), t(cam),
                             with_depth=with_depth, valid=t(valid))
    assert got.keys() == want.keys()
    gi, wi = n(got["iuv_image_gt"]), n(want["iuv_image_gt"])
    assert gi.shape == (3, 128, 96, 3)
    assert not gi[1].any()  # the invalid sample is zeroed
    part_g, part_w = np.round(gi[..., 0] * 24), np.round(wi[..., 0] * 24)
    assert (part_g == part_w).mean() >= 0.999
    assert ((part_g > 0) == (part_w > 0)).mean() >= 0.999
    fg = (part_g > 0) & (part_w > 0)
    assert fg[[0, 2]].mean() > 0.1
    maps = [(gi[..., 1:], wi[..., 1:])]
    if with_depth:
        maps.append((n(got["depth_image_gt"]), n(want["depth_image_gt"])))
    for a, b in maps:
        diff = np.abs(a - b).max(axis=-1)[fg]
        assert (diff <= 1e-2).mean() >= 0.995
        assert np.median(diff) <= 1e-4
    with pytest.raises(ValueError, match="source"):
        tgt.render_gt_maps(tgt.build_render_consts(t_assets(0), mesh="sub"), t(verts), t(cam))


def test_gt_camera_clamps_match_whmr_tpu():
    cam_t = np.array([
        [0.1, -0.2, 8.7],           # plausible
        [np.nan, 0.3, np.nan],      # NaN: far default, txy 0
        [np.inf, -np.inf, np.inf],  # inf
        [25.0, -30.0, -4.0],        # behind the camera: far default; txy clamped
        [0.0, 0.0, 0.5],            # implausibly close: far default
        [0.0, 0.0, 250.0],          # beyond the far bound
        [0.0, 0.0, -np.inf],
    ], np.float32)
    got, want = n(tgt.gt_camera_from_cam_t(t(cam_t))), n(jgt.gt_camera_from_cam_t(jnp.asarray(cam_t)))
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[1:, 0], 2 * 1000.0 / 256.0 / 100.0, rtol=1e-6)


def _lsq_inputs(rng, b=4, j=49):
    joints = rng.randn(b, j, 3).astype(np.float32) * 0.3
    t_true = np.stack([rng.uniform(-0.5, 0.5, b), rng.uniform(-0.5, 0.5, b), rng.uniform(4, 10, b)], -1)
    moved = joints + t_true[:, None, :].astype(np.float32)
    p2d = moved[..., :2] / moved[..., 2:3] * 1000.0 + 128.0 + rng.randn(b, j, 2).astype(np.float32)
    conf = (rng.rand(b, j, 1) > 0.2).astype(np.float32)
    return joints, np.concatenate([p2d, conf], -1).astype(np.float32)


def test_estimate_translation_matches_whmr_tpu(monkeypatch):
    joints, kp = _lsq_inputs(np.random.RandomState(4))
    want = jcam.estimate_translation(jnp.asarray(joints), jnp.asarray(kp), 1000.0, (256.0, 256.0))
    got = tcam.estimate_translation(t(joints), t(kp), 1000.0, (256.0, 256.0))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)

    # A singular system (no confident joint in sample 1): non-finite values
    # through solve_ex, no exception and no call of `solve`, which raises
    # there and waits for the device to check.
    kp[1, :, 2] = 0.0

    def refuse(*a, **k):
        raise AssertionError("estimate_translation must not call torch.linalg.solve")

    monkeypatch.setattr(torch.linalg, "solve", refuse)
    got = n(tcam.estimate_translation(t(joints), t(kp), 1000.0, (256.0, 256.0)))
    want = n(jcam.estimate_translation(jnp.asarray(joints), jnp.asarray(kp), 1000.0, (256.0, 256.0)))
    assert not np.isfinite(got[1]).any() and not np.isfinite(want[1]).any()
    np.testing.assert_allclose(got[[0, 2, 3]], want[[0, 2, 3]], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(n(tgt.gt_camera_from_cam_t(t(got))), n(jgt.gt_camera_from_cam_t(jnp.asarray(got))))


def test_iuv_codec_matches_whmr_tpu():
    rng = np.random.RandomState(5)
    part = rng.randint(0, 25, (2, 6, 5)).astype(np.float32)
    part[0, 0, :] = np.arange(5) + 0.5  # halves: round half to even on both sides
    img = np.stack([part / 24.0, rng.rand(2, 6, 5), rng.rand(2, 6, 5)], -1).astype(np.float32)
    got, want = tiuv.iuv_img2map(t(img)), jiuv.iuv_img2map(jnp.asarray(img))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(n(got[k]), n(want[k]), err_msg=k)
    maps = [rng.randn(2, 6, 5, k).astype(np.float32) for k in (25, 25, 25, 15)]
    for ann in (None, maps[3]):
        args = maps[:3] + ([] if ann is None else [ann])
        np.testing.assert_array_equal(
            n(tiuv.iuv_map2img(*(t(a) for a in args))), n(jiuv.iuv_map2img(*(jnp.asarray(a) for a in args)))
        )
