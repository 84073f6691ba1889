"""whmr_tpu_torch.ops (rotation, camera, grid sample) against whmr_tpu.ops,
fp32, atol 1e-5. Random rotations keep their angle below 0.9 pi, away from
the quaternion branch switch at pi."""

import jax.numpy as jnp
import numpy as np
import pytest

from whmr_tpu.ops import camera as jcam
from whmr_tpu.ops import grid_sample as jgs
from whmr_tpu.ops import rotation as jrot
from whmr_tpu_torch.ops import camera as tcam
from whmr_tpu_torch.ops import grid_sample as tgs
from whmr_tpu_torch.ops import rotation as trot

from torch_port_util import release_memory, n, t  # noqa: F401 (autouse fixture)

ATOL = 1e-5


def _axis_angle(rng, count):
    axis = rng.randn(count, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return (axis * rng.uniform(0.05, 0.9 * np.pi, (count, 1))).astype(np.float32)


def _rotmats(rng, count):
    return np.asarray(jrot.batch_rodrigues(jnp.asarray(_axis_angle(rng, count))))


@pytest.mark.parametrize(
    "name,make",
    [
        ("batch_rodrigues", lambda r: _axis_angle(r, 64)),
        ("quat_to_rotmat", lambda r: r.randn(64, 4).astype(np.float32)),
        ("rot6d_to_rotmat", lambda r: r.randn(64, 6).astype(np.float32)),
        ("rotmat_to_rot6d", lambda r: _rotmats(r, 64)),
        ("unbiased_gram_schmidt", lambda r: (_rotmats(r, 64) + 0.05 * r.randn(64, 3, 3)).astype(np.float32).reshape(16, 4, 3, 3)),
        ("rotmat_to_quat", lambda r: _rotmats(r, 64)),
        ("quat_to_angle_axis", lambda r: r.randn(64, 4).astype(np.float32)),
        ("rotmat_to_angle_axis", lambda r: _rotmats(r, 64)),
        ("euler_to_rotmat", lambda r: r.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)),
    ],
)
def test_rotation(name, make):
    x = make(np.random.RandomState(0))
    want = getattr(jrot, name)(jnp.asarray(x))
    got = getattr(trot, name)(t(x))
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


def test_rotation_identity_and_small_angle():
    eye = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    np.testing.assert_allclose(n(trot.rotmat_to_angle_axis(t(eye))), 0.0, atol=ATOL)
    np.testing.assert_allclose(
        n(trot.rotmat_to_angle_axis(t(eye))), n(jrot.rotmat_to_angle_axis(jnp.asarray(eye))), atol=ATOL
    )


def _cam_inputs(rng, b=5, j=49):
    pts = rng.randn(b, j, 3).astype(np.float32) * 0.3
    trans = np.stack([rng.randn(b) * 0.2, rng.randn(b) * 0.2, rng.uniform(4, 8, b)], -1).astype(np.float32)
    focal = rng.uniform(500, 2000, b).astype(np.float32)
    center = rng.uniform(100, 600, (b, 2)).astype(np.float32)
    cam = np.stack([rng.uniform(0.6, 1.2, b), rng.randn(b) * 0.1, rng.randn(b) * 0.1], -1).astype(np.float32)
    return pts, trans, focal, center, cam


@pytest.mark.parametrize("focal", ["per_sample", "scalar"])
def test_projections(focal):
    pts, trans, focals, center, cam = _cam_inputs(np.random.RandomState(1))
    f = focals if focal == "per_sample" else np.float32(1000.0)
    want = jcam.perspective_projection(jnp.asarray(pts), None, jnp.asarray(trans), jnp.asarray(f), jnp.asarray(center))
    got = tcam.perspective_projection(t(pts), t(trans), t(f), t(center))
    np.testing.assert_allclose(n(got), n(want), atol=1e-3, rtol=1e-6)  # pixels, O(1e3)
    want = jcam.weak_perspective_projection(jnp.asarray(pts), jnp.asarray(cam), (256, 256))
    got = tcam.weak_perspective_projection(t(pts), t(cam), (256, 256))
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


def test_convert_pare_to_full_img_cam():
    rng = np.random.RandomState(2)
    _, _, _, center, cam = _cam_inputs(rng)
    bbox_h = rng.uniform(150, 500, 5).astype(np.float32)
    tz = rng.uniform(2, 9, 5).astype(np.float32)
    img_w, img_h = np.full(5, 1280.0, np.float32), np.full(5, 720.0, np.float32)
    args = (cam, bbox_h, center, img_w, img_h)
    want = jcam.convert_pare_to_full_img_cam(*map(jnp.asarray, args), tz=jnp.asarray(tz))
    got = tcam.convert_pare_to_full_img_cam(*map(t, args), t(tz))
    np.testing.assert_allclose(n(got), n(want), atol=ATOL, rtol=1e-6)


def test_cam_angle_decoding():
    rng = np.random.RandomState(3)
    logits = [rng.randn(4, 256).astype(np.float32) * 3 for _ in range(3)]
    np.testing.assert_allclose(
        n(tcam.softargmax_1d(t(logits[0]))), n(jcam.softargmax_1d(jnp.asarray(logits[0]))), atol=ATOL
    )
    want = jcam.decode_cam_angles(*map(jnp.asarray, logits))
    got = tcam.decode_cam_angles(*map(t, logits))
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), atol=ATOL)
    np.testing.assert_allclose(
        n(tcam.soft_idx_to_angle(t(logits[0]), 0.2, 2.1)),
        n(jcam.soft_idx_to_angle(jnp.asarray(logits[0]), 0.2, 2.1)), atol=ATOL,
    )


@pytest.mark.parametrize("hw", [(16, 12), (7, 9)])
def test_grid_sample(hw):
    rng = np.random.RandomState(4)
    feat = rng.randn(3, *hw, 8).astype(np.float32)
    # Inside, on the border, and out of range (zero padding).
    pts = rng.uniform(-1.2, 1.2, (3, 67, 2)).astype(np.float32)
    pts[:, :4] = [[-1, -1], [1, 1], [-1, 1], [1, -1]]
    want = jgs.grid_sample_2d(jnp.asarray(feat), jnp.asarray(pts))
    got = tgs.grid_sample_2d(t(feat), t(pts))
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)


def test_grid_sample_matches_torch_grid_sample():
    import torch
    import torch.nn.functional as F

    rng = np.random.RandomState(5)
    feat = rng.randn(2, 10, 14, 6).astype(np.float32)
    pts = rng.uniform(-1.1, 1.1, (2, 30, 2)).astype(np.float32)
    ref = F.grid_sample(t(feat).permute(0, 3, 1, 2), t(pts)[:, :, None], align_corners=True)
    np.testing.assert_allclose(
        n(tgs.grid_sample_2d(t(feat), t(pts))), n(ref[..., 0].transpose(1, 2)), atol=ATOL
    )
    bf = tgs.grid_sample_2d(t(feat, torch.bfloat16), t(pts, torch.bfloat16))
    assert bf.dtype == torch.bfloat16
