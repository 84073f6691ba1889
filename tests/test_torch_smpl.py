"""whmr_tpu_torch SMPL forward and regressor output bundle against whmr_tpu,
fp32, atol 1e-5, on the synthetic assets."""

import jax.numpy as jnp
import numpy as np
import pytest

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.models import regressor as jreg
from whmr_tpu.models import smpl as jsmpl
from whmr_tpu.ops.rotation import batch_rodrigues
from whmr_tpu_torch.data.assets import synthetic_smpl_assets as t_assets
from whmr_tpu_torch.models import regressor as treg
from whmr_tpu_torch.models import smpl as tsmpl

from torch_port_util import release_memory, n, t  # noqa: F401 (autouse fixture)

ATOL = 1e-5


@pytest.fixture(scope="module")
def consts():
    return jreg.body_consts_from_assets(j_assets(0)), treg.body_consts_from_assets(t_assets(0))


def _pose(seed, b=3):
    rng = np.random.RandomState(seed)
    betas = (rng.randn(b, 10) * 0.8).astype(np.float32)
    rot = np.asarray(batch_rodrigues(jnp.asarray((rng.randn(b * 24, 3) * 0.4).astype(np.float32))))
    return betas, rot.reshape(b, 24, 3, 3)


def test_body_consts_equal(consts):
    jc, tc = consts
    for name in ("dmap0", "dmap1", "ssm", "j_regressor_h36m", "mean_pose", "mean_shape", "mean_cam"):
        np.testing.assert_allclose(n(getattr(tc, name)), n(getattr(jc, name)), atol=0, err_msg=name)


def test_smpl_forward(consts):
    jc, tc = consts
    betas, rot = _pose(0)
    want = jsmpl.smpl_forward(jc.smpl, jnp.asarray(betas), jnp.asarray(rot))
    got = tsmpl.smpl_forward(tc.smpl, t(betas), t(rot))
    for field in want._fields:
        np.testing.assert_allclose(n(getattr(got, field)), n(getattr(want, field)), atol=ATOL, err_msg=field)
    jv, tv = want.vertices, got.vertices
    np.testing.assert_allclose(
        n(tsmpl.select_h36m_j14(tc.j_regressor_h36m, tv)),
        n(jsmpl.select_h36m_j14(jc.j_regressor_h36m, jv)), atol=ATOL,
    )
    for a, b in zip(tsmpl.joints_from_vertices(tc.smpl, tv), jsmpl.joints_from_vertices(jc.smpl, jv)):
        np.testing.assert_allclose(n(a), n(b), atol=ATOL)


@pytest.mark.parametrize("with_cam,with_h36m", [(False, False), (True, False), (True, True)])
def test_smpl_out_bundle(consts, with_cam, with_h36m):
    jc, tc = consts
    rng = np.random.RandomState(1)
    betas, rot = _pose(2)
    b = betas.shape[0]
    cam = np.stack([rng.uniform(0.7, 1.1, b), rng.randn(b) * 0.1, rng.randn(b) * 0.1], -1).astype(np.float32)
    state = dict(
        bbox_info=rng.randn(b, 5).astype(np.float32) * 0.1,
        center=rng.uniform(200, 900, (b, 2)).astype(np.float32),
        scale=rng.uniform(0.8, 2.4, b).astype(np.float32),
        bbox_height=rng.uniform(150, 500, b).astype(np.float32),
        orig_shape=np.tile(np.array([[720.0, 1280.0]], np.float32), (b, 1)),
        tz=rng.uniform(2, 9, b).astype(np.float32),
    )
    jstate = jreg.CamState(**{k: jnp.asarray(v) for k, v in state.items()}) if with_cam else None
    tstate = treg.CamState(**{k: t(v) for k, v in state.items()}) if with_cam else None
    want, _ = jreg._smpl_out_bundle(
        jc, jnp.asarray(rot), jnp.asarray(betas), jnp.asarray(cam), jstate, (256, 256),
        False, 2, jc.j_regressor_h36m if with_h36m else None,
    )
    got, _ = treg._smpl_out_bundle(
        tc, t(rot), t(betas), t(cam), tstate, (256, 256),
        tc.j_regressor_h36m if with_h36m else None,
    )
    assert want.keys() == got.keys()
    for k in want:
        # kp_2d_w and pred_cam_t are O(1-10); focal_length is O(1e3).
        tol = ATOL * 100 if k == "focal_length" else ATOL
        np.testing.assert_allclose(n(got[k]), n(want[k]), atol=tol, rtol=1e-6, err_msg=k)


def test_forward_init(consts):
    jc, tc = consts
    want = jreg.forward_init(jc, 2)
    got = treg.forward_init(tc, 2)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(n(got[k]), n(want[k]), atol=ATOL, err_msg=k)
