"""whmr_tpu_torch.training.losses against whmr_tpu.training.losses: the
same random predictions and batch through `whmr_loss`, term by term, in
fp32, within 1e-5 relative (sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest

from whmr_tpu.ops.iuv import _ANN_MATRIX
from whmr_tpu.training import losses as jl
from whmr_tpu.utils.testing import make_example_train_batch, tiny_config
from whmr_tpu_torch.training import losses as tl
from whmr_tpu_torch.utils import testing as ttesting

from torch_port_util import release_memory, n, t  # noqa: F401 (autouse fixture)

B, HM = 3, (8, 6)


def _preds(rng, n_iter=3):
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    smpl_out = [{}]
    for _ in range(n_iter):
        smpl_out.append({
            "rotmat": f(B, 24, 3, 3), "pred_shape": f(B, 10), "pred_cam": np.abs(f(B, 3)) * 0.3,
            "kp_2d": f(B, 49, 2), "kp_2d_w": f(B, 49, 2), "kp_3d": f(B, 49, 3) * 0.3,
            "verts": f(B, 6890, 3) * 0.3, "sub_verts": f(B, 1723, 3) * 0.3, "temp_verts": f(B, 431, 3) * 0.3,
            "focal_length": 1400 + 100 * f(B),
        })
    dp = {k: f(B, *HM, c) * 2 for k, c in (("predict_u", 25), ("predict_v", 25),
                                            ("predict_uv_index", 25), ("predict_ann_index", 15))}
    return {"smpl_out": smpl_out, "dp_out": [dp], "dpth_out": [f(B, *HM, 1)]}


def _uvia(rng):
    part = rng.randint(0, 25, (B, *HM))
    index = np.eye(25, dtype=np.float32)[part]
    ann = index @ _ANN_MATRIX
    u, v = index * rng.rand(B, *HM, 1), index * rng.rand(B, *HM, 1)
    return {"u": u.astype(np.float32), "v": v.astype(np.float32), "index": index, "ann": ann.astype(np.float32)}


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(v, fn) for v in x]
    return fn(x)


@pytest.mark.parametrize("variant", ["default", "all_terms", "no_valid"])
def test_whmr_loss_matches_whmr_tpu(variant):
    rng = np.random.RandomState(0)
    over = {}
    if variant == "all_terms":
        over = {"loss.kp_2d_w": 300.0, "pymaf.focal_supv_on": True, "pymaf.depth_supv_on": True}
    jcfg, tcfg = tiny_config().with_overrides(**over), ttesting.tiny_config().with_overrides(**over)
    batch = make_example_train_batch(jcfg, B, seed=1)
    batch["has_pose_3d"] = np.array([1, 0, 1], np.float32)
    batch["has_smpl"] = np.zeros(B, np.float32) if variant == "no_valid" else np.array([1, 1, 0], np.float32)
    preds = _preds(rng)
    gt = [rng.randn(B, v, 3).astype(np.float32) * 0.3 for v in (6890, 1723, 431)]
    uvia = _uvia(rng)
    depth = rng.randn(B, *HM, 1).astype(np.float32) if variant == "all_terms" else None

    want = jl.whmr_loss(jcfg, _tree(preds, jnp.asarray), _tree(batch, jnp.asarray), *map(jnp.asarray, gt),
                        uvia_gt=_tree(uvia, jnp.asarray), depth_gt=None if depth is None else jnp.asarray(depth))
    got = tl.whmr_loss(tcfg, _tree(preds, t), _tree(batch, t), *map(t, gt),
                       uvia_gt=_tree(uvia, t), depth_gt=None if depth is None else t(depth))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    if variant == "all_terms":
        assert {"loss_keypoints_world_1", "loss_focal_length_3", "loss_Depth"} <= set(got)
    if variant == "no_valid":
        assert float(got["loss_regr_pose_1"]) == 0.0 and float(got["loss_IndexUV"]) == 0.0
