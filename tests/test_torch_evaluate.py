"""Evaluation: the port's Procrustes ops and run_evaluation against whmr_tpu's.

- `batch_compute_similarity_transform` and the metrics on random point sets,
  including mirrored ones (the reflection case, det(U V^T) < 0), within
  1e-5 (fp32 SVDs of two libraries).
- `run_evaluation` at `tiny_config`, fp32, on `model.init` variables carried
  across by `state_dict_from_flax`, over 2 batches, with the J14 and the
  J17 mapper: the metrics within 1e-4 relative and the count exactly. The
  J14 case also scores world-frame GT from `global_pose` under a given
  `cam_rotmat`, gendered GT, and the per-sample dump; the J17 case pads the
  port's batches to a fixed size (rows of valid=0 change nothing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.inference.evaluate import run_evaluation as j_run_evaluation
from whmr_tpu.models import regressor as jreg
from whmr_tpu.models.smpl import smpl_params_from_assets as j_smpl_params
from whmr_tpu.models.whmr import WHMR as JWHMR
from whmr_tpu.ops import procrustes as jp
from whmr_tpu.utils.testing import make_example_inputs, make_example_train_batch, tiny_config
from whmr_tpu_torch.data.assets import synthetic_smpl_assets as t_assets
from whmr_tpu_torch.inference.eval_cli import device_eval_batch
from whmr_tpu_torch.inference.evaluate import run_evaluation
from whmr_tpu_torch.models import whmr as twhmr
from whmr_tpu_torch.models.smpl import smpl_params_from_assets as t_smpl_params
from whmr_tpu_torch.ops import procrustes as tp
from whmr_tpu_torch.utils import testing as ttesting
from whmr_tpu_torch.utils.convert import state_dict_from_flax

from torch_port_util import release_memory, n, random_batch_stats, t  # noqa: F401 (autouse fixture)


def _point_sets(seed, mirror):
    rng = np.random.RandomState(seed)
    s2 = rng.randn(6, 14, 3).astype(np.float32)
    s1 = (1.3 * s2 @ np.linalg.qr(rng.randn(3, 3))[0].T + rng.randn(6, 1, 3) + 0.001 * rng.randn(6, 14, 3))
    if mirror:
        s1[..., 0] *= -1.0
    return s1.astype(np.float32), s2


@pytest.mark.parametrize("mirror", [False, True], ids=["rotation", "reflection"])
def test_procrustes_matches_whmr_tpu(mirror):
    s1, s2 = _point_sets(3, mirror)
    want = jp.batch_compute_similarity_transform(jnp.asarray(s1), jnp.asarray(s2))
    got = tp.batch_compute_similarity_transform(t(s1), t(s2))
    np.testing.assert_allclose(n(got), n(want), atol=1e-5)
    for name in ("mpjpe", "pa_mpjpe", "per_vertex_error"):
        for reduce in ("mean", "none"):
            w = getattr(jp, name)(jnp.asarray(s1), jnp.asarray(s2), reduce=reduce)
            g = getattr(tp, name)(t(s1), t(s2), reduce=reduce)
            np.testing.assert_allclose(n(g), n(w), atol=1e-5, err_msg=f"{name} {reduce}")
    # a mirrored set cannot be aligned exactly: det(R) = +1 is enforced
    assert (float(tp.pa_mpjpe(t(s1), t(s2))) > 1e-2) == mirror


BATCH = 3


@pytest.fixture(scope="module")
def carried():
    cfg = tiny_config()
    args = {k: jnp.asarray(v) for k, v in make_example_inputs(cfg, 2).items()}
    args["full_x"] = jnp.zeros((2, 64, 64, 3), jnp.float32)  # builds CamCalib's variables too
    consts = jreg.body_consts_from_assets(j_assets(0))
    variables = jax.jit(lambda c, a: JWHMR(cfg).init(jax.random.PRNGKey(0), c, **a))(consts, args)
    variables = random_batch_stats(jax.device_get(variables))
    model, tconsts = twhmr.build_model(ttesting.tiny_config(), dtype=torch.float32, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return consts, variables, model, tconsts


def _host_batches(world):
    cfg = tiny_config()
    out = []
    for seed in (11, 12):
        b = make_example_train_batch(cfg, BATCH, seed=seed)
        b = {k: b[k] for k in ("img", "center", "scale", "bbox_height", "orig_shape", "bbox_info",
                               "pose", "betas", "has_smpl")}
        b["has_smpl"][1] = 0.0  # a row that does not count
        if world:
            rng = np.random.RandomState(seed)
            b["cam_rotmat"] = np.linalg.qr(rng.randn(BATCH, 3, 3))[0].astype(np.float32)
            b["cam_rotmat"] *= np.sign(np.linalg.det(b["cam_rotmat"]))[:, None, None]
            b["global_pose"] = b["pose"].copy()
            b["global_pose"][:, :3] += 0.5
            b["gender"] = np.array([0, 1, 2], np.int32)
        out.append(b)
    return out


@pytest.mark.parametrize("mapper", ["j14", "j17"])
def test_run_evaluation_matches_whmr_tpu(carried, tmp_path, mapper):
    jconsts, variables, model, tconsts = carried
    world = mapper == "j14"
    host = _host_batches(world)
    jgendered = tgendered = None
    if world:
        jgendered = {"male": j_smpl_params(j_assets(1)), "female": j_smpl_params(j_assets(2))}
        tgendered = {"male": t_smpl_params(t_assets(1)), "female": t_smpl_params(t_assets(2))}

    def jbatches():
        for hb in host:
            b = {k: jnp.asarray(v) for k, v in hb.items() if k != "has_smpl"}
            if "cam_rotmat" not in b:
                b["cam_rotmat"] = jnp.broadcast_to(jnp.eye(3), (BATCH, 3, 3))
            b["valid"] = jnp.asarray(hb["has_smpl"])
            yield b

    def tbatches():
        for hb in host:
            b, nb = device_eval_batch(hb, extra_keys=("pose", "betas", "gender", "global_pose"), device="cpu")
            b["valid"] = t(hb["has_smpl"])
            yield b

    jfile, tfile = (str(tmp_path / f"{side}.npz") for side in ("jax", "port")) if world else (None, None)
    want = j_run_evaluation(tiny_config(), JWHMR(tiny_config()), variables, jconsts, jbatches(),
                            log_every=0, gendered_smpl=jgendered, joint_mapper=mapper, result_file=jfile)
    model.train()  # run_evaluation evaluates in eval mode and restores the mode
    got = run_evaluation(ttesting.tiny_config(), model, tconsts, tbatches(), log_every=0,
                         gendered_smpl=tgendered, joint_mapper=mapper, result_file=tfile,
                         fixed_batch=None if world else BATCH + 2)
    assert model.training
    assert got["count"] == want["count"] == 4
    for k in ("mpjpe", "pa_mpjpe", "pve"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    if world:
        jd, td = np.load(jfile), np.load(tfile)
        assert set(jd.files) == set(td.files)
        for k in jd.files:
            assert td[k].shape == jd[k].shape, k
            np.testing.assert_allclose(td[k], jd[k], atol=1e-4, err_msg=k)


def test_eval_step_guards():
    model, _ = twhmr.build_model(ttesting.tiny_config(), dtype=torch.float32, device="cpu")
    cfg = ttesting.tiny_config()
    for kw in ({"mesh": object()}, {"regressor": "hmr"}, {"forward_override": lambda *a: a}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            run_evaluation(cfg, model, None, [], **kw)
    b, nb = device_eval_batch({"img": np.zeros((2, 4, 4, 3)), "pose": np.zeros((2, 72)), "junk": np.zeros(2)},
                              extra_keys=("pose",), device="cpu")
    assert nb == 2 and set(b) == {"img", "pose", "cam_rotmat"} and b["img"].dtype == torch.float32
    assert torch.equal(b["cam_rotmat"], torch.eye(3).expand(2, 3, 3))
