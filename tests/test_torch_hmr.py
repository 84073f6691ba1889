"""The HMR baseline (`regressor="hmr"`): whmr_tpu_torch against whmr_tpu
on flax variables drawn with numpy in the shapes of whmr_tpu's init
(`torch_port_util.numpy_variables`) and carried across by
`state_dict_from_flax`: the model, its loss, its train step and
`run_evaluation`. The Trainer and the CLIs with it are in
test_torch_hmr_trainer.py.

Tolerances: the eval forward and the loss in fp32, atol 1e-4; the metric
protocol 1e-4 relative. The train step is held in float64 on both sides
(the model, the constants and the batch): in fp32 the ResNet-50's
batch-statistics BatchNorm at B=4 amplifies the rounding of its
reductions about a million times (an fp32 port step and a float64
whmr_tpu step differ by 20% on layer4's gradients; float64 on both sides
agree to 5e-8), so the gradient is held leaf by leaf through Adam's
moments, mu and nu within 1e-6 of each leaf's own largest, and the
BatchNorm statistics within 1e-6.

Dropout is the identity on both sides in the step (flax's
`nn.Dropout.__call__` patched, the port's `Dropout` at p=0).
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.inference import evaluate as jeval
from whmr_tpu.models import regressor as jreg
from whmr_tpu.models.hmr import HMR as JHMR
from whmr_tpu.training import losses as jlosses
from whmr_tpu.training import train_step as jts
from whmr_tpu.utils.testing import make_example_train_batch, tiny_config
from whmr_tpu_torch.inference.evaluate import run_evaluation
from whmr_tpu_torch.models import layers as tlayers
from whmr_tpu_torch.data.assets import synthetic_smpl_assets as t_assets
from whmr_tpu_torch.models.hmr import HMR
from whmr_tpu_torch.models.whmr import body_consts_from_assets
from whmr_tpu_torch.training import losses as tlosses
from whmr_tpu_torch.training import train_step as tts
from whmr_tpu_torch.training.trainer import Trainer
from whmr_tpu_torch.utils import testing as ttesting
from whmr_tpu_torch.utils.convert import state_dict_from_flax

from torch_port_util import (  # noqa: F401 (autouse fixture)
    float64_module,
    n,
    numpy_variables,
    release_memory,
    t,
    to_float64,
)

B = 4
HW = (128, 96)  # HMR pools its map: any crop size runs


def _batch(seed=1):
    batch = make_example_train_batch(tiny_config(), B, seed=seed)
    rng = np.random.RandomState(seed)
    batch["img"] = rng.randn(B, *HW, 3).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def carried():
    consts = jreg.body_consts_from_assets(j_assets(0))
    variables = numpy_variables(lambda c, x: JHMR().init(jax.random.PRNGKey(0), c, x), consts,
                                jnp.zeros((2, *HW, 3), jnp.float32))
    return consts, variables, state_dict_from_flax(variables)


@pytest.fixture(scope="module")
def tconsts():
    return body_consts_from_assets(t_assets(0))


def _port(sd):
    """The port's HMR on the carried weights, in eval mode (as
    `build_hmr` returns it; its seeded init is overwritten here)."""
    model = HMR()
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_hmr_names_and_forward_match_whmr_tpu(carried, tconsts):
    consts, variables, sd = carried
    x = _batch()["img"]
    want = jax.jit(lambda v, c, x: JHMR().apply(v, c, x))(variables, consts, jnp.asarray(x))
    model = _port(sd)
    # the reference's keys: the trunk's and the regressor's, top-level
    assert {"conv1.weight", "layer4.2.bn3.running_var", "fc1.weight", "decpose.bias"} <= set(sd)
    assert model.fc1.in_features == 2048 + 144 + 13
    with torch.no_grad():
        got = model(tconsts, t(x))
    assert got[0].shape == (B, 24, 3, 3) and got[1].shape == (B, 10) and got[2].shape == (B, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), atol=1e-4)
    with pytest.raises(ValueError, match="model.train"):
        model(tconsts, t(x), train=True)


def test_hmr_loss_matches_whmr_tpu():
    rng = np.random.RandomState(0)
    batch = _batch()
    batch["has_smpl"][1] = 0.0
    batch["has_pose_3d"][2] = 0.0
    rot = np.linalg.qr(rng.randn(B * 24, 3, 3))[0].reshape(B, 24, 3, 3).astype(np.float32)
    betas = rng.randn(B, 10).astype(np.float32)
    cam = np.concatenate([rng.uniform(0.5, 1.2, (B, 1)), rng.randn(B, 2) * 0.1], 1).astype(np.float32)
    kp2d = rng.uniform(-1, 1, (B, 49, 2)).astype(np.float32)
    kp3d = rng.randn(B, 49, 3).astype(np.float32)
    cfg = tiny_config().with_overrides(**{"loss.kp_2d_w": 300.0})
    tcfg = ttesting.tiny_config().with_overrides(**{"loss.kp_2d_w": 300.0})
    want = jlosses.hmr_loss(cfg, *map(jnp.asarray, (rot, betas, cam, kp2d, kp3d)),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    got = tlosses.hmr_loss(tcfg, *map(t, (rot, betas, cam, kp2d, kp3d)), {k: t(v) for k, v in batch.items()})
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_hmr_train_step_matches_whmr_tpu_float64(carried, tconsts):
    _, variables, sd = carried
    batch = _batch()
    cfg = tiny_config().with_overrides(**{"loss.kp_2d_w": 300.0})
    tcfg = ttesting.tiny_config().with_overrides(**{"loss.kp_2d_w": 300.0})
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
        params = f64(variables["params"])
        tx = jts.make_optimizer(cfg)
        state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=f64(variables["batch_stats"]), opt_state=tx.init(params), tx=tx)
        jconsts = jreg.body_consts_from_assets(j_assets(0), dtype=jnp.float64)
        fn = jax.jit(lambda s, c, b: jts.hmr_train_step(cfg, JHMR(dtype=jnp.float64), s, c, b,
                                                         jax.random.PRNGKey(0)))
        jstate, jmetrics = fn(state, jconsts, f64({k: jnp.asarray(v) for k, v in batch.items()}))
        jmu, jnu = jstate.opt_state[0].mu, jstate.opt_state[0].nu
        jmu, jnu, jstats, jmetrics = jax.device_get((jmu, jnu, jstate.batch_stats, jmetrics))

    model = float64_module(_port(sd))
    for m in model.modules():
        if isinstance(m, tlayers.Dropout):
            m.p = 0.0
    tstate = tts.create_train_state(tcfg, model)
    tstate, metrics = tts.hmr_train_step(tcfg, model, tstate, to_float64(tconsts),
                                         to_float64({k: t(v) for k, v in batch.items()}))
    assert tstate.step == 1 and tstate.opt_state.count == 1
    assert metrics.keys() == jmetrics.keys()
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-6, err_msg=k)
    names = list(tstate.params)
    for moment, jtree in (("mu", jmu), ("nu", jnu)):
        want = state_dict_from_flax({"params": jtree, "batch_stats": jstats})
        for k, got in zip(names, getattr(tstate.opt_state, moment)):
            w = want[k].numpy()
            scale = np.abs(w).max()
            assert scale > 0, k
            assert np.abs(got.numpy() - w).max() <= 1e-6 * scale, (moment, k)
    want = state_dict_from_flax({"params": jmu, "batch_stats": jstats})
    for k, v in tstate.batch_stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


def test_grad_accum_is_refused(tmp_path):
    cfg = ttesting.tiny_config().with_overrides(**{"train.grad_accum": 2})
    with pytest.raises(ValueError, match="--grad_accum is not supported with --regressor hmr"):
        Trainer(cfg, str(tmp_path), device="cpu", regressor="hmr")


def _eval_batches(seed=3, n_batches=2):
    for i in range(n_batches):
        batch = _batch(seed + i)
        yield {"img": batch["img"], "pose": batch["pose"], "betas": batch["betas"],
               "valid": np.array([1, 1, 0, 1], np.float32)}


def test_run_evaluation_matches_whmr_tpu(carried, tconsts, tmp_path):
    consts, variables, sd = carried
    want = jeval.run_evaluation(
        tiny_config(), JHMR(), variables, consts,
        ({k: jnp.asarray(v) for k, v in b.items()} for b in _eval_batches()),
        log_every=0, regressor="hmr", result_file=str(tmp_path / "jax.npz"),
    )
    model = _port(sd)
    got = run_evaluation(ttesting.tiny_config(), model, tconsts,
                         ({k: t(v) for k, v in b.items()} for b in _eval_batches()),
                         log_every=0, regressor="hmr", result_file=str(tmp_path / "port.npz"))
    assert got["count"] == want["count"] == 6
    for k in ("mpjpe", "pa_mpjpe", "pve"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    jd, td = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert set(jd.files) == set(td.files)
    for k in jd.files:
        np.testing.assert_allclose(td[k], jd[k], atol=1e-4, err_msg=k)
    assert np.abs(td["pose"]).max() > 0  # the axis-angle pose, not zeros
    # a model of the other kind is refused
    with pytest.raises(ValueError, match="does not score"):
        run_evaluation(ttesting.tiny_config(), model, tconsts, [], regressor="pymaf_net")
