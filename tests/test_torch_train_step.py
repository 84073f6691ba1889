"""The slice as a whole: whmr_tpu_torch's train step against whmr_tpu's at
`tiny_config`, fp32, B=3, with the render consts of the synthetic assets
(so the GT camera fit, the GT IUV render and the aux losses run), on
`model.init` variables carried across by `state_dict_from_flax`.

Dropout is the identity on both sides, in these tests only: flax's
`nn.Dropout.__call__` is patched for whmr_tpu and the port's `Dropout`
modules get p=0; tiny_config's drop path rate is 0. Random draws are
compared by their keep rates instead.

Tolerances: loss terms and grad_norm 1e-4 relative; each gradient leaf
within 1e-3 of that leaf's largest magnitude (the frameworks sum in other
orders); the updated
BatchNorm buffers 1e-5. The optimizer is held against whmr_tpu's
`make_optimizer` on IDENTICAL gradients (1e-6 relative): after a whole step,
Adam's first update is about lr * sign(g), so tiny gradient differences
would show as differences of the order of lr.
"""

import copy

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.models import regressor as jreg
from whmr_tpu.models.whmr import WHMR as JWHMR
from whmr_tpu.training import gt_renderer as jgt
from whmr_tpu.training import train_step as jts
from whmr_tpu.utils.testing import make_example_inputs, make_example_train_batch, tiny_config
from whmr_tpu_torch.data.assets import synthetic_smpl_assets as t_assets
from whmr_tpu_torch.models import layers as tlayers
from whmr_tpu_torch.models import vit as tvit
from whmr_tpu_torch.models import whmr as twhmr
from whmr_tpu_torch.training import gt_renderer as tgt
from whmr_tpu_torch.training import train_step as tts
from whmr_tpu_torch.utils import testing as ttesting
from whmr_tpu_torch.utils.convert import state_dict_from_flax

from torch_port_util import release_memory, n, random_batch_stats, t  # noqa: F401 (autouse fixture)

BATCH = 3
_BN_KEYS = ("running_mean", "running_var", "num_batches_tracked")


def _cfgs(stage):
    over = {"train.stage": stage}
    if stage == 1:
        # The world keypoints carry stage 1's gradient gating.
        over["loss.kp_2d_w"] = 300.0
    return tiny_config().with_overrides(**over), ttesting.tiny_config().with_overrides(**over)


@pytest.fixture(scope="module")
def variables():
    cfg = tiny_config()
    args = {k: jnp.asarray(v) for k, v in make_example_inputs(cfg, BATCH).items()}
    args["full_x"] = jnp.zeros((BATCH, 64, 64, 3), jnp.float32)
    consts = jreg.body_consts_from_assets(j_assets(0))
    v = jax.jit(lambda c, a: JWHMR(cfg).init(jax.random.PRNGKey(0), c, **a))(consts, args)
    return consts, random_batch_stats(jax.device_get(v))


@pytest.fixture(scope="module")
def render_consts():
    return jgt.build_render_consts(j_assets(0)), tgt.build_render_consts(t_assets(0))


def _batch(cfg, seed=1):
    # Keypoints from the GT joints, so that the GT camera frames the body.
    consts = twhmr.body_consts_from_assets(t_assets(0))
    return ttesting.make_keypoints_consistent(consts, make_example_train_batch(cfg, BATCH, seed=seed))


def _port_model(tcfg, sd):
    model, consts = twhmr.build_model(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(sd, strict=True)
    for m in model.modules():
        if isinstance(m, tlayers.Dropout):
            m.p = 0.0
    return model, consts


def _jax_step(cfg, consts, variables, batch, rc):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        fn = jax.jit(lambda p, s, c, b: jts._microbatch_grads(
            cfg, JWHMR(cfg), p, s, c, b, jax.random.PRNGKey(0), render_consts=rc))
        grads, losses, stats = fn(variables["params"], variables["batch_stats"], consts,
                                  jax.tree_util.tree_map(jnp.asarray, batch))
    grads, losses, stats = jax.device_get((grads, losses, stats))
    return grads, losses, stats, float(optax.global_norm(grads))


def _split(sd):
    return ({k: v for k, v in sd.items() if not k.endswith(_BN_KEYS)},
            {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))})


@pytest.mark.parametrize("stage", [2, 1])
def test_train_step_matches_whmr_tpu(variables, render_consts, stage):
    jconsts, var = variables
    jcfg, tcfg = _cfgs(stage)
    batch = _batch(jcfg)
    model, consts = _port_model(tcfg, state_dict_from_flax(var))
    tb = {k: t(v) for k, v in batch.items()}
    # whmr_tpu takes the port's GT maps as given targets, and the port's
    # step renders its own: the step is compared apart from the render,
    # whose edge pixels follow fp32 rounding (test_torch_gt_renderer.py).
    uvia_gt = tts.gt_targets(tcfg, consts, tb, render_consts[1])[3]
    jbatch = dict(batch, uvia_gt={k: n(v) for k, v in uvia_gt.items()})
    jgrads, jlosses, jstats, jnorm = _jax_step(jcfg, jconsts, var, jbatch, render_consts[0])
    want_grads, _ = _split(state_dict_from_flax({"params": jgrads, "batch_stats": jstats}))
    _, want_stats = _split(state_dict_from_flax({"params": var["params"], "batch_stats": jstats}))

    state = tts.create_train_state(tcfg, model)
    grads, losses = tts._microbatch_grads(tcfg, model, state, consts, tb, None, render_consts[1])

    assert losses.keys() == jlosses.keys()
    for k in jlosses:
        np.testing.assert_allclose(n(losses[k]), n(jlosses[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(n(tts.global_norm(list(grads.values()))), jnorm, rtol=1e-4)
    assert grads.keys() == want_grads.keys()
    zero_port, zero_jax = set(), set()
    # A leaf whose gradient vanishes in exact arithmetic (a bias feeding a
    # batch-statistics BatchNorm) holds only rounding noise: its scale is
    # floored at 1e-6 of the model's largest gradient.
    floor = 1e-6 * max(np.abs(g.numpy()).max() for g in want_grads.values())
    for k, want in want_grads.items():
        got, want = n(grads[k]), want.numpy()
        scale = max(np.abs(want).max(), floor)
        assert np.abs(got - want).max() <= 1e-3 * scale, (k, np.abs(got - want).max(), scale)
        if not np.any(got):
            zero_port.add(k)
        if not np.any(want):
            zero_jax.add(k)
    # The detached inputs get zero gradient exactly where whmr_tpu's do.
    assert zero_port == zero_jax
    assert any(k.startswith("conv.") for k in zero_jax) == (stage == 2)
    for k, want in want_stats.items():
        np.testing.assert_allclose(n(state.batch_stats[k]), want.numpy(), atol=1e-5, err_msg=k)


def test_optimizer_matches_optax_on_identical_grads():
    """Clip (triggered on some steps, not others), Adam and the step decay
    (boundary at step 2 = epoch 1 x 2 steps) against whmr_tpu's
    make_optimizer over four steps."""
    over = {"train.grad_clip_norm": 3.0, "train.lr_decay_epochs": (1,), "train.base_lr": 1e-2}
    jcfg, tcfg = tiny_config().with_overrides(**over), ttesting.tiny_config().with_overrides(**over)
    rng = np.random.RandomState(0)
    shapes = [(7, 3), (5,), (2, 3, 4)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = jts.make_optimizer(jcfg, steps_per_epoch=2)
    jp, jstate = [jnp.asarray(p) for p in params], None
    jstate = tx.init(jp)
    opt = tts.make_optimizer(tcfg, steps_per_epoch=2)
    tp = [torch.tensor(p) for p in params]
    tstate = opt.init(tp)
    for step, gscale in enumerate((0.1, 5.0, 0.2, 5.0)):
        grads = [(rng.randn(*s) * gscale).astype(np.float32) for s in shapes]
        before = [p.clone() for p in tp]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tstate = opt.step(tp, [torch.tensor(g) for g in grads], tstate)
        assert tstate.count == step + 1
        for got, want, old, u in zip(tp, jp, before, updates):
            np.testing.assert_allclose(n(got), n(want), rtol=1e-6)
            # got - old carries the rounding of O(1) parameters: a few ulps.
            np.testing.assert_allclose(n(got - old), n(u), rtol=1e-5, atol=5e-7)


def test_accum_matches_manual_loop():
    """train_step_accum over K=2 microbatches equals averaging the two
    microbatch gradients by hand, BatchNorm statistics chained, one step."""
    tcfg = ttesting.tiny_config()
    model, consts = twhmr.build_model(tcfg, dtype=torch.float32, device="cpu", seed=3)
    twin = copy.deepcopy(model)
    batch = {k: t(v) for k, v in ttesting.make_example_train_batch(tcfg, 4, seed=2).items()}
    micro = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in batch.items()}

    state = tts.create_train_state(tcfg, model)
    state, metrics = tts.train_step_accum(tcfg, model, state, consts, micro, torch.Generator().manual_seed(5))

    ref = tts.create_train_state(tcfg, twin)
    g = torch.Generator().manual_seed(5)
    parts = [tts._microbatch_grads(tcfg, twin, ref, consts, {k: v[i] for k, v in micro.items()}, g)
             for i in range(2)]
    grads = {k: (parts[0][0][k] + parts[1][0][k]) * 0.5 for k in parts[0][0]}
    ref.apply_gradients(grads)
    assert state.step == ref.step == 1
    for k in state.params:
        np.testing.assert_allclose(n(state.params[k]), n(ref.params[k]), rtol=1e-6, atol=1e-9, err_msg=k)
    for k in state.batch_stats:
        np.testing.assert_allclose(n(state.batch_stats[k]), n(ref.batch_stats[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(n(metrics["loss"]), n((parts[0][1]["loss"] + parts[1][1]["loss"]) / 2),
                               rtol=1e-6)
    np.testing.assert_allclose(n(metrics["grad_norm"]), n(tts.global_norm(list(grads.values()))), rtol=1e-6)


def test_ema_updates_toward_params():
    tcfg = ttesting.tiny_config().with_overrides(**{"train.ema_decay": 0.5})
    model, _ = twhmr.build_model(tcfg, dtype=torch.float32, device="cpu")
    state = tts.create_train_state(tcfg, model)
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    rng = np.random.RandomState(0)
    state.apply_gradients({k: torch.tensor(rng.randn(*p.shape).astype(np.float32)) for k, p in p0.items()})
    for k, p in state.params.items():
        np.testing.assert_allclose(n(state.ema_params[k]), n(0.5 * p0[k] + 0.5 * p), rtol=1e-6, atol=1e-7)
    assert tts.create_train_state(ttesting.tiny_config(), model).ema_params is None


def test_device_normalize_uint8_matches_whmr_tpu():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (2, 8, 6, 3)).astype(np.uint8)
    noise = rng.uniform(0.6, 1.4, (2, 3)).astype(np.float32)
    want = jts.device_normalize(jnp.asarray(img), jnp.asarray(noise))
    got = tts.device_normalize(torch.from_numpy(img), torch.from_numpy(noise))
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)
    batch = {"img": torch.from_numpy(img), "pixel_noise": torch.from_numpy(noise)}
    np.testing.assert_array_equal(n(tts._model_input(batch)), n(got))


@pytest.mark.parametrize("kind", ["drop_path", "dropout"])
def test_keep_rates_from_a_seeded_generator(kind):
    p = 0.3 if kind == "drop_path" else 0.5
    mod = tvit.DropPath(p) if kind == "drop_path" else tlayers.Dropout(p)
    x = torch.ones(20000, 4, 3)
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        outs[dtype] = mod.train()(x.to(dtype), torch.Generator().manual_seed(7))
    kept = outs[torch.float32] != 0
    # The same draws whatever the compute dtype; kept values scaled by 1/keep.
    assert torch.equal(kept, outs[torch.bfloat16] != 0)
    np.testing.assert_allclose(n(outs[torch.float32][kept]), 1.0 / (1.0 - p), rtol=1e-6)
    if kind == "drop_path":
        assert bool((kept == kept[:, :1, :1]).all())  # one draw per sample
    rate = kept.float().mean().item()
    assert abs(rate - (1.0 - p)) < 0.01, rate
    assert torch.equal(mod.eval()(x), x)
