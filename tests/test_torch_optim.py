"""`train.fused_adam` (training/optim.py) against whmr_tpu's
`training/optim.py::fused_adam` and against the port's foreach optimizer.

Each case runs four steps on a random tree (fp32 leaves, or bf16 leaves
with fp32 moments), under a step schedule and, in fp32, with the
global-norm clip before it (on some steps above its limit, on others
below), fed IDENTICAL gradients on both sides. Tolerances: fp32
parameters 1e-6 relative and their updates 1e-5 relative (atol 5e-7: an
update is computed beside O(1) parameters), as in
test_torch_train_step.py's optimizer test; bf16 parameters within one
bf16 ulp; the moments within 1e-6 of their largest element (a moment that
changes sign between steps is the difference of rounded terms).
"""

import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from whmr_tpu.training.optim import fused_adam as j_fused_adam
from whmr_tpu_torch.training import train_step as tts
from whmr_tpu_torch.training.optim import FusedAdam, FusedAdamState
from whmr_tpu_torch.training.trainer import Trainer
from whmr_tpu_torch.utils.testing import make_example_train_batch, tiny_config

from torch_port_util import n, release_memory  # noqa: F401 (autouse fixture)

SHAPES = [(7, 3), (5,), (2, 3, 4), (1,)]


def _jax_tx(base_lr, boundaries, gamma, clip):
    sched = optax.piecewise_constant_schedule(base_lr, {b: gamma for b in boundaries}) if boundaries else base_lr
    tx = j_fused_adam(sched)
    return optax.chain(optax.clip_by_global_norm(clip), tx) if clip > 0 else tx


@pytest.mark.parametrize("dtype, base_lr, boundaries, gamma, clip", [
    ("float32", 1e-2, (), 0.1, 0.0),
    ("float32", 1e-2, (2,), 0.1, 3.0),
    ("float32", 3e-3, (1, 3), 0.5, 1.0),
    # bf16 leaves without the clip: optax rounds a bf16 tree's global norm
    # and clipped gradients in bf16, the port scales the fp32 flat buffer
    ("bfloat16", 1e-2, (), 0.1, 0.0),
    ("bfloat16", 3e-3, (1, 3), 0.5, 0.0),
])
def test_fused_adam_matches_whmr_tpu(dtype, base_lr, boundaries, gamma, clip):
    rng = np.random.RandomState(0)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    tx = _jax_tx(base_lr, boundaries, gamma, clip)
    jp = [jnp.asarray(p, jdt) for p in params]
    jstate = tx.init(jp)
    opt = FusedAdam(base_lr, boundaries=boundaries, gamma=gamma, clip_norm=clip)
    tp = [torch.tensor(p).to(tdt) for p in params]
    tstate = opt.init(tp)
    assert isinstance(tstate, FusedAdamState) and tstate.flat_mu.numel() == sum(p.numel() for p in tp)
    for step, gscale in enumerate((0.1, 5.0, 0.2, 5.0)):
        grads = [(rng.randn(*s) * gscale).astype(np.float32) for s in SHAPES]
        before = [p.clone() for p in tp]
        updates, jstate = tx.update([jnp.asarray(g, jdt) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tstate = opt.step(tp, [torch.tensor(g).to(tdt) for g in grads], tstate)
        assert tstate.count == step + 1
        for got, want, old, u in zip(tp, jp, before, updates):
            assert got.dtype == tdt
            if dtype == "float32":
                np.testing.assert_allclose(n(got), n(want), rtol=1e-6)
                np.testing.assert_allclose(n(got - old), n(u), rtol=1e-5, atol=5e-7)
            else:
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(n(want)), 1e-30))) - 7)
                assert np.all(np.abs(n(got) - n(want)) <= ulp)
        fused_state = jstate[-1] if clip > 0 else jstate
        for got, want in ((tstate.flat_mu, fused_state.mu), (tstate.flat_nu, fused_state.nu)):
            assert np.abs(n(got) - n(want)).max() <= 1e-6 * np.abs(n(want)).max()
    # the per-parameter moments are views of the flat buffers
    assert tstate.mu[2].data_ptr() == tstate.flat_mu[5 * 1 + 7 * 3:].data_ptr()
    torch.testing.assert_close(torch.cat([m.reshape(-1) for m in tstate.nu]), tstate.flat_nu, rtol=0, atol=0)


def test_fused_matches_foreach_and_make_optimizer_selects_it():
    cfg = tiny_config().with_overrides(**{"train.fused_adam": True, "train.grad_clip_norm": 2.0,
                                          "train.lr_decay_epochs": (1,), "train.base_lr": 1e-2})
    fused = tts.make_optimizer(cfg, steps_per_epoch=2)
    foreach = tts.make_optimizer(cfg.with_overrides(**{"train.fused_adam": False}), steps_per_epoch=2)
    assert isinstance(fused, FusedAdam) and type(foreach) is tts.Optimizer
    assert fused.boundaries == foreach.boundaries == [2] and fused.clip_norm == 2.0
    rng = np.random.RandomState(1)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    a, b = [torch.tensor(p) for p in params], [torch.tensor(p) for p in params]
    sa, sb = fused.init(a), foreach.init(b)
    for gscale in (0.1, 5.0, 0.2):
        grads = [torch.tensor((rng.randn(*s) * gscale).astype(np.float32)) for s in SHAPES]
        sa, sb = fused.step(a, grads, sa), foreach.step(b, grads, sb)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    for x, y in zip(sa.mu + sa.nu, sb.mu + sb.nu):
        assert (x - y).abs().max() <= 1e-6 * y.abs().max()


@pytest.mark.parametrize("flags", [{"fsdp": True}, {"model_parallel": 2}])
def test_trainer_refuses_fused_adam_with_sharding(tmp_path, flags):
    cfg = tiny_config().with_overrides(**{"train.fused_adam": True})
    with pytest.raises(ValueError, match="fused_adam keeps flat"):
        Trainer(cfg, str(tmp_path), device="cpu", aux_rendering=False, **flags)


def test_trainer_fused_adam_checkpoint_and_resume(tmp_path):
    """The moments checkpoint by parameter name (the foreach layout) and a
    resume copies them back into the flat buffers' views, bit for bit."""
    cfg = tiny_config().with_overrides(**{"train.fused_adam": True})
    tr = Trainer(cfg, str(tmp_path / "run"), device="cpu", aux_rendering=False)
    tr.fit(lambda epoch: (make_example_train_batch(cfg, 2, seed=i) for i in range(2)), num_epochs=1, log_every=1)
    assert tr.state.step == 2 and tr.state.opt_state.count == 2
    payload = tr.ckpt.restore()
    assert set(payload["opt_state"]["mu"]) == set(tr.state.params)
    fresh = Trainer(cfg, str(tmp_path / "run"), device="cpu", aux_rendering=False, seed=3)
    flat = fresh.state.opt_state.flat_mu
    assert fresh.resume() and fresh.state.opt_state.count == 2
    st = fresh.state.opt_state
    assert st.flat_mu is flat and st.mu[0].data_ptr() == flat.data_ptr()
    for x, y in zip(tr.state.opt_state.mu + tr.state.opt_state.nu, st.mu + st.nu):
        assert torch.equal(x, y)
    fresh.fit(lambda epoch: (make_example_train_batch(cfg, 2, seed=9),), num_epochs=2, log_every=1)
    assert fresh.state.step == 3
    shutil.rmtree(tmp_path, ignore_errors=True)
