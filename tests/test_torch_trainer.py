"""The port's Trainer (whmr_tpu_torch/training/trainer.py).

- The cases of tests/test_trainer.py that this slice covers, on the port, at
  `tiny_config` without the GT render: checkpoint round trip, epoch-boundary
  and mid-epoch resume, log_every across epochs, LR decay at the epoch
  boundary and its restore on resume, the profile window, grad_accum, the
  validate glue with global_pose, best-checkpoint tracking and the SIGTERM
  preemption save; and the loop's spans (`fit.*`, utils/profiling.py). A resumed state is compared bit for bit: the checkpoint
  is a copy.
- The weight bridge: a torch .pt written from `state_dict_from_flax`, a bare
  ViT backbone and a port checkpoint directory load through
  `load_pretrained`; so does the published checkpoint's key set (the
  port's `real_ckpt_manifest`, held key for key and shape for shape to
  whmr_tpu's), strictly, in both packages.
- The whole slice: whmr_tpu's `Trainer.fit` and the port's over the same 2
  batches (2 epochs of 1 step, the LR decayed after epoch 1), from the same
  weights, with dropout off on both sides as in test_torch_train_step.py:
  the logged losses per step within 1e-4 relative, and the step, epoch and
  Adam/LR counters equal.
"""

import json
import os
import shutil
import signal

import flax.linen
import jax
import numpy as np
import pytest
import torch

from whmr_tpu.parallel import make_mesh
from whmr_tpu.training.trainer import Trainer as JTrainer
from whmr_tpu.utils import real_ckpt_manifest as j_manifest
from whmr_tpu.utils.testing import tiny_config as j_tiny_config
from whmr_tpu_torch.models import layers as tlayers
from whmr_tpu_torch.training import train_step as tts
from whmr_tpu_torch.training.trainer import Trainer
from whmr_tpu_torch.utils import profiling
from whmr_tpu_torch.utils import real_ckpt_manifest as t_manifest
from whmr_tpu_torch.utils.convert import state_dict_from_flax
from whmr_tpu_torch.utils.testing import make_example_train_batch, tiny_config

from torch_port_util import release_memory  # noqa: F401 (autouse fixture)

B = 4


@pytest.fixture(autouse=True)
def _drop_run_dirs(tmp_path):
    """A tiny_config checkpoint is 0.44 GB (CamCalib's ResNet-50 and its
    Adam moments): delete each test's run directories when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def batch_iter(cfg, n_batches=2, batch=B):
    for i in range(n_batches):
        yield make_example_train_batch(cfg, batch, seed=i)


def _trainer(path, cfg=None, **kw):
    return Trainer(cfg or tiny_config(), str(path), aux_rendering=False, device="cpu", **kw)


def _assert_same_state(a, b):
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for k in a.batch_stats:
        assert torch.equal(a.batch_stats[k], b.batch_stats[k]), k
    assert a.opt_state.count == b.opt_state.count
    for x, y in zip(a.opt_state.mu + a.opt_state.nu, b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)


def _steps_logged(tr):
    with open(tr.metrics.path) as f:
        return [json.loads(line)["step"] for line in f if '"loss"' in line]


def test_epoch_and_checkpoint_roundtrip(tmp_path):
    cfg = tiny_config()
    tr = _trainer(tmp_path / "run")
    last = tr.train_epoch(batch_iter(cfg), log_every=1)
    assert np.isfinite(last["loss"]) and tr.state.step == 2
    tr.save(metric=last["loss"])
    assert _steps_logged(tr) == [1, 2]
    with open(tmp_path / "run" / "config.json") as f:
        assert json.load(f)["vit"]["embed_dim"] == 64
    fresh = _trainer(tmp_path / "run", seed=5)
    assert fresh.resume()
    assert fresh.state.step == 2 and fresh.epoch == 0 and fresh.batch_idx == 0
    _assert_same_state(tr.state, fresh.state)
    assert fresh.ckpt.restore_best()["step"] == 2


def test_epoch_boundary_resume_does_not_retrain(tmp_path):
    cfg = tiny_config()
    tr = _trainer(tmp_path / "runE")
    tr.fit(lambda epoch: batch_iter(cfg), num_epochs=1, log_every=1)
    assert tr.state.step == 2
    fresh = _trainer(tmp_path / "runE")
    assert fresh.resume()
    assert fresh.epoch == 1 and fresh.batch_idx == 0
    fresh.fit(lambda epoch: batch_iter(cfg), num_epochs=2, log_every=1)
    assert fresh.state.step == 4


def test_mid_epoch_resume(tmp_path):
    cfg = tiny_config()
    tr = _trainer(tmp_path / "runM")
    tr.train_epoch(batch_iter(cfg, n_batches=3), log_every=1, save_every=2)
    assert tr.batch_idx == 3
    assert tr.ckpt.restore(step=2)["batch_idx"] == 2  # the async periodic save
    tr.save(batch_idx=tr.batch_idx)
    fresh = _trainer(tmp_path / "runM")
    assert fresh.resume()
    assert fresh.batch_idx == 3 and fresh.state.step == 3
    # the resumed epoch skips its first 3 batches: 1 step
    fresh.fit(lambda epoch: batch_iter(cfg, n_batches=4), num_epochs=fresh.epoch + 1, log_every=1)
    assert fresh.state.step == 3 + 1 and fresh.batch_idx == 0 and fresh.epoch == 1


def test_log_every_spans_epochs_and_fit_tracks_best(tmp_path):
    cfg = tiny_config()
    tr = _trainer(tmp_path / "runL")
    vals = iter([5.0, 3.0, 4.0])
    # 1-step epochs, log_every=2: the cadence counts steps across epochs
    tr.fit(lambda epoch: batch_iter(cfg, n_batches=1), num_epochs=3, log_every=2,
           validate_fn=lambda state: {"pa_mpjpe": next(vals)})
    assert _steps_logged(tr) == [2]
    assert tr.ckpt._best_metric == 3.0
    assert tr.ckpt.restore_best()["step"] == 2


def test_lr_decay_at_epoch_boundary_and_resume(tmp_path):
    cfg = tiny_config().with_overrides(**{"train.lr_decay_epochs": (2,)})
    opt = tts.make_optimizer(cfg, steps_per_epoch=5)
    p = [torch.zeros(3)]
    state = opt.init(p)
    lrs = []
    for _ in range(12):
        before = p[0].clone()
        state = opt.step(p, [torch.ones(3)], state)
        # Adam of a constant gradient: |update| == the current LR
        lrs.append(float((before - p[0])[0]))
    np.testing.assert_allclose(lrs[:10], cfg.train.base_lr, rtol=1e-4)
    np.testing.assert_allclose(lrs[10:], cfg.train.base_lr * 0.1, rtol=1e-4)
    # resume restores Adam's count, and with it the schedule's step
    cfg = tiny_config().with_overrides(**{"train.lr_decay_epochs": (1,)})
    tr = _trainer(tmp_path / "runR", cfg, steps_per_epoch=2)
    tr.fit(lambda epoch: batch_iter(cfg), num_epochs=1, log_every=1)
    fresh = _trainer(tmp_path / "runR", cfg, steps_per_epoch=2)
    assert fresh.resume() and fresh.state.opt_state.count == 2
    assert fresh.state.tx.learning_rate(fresh.state.opt_state.count) == np.float32(cfg.train.base_lr * np.float32(0.1))


@pytest.mark.parametrize("accum", [1, 2])
def test_profile_window_and_grad_accum(tmp_path, accum):
    cfg = tiny_config().with_overrides(**{"train.grad_accum": accum, "train.batch_size": 8})
    tr = _trainer(tmp_path / "prof", cfg)
    tdir = tmp_path / "trace"
    tr.enable_profiling(str(tdir), steps=1, skip=1)
    last = tr.train_epoch(batch_iter(cfg, n_batches=3, batch=8), log_every=0)
    assert tr._profile["done"] and last == {}
    assert tr.state.step == 3 and tr.state.opt_state.count == 3
    traces = [f for f in os.listdir(tdir) if f.startswith("trace_") and f.endswith(".json")]
    assert len(traces) == 1
    with open(tdir / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    # the tracer's summary of the window beside it: the one traced step
    with open(tdir / f"spans_{os.getpid()}.json") as f:
        spans = json.load(f)["spans"]
    assert spans["fit.step"]["count"] == 1 and spans["train.step"]["count"] == 1
    assert spans["train.forward"]["count"] == accum and spans["whmr.forward"]["count"] == accum
    assert not profiling.enabled()



def test_timer_spans_and_memory_stats(tmp_path):
    tr = _trainer(tmp_path / "timed")
    profiling.reset()
    profiling.enable()
    try:
        tr.train_epoch(batch_iter(tiny_config(), n_batches=3), log_every=2, save_every=2)
    finally:
        profiling.disable()
    tr.ckpt.wait_until_finished()
    # one span a step, one a metric read-back (step 2), one a save (step 2),
    # each a root; a train step in each step span
    fit = [r for r in profiling.records() if r["name"].startswith("fit.")]
    assert [r["name"] for r in fit] == ["fit.step", "fit.step", "fit.log", "fit.save", "fit.step"]
    assert all(r["parent"] is None and r["host_ms"] > 0 for r in fit)
    steps = profiling.records("train.step")
    assert [r["root"] for r in steps] == [r["id"] for r in fit if r["name"] == "fit.step"]
    summary = profiling.summary()
    assert {k: v["count"] for k, v in summary["spans"].items() if k.startswith("fit.")} == \
        {"fit.step": 3, "fit.log": 1, "fit.save": 1}
    profiling.dump(str(tmp_path / "spans.json"))
    with open(tmp_path / "spans.json") as f:
        assert json.load(f) == summary
    profiling.reset()
    # without a card there are no allocator counters
    assert profiling.device_memory_stats() is None

def test_grad_accum_must_divide_the_batch(tmp_path):
    cfg = tiny_config().with_overrides(**{"train.grad_accum": 3, "train.batch_size": 8})
    with pytest.raises(ValueError, match="grad_accum=3 must divide"):
        _trainer(tmp_path / "bad", cfg)
    # the sharded trainer is ported: it needs a process group
    with pytest.raises(RuntimeError, match="process group"):
        _trainer(tmp_path / "bad", fsdp=True)
    # the HMR baseline is ported (test_torch_hmr_trainer.py); it refuses
    # gradient accumulation
    with pytest.raises(ValueError, match="not supported with --regressor hmr"):
        _trainer(tmp_path / "bad", tiny_config().with_overrides(**{"train.grad_accum": 2}), regressor="hmr")


def test_validate_fn_glue_consumes_global_pose(tmp_path):
    import scipy.spatial.transform as sst

    cfg = tiny_config()
    tr = _trainer(tmp_path / "runv")
    base = make_example_train_batch(cfg, 4, seed=7)
    assert tr.make_validate_fn(lambda: [base])(tr.state)["count"] == 4
    assert tr.model.training  # back in train mode after validation
    rot = np.broadcast_to(sst.Rotation.from_euler("x", 25, degrees=True).as_matrix(), (4, 3, 3)).astype(np.float32)
    gp = np.array(base["pose"], np.float32).copy()
    gp[:, 0] += 0.6  # world orient differs from the crop-local pose

    def with_gp(g):
        return lambda: [dict(base, cam_rotmat=rot, global_pose=g)]

    r_world = tr.make_validate_fn(with_gp(gp))(tr.state)
    r_local = tr.make_validate_fn(with_gp(np.array(base["pose"], np.float32)))(tr.state)
    assert np.isfinite(r_world["pa_mpjpe"]) and np.isfinite(r_local["mpjpe"])
    assert abs(r_world["mpjpe"] - r_local["mpjpe"]) > 1e-3


def test_sigterm_saves_and_resume_continues(tmp_path):
    """SIGTERM after the loader's second batch: the loop saves a consistent
    checkpoint at the next batch boundary (step 2, batch 2; device_prefetch
    has already taken the third batch) and exits 0; resume ends the epoch."""
    cfg = tiny_config()

    def preempting(epoch):
        for i, b in enumerate(batch_iter(cfg, n_batches=3)):
            yield b
            if i == 1:
                signal.raise_signal(signal.SIGTERM)

    old = signal.getsignal(signal.SIGTERM)
    try:
        tr = _trainer(tmp_path / "pre")
        tr.install_preemption_handler()
        with pytest.raises(SystemExit) as e:
            tr.fit(preempting, num_epochs=1, log_every=1)
        assert e.value.code == 0
    finally:
        signal.signal(signal.SIGTERM, old)
    saved = tr.ckpt.restore()
    assert (saved["step"], saved["epoch"], saved["batch_idx"]) == (2, 0, 2)
    fresh = _trainer(tmp_path / "pre")
    assert fresh.resume() and fresh.batch_idx == 2
    _assert_same_state(tr.state, fresh.state)
    fresh.fit(lambda epoch: batch_iter(cfg, n_batches=3), num_epochs=1, log_every=1)
    assert fresh.state.step == 3 and fresh.epoch == 1


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """whmr_tpu's Trainer on one device: its initial variables, then 2
    epochs of 1 step (lr decayed by 0.1 from step 1) with dropout off."""
    cfg = j_tiny_config().with_overrides(**{"train.lr_decay_epochs": (1,)})
    run_dir = tmp_path_factory.mktemp("jax_run")
    jt = JTrainer(cfg, str(run_dir), mesh=make_mesh(1), aux_rendering=False)
    variables = jax.device_get({"params": jt.state.params, "batch_stats": jt.state.batch_stats})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        jt.fit(lambda epoch: [make_example_train_batch(cfg, B, seed=epoch)], num_epochs=2, log_every=1)
    with open(jt.metrics.path) as f:
        records = [json.loads(line) for line in f]
    # optax's Adam and schedule states are namedtuples with a `count` field
    has_count = lambda x: "count" in getattr(x, "_fields", ())  # noqa: E731
    counts = [int(leaf.count) for leaf in jax.tree_util.tree_leaves(jt.state.opt_state, is_leaf=has_count)
              if has_count(leaf)]
    yield {"variables": variables, "records": records, "step": int(jt.state.step), "epoch": jt.epoch,
           "counts": counts, "trainer": jt}
    shutil.rmtree(run_dir, ignore_errors=True)  # its two epoch checkpoints


def test_fit_matches_whmr_tpu(tmp_path, jax_run):
    cfg = tiny_config().with_overrides(**{"train.lr_decay_epochs": (1,)})
    tr = _trainer(tmp_path / "port", cfg)
    tr.model.load_state_dict(state_dict_from_flax(jax_run["variables"]), strict=True)
    for m in tr.model.modules():
        if isinstance(m, tlayers.Dropout):
            m.p = 0.0
    tr.fit(lambda epoch: [make_example_train_batch(cfg, B, seed=epoch)], num_epochs=2, log_every=1)
    with open(tr.metrics.path) as f:
        records = [json.loads(line) for line in f]
    want = jax_run["records"]
    assert [r["step"] for r in records] == [r["step"] for r in want] == [1, 2]
    for got, ref in zip(records, want):
        assert got.keys() == ref.keys()
        for k in ref:
            if k not in ("step", "time"):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-7, err_msg=f"step {ref['step']} {k}")
    assert (tr.state.step, tr.epoch) == (jax_run["step"], jax_run["epoch"]) == (2, 2)
    assert set(jax_run["counts"]) == {tr.state.opt_state.count} == {2}
    assert tr.state.tx.learning_rate(1) == np.float32(cfg.train.base_lr * np.float32(0.1))


def test_load_pretrained(tmp_path, jax_run):
    """A torch .pt from state_dict_from_flax loads with every leaf matched;
    a bare ViT backbone maps under feature_extractor. and leaves the heads;
    a port checkpoint directory loads; an orbax-style directory raises."""
    sd = state_dict_from_flax(jax_run["variables"])
    pt = tmp_path / "w-hmr.pt"
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, pt)
    tr = _trainer(tmp_path / "a")
    n = tr.load_pretrained(str(pt), strict=True)
    assert n == len(tr.state.params)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, sd[k]), k

    bare = {k[len("feature_extractor."):]: v * 2 for k, v in sd.items() if k.startswith("feature_extractor.")}
    torch.save({"state_dict": bare}, tmp_path / "vitpose.pth")
    head = tr.state.params["regressor.0.decpose.weight"].clone()
    assert tr.load_pretrained(str(tmp_path / "vitpose.pth")) == len(bare)
    key = "feature_extractor.backbone.blocks.0.attn.qkv.weight"
    assert torch.equal(tr.state.params[key], sd[key] * 2)
    assert torch.equal(tr.state.params["regressor.0.decpose.weight"], head)

    tr.train_epoch(batch_iter(tiny_config(), 1), log_every=100)
    tr.save()
    dst = _trainer(tmp_path / "b")
    assert dst.load_pretrained(str(tmp_path / "a" / "checkpoints")) == len(tr.state.params)
    assert torch.equal(dst.state.params[key], tr.state.params[key])
    assert dst.state.step == 0 and dst.state.opt_state.count == 0  # a warm start, not a resume

    bad = dict(sd)
    bad[key] = torch.zeros(3)
    torch.save(bad, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="1 unmatched/mismatched keys"):
        dst.load_pretrained(str(tmp_path / "bad.pt"), strict=True)
    os.makedirs(tmp_path / "orbax" / "0" / "default")
    with pytest.raises(FileNotFoundError, match="orbax"):
        dst.load_pretrained(str(tmp_path / "orbax"))


@pytest.mark.parametrize("size", ["default", "tiny"])
def test_reference_manifest_equals_whmr_tpu(size):
    """The port's copy of the manifest: whmr_tpu's keys, shapes, order and
    integer keys, and the same random state_dict from a seed."""
    jcfg, tcfg = (None, None) if size == "default" else (j_tiny_config(), tiny_config())
    got, want = t_manifest.real_checkpoint_manifest(tcfg), j_manifest.real_checkpoint_manifest(jcfg)
    assert list(got.items()) == list(want.items())
    assert t_manifest.INT_KEY_SUFFIXES == j_manifest.INT_KEY_SUFFIXES
    if size == "tiny":
        a, b = t_manifest.manifest_state_dict(tcfg, seed=3), j_manifest.manifest_state_dict(jcfg, seed=3)
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_load_pretrained_reference_manifest(tmp_path, jax_run):
    """The published checkpoint's key set (the manifest, at tiny_config)
    loads strictly: the 61 constant buffers are dropped as whmr_tpu drops
    them, and every port parameter is matched and loaded. whmr_tpu's loader
    takes the same file. A truly unknown key, or a wrong shape, still raises."""
    sd = {k: torch.from_numpy(v) for k, v in t_manifest.manifest_state_dict(tiny_config(), seed=3).items()}
    pt = tmp_path / "w-hmr-p-vitpose_checkpoint.pt"
    torch.save({"model": sd}, pt)
    tr = _trainer(tmp_path / "port")
    assert tr.load_pretrained(str(pt), strict=True) == len(tr.state.params)
    for k, v in tr.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k
    jt = jax_run["trainer"]  # whmr_tpu's Trainer at tiny_config (its run is over)
    assert jt.load_pretrained(str(pt), strict=True) == len(jax.tree_util.tree_leaves(jt.state.params))

    key = "regressor.0.decpose.weight"
    for label, bad in (("unknown", {**sd, "regressor.0.not_a_layer.weight": torch.zeros(3)}),
                       ("shape", {**sd, key: torch.zeros(3)})):
        torch.save({"model": bad}, tmp_path / f"{label}.pt")
        with pytest.raises(ValueError, match="1 unmatched/mismatched keys"):
            tr.load_pretrained(str(tmp_path / f"{label}.pt"), strict=True)
