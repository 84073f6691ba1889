"""Parallel training and evaluation of the port on torch.distributed, on the
CPU: gloo ranks spawned on one torch thread each, at `tiny_config`.

- The sharded step: the port's Trainer at 2-rank DP, 2-rank TP, 2-rank FSDP
  and 4-rank dp2 x tp2 (`tests/torch_parallel_worker.py`), each rank fed
  the same global batch of 4 and keeping its rows (at dp2 x tp2 each rank
  is fed only its rows, `local_batches`, as whmr-train's loader feeds
  it), against whmr_tpu's step
  at the global batch (one device; for TP, `make_jitted_train_step` on
  `make_mesh(model_parallel=2)`), with dropout off on both sides as in
  test_torch_train_step.py, and the global-norm clip on (so the norm over
  the shards scales the update). The batch's SMPL and 3D-keypoint masks differ
  between the ranks' rows, so a local denominator would show. whmr_tpu takes
  the port's GT IUV render of the global batch as its target; each port
  rank renders its rows.
- Tolerances: the logged losses and grad_norm 1e-4 relative; the BatchNorm
  running statistics 1e-4; the parameters within 1e-4. Adam's first update
  moves an element by lr * g / (|g| + eps), so by the learning rate (5e-5)
  with the gradient's sign, and the parameter check alone would pass an
  update that was never applied. So the gradient is held leaf by leaf:
  Adam's moments (mu = 0.1 g, nu = 0.001 g^2) within MOMENT_TOL of each
  leaf's own largest reference moment, and the update within a tenth of
  the learning rate wherever the reference's |mu| exceeds 1e-2 of its
  leaf's largest (there the sign is not in doubt). On the four sharded
  runs the worst leaf reads 3.5e-5 of its own scale for mu and 7.1e-5 for
  nu (nu is quadratic in g), and the update passes on every clear
  element. With a planted fault in the 2-rank DP run the worst leaf's mu
  reads 2.0 (the gradient sync skipped) and 0.63 (the local mask count as
  the loss denominator), and the update 2 learning rates (a flipped sign).
- vit.remat under TP and FSDP: the same step as without it, bit for bit
  (and against whmr_tpu's step, as the other cases).
- A checkpoint written by the FSDP and the TP runs (gathered on rank 0, in
  the reference layout) loads into a one-process Trainer bit for bit.
- The loader's rank slices are disjoint and cover the epoch, and
  whmr-train on 2 ranks loads B / 2 rows a step on each.
- `run_evaluation(mesh=)` and `whmr-eval --data_parallel 2` on 2 ranks give
  the one-process metrics and result file.
- A mesh without a process group raises.

Each rank has its own timeout: a hung rank fails the test. The file takes
about 150 s alone.
"""

import json
import multiprocessing as mp
import shutil
import socket

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
from whmr_tpu.parallel import batch_sharding, make_mesh as j_make_mesh, shard_params as j_shard_params
from whmr_tpu.training import gt_renderer as jgt
from whmr_tpu.training import train_step as jts
from whmr_tpu.utils.testing import make_example_inputs, tiny_config
from whmr_tpu_torch.config import config_from_args
from whmr_tpu_torch.data.assets import synthetic_smpl_assets as t_assets
from whmr_tpu_torch.data.loader import BatchLoader, host_tensor
from whmr_tpu_torch.data.npz_dataset import NpzDataset
from whmr_tpu_torch.inference import eval_cli
from whmr_tpu_torch.inference.evaluate import run_evaluation
from whmr_tpu_torch.models import whmr as twhmr
from whmr_tpu_torch.parallel import make_mesh
from whmr_tpu_torch.training import gt_renderer as tgt
from whmr_tpu_torch.training import train_step as tts
from whmr_tpu_torch.training.trainer import Trainer
from whmr_tpu_torch.utils import testing as ttesting
from whmr_tpu_torch.utils.convert import state_dict_from_flax

import torch_parallel_worker
from torch_port_util import n, random_batch_stats, release_memory  # noqa: F401 (autouse fixture)

B = 4
RANK_TIMEOUT = 240
# WHMRConfig() made tiny on whmr-eval's command line (test_torch_cli.py's TINY).
TINY = ["pymaf.mlp_dim", "32,16,8,4", "deconv.num_filters", "32,32,32", "vit.embed_dim", "64",
        "vit.depth", "2", "vit.num_heads", "2", "vit.drop_path_rate", "0.0"]
# The global-norm clip on (the step's grad_norm is about 6e3 here), so the
# sharded norm scales every gradient.
CLIP = {"train.grad_clip_norm": 1000.0}
LR = 5e-5  # tiny_config's train.base_lr
# Adam's moments, per leaf, relative to the leaf's largest reference moment.
MOMENT_TOL = 1e-4
# name: (ranks, model_parallel, fsdp, save a checkpoint, fed local rows,
# vit.remat)
CASES = {
    "dp": (2, 1, False, False, False, False),
    "tp": (2, 2, False, True, False, False),
    "fsdp": (2, 1, True, True, False, False),
    "dp2xtp2": (4, 2, False, False, True, False),
    "tp_remat": (2, 2, False, False, False, True),
    "fsdp_remat": (2, 1, True, False, False, True),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, spec):
    """Run `world` ranks of a worker case; fail on a rank's error or hang."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=torch_parallel_worker.run_case, args=(r, world, port, spec)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} of {world} hung past {RANK_TIMEOUT} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"


def _global_batch():
    """B=4 rows, keypoints from the GT joints; rows 0-1 and 2-3 (the two
    data ranks' rows) hold different SMPL and 3D-keypoint mask counts."""
    consts = twhmr.body_consts_from_assets(t_assets(0))
    batch = ttesting.make_keypoints_consistent(
        consts, ttesting.make_example_train_batch(ttesting.tiny_config(), B, seed=1))
    batch = {k: np.asarray(v) for k, v in batch.items()}
    batch["has_smpl"] = np.array([1, 1, 1, 0], np.float32)
    batch["has_pose_3d"] = np.array([1, 0, 0, 0], np.float32)
    return batch


def _adam_moments(opt_state):
    adam = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
    return adam[0].mu, adam[0].nu


def _as_port(jstate, metrics):
    """whmr_tpu's state after the step, by the port's names."""
    stats = ("running_mean", "running_var", "num_batches_tracked")

    def named(params):
        sd = state_dict_from_flax({"params": params, "batch_stats": jstate.batch_stats})
        return {k: v for k, v in sd.items() if not k.endswith(stats)}

    mu, nu = _adam_moments(jstate.opt_state)
    sd = state_dict_from_flax({"params": jstate.params, "batch_stats": jstate.batch_stats})
    return {
        "params": named(jstate.params),
        "batch_stats": {k: v for k, v in sd.items() if k.endswith(stats[:2])},
        "mu": named(mu),
        "nu": named(nu),
        "metrics": {k: float(v) for k, v in metrics.items()},
    }


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """whmr_tpu's step at the global batch (one device, and on a dp4 x tp2
    mesh), and the files the port's ranks start from."""
    root = tmp_path_factory.mktemp("parallel")
    cfg = tiny_config().with_overrides(**CLIP)
    args = {k: jnp.asarray(v) for k, v in make_example_inputs(cfg, 2).items()}
    args["full_x"] = jnp.zeros((2, 64, 64, 3), jnp.float32)
    jconsts = jreg.body_consts_from_assets(j_assets(0))
    var = jax.jit(lambda c, a: JWHMR(cfg).init(jax.random.PRNGKey(0), c, **a))(jconsts, args)
    var = random_batch_stats(jax.device_get(var))
    weights = str(root / "weights.pt")
    torch.save(state_dict_from_flax(var), weights)

    batch = _global_batch()
    np.savez(root / "batch.npz", **batch)
    # whmr_tpu scores the port's GT render of the global batch.
    tcfg = ttesting.tiny_config()
    tconsts = twhmr.body_consts_from_assets(t_assets(0))
    uvia = tts.gt_targets(tcfg, tconsts, {k: torch.as_tensor(v) for k, v in batch.items()},
                          tgt.build_render_consts(t_assets(0)))[3]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["uvia_gt"] = {k: jnp.asarray(n(v)) for k, v in uvia.items()}
    tx = jts.make_optimizer(cfg)
    model = JWHMR(cfg)
    out = {"root": root, "weights": weights, "batch": str(root / "batch.npz")}
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        for name, mesh in (("one", None), ("tp", j_make_mesh(model_parallel=2))):
            state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=var["params"],
                                   batch_stats=var["batch_stats"], opt_state=tx.init(var["params"]), tx=tx)
            b = jbatch
            if mesh is not None:
                state = state.replace(params=j_shard_params(state.params, mesh))
                b = jax.device_put(jbatch, batch_sharding(mesh))
            step = jts.make_jitted_train_step(cfg, model, mesh=mesh, donate=False,
                                              render_consts=jgt.build_render_consts(j_assets(0)))
            state, metrics = step(state, jconsts, b, jax.random.PRNGKey(1))
            out[name] = _as_port(jax.device_get(state), jax.device_get(metrics))
    yield out
    shutil.rmtree(root, ignore_errors=True)


_RUNS = {}


def _run(ref, name):
    """The port's ranks of a case, run once for the module."""
    if name not in _RUNS:
        world, model_parallel, fsdp, save, local, remat = CASES[name]
        spec = {"log_dir": str(ref["root"] / name), "model_parallel": model_parallel, "fsdp": fsdp,
                "weights": ref["weights"], "batches": [ref["batch"]], "out": str(ref["root"] / f"{name}.pt"),
                "save": save, "local": local, "overrides": {**CLIP, "vit.remat": remat}}
        _spawn(world, spec)
        _RUNS[name] = dict(torch.load(spec["out"], weights_only=True), log_dir=spec["log_dir"])
    return _RUNS[name]


def _close(got, want, part, tol):
    assert got.keys() == want.keys(), part
    for k, w in want.items():
        err = np.abs(n(got[k]) - n(w)).max()
        assert err <= tol, (part, k, err)


def _moments_per_leaf(got, want, part):
    """Each leaf of an Adam moment within MOMENT_TOL of its own largest
    reference value."""
    assert got.keys() == want.keys(), part
    for k, w in want.items():
        w = n(w)
        err, scale = np.abs(n(got[k]) - w).max(), np.abs(w).max()
        assert err <= MOMENT_TOL * scale, (part, k, err, scale)


def _update(got, want, p0, mu):
    """The update p1 - p0 within LR / 10 of the reference's wherever the
    reference's |mu| exceeds 1e-2 of its leaf's largest."""
    for k, w in want.items():
        m = np.abs(n(mu[k]))
        clear = m > 1e-2 * m.max()
        err = np.abs((n(got[k]) - n(p0[k])) - (n(w) - n(p0[k])))[clear]
        assert err.max(initial=0.0) <= LR / 10, ("update", k, err.max())


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_whmr_tpu(ref, name):
    got = _run(ref, name)
    p0 = torch.load(ref["weights"], weights_only=True)
    recs = [json.loads(line) for line in got["records"].splitlines()]
    assert [r["step"] for r in recs] == [1]
    for want in (ref["one"], ref["tp"]) if CASES[name][1] > 1 else (ref["one"],):
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(recs[0][k], v, rtol=1e-4, err_msg=(name, k))
        _close(got["batch_stats"], want["batch_stats"], "batch_stats", 1e-4)
        _close(got["params"], want["params"], "params", 1e-4)
        _update(got["params"], want["params"], p0, want["mu"])
        for part in ("mu", "nu"):
            _moments_per_leaf(got[part], want[part], part)


@pytest.mark.parametrize("name", ["tp", "fsdp"])
def test_remat_step_equals_the_step_without_it(ref, name):
    """vit.remat under TP (DTensor linears) and FSDP2 (each block a unit,
    re-gathered for the recompute): the step's records, parameters, Adam
    moments and BatchNorm statistics equal the same sharded step's without
    remat, bit for bit."""
    got, want = _run(ref, f"{name}_remat"), _run(ref, name)

    def metrics(run):  # the records without their wall-clock stamps
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in run["records"].splitlines()]

    assert metrics(got) == metrics(want)
    for part in ("params", "batch_stats", "mu", "nu"):
        assert got[part].keys() == want[part].keys(), part
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)


@pytest.mark.parametrize("name", ["fsdp", "tp"])
def test_sharded_checkpoint_loads_into_one_process_trainer(ref, name):
    got = _run(ref, name)
    tr = Trainer(ttesting.tiny_config(), got["log_dir"], device="cpu", seed=3)
    assert tr.resume() and tr.state.step == 1
    names = list(tr.state.params)
    live = {"params": tr.state.params, "batch_stats": tr.state.batch_stats,
            "mu": dict(zip(names, tr.state.opt_state.mu)), "nu": dict(zip(names, tr.state.opt_state.nu))}
    for part, tensors in live.items():
        assert tensors.keys() == got[part].keys()
        for k, v in tensors.items():
            assert torch.equal(v, got[part][k]), (part, k)


def test_loader_rank_slices_are_disjoint_and_cover_the_epoch():
    ds = list(range(23))
    for epoch in (0, 1):
        slices = []
        for rank in range(3):
            loader = BatchLoader(ds, 4, num_hosts=3, host_index=rank, seed=2)
            loader.set_epoch(epoch)
            slices.append(set(loader._epoch_indices().tolist()))
        assert all(not (a & b) for i, a in enumerate(slices) for b in slices[i + 1:])
        assert set().union(*slices) == set(ds)


def test_whmr_train_feeds_each_rank_its_rows(tmp_path):
    """whmr-train on 2 ranks, 8 samples, B=4: each rank loads 2 rows a step
    from its half of the epoch (N / B = 2 steps), and the synced update
    leaves both ranks with the same parameters."""
    consts = twhmr.body_consts_from_assets(t_assets(0))
    paths = ttesting.write_npz_dataset(tmp_path / "data", consts, 8, seed=0)
    argv = ["--train_npz", paths["npz"], "--img_dir", paths["img_dir"], "--log_dir", str(tmp_path),
            "--name", "run", "--batch_size", "4", "--num_epochs", "1", "--log_every", "1", "--no_aug",
            "--device", "cpu", "--misc", *TINY, "pymaf.aux_supv_on", "False", "pymaf.depth_supv_on", "False"]
    out = str(tmp_path / "cli")
    _spawn(2, {"cli": True, "argv": argv, "out": out})
    reps = [torch.load(f"{out}.{r}.pt", weights_only=True) for r in range(2)]
    for rep in reps:
        assert rep["rows"] == [2, 2] and rep["step"] == 2
    for k, v in reps[0]["params"].items():
        assert torch.equal(v, reps[1]["params"][k]), k


def test_data_parallel_evaluation_equals_one_process(ref, tmp_path):
    ckpt = str(ref["root"] / "fsdp" / "checkpoints")
    _run(ref, "fsdp")
    consts = twhmr.body_consts_from_assets(t_assets(0))
    paths = ttesting.write_npz_dataset(tmp_path / "data", consts, 6, seed=2)
    argv = ["--checkpoint", ckpt, "--dataset_npz", paths["npz"], "--img_dir", paths["img_dir"],
            "--batch_size", "4", "--device", "cpu", "--log_freq", "0", "--misc", *TINY]
    out = str(tmp_path / "eval.pt")
    _spawn(2, {"eval": True, "argv": argv, "out": out})
    got = torch.load(out, weights_only=True)

    args = eval_cli.build_parser().parse_args(argv)
    cfg = config_from_args(args)
    model, consts, _ = eval_cli.load_model_state(args, cfg)
    ds = NpzDataset(cfg, paths["npz"], paths["img_dir"], is_train=False)

    def batches():
        for hb in BatchLoader(ds, 4, shuffle=False, drop_last=False):
            b, _ = eval_cli.device_eval_batch(hb, extra_keys=("pose", "betas", "gender", "global_pose"),
                                              device="cpu")
            b["valid"] = host_tensor(hb["has_smpl"])
            yield b

    want = run_evaluation(cfg, model, consts, batches(), log_every=0, result_file=str(tmp_path / "one.npz"))
    dump = np.load(tmp_path / "one.npz")
    for which in ("direct", "cli"):
        assert got[which]["count"] == want["count"] == 6
        for k in ("mpjpe", "pa_mpjpe", "pve"):
            np.testing.assert_allclose(got[which][k], want[k], rtol=1e-4, err_msg=(which, k))
        other = np.load(f"{out}.{which}.npz")
        assert other.files == dump.files
        for k in dump.files:
            np.testing.assert_allclose(other[k], dump[k], atol=1e-5, err_msg=(which, k))


@pytest.mark.parametrize("kwargs", [{"model_parallel": 2}, {"fsdp": True}, {"mesh": "any"}])
def test_a_mesh_without_a_process_group_raises(tmp_path, kwargs):
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(ttesting.tiny_config(), str(tmp_path), device="cpu", aux_rendering=False, **kwargs)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
