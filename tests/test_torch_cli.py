"""The port's CLIs against whmr_tpu's, on one dataset on disk.

- `whmr-train` (training/cli.py): the argument checks pinned in whmr_tpu's
  tests (the odd `--misc` count, the `--img_dir`/`--train_npz` count, the
  broadcast of one `--img_dir`), the options of later slices raising
  NotImplementedError, and `--device cuda` without a card raising.
- `--resume` continues the port's run to the next epoch.
- One run of each package's `whmr-train` on the same npz, from the same
  `--pretrained` .pt (a port state_dict, which whmr_tpu reads through
  `convert_whmr_checkpoint`), with `--no_aug`, the GT render off and
  dropout off on both sides: the metrics.jsonl losses agree step by step
  within 1e-4 relative. whmr_tpu runs on a one-device mesh, the
  single-device math of the port.
- `whmr-eval` (inference/eval_cli.py) on the same weights in both formats
  (whmr_tpu's orbax checkpoint of its run, and the port's checkpoint of
  `state_dict_from_flax` of it): the `--result_file` arrays within 1e-4,
  the parts metrics within PARTS_ATOL (the rasterizers' CPU difference:
  XLA contracts into FMAs, the port rounds each operation, so a pixel
  centre within an ulp of an edge can change side), the COCO AP and AR
  within 1e-6; and the CLI's guards.
- `whmr-agora` (inference/agora.py): the pkl tree the port's run writes holds
  what whmr_tpu's `export_person` writes from the same forward outputs.
"""

import argparse
import json
import os
import pickle
import shutil
import signal

import flax.linen
import numpy as np
import pytest
import torch

import whmr_tpu.training.trainer as jtrainer
from whmr_tpu.config import config_from_args as j_config_from_args
from whmr_tpu.inference import agora as jagora
from whmr_tpu.inference import eval_cli as jeval
from whmr_tpu.parallel import make_mesh
from whmr_tpu.training import cli as jcli
from whmr_tpu_torch.data.assets import synthetic_smpl_assets
from whmr_tpu_torch.data.loader import BatchLoader
from whmr_tpu_torch.data.npz_dataset import NpzDataset
from whmr_tpu_torch.inference import agora as tagora
from whmr_tpu_torch.inference import eval_cli as teval
from whmr_tpu_torch.models import layers as tlayers
from whmr_tpu_torch.models.regressor import body_consts_from_assets
from whmr_tpu_torch.models.whmr import build_model
from whmr_tpu_torch.training import cli as tcli
from whmr_tpu_torch.utils.checkpoint import CheckpointManager
from whmr_tpu_torch.utils.convert import state_dict_from_flax
from whmr_tpu_torch.utils.testing import tiny_config, write_npz_dataset

from torch_port_util import release_memory  # noqa: F401 (autouse fixture)

# --misc overrides that make WHMRConfig() tiny_config, in both packages.
TINY = ["pymaf.mlp_dim", "32,16,8,4", "deconv.num_filters", "32,32,32", "vit.embed_dim", "64",
        "vit.depth", "2", "vit.num_heads", "2", "vit.drop_path_rate", "0.0"]
NO_RENDER = ["pymaf.aux_supv_on", "False", "pymaf.depth_supv_on", "False"]
# The trained model (no IUV head, as the render is off), in every CLI below.
MODEL = TINY + NO_RENDER
STEPS = 2
# Parts metrics between the two rasterizers on the CPU: a mask or label
# that differs on 0.1 % of the 256 x 256 crop moves a metric by 1e-3.
PARTS_ATOL = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dataset, the pretrained .pt, both whmr-train runs, and the
    trained whmr_tpu weights in both checkpoint formats."""
    root = tmp_path_factory.mktemp("torch_cli")
    consts = body_consts_from_assets(synthetic_smpl_assets(0), device="cpu")
    paths = write_npz_dataset(root, consts, 8, seed=0, n_parts=1, n_coco=8)
    # the parts protocol renders every crop it evaluates: one crop keeps
    # whmr_tpu's CPU render short
    labels = dict(np.load(paths["npz"]))
    np.savez(root / "parts.npz", **{k: v[:1] for k, v in labels.items()})
    paths["parts_npz"] = str(root / "parts.npz")
    model, _ = build_model(tiny_config(), dtype=torch.float32, device="cpu", seed=3)
    paths["pretrained"] = str(root / "pretrained.pt")
    torch.save({"model": model.state_dict()}, paths["pretrained"])

    argv = ["--train_npz", paths["npz"], "--img_dir", paths["img_dir"], "--log_dir", str(root),
            "--batch_size", "2", "--num_epochs", "1", "--steps_per_epoch", str(STEPS), "--log_every", "1",
            "--no_aug", "--pretrained", paths["pretrained"], "--misc", *TINY, *NO_RENDER]
    sigterm = signal.getsignal(signal.SIGTERM)  # both mains install a preemption handler
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(tlayers.Dropout, "forward", lambda self, x, generator=None: x)
        mp.setattr(jtrainer, "make_mesh", lambda model_parallel=1: make_mesh(1))
        try:
            jcli.main(argv + ["--name", "jax"])
            tr = tcli.main(argv + ["--name", "port", "--device", "cpu"])
        finally:
            signal.signal(signal.SIGTERM, sigterm)
    assert tr.state.step == STEPS and tr.device.type == "cpu"
    paths["train_argv"] = argv
    paths["records"] = {}
    for name in ("jax", "port"):
        with open(root / name / "metrics.jsonl") as f:
            paths["records"][name] = [json.loads(line) for line in f if '"loss"' in line]

    # whmr_tpu's trained weights, also as a weights-only checkpoint of the port
    paths["jax_ckpt"] = str(root / "jax" / "checkpoints")
    args = argparse.Namespace(checkpoint=paths["jax_ckpt"], data_dir=None, regressor="pymaf_net",
                              cfg_file=None, misc=MODEL)
    _, variables, _, _ = jeval.load_model_state(args, j_config_from_args(args))
    sd = state_dict_from_flax(variables)
    port_model, _ = build_model(tiny_config().with_overrides(**dict(zip(NO_RENDER[::2], NO_RENDER[1::2]))),
                                dtype=torch.float32, device="cpu")
    params = {k for k, _ in port_model.named_parameters()}
    stats = {k for k, _ in port_model.named_buffers() if k.endswith(("running_mean", "running_var"))}
    assert params | stats <= set(sd)
    paths["port_ckpt"] = str(root / "port_weights")
    CheckpointManager(paths["port_ckpt"]).save(1, {"params": {k: sd[k] for k in params},
                                                   "batch_stats": {k: sd[k] for k in stats}})
    yield paths
    shutil.rmtree(root, ignore_errors=True)


def _eval_argv(paths, ckpt, *extra, npz="npz"):
    return ["--checkpoint", ckpt, "--dataset_npz", paths[npz], "--img_dir", paths["img_dir"],
            "--batch_size", "4", *extra, "--misc", *MODEL]


def test_train_losses_match_whmr_tpu(runs):
    got, want = runs["records"]["port"], runs["records"]["jax"]
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(1, STEPS + 1))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if k not in ("step", "time"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7, err_msg=f"step {w['step']} {k}")
    assert os.path.isfile(os.path.join(os.path.dirname(runs["npz"]), "port", "checkpoints", str(STEPS), "payload.pt"))


def test_train_resume_continues(runs, capsys):
    """--resume continues the port's run from its epoch checkpoint (the
    pretrained weights are not loaded again) to the next epoch's end."""
    sigterm = signal.getsignal(signal.SIGTERM)
    try:
        tr = tcli.main(runs["train_argv"] + ["--name", "port", "--device", "cpu", "--resume", "--num_epochs", "2"])
    finally:
        signal.signal(signal.SIGTERM, sigterm)
    out = capsys.readouterr().out
    assert f"resumed from step {STEPS} (epoch 1, batch 0)" in out and "loaded pretrained" not in out
    assert (tr.state.step, tr.epoch) == (2 * STEPS, 2)
    with open(tr.metrics.path) as f:
        assert [json.loads(line)["step"] for line in f if '"loss"' in line] == list(range(1, 2 * STEPS + 1))


def test_eval_metric_protocol_matches(runs, tmp_path, capsys):
    res = {name: str(tmp_path / f"{name}.npz") for name in ("jax", "port")}
    jeval.main(_eval_argv(runs, runs["jax_ckpt"], "--result_file", res["jax"]))
    want_out = capsys.readouterr().out
    got = teval.main(_eval_argv(runs, runs["port_ckpt"], "--result_file", res["port"], "--device", "cpu"))
    got_out = capsys.readouterr().out
    assert got["count"] == 8

    def metrics(out):
        lines = dict(line.split(": ") for line in out.splitlines() if line.startswith(("PVE", "MPJPE", "PA-MPJPE")))
        return {k: float(v) for k, v in lines.items()}

    for k, v in metrics(want_out).items():
        assert metrics(got_out)[k] == pytest.approx(v, rel=1e-4, abs=0.01), k
    a, b = np.load(res["port"]), np.load(res["jax"])
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_eval_parts_protocol_matches(runs, capsys):
    argv = _eval_argv(runs, runs["jax_ckpt"], "--eval_parts", "--parts_dir", runs["parts_dir"], npz="parts_npz")
    jeval.main(argv)
    want = {line.split(": ")[0]: float(line.split(": ")[1]) for line in capsys.readouterr().out.splitlines()
            if line.startswith(("Mask", "Parts"))}
    got = teval.main(_eval_argv(runs, runs["port_ckpt"], "--eval_parts", "--parts_dir", runs["parts_dir"],
                                "--device", "cpu", npz="parts_npz"))
    names = {"mask_accuracy": "Mask Accuracy", "mask_f1": "Mask F1", "parts_accuracy": "Parts Accuracy"}
    for k, label in names.items():
        assert 0.0 <= got[k] <= 1.0
        assert abs(got[k] - want[label]) <= PARTS_ATOL + 5e-5, (k, got[k], want[label])  # prints round to 1e-4


def test_eval_coco_ap_matches(runs, monkeypatch):
    got = teval.main(_eval_argv(runs, runs["port_ckpt"], "--coco_ap", "--coco_gt", runs["coco_gt"], "--device", "cpu"))
    captured = {}
    monkeypatch.setattr(jeval, "run_coco_ap_evaluation",
                        lambda *a, _real=jeval.run_coco_ap_evaluation: captured.setdefault("r", _real(*a)))
    jeval.main(_eval_argv(runs, runs["jax_ckpt"], "--coco_ap", "--coco_gt", runs["coco_gt"]))
    for k in ("AP", "AP50", "AP75", "AR"):
        assert got[k] == pytest.approx(captured["r"][k], abs=1e-6), k
        assert 0.0 <= got[k] <= 1.0


@torch.no_grad()
def test_agora_export_matches(runs, tmp_path):
    """The port's whmr-agora writes, for each crop, the pkl that whmr_tpu's
    export_person writes from the same forward outputs (the forward itself
    is held against whmr_tpu's by the metric protocol's arrays)."""
    out = tmp_path / "port"
    tagora.main(["--checkpoint", runs["port_ckpt"], "--out_dir", str(out), "--device", "cpu", "--zip",
                 "--dataset_npz", runs["npz"], "--img_dir", runs["img_dir"], "--batch_size", "4",
                 "--misc", *MODEL])
    args = argparse.Namespace(checkpoint=runs["port_ckpt"], data_dir=None, device="cpu")
    model, consts, _ = teval.load_model_state(args, tiny_config().with_overrides(
        **dict(zip(NO_RENDER[::2], NO_RENDER[1::2]))))
    ds = NpzDataset(tiny_config(), runs["npz"], runs["img_dir"], is_train=False)
    batch, _ = teval.device_eval_batch(BatchLoader(ds, 8, shuffle=False).__iter__().__next__(), device="cpu")
    last = teval._forward(model, consts, batch)["smpl_out"][-1]
    names = sorted(os.listdir(out))
    assert len(names) == 8 and os.path.isfile(str(out) + ".zip")
    for i in range(8):
        want = jagora.export_person(
            str(tmp_path / "jax"), str(ds.imgname[i]), 1, verts=last["verts"][i].numpy(),
            smpl_joints3d=last["smpl_kp_3d"][i].numpy(), pred_cam=last["pred_cam"][i].numpy(),
            bbox_height=float(batch["bbox_height"][i]), bbox_center=batch["center"][i].numpy(),
            focal_length=float(last["focal_length"][i]))
        with open(out / os.path.basename(want), "rb") as f, open(want, "rb") as g:
            a, b = pickle.load(f), pickle.load(g)
        assert a.keys() == b.keys()
        for k in b:
            tol = 1e-4 * max(1.0, float(np.abs(b[k]).max()))  # 2D joints are pixels of a 3840 x 2160 frame
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=tol, err_msg=f"{i} {k}")


def test_agora_person_export_matches(tmp_path):
    rng = np.random.RandomState(0)
    kw = dict(verts=rng.randn(6890, 3).astype(np.float32), smpl_joints3d=rng.randn(49, 3).astype(np.float32),
              pred_cam=np.array([0.9, 0.05, -0.1], np.float32), bbox_height=310.0,
              bbox_center=np.array([700.0, 340.0], np.float32), focal_length=1500.0, mode="val")
    for name in ("a_b_c.png", "plain.png"):
        assert tagora.result_filename(name, 2, "val") == jagora.result_filename(name, 2, "val")
        assert tagora.result_filename(name, 1) == jagora.result_filename(name, 1)
        a = tagora.export_person(str(tmp_path / "t"), name, 1, **kw)
        b = jagora.export_person(str(tmp_path / "j"), name, 1, **kw)
        with open(a, "rb") as f, open(b, "rb") as g:
            pa, pb = pickle.load(f), pickle.load(g)
        for k in pb:
            np.testing.assert_array_equal(pa[k], pb[k])


class TestTrainArguments:
    """whmr-train rejects, does not silently mangle, malformed arguments
    (the checks of whmr_tpu's tests/test_cli_help.py), and the options of
    later slices raise."""

    def test_odd_misc_list_rejected(self):
        with pytest.raises(SystemExit, match="odd number"):
            tcli.main(["--train_npz", "a.npz", "--misc", "train.base_lr"])

    def test_img_dir_count_mismatch_rejected(self):
        with pytest.raises(SystemExit, match="must match"):
            tcli.main(["--train_npz", "a.npz", "--train_npz", "b.npz", "--train_npz", "c.npz",
                       "--img_dir", "d1", "--img_dir", "d2"])

    def test_single_img_dir_broadcasts(self, tmp_path):
        # missing npz files fail at NpzDataset load, after the argument
        # checks; the error naming a file proves none was dropped
        with pytest.raises(FileNotFoundError, match="a.npz"):
            tcli.main(["--train_npz", str(tmp_path / "a.npz"), "--train_npz", str(tmp_path / "b.npz"),
                       "--img_dir", str(tmp_path)])

    @pytest.mark.parametrize("flags,slice_", [(["--model_parallel", "2"], "slice 5"), (["--fsdp"], "slice 5"),
                                              (["--regressor", "hmr"], "slice 6")])
    def test_later_slices_raise(self, runs, tmp_path, flags, slice_):
        with pytest.raises(NotImplementedError, match=slice_):
            tcli.main(["--train_npz", runs["npz"], "--img_dir", runs["img_dir"], "--log_dir", str(tmp_path),
                       "--device", "cpu", *flags, "--misc", *TINY])

    def test_no_card_raises(self, runs, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="--device cpu"):
            tcli.main(["--train_npz", runs["npz"], "--img_dir", runs["img_dir"], "--log_dir", str(tmp_path),
                       "--misc", *TINY])


class TestEvalGuards:
    def test_identity_cam_guard(self, runs, tmp_path):
        """Labels without cam_rotmat abort unless --allow_identity_cam, and
        cam_rotmat without global_pose aborts."""
        labels = dict(np.load(runs["npz"]))
        for drop, match in (("cam_rotmat", "no 'cam_rotmat'"), ("global_pose", "no 'global_pose'")):
            npz = str(tmp_path / f"no_{drop}.npz")
            np.savez(npz, **{k: v for k, v in labels.items() if k != drop})
            with pytest.raises(SystemExit, match=match):
                teval.main(["--checkpoint", runs["port_ckpt"], "--dataset_npz", npz, "--img_dir", runs["img_dir"],
                            "--device", "cpu", "--misc", *MODEL])

    @pytest.mark.parametrize("flags,error,match", [
        ([], SystemExit, "exactly one"),
        (["--checkpoint", "CKPT", "--bundle", "b"], SystemExit, "exactly one"),
        (["--bundle", "b"], NotImplementedError, "slice 4"),
        (["--checkpoint", "CKPT", "--data_parallel", "2"], NotImplementedError, "slice 5"),
        (["--checkpoint", "CKPT", "--regressor", "hmr"], NotImplementedError, "slice 6"),
        (["--checkpoint", "CKPT", "--eval_parts"], SystemExit, "--parts_dir"),
        (["--checkpoint", "CKPT", "--coco_ap"], SystemExit, "--coco_gt"),
        (["--checkpoint", "ORBAX"], SystemExit, "cannot be read without orbax"),
    ])
    def test_guards(self, runs, tmp_path, flags, error, match):
        orbax = tmp_path / "orbax"
        os.makedirs(orbax / "1" / "default")
        flags = [{"CKPT": runs["port_ckpt"], "ORBAX": str(orbax)}.get(f, f) for f in flags]
        with pytest.raises(error, match=match):
            teval.main(["--dataset_npz", runs["npz"], "--img_dir", runs["img_dir"], "--device", "cpu", *flags,
                        "--misc", *MODEL])

    def test_no_card_raises(self, runs, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="--device cpu"):
            teval.main(_eval_argv(runs, runs["port_ckpt"]))
