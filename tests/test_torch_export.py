"""`whmr-export` of whmr_tpu_torch (torch.export bundles) at `tiny_config`
on the CPU, under `vit.attn_impl="pallas"`, so that every program carries
K1 as the operator `whmr::attention_qkv` (on the CPU its body is the plain
version). One bundle of each CamCalib mode (none, "batch", "split") and
each variant (demo, eval): a polymorphic one run at two batch sizes, the
others fixed; "split" and eval ones through the CLI, the eval one with
`--check`. Each is held against the live port model and against whmr_tpu's
serving graph (`whmr_tpu/inference/export.py::make_serving_fn`, jitted) on
the same inputs, the "split" one also served by a coalescing
`BatchingExecutor` against the live pipeline's, and the eval bundle through
`run_evaluation(forward_override=)` and `whmr-eval --bundle` against the
live eval. Each bundle is traced, saved and loaded once a module.

Tolerances: a bundle against the live port model within 1e-5 (the same
operations, traced); against whmr_tpu within atol 1e-4 (rtol 1e-6 for the
O(1e3) focal length and translation), the forward's parity tolerance;
metrics within 1e-4 relative.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.inference import export as jexport
from whmr_tpu.models.regressor import body_consts_from_assets as j_consts
from whmr_tpu.models.whmr import WHMR as JWHMR
from whmr_tpu.utils.testing import tiny_config as jtiny
from whmr_tpu_torch.data.assets import synthetic_smpl_assets
from whmr_tpu_torch.inference import eval_cli, export_cli
from whmr_tpu_torch.inference import export as texport
from whmr_tpu_torch.inference import pipeline as tpipeline
from whmr_tpu_torch.inference.evaluate import run_evaluation
from whmr_tpu_torch.inference.export import OUTPUT_KEYS
from whmr_tpu_torch.inference.pipeline import DemoPipeline, Detection
from whmr_tpu_torch.inference.serve_cli import BatchingExecutor
from whmr_tpu_torch.models.whmr import build_model
from whmr_tpu_torch.utils.testing import tiny_config, write_npz_dataset

from torch_port_util import carried_whmr, release_memory, save_port_checkpoint  # noqa: F401 (autouse fixture)

OVERRIDES = {"cam_img_size": (128, 128), "vit.attn_impl": "pallas"}
TINY = ["pymaf.mlp_dim", "32,16,8,4", "deconv.num_filters", "32,32,32", "vit.embed_dim", "64",
        "vit.depth", "2", "vit.num_heads", "2", "vit.drop_path_rate", "0.0", "cam_img_size", "128,128",
        "vit.attn_impl", "pallas"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The carried weights, the live port model, a checkpoint of them and
    whmr_tpu's serving graphs by CamCalib mode."""
    jcfg = jtiny().with_overrides(**{"cam_img_size": (128, 128)})
    variables, sd = carried_whmr(jcfg)
    cfg = tiny_config().with_overrides(**OVERRIDES)
    model, consts = build_model(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(sd)
    model.requires_grad_(False)
    root = tmp_path_factory.mktemp("export")
    jc = j_consts(j_assets())
    flat, treedef = jax.tree.flatten((variables, jc))

    def jax_serving(mode):
        fn = jax.jit(jexport.make_serving_fn(jcfg, JWHMR(jcfg), treedef, mode))
        return lambda *args: fn(flat, *(jnp.asarray(a.numpy()) for a in args))

    return {"cfg": cfg, "model": model, "consts": consts, "root": root, "jax": jax_serving, "sd": sd,
            "variables": variables, "ckpt": save_port_checkpoint(sd, root / "ckpt")}


def _live(setup, mode, args):
    with torch.no_grad():
        return texport.ServingModule(setup["model"], setup["consts"], mode)(*args)


def _close(got, want, atol, rtol=0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32), np.asarray(want[k], np.float32),
                                   atol=atol, rtol=rtol, err_msg=k)


def _k1_nodes(program):
    return sum(str(n.target) == "whmr.attention_qkv.default" for n in program.graph.nodes)


def test_polymorphic_bundle_keeps_k1_and_the_symbolic_batch(setup):
    """No CamCalib, batch 0: one program serves B=2 and B=3; K1 stays in
    the graph as `whmr::attention_qkv`, once a ViT block."""
    cfg, out = setup["cfg"], str(setup["root"] / "poly")
    program = texport.export_serving(cfg, setup["model"], setup["consts"], 0)
    texport.save_exported(out, program, cfg, 0, None)
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert meta["batch_size"] == 0 and meta["camcalib"] is False and meta["variant"] == "demo"
    assert meta["format"] == "torch.export" and meta["device"] == "cpu" and meta["dtype"] == "float32"
    assert _k1_nodes(program) == cfg.vit.depth
    (bound,) = program.range_constraints.values()
    assert bound.lower <= 2 and bound.upper > 2**31  # B was not specialised
    served = texport.load_exported(out)
    for b in (2, 3):
        args = texport.batch_args(cfg, b, None, "cpu", seed=b)
        got = texport.fetch(served(*args))
        assert got["verts"].shape == (b, 6890, 3)
        _close(got, _live(setup, None, args), atol=1e-5)
    _close(got, setup["jax"](None)(*args), atol=1e-4, rtol=1e-6)  # at B=3


def test_batch_camcalib_bundle(setup):
    cfg, out = setup["cfg"], str(setup["root"] / "batch")
    program = texport.export_serving(cfg, setup["model"], setup["consts"], 2, camcalib="batch")
    texport.save_exported(out, program, cfg, 2, "batch")
    served = texport.load_exported(out)
    args = texport.batch_args(cfg, 2, "batch", "cpu", seed=4)
    got = texport.fetch(served(*args[:6], full_u8=args[6]))
    _close(got, _live(setup, "batch", args), atol=1e-5)
    _close(got, setup["jax"]("batch")(*args), atol=1e-4, rtol=1e-6)
    with pytest.raises(ValueError, match="full_u8"):
        served(*args[:6])


@pytest.fixture(scope="module")
def split_bundle(setup):
    """whmr-export --camcalib split at batch 2, and the bundle loaded."""
    out = str(setup["root"] / "split")
    export_cli.main(["--checkpoint", setup["ckpt"], "--output", out, "--camcalib", "split", "--batch_size", "2",
                     "--device", "cpu", "--misc", *TINY])
    return out, texport.load_exported(out)


def test_split_bundle_through_the_cli(setup, split_bundle):
    """whmr-export --camcalib split: the main program with per-crop
    cam_rotmat equals the live model's and whmr_tpu's; fed the frame, the
    bundle's CamCalib program gives "batch" mode's answer."""
    cfg, (out, served) = setup["cfg"], split_bundle
    assert sorted(os.listdir(out)) == ["camcalib.pt2", "forward.pt2", "meta.json"]
    assert served.camcalib_mode == "split" and served.batch_size == 2
    args = texport.batch_args(cfg, 2, "batch", "cpu", seed=5)
    cam = texport.fetch(served.camcalib_fn(args[6]))
    with torch.no_grad():
        want_cam = [t.numpy() for t in setup["model"].camcalib(texport.Normalize()(args[6]))]
    np.testing.assert_allclose(cam["cam_rotmat"], want_cam[0], atol=1e-5)
    np.testing.assert_allclose(cam["render_rotmat"], want_cam[1], atol=1e-5)
    rot = torch.from_numpy(cam["cam_rotmat"]).expand(2, 3, 3).contiguous()
    split_args = (*args[:6], rot)
    got = texport.fetch(served(*args[:6], cam_rotmat=rot))
    _close(got, _live(setup, "split", split_args), atol=1e-5)
    _close(got, setup["jax"]("split")(*split_args), atol=1e-4, rtol=1e-6)
    framed = texport.fetch(served(*args[:6], full_u8=args[6]))
    _close(framed, _live(setup, "batch", args), atol=1e-5)


def _img(seed, hw=(200, 160)):
    return np.random.RandomState(seed).randint(0, 255, (*hw, 3), np.uint8)


def _same_result(got, want, atol):
    assert got["n_people"] == want["n_people"]
    for k in OUTPUT_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol, err_msg=k)


def test_split_bundle_server_matches_live(setup, split_bundle):
    """A "split" bundle serves with coalescing (its CamCalib program runs
    once a frame) and answers as the live pipeline does."""
    cfg, cap = setup["cfg"], 2
    one, two = [Detection(80.0, 100.0, 90.0)], [Detection(60.0, 100.0, 90.0), Detection(110.0, 90.0, 70.0)]
    pipe = DemoPipeline(cfg, setup["sd"], synthetic_smpl_assets(), max_people=cap, use_camcalib=True, device="cpu")
    with pytest.MonkeyPatch.context() as mp:  # the bundle loaded once, in the fixture
        mp.setattr(tpipeline, "load_exported", lambda path, device=None: split_bundle[1])
        bpipe = DemoPipeline(cfg, None, synthetic_smpl_assets(), max_people=cap, use_camcalib=True,
                             bundle=split_bundle[0], device="cpu")
    assert bpipe.model is None and bpipe._cam_fwd is not None
    live, frozen = BatchingExecutor(pipe, max_wait_ms=5.0), BatchingExecutor(bpipe, max_wait_ms=5.0)
    try:
        jobs = [(_img(15), two), (_img(16), one), (_img(15), one)]
        for img, dets in jobs:
            _same_result(frozen.submit(img, dets=dets), live.submit(img, dets=dets), atol=1e-5)
        assert frozen.stats["camcalib_calls"] == 2 and frozen.stats["camcalib_cache_hits"] == 1
        # the demo path: the frame in, the bundle's camcalib_fn inside
        _same_result(bpipe.run_image(_img(17), dets=two), pipe.run_image(_img(17), dets=two), atol=1e-5)
    finally:
        live.shutdown()
        frozen.shutdown()


@pytest.fixture(scope="module")
def eval_bundle(setup, tmp_path_factory):
    """whmr-export --eval --check, the bundle that --check loaded (kept for
    the tests below), and a labelled dataset on disk."""
    out, printed, loaded = str(setup["root"] / "eval"), io.StringIO(), []
    real_load = texport.load_exported

    def load(path, device=None):
        loaded.append(real_load(path, device=device))
        return loaded[-1]

    with contextlib.redirect_stdout(printed), pytest.MonkeyPatch.context() as mp:
        mp.setattr(texport, "load_exported", load)
        export_cli.main(["--checkpoint", setup["ckpt"], "--output", out, "--eval", "--batch_size", "2", "--check",
                         "--device", "cpu", "--misc", *TINY])
    assert "check outputs finite: True" in printed.getvalue() and len(loaded) == 1
    data = write_npz_dataset(tmp_path_factory.mktemp("evaldata"), setup["consts"], 5, seed=1, img_wh=(240, 180))
    return out, data, loaded[0]


def test_eval_bundle_matches_live(setup, eval_bundle):
    cfg = setup["cfg"]
    served = eval_bundle[2]
    assert served.variant == "eval" and served.batch_size == 2
    args = texport.eval_args(cfg, 2, "cpu", seed=6)
    got = texport.fetch(served.call_eval(*args))
    with torch.no_grad():
        want = texport.EvalServingModule(setup["model"], setup["consts"])(*args)
    _close(got, want, atol=1e-5)
    jcfg = jtiny().with_overrides(**{"cam_img_size": (128, 128)})
    flat, treedef = jax.tree.flatten((setup["variables"], j_consts(j_assets())))
    jfn = jax.jit(jexport.make_eval_serving_fn(jcfg, JWHMR(jcfg), treedef))
    _close(got, jfn(flat, *(jnp.asarray(a.numpy()) for a in args)), atol=1e-4, rtol=1e-6)


def test_eval_bundle_protocols_match_live(setup, eval_bundle, capsys):
    """run_evaluation(forward_override=) and whmr-eval --bundle against the
    live model's evaluation: 5 samples at a fixed batch of 2, so the last
    batch is padded with valid=0 rows."""
    bundle, data, served = eval_bundle
    argv = ["--dataset_npz", data["npz"], "--img_dir", data["img_dir"], "--batch_size", "2", "--device", "cpu",
            "--log_freq", "0", "--misc", *TINY]
    live = eval_cli.main(["--checkpoint", setup["ckpt"], *argv])
    args = eval_cli.build_parser().parse_args(["--bundle", bundle, *argv])
    with pytest.MonkeyPatch.context() as mp:  # the bundle loaded once, in the fixture
        mp.setattr(texport, "load_exported", lambda path, device=None: served)
        frozen = eval_cli.main(["--bundle", bundle, *argv])
        loaded, consts, _, override = eval_cli.load_bundle_state(args, setup["cfg"])
    assert live["count"] == frozen["count"] == 5
    for k in ("mpjpe", "pa_mpjpe", "pve"):
        assert np.isfinite(frozen[k]) and frozen[k] == pytest.approx(live[k], rel=1e-4), k

    assert loaded is served
    rng = np.random.RandomState(7)
    batches = []
    for n in (2, 1):
        inp = dict(zip(("img", "center", "scale", "bbox_height", "orig_shape", "bbox_info", "cam_rotmat"),
                       texport.eval_args(setup["cfg"], n, "cpu", seed=n)))
        inp.update(pose=torch.from_numpy((rng.randn(n, 72) * 0.2).astype(np.float32)),
                   betas=torch.from_numpy(rng.randn(n, 10).astype(np.float32)), valid=torch.ones(n))
        batches.append(inp)
    want = run_evaluation(setup["cfg"], setup["model"], setup["consts"], batches, log_every=0)
    got = run_evaluation(setup["cfg"], None, consts, batches, log_every=0, forward_override=override,
                         fixed_batch=served.batch_size)
    for k in ("mpjpe", "pa_mpjpe", "pve"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k


def test_bundle_guards(setup, eval_bundle, split_bundle, tmp_path):
    cfg = setup["cfg"]
    jdir = tmp_path / "jax_bundle"
    jdir.mkdir()
    (jdir / "forward.jaxexport").write_bytes(b"\x00")
    (jdir / "meta.json").write_text("{}")
    with pytest.raises(ValueError, match="whmr_tpu bundle"):
        texport.load_exported(str(jdir))
    served = eval_bundle[2]
    with pytest.raises(ValueError, match="call_eval"):
        served(*texport.batch_args(cfg, 2, None, "cpu"))
    with pytest.raises(ValueError, match="demo-variant"):
        DemoPipeline(cfg, None, synthetic_smpl_assets(), max_people=2, use_camcalib=False, bundle=eval_bundle[0],
                     device="cpu")
    split = split_bundle[0]
    with pytest.raises(ValueError, match="use_camcalib"):
        DemoPipeline(cfg, None, synthetic_smpl_assets(), max_people=2, use_camcalib=False, bundle=split,
                     device="cpu")
    with pytest.raises(ValueError, match="fixed batch 2"):
        DemoPipeline(cfg, None, synthetic_smpl_assets(), max_people=3, use_camcalib=True, bundle=split,
                     device="cpu")
    with pytest.raises(ValueError, match="camcalib is a demo-graph branch"):
        texport.export_serving(cfg, setup["model"], setup["consts"], 2, camcalib="split", variant="eval")
    with pytest.raises(SystemExit, match="mutually exclusive"):
        export_cli.main(["--checkpoint", setup["ckpt"], "--output", str(tmp_path / "x"), "--eval", "--camcalib",
                         "--device", "cpu"])
    with pytest.raises(SystemExit, match="eval-variant|eval graph"):
        eval_cli.main(["--bundle", split, "--dataset_npz", eval_bundle[1]["npz"], "--img_dir",
                       eval_bundle[1]["img_dir"], "--device", "cpu", "--misc", *TINY])
