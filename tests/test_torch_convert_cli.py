"""`whmr-convert` of the port (utils/convert_cli.py) against whmr_tpu's
converter on whmr_tpu's `synthetic_reference_state_dict` (every key family
of the published checkpoint, its constant buffers included) saved as a
reference `{"model": state_dict}` .pt.

The port's checkpoint holds the reference's values bit for bit, as
`state_dict_from_flax(convert_whmr_checkpoint(sd))` does; the report's
counts (matched parameters, matched BatchNorm statistics, mismatched
shapes, unmatched keys) equal whmr_tpu's `merge_trees` report over its
model's tree, also when the model's widths differ from the checkpoint's;
`--strict` refuses an unknown key. whmr_tpu's model tree comes from
`jax.eval_shape` of its init: shapes are all its merge reads.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.models import regressor as jreg
from whmr_tpu.models.whmr import WHMR as JWHMR
from whmr_tpu.utils.convert import convert_whmr_checkpoint, synthetic_reference_state_dict
from whmr_tpu.utils.convert_cli import merge_trees as j_merge_trees
from whmr_tpu.utils.testing import make_example_inputs, tiny_config
from whmr_tpu_torch.inference.eval_cli import restore_checkpoint
from whmr_tpu_torch.models.whmr import build_model
from whmr_tpu_torch.training.trainer import Trainer
from whmr_tpu_torch.utils import testing as ttesting
from whmr_tpu_torch.utils.checkpoint import CheckpointManager
from whmr_tpu_torch.utils.convert import state_dict_from_flax
from whmr_tpu_torch.utils.convert_cli import main as convert_main

from torch_port_util import release_memory  # noqa: F401 (autouse fixture)

TINY = ["pymaf.mlp_dim", "32,16,8,4", "deconv.num_filters", "32,32,32", "vit.embed_dim", "64",
        "vit.depth", "2", "vit.num_heads", "2", "vit.drop_path_rate", "0.0"]
# the model's last MAF width differs from the checkpoint's
NARROW = ["pymaf.mlp_dim", "32,16,8,2"] + TINY[2:]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    sd = synthetic_reference_state_dict(tiny_config(), seed=0)
    path = tmp_path_factory.mktemp("convert") / "ref.pt"
    torch.save({"model": {"module." + k: torch.as_tensor(v) for k, v in sd.items()}}, path)
    return sd, str(path)


def _whmr_tpu_report(sd, misc):
    """whmr_tpu's whmr-convert report for a model of the `misc` config."""
    cfg = tiny_config().with_overrides(**dict(zip(misc[::2], misc[1::2])))
    converted, report = convert_whmr_checkpoint(sd, return_report=True)
    args = {k: jnp.asarray(v) for k, v in make_example_inputs(cfg, 2).items()}
    args["full_x"] = jnp.zeros((2, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda c, a: JWHMR(cfg).init(jax.random.PRNGKey(0), c, **a),
                            jreg.body_consts_from_assets(j_assets(0)), args)
    _, rep_p = j_merge_trees(dict(shapes["params"]), converted["params"])
    _, rep_s = j_merge_trees(dict(shapes["batch_stats"]), converted["batch_stats"])
    return report, rep_p, rep_s


def _counts(unrecognized, rep_p, rep_s):
    return {
        "matched": rep_p["matched"], "matched_stats": rep_s["matched"],
        "mismatched": len(rep_p["mismatched"]) + len(rep_s["mismatched"]),
        "unmatched": len(unrecognized) + len(rep_p["extra"]) + len(rep_s["extra"]),
    }


def test_convert_holds_the_reference_values(reference, tmp_path, capsys):
    sd, path = reference
    out = str(tmp_path / "out")
    report = convert_main(["--torch_ckpt", path, "--out", out, "--strict", "--device", "cpu", "--misc", *TINY])
    jreport, rep_p, rep_s = _whmr_tpu_report(sd, TINY)
    assert _counts(report["unrecognized"], report["params"], report["batch_stats"]) == _counts(
        jreport["unrecognized"], rep_p, rep_s)
    assert report["params"]["matched"] > 100 and not report["unrecognized"]
    assert f"matched params: {rep_p['matched']} (+{rep_s['matched']} batch stats)" in capsys.readouterr().out

    want = state_dict_from_flax(convert_whmr_checkpoint(sd))
    payload = CheckpointManager(out).restore()
    got = {**payload["params"], **payload["batch_stats"]}
    assert set(got) == {k for k in want if not k.endswith("num_batches_tracked")}
    for k, v in got.items():
        assert torch.equal(v, want[k]), k

    # whmr-eval --checkpoint and whmr-train --pretrained read it
    model, _ = build_model(ttesting.tiny_config(), dtype=torch.float32, device="cpu", seed=7)
    restore_checkpoint(model, out)
    for k, v in model.state_dict().items():
        if k in got:
            assert torch.equal(v, got[k]), k
    tr = Trainer(ttesting.tiny_config(), str(tmp_path / "run"), device="cpu", aux_rendering=False)
    assert tr.load_pretrained(out, strict=True) == report["params"]["matched"]
    assert torch.equal(tr.state.params["regressor.0.fc1.weight"], got["regressor.0.fc1.weight"])
    shutil.rmtree(tmp_path, ignore_errors=True)  # checkpoints of 0.2-0.5 GB


def test_convert_reports_mismatches_as_whmr_tpu(reference, tmp_path):
    sd, path = reference
    out = str(tmp_path / "narrow")
    report = convert_main(["--torch_ckpt", path, "--out", out, "--device", "cpu", "--misc", *NARROW])
    jreport, rep_p, rep_s = _whmr_tpu_report(sd, NARROW)
    counts = _counts(report["unrecognized"], report["params"], report["batch_stats"])
    assert counts == _counts(jreport["unrecognized"], rep_p, rep_s)
    assert counts["mismatched"] > 0
    # without --strict the matching leaves are written and the rest keep the init
    assert CheckpointManager(out).latest_step() == 0
    with pytest.raises(SystemExit, match="--strict"):
        convert_main(["--torch_ckpt", path, "--out", out, "--strict", "--device", "cpu", "--misc", *NARROW])
    shutil.rmtree(tmp_path, ignore_errors=True)  # checkpoints of 0.2-0.5 GB


def test_strict_refuses_an_unknown_key(reference, tmp_path):
    sd, _ = reference
    path = tmp_path / "extra.pt"
    torch.save({"model": {**{k: torch.as_tensor(v) for k, v in sd.items()}, "head.fc.weight": torch.zeros(3)}}, path)
    with pytest.raises(SystemExit, match="--strict: 1 conversion problems"):
        convert_main(["--torch_ckpt", str(path), "--out", str(tmp_path / "o"), "--strict", "--device", "cpu",
                      "--misc", *TINY])
    # a bare state_dict with --state_dict_key none
    bare = tmp_path / "bare.pt"
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, bare)
    report = convert_main(["--torch_ckpt", str(bare), "--out", str(tmp_path / "b"), "--state_dict_key", "none",
                           "--strict", "--device", "cpu", "--misc", *TINY])
    assert not report["unrecognized"] and np.all([not r for r in report["params"]["mismatched"]])
    shutil.rmtree(tmp_path, ignore_errors=True)  # checkpoints of 0.2-0.5 GB
