"""The weight bridge and the port's package rules.

- Round trip: a reference-shaped state_dict -> whmr_tpu's
  `convert_whmr_checkpoint` -> the port's `state_dict_from_flax` -> a strict
  `load_state_dict`; every key the converter consumes comes back bit-equal.
  The constant buffers it skips (convert.py:53-61) are out of scope.
- Hygiene: no module of whmr_tpu_torch, and not chip_smoke.py, imports jax,
  flax, optax, orbax or whmr_tpu (not even its jax-free config and data
  modules); `build_model` without a device raises where CUDA is
  absent; chip_smoke.py fails without a card and without the package.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from whmr_tpu.utils.convert import convert_whmr_checkpoint, synthetic_reference_state_dict
from whmr_tpu.utils.testing import tiny_config
from whmr_tpu_torch.models import whmr as twhmr
from whmr_tpu_torch.utils import testing as ttesting
from whmr_tpu_torch.utils.convert import state_dict_from_flax

from torch_port_util import release_memory  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parent.parent


def test_reference_checkpoint_round_trip():
    ref = synthetic_reference_state_dict(tiny_config(), seed=4)
    converted, report = convert_whmr_checkpoint(ref, return_report=True)
    assert not report["unrecognized"]
    sd = state_dict_from_flax(converted)
    for key in sorted(report["consumed"]):
        assert key in sd, key
        np.testing.assert_array_equal(sd[key].numpy(), ref[key], err_msg=key)
    model, _ = twhmr.build_model(ttesting.tiny_config(), dtype=torch.float32, device="cpu")
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "whmr_tpu"}


def _forbidden_imports(path: Path):
    return set(_imported_roots(path)) & FORBIDDEN


def test_port_imports_no_jax_nor_whmr_tpu(tmp_path):
    files = sorted((ROOT / "whmr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    names = {str(f.relative_to(ROOT)) for f in files}
    # the trainer slice's and the data/CLI slice's modules are among those scanned
    assert names >= {
        "whmr_tpu_torch/utils/checkpoint.py", "whmr_tpu_torch/data/loader.py",
        "whmr_tpu_torch/utils/profiling.py", "whmr_tpu_torch/ops/procrustes.py",
        "whmr_tpu_torch/inference/evaluate.py", "whmr_tpu_torch/inference/eval_cli.py",
        "whmr_tpu_torch/training/trainer.py", "whmr_tpu_torch/config.py",
        "whmr_tpu_torch/data/kp_formats.py", "whmr_tpu_torch/data/augment.py",
        "whmr_tpu_torch/data/npz_dataset.py", "whmr_tpu_torch/training/cli.py",
        "whmr_tpu_torch/inference/part_segm.py", "whmr_tpu_torch/inference/coco_eval.py",
        "whmr_tpu_torch/inference/agora.py", "whmr_tpu_torch/data/coco.py", "whmr_tpu_torch/data/tcmr.py",
        "whmr_tpu_torch/data/fits_dict.py", "whmr_tpu_torch/data/data_cli.py",
    }
    for f in files:
        bad = _forbidden_imports(f)
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
    # the scan catches a copy that reaches back into whmr_tpu's jax-free
    # modules, at the top of the file or inside a function
    for line in ("from whmr_tpu.config import WHMRConfig", "import whmr_tpu.data.augment as A",
                 "def f():\n    from whmr_tpu.data.kp_formats import FORMATS"):
        copy = tmp_path / "copy.py"
        copy.write_text(line + "\n")
        assert _forbidden_imports(copy) == {"whmr_tpu"}, line


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path, where):
    """No result line and a non-zero exit without CUDA, and in a directory
    that holds chip_smoke.py and nothing else of the repo."""
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_build_model_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twhmr.build_model(ttesting.tiny_config())
