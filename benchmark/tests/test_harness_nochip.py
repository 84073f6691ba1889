"""A run without a card fails and prints no result; it does not fall back
to the CPU. A run refuses to report once JAX or the JAX package is loaded,
comparing whole top-level names (`whmr_tpu_torch` is not `whmr_tpu`)."""

from __future__ import annotations

import shutil
import subprocess
import sys

from conftest import HERE, ROOT


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "vitb-train-b192", "--seed", "3000000007",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "whmr_tpu_torch_lookalike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "whmr_tpu.config", sys)
    assert run.forbidden_modules() == ["whmr_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    """A tiny CPU run of each driver in a fresh process loads none of them."""
    code = (
        "import sys, torch; sys.path[:0] = [%r, %r]\n"
        "from conftest import tiny_files\n"
        "import run\n"
        "for cell in ('vitb-infer-b192', 'vitb-train-b192'):\n"
        "    b, w, f = tiny_files(cell)\n"
        "    assert run.execute(b, w, 11, 0.2, False, torch.device('cpu'), files=f)['correct']\n"
        "print(run.forbidden_modules())\n" % (str(HERE / "tests"), str(HERE))
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
