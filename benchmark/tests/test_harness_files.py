"""BENCHMARK.json keeps to its contract, every file it names loads by name,
and a new configuration, traffic mix, cell or per-layer metric is found by
adding files alone."""

from __future__ import annotations

import json
import re
import shutil
import sys

import pytest

from conftest import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]] + [c["name"] for c in b["configs"]] \
        + [w["name"] for w in b["workloads"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    cells = {w["name"] for w in b["workloads"]}
    assert all(set(m.get("workloads", cells)) <= cells for m in b["end_to_end"] + b["per_layer"])
    assert all(w["chips"] == 1 for w in b["workloads"])
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    assert len(json.dumps(b)) < 64 * 1024


def test_every_named_file_loads():
    import run

    b = bench()
    for w in b["workloads"]:
        files = run.cell_files(w)
        assert (HERE / "traffic" / f"{files['traffic']['kind']}.py").is_file()
        run.load_module(HERE / "traffic" / f"{files['traffic']['kind']}.py", "driver_" + files["traffic"]["kind"])
    for m in b["per_layer"]:
        mod = run.load_module(run.metric_path(m["name"]), "metric_" + m["name"].replace(".", "_"))
        assert mod.read({}) is None  # nothing to read: the metric is left out, never 0


def test_new_cell_config_and_metric_are_files_alone(tmp_path):
    """A copy of the benchmark, a new configuration, mix, cell and metric
    added as files and entries only: the copy's run.py finds them."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cfg = json.loads((HERE / "configs" / "whmr-vitb.json").read_text())
    cfg["name"] = "whmr-vitb-new"
    (root / "benchmark" / "configs" / "whmr-vitb-new.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "infer-b192.json").read_text())
    mix["batch"] = 96
    (root / "benchmark" / "traffic" / "infer-b96.json").write_text(json.dumps(mix))
    (root / "benchmark" / "limits" / "new-cell.json").write_text(json.dumps({"out_gap": 0.1}))
    (root / "benchmark" / "metrics" / "batches.infer.py").write_text(
        "def read(ctx):\n    w = ctx.get('window')\n    return w['batches'] if w else None\n")
    b["configs"].append({"name": "whmr-vitb-new", "source": "x", "file": "benchmark/configs/whmr-vitb-new.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "new-cell", "config": "whmr-vitb-new", "traffic": "infer-b96", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "batches.infer", "unit": "batches", "better": "higher", "source": "host_clock",
                           "layer": "entry", "moves": "infer_crops_per_s", "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    sys.modules.pop("run_copy", None)
    import run

    copy = run.load_module(root / "benchmark" / "run.py", "run_copy")
    files = copy.cell_files(b["workloads"][-1])
    assert files["traffic"]["batch"] == 96 and files["config"]["name"] == "whmr-vitb-new"
    metric = copy.load_module(copy.metric_path("batches.infer"), "metric_batches")
    assert metric.read({"window": {"batches": 7}}) == 7
    # A metric with no reader of its own is read by its base name's.
    assert copy.metric_path("idle_share.serve") == root / "benchmark" / "metrics" / "idle_share.py"
    # Nothing that was there changed.
    for path in HERE.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (root / "benchmark" / path.relative_to(HERE)).read_bytes() == path.read_bytes()


@pytest.mark.cuda
def test_cells_run_on_the_card():
    """Each cell once, briefly, on the card: correct, with its metrics."""
    import subprocess

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for w in bench()["workloads"]:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", w["name"], "--seed", "5000000001",
                              "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
