"""Shared set-up of the benchmark's CPU tests: the benchmark's modules and
the port on the path, and a tiny cell (the port's `tiny_config` widths)
that the drivers run on the CPU in float32."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT), str(HERE)]

TINY = {"vit.embed_dim": 64, "vit.depth": 2, "vit.num_heads": 2, "deconv.num_filters": [32, 32, 32],
        "pymaf.mlp_dim": [32, 16, 8, 4]}


def tiny_files(cell: str) -> dict:
    """The cell's files cut to the tiny widths, batch 4, float32."""
    import run

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload = {w["name"]: w for w in bench["workloads"]}[cell]
    files = run.cell_files(workload)
    files["config"]["model"].update(TINY)
    files["traffic"].update({"batch": 4, "pool": 3, "dtype": "float32"})
    if files["traffic"]["kind"] == "infer":
        files["traffic"].update({"check_from_first": 2, "check_rows": 2, "warmup_batches": 1})
    return bench, workload, files


@pytest.fixture
def tiny_run():
    """tiny_run(cell, seed, hooks=None) -> the result line of a CPU run."""
    import torch

    import run

    def go(cell, seed=20260101, hooks=None, seconds=0.5):
        bench, workload, files = tiny_files(cell)
        return run.execute(bench, workload, seed, seconds, False, torch.device("cpu"), hooks=hooks, files=files)

    return go
