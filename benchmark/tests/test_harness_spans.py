"""The `program_span` readers (benchmark/spans.py and its metrics) on a
fabricated registry of two traced passes, and on the spans a tiny CPU
forward records under two profiler sessions."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT

INFER = {"backbone_host_ms.infer": ("whmr.backbone", "host"), "backbone_device_ms.infer": ("whmr.backbone", "device"),
         "heads_host_ms.infer": ("whmr.heads", "host"), "heads_device_ms.infer": ("whmr.heads", "device"),
         "maf_host_ms.infer": ("whmr.maf", "host"), "maf_device_ms.infer": ("whmr.maf", "device")}
TRAIN = {"step_host_ms.train": ("train.step", "host"), "targets_device_ms.train": ("train.targets", "device"),
         "forward_device_ms.train": ("train.forward", "device"),
         "backward_device_ms.train": ("train.backward", "device"),
         "optimizer_device_ms.train": ("train.optimizer", "device")}


def reader(name):
    import run

    return run.load_module(run.metric_path(name), "metric_" + name.replace(".", "_"))


class Registry:
    """Span records as the port's tracer gives them."""

    def __init__(self):
        self.recs, self.next_id, self.clock = [], 1, 0

    def add(self, name, host_ms, device_ms, parent=None):
        rec = {"name": name, "id": self.next_id, "parent": parent["id"] if parent else None,
               "root": parent["root"] if parent else self.next_id, "thread": 1,
               "host_start_ns": self.clock, "host_end_ns": self.clock + int(host_ms * 1e6),
               "host_ms": host_ms, "device_ms": device_ms}
        self.next_id += 1
        self.clock += 1000
        self.recs.append(rec)
        return rec


def forward(reg, k, parent=None):
    """A forward whose spans read k-scaled times: backbone 10k host and 11k
    device ms, heads 2k + 1k host and 3k + 1k device, maf 5k and 6k."""
    root = reg.add("whmr.forward", 20 * k, 25 * k, parent)
    reg.add("whmr.backbone", 10 * k, 11 * k, root)
    reg.add("whmr.heads", 2 * k, 3 * k, root)
    reg.add("whmr.maf", 5 * k, 6 * k, root)
    reg.add("whmr.heads", 1 * k, 1 * k, root)
    return root


def step(reg, k):
    root = reg.add("train.step", 100 * k, 120 * k)
    reg.add("train.targets", 4 * k, 9 * k, root)
    fwd = reg.add("train.forward", 30 * k, 35 * k, root)
    forward(reg, k, fwd)
    reg.add("train.backward", 20 * k, 60 * k, root)
    reg.add("train.optimizer", 10 * k, 15 * k, root)


@pytest.fixture
def registry(monkeypatch):
    import spans

    reg = Registry()
    monkeypatch.setattr(spans, "records", lambda: list(reg.recs))
    return reg


def test_infer_readers_take_the_first_pass_sum_per_root_and_median(registry):
    # CUDA-only pass: three forwards at k = 1, 3, 2; CPU+CUDA pass: three
    # slow ones, which no reader may see
    for k in (1, 3, 2, 50, 60, 70):
        forward(registry, k)
    want = {"backbone_host_ms.infer": 20.0, "backbone_device_ms.infer": 22.0, "heads_host_ms.infer": 6.0,
            "heads_device_ms.infer": 8.0, "maf_host_ms.infer": 10.0, "maf_device_ms.infer": 12.0}
    assert {name: reader(name).read({}) for name in INFER} == pytest.approx(want)
    # the infer readers find no forward roots in a train window
    for name in TRAIN:
        assert reader(name).read({}) is None


def test_train_readers_take_the_first_pass_steps(registry):
    for k in (2, 1, 4, 40, 50, 60):
        step(registry, k)
    want = {"step_host_ms.train": 200.0, "targets_device_ms.train": 18.0, "forward_device_ms.train": 70.0,
            "backward_device_ms.train": 120.0, "optimizer_device_ms.train": 30.0}
    assert {name: reader(name).read({}) for name in TRAIN} == pytest.approx(want)
    # forwards nested in a step are no roots of their own
    for name in INFER:
        assert reader(name).read({}) is None


def test_none_without_spans_or_without_device_time(registry, monkeypatch):
    for name in list(INFER) + list(TRAIN):
        assert reader(name).read({}) is None
    # one traced pass's worth of roots: the first half of one is none
    forward(registry, 1)
    assert reader("backbone_host_ms.infer").read({}) is None
    # a CPU run has host time only
    forward(registry, 1)
    for r in registry.recs:
        r["device_ms"] = None
    assert reader("backbone_host_ms.infer").read({}) == pytest.approx(10.0)
    assert reader("backbone_device_ms.infer").read({}) is None
    # a port without the tracer: its profiling module has no records()
    import spans
    from whmr_tpu_torch.utils import profiling

    monkeypatch.undo()
    monkeypatch.delattr(profiling, "records")
    assert spans.records() == [] and reader("maf_host_ms.infer").read({}) is None


def test_readers_on_a_tiny_cpu_forward_under_two_profiler_sessions():
    import torch

    from whmr_tpu_torch.models.whmr import build_model
    from whmr_tpu_torch.utils import profiling
    from whmr_tpu_torch.utils.testing import make_example_inputs, tiny_config

    cfg = tiny_config()
    model, consts = build_model(cfg, dtype=torch.float32, device="cpu")
    inp = make_example_inputs(cfg, 2)
    args = [torch.from_numpy(inp[k]) for k in ("x", "center", "scale", "bbox_height", "orig_shape", "bbox_info")]
    profiling.reset()
    try:
        with torch.inference_mode():
            for _ in range(2):  # as trace.traced runs its two passes
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                    model(consts, *args)
                    model(consts, *args)
            host = {name: reader(name).read({}) for name in INFER}
    finally:
        profiling.reset()
    for name, value in host.items():
        assert (value is None) == name.endswith("device_ms.infer"), (name, value)
    assert all(host[n] > 0 for n in ("backbone_host_ms.infer", "heads_host_ms.infer", "maf_host_ms.infer"))


def test_span_metrics_declared():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    per = {m["name"]: m for m in b["per_layer"]}
    for name in INFER:
        assert per[name]["source"] == "program_span" and per[name]["moves"] == "infer_crops_per_s"
        assert per[name]["workloads"] == ["vitl-infer-b192", "vitb-infer-b192"]
    for name in TRAIN:
        assert per[name]["source"] == "program_span" and per[name]["moves"] == "train_crops_per_s"
        assert per[name]["workloads"] == ["vitb-train-b192", "vitl-train-b128"]
