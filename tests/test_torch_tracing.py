"""The port's tracer (whmr_tpu_torch/utils/profiling.py) on the CPU.

The span tree and shared root ids of a tiny `WHMR.forward` and of each train
step; off, a span records nothing and makes no CUDA event; the device events
(a fake CUDA event class stands in for the card's): pooled, read lazily,
skipped while a graph is captured; under a CPU `torch.profiler` session the
spans record by themselves and their `record_function` ranges enclose the
aten ops they launched; the ring's bound and drop count; the counters;
`summary` and `dump`; a `torch.export` of the forward with the tracer on
holds no profiler op; the serving executor's `serve.queue_wait` spans under
the device batch's forward.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from whmr_tpu_torch.inference import export as texport
from whmr_tpu_torch.inference.pipeline import DemoPipeline, Detection
from whmr_tpu_torch.inference.serve_cli import BatchingExecutor
from whmr_tpu_torch.models.whmr import build_hmr, build_model
from whmr_tpu_torch.training import train_step as ts
from whmr_tpu_torch.utils import profiling
from whmr_tpu_torch.utils.testing import make_example_inputs, make_example_train_batch, tiny_config

from torch_port_util import release_memory  # noqa: F401 (autouse fixture)

FORWARD_ARGS = ("x", "center", "scale", "bbox_height", "orig_shape", "bbox_info")


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.reset()
    profiling.disable()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    model, consts = build_model(cfg, dtype=torch.float32, device="cpu")
    return cfg, model, consts


def _forward_inputs(cfg, batch=2):
    inp = make_example_inputs(cfg, batch)
    return [torch.from_numpy(inp[k]) for k in FORWARD_ARGS]


def _tree(recs):
    """{id: record} and the records by name."""
    by_id = {r["id"]: r for r in recs}
    by_name = {}
    for r in recs:
        by_name.setdefault(r["name"], []).append(r)
    return by_id, by_name


def _inside(child, parent):
    return parent["host_start_ns"] <= child["host_start_ns"] <= child["host_end_ns"] <= parent["host_end_ns"]


def test_forward_span_tree(tiny):
    cfg, model, consts = tiny
    profiling.enable()
    with torch.inference_mode():
        model(consts, *_forward_inputs(cfg))
    by_id, by_name = _tree(profiling.records())
    assert sorted(by_name) == ["whmr.backbone", "whmr.forward", "whmr.heads", "whmr.maf"]
    (root,) = by_name["whmr.forward"]
    assert root["parent"] is None and root["root"] == root["id"]
    # the heads are two intervals: before the MAF loop and after it
    assert [len(by_name[k]) for k in ("whmr.backbone", "whmr.heads", "whmr.maf")] == [1, 2, 1]
    order = [r["name"] for r in profiling.records() if r["parent"] is not None]
    assert order == ["whmr.backbone", "whmr.heads", "whmr.maf", "whmr.heads"]
    for r in by_id.values():
        assert r["root"] == root["id"] and r["thread"] == threading.get_ident()
        assert r["device_ms"] is None and r["host_ms"] > 0  # no card: host time only
        if r is not root:
            assert r["parent"] == root["id"] and _inside(r, root)


@pytest.mark.parametrize("kind", ["train_step", "train_step_accum", "hmr_train_step"])
def test_train_step_span_tree(kind):
    cfg = tiny_config()
    if kind == "hmr_train_step":
        model, consts = build_hmr(dtype=torch.float32, device="cpu")
    else:
        model, consts = build_model(cfg, dtype=torch.float32, device="cpu")
    state = ts.create_train_state(cfg, model)
    batch = {k: torch.from_numpy(v) for k, v in make_example_train_batch(cfg, 4).items()}
    gen = torch.Generator().manual_seed(0)
    profiling.enable()
    if kind == "train_step":
        ts.train_step(cfg, model, state, consts, batch, gen)
    elif kind == "train_step_accum":
        ts.train_step_accum(cfg, model, state, consts, {k: v.reshape(2, 2, *v.shape[1:]) for k, v in batch.items()},
                            gen)
    else:
        ts.hmr_train_step(cfg, model, state, consts, batch, gen)
    recs = profiling.records()
    by_id, by_name = _tree(recs)
    (root,) = by_name["train.step"]
    assert root["parent"] is None and all(r["root"] == root["id"] for r in recs)
    micro = 2 if kind == "train_step_accum" else 1
    phases = [r["name"] for r in recs if r["parent"] == root["id"]]
    if kind == "hmr_train_step":
        assert phases == ["train.forward", "train.backward", "train.optimizer"]
    else:
        assert phases == ["train.targets", "train.forward", "train.backward"] * micro + ["train.optimizer"]
        # the model's spans nest in the step's forward phase
        for r in by_name["whmr.forward"]:
            assert by_id[r["parent"]]["name"] == "train.forward" and _inside(r, by_id[r["parent"]])
        assert len(by_name["whmr.forward"]) == micro and len(by_name["whmr.maf"]) == micro
    for r in recs:
        if r is not root:
            assert _inside(r, by_id[r["parent"]])


def test_off_records_nothing_and_makes_no_event(tiny, monkeypatch):
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            made.append(self)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    cfg, model, consts = tiny
    with torch.inference_mode():
        model(consts, *_forward_inputs(cfg))
    # off: every span is the one shared no-op, which yields nothing
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a") as rec:
        assert rec is None
    profiling.add("serve.queue_wait", 0, 1)
    assert profiling.records() == [] and made == []
    assert profiling.summary() == {"spans": {}, "counters": {}, "dropped": 0}


class _FakeEvent:
    """A CUDA event on the host: `record` stamps a counter, `query` says
    whether the card has reached it (`done`)."""

    clock = 0
    done = True
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at = None

    def record(self):
        type(self).clock += 1
        self.at = type(self).clock

    def query(self):
        return type(self).done

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.fixture
def fake_card(monkeypatch):
    class Event(_FakeEvent):
        clock, done, made = 0, True, 0

    capturing = []
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: bool(capturing))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return Event, capturing


def test_device_events_pooled_and_read_lazily(fake_card):
    Event, _ = fake_card
    profiling.enable()
    Event.done = False
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
    assert Event.made == 4
    # the card has not reached the end events: no time yet, and no wait
    assert [r["device_ms"] for r in profiling.records()] == [None, None]
    Event.done = True
    # outer: recorded at 1 and 4; inner at 2 and 3
    assert {r["name"]: r["device_ms"] for r in profiling.records()} == {"outer": 3.0, "inner": 1.0}
    # read events go back to the pool: the next spans make none
    with profiling.span("again"):
        with profiling.span("again.inner"):
            pass
    assert Event.made == 4
    assert profiling.summary()["spans"]["again"]["device_ms_p50"] == 3.0
    # unread, the events of finished spans are reclaimed for new spans
    profiling.reset()
    Event.made = 0
    for _ in range(5):
        with profiling.span("loop"):
            pass
    assert Event.made == 2
    assert [r["device_ms"] for r in profiling.records()] == [1.0] * 5


def test_no_events_while_a_graph_is_captured(fake_card):
    Event, capturing = fake_card
    profiling.enable()
    capturing.append(True)
    with profiling.span("captured"):
        pass
    capturing.clear()
    with profiling.span("eager"):
        pass
    assert Event.made == 2
    assert {r["name"]: r["device_ms"] for r in profiling.records()} == {"captured": None, "eager": 1.0}


def test_profiler_session_records_and_ranges_enclose_the_ops(tiny):
    cfg, model, consts = tiny
    args = _forward_inputs(cfg)
    assert not profiling.enabled()
    with torch.inference_mode(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(consts, *args)
    # the session alone turned the spans on, for its life only
    names = {r["name"] for r in profiling.records()}
    assert names == {"whmr.forward", "whmr.backbone", "whmr.heads", "whmr.maf"}
    with torch.inference_mode():
        model(consts, *args)
    assert len(profiling.records("whmr.forward")) == 1
    events = list(prof.events())
    ranges = {e.name: e for e in events if e.name in names}
    assert set(ranges) == names
    for span_name, op_name in (("whmr.backbone", "aten::linear"), ("whmr.maf", "aten::bmm")):
        rng = ranges[span_name]
        inside = [e for e in events if e.name == op_name and e.thread == rng.thread
                  and rng.time_range.start <= e.time_range.start and e.time_range.end <= rng.time_range.end]
        assert inside, (span_name, op_name)
    # the forward's range encloses its module's ranges
    fwd = ranges["whmr.forward"].time_range
    for name in names:
        assert fwd.start <= ranges[name].time_range.start and ranges[name].time_range.end <= fwd.end


def test_ring_bound_and_drop_count():
    tracer = profiling.Tracer(capacity=4)
    tracer.enable()
    for i in range(10):
        with tracer.span(f"s{i}"):
            pass
    assert [r["name"] for r in tracer.records()] == ["s6", "s7", "s8", "s9"]
    assert tracer.dropped == 6 and tracer.summary()["dropped"] == 6
    tracer.reset()
    assert tracer.records() == [] and tracer.dropped == 0


def test_threads_keep_their_own_trees():
    profiling.enable()
    gate = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.span(f"{tag}.root"):
            gate.wait()
            with profiling.span(f"{tag}.child"):
                gate.wait()

    threads = [threading.Thread(target=work, args=(tag,)) for tag in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    by_id, by_name = _tree(profiling.records())
    for tag in ("a", "b"):
        (root,), (child,) = by_name[f"{tag}.root"], by_name[f"{tag}.child"]
        assert child["parent"] == root["id"] == child["root"] and child["thread"] == root["thread"]
    assert by_name["a.root"][0]["thread"] != by_name["b.root"][0]["thread"]


def test_threads_under_a_short_switch_interval_lose_nothing():
    """More threads than cores, each opening nested spans and counting, with
    the interpreter switching threads every microsecond: every span is kept
    under its own thread's root and no count is lost."""
    import os
    import sys

    n_threads, n_iter = 2 * (os.cpu_count() or 4), 200
    profiling.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_iter):
                with profiling.span("root"):
                    with profiling.span("child"):
                        profiling.count("stress")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert profiling.counter("stress") == n_threads * n_iter
    by_id, by_name = _tree(profiling.records())
    assert len(by_name["root"]) == len(by_name["child"]) == n_threads * n_iter and profiling.TRACER.dropped == 0
    for child in by_name["child"]:
        root = by_id[child["parent"]]
        assert root["name"] == "root" and child["root"] == root["id"] and child["thread"] == root["thread"]


def test_a_raising_block_still_closes_its_span():
    profiling.enable()
    with pytest.raises(ValueError):
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise ValueError("boom")
    with profiling.span("next"):
        pass
    by_id, by_name = _tree(profiling.records())
    assert by_name["inner"][0]["parent"] == by_name["outer"][0]["id"]
    assert by_name["next"][0]["parent"] is None  # the stack unwound
    assert profiling.last_root().name == "next"


def test_counters_always_count():
    assert not profiling.enabled()
    profiling.count("k1.launches")
    profiling.count("k1.launches", 2)
    profiling.count("k2.launches")
    assert profiling.counter("k1.launches") == 3 and profiling.counter("k3.launches") == 0
    assert profiling.counters() == {"k1.launches": 3, "k2.launches": 1}
    profiling.enable()
    with profiling.span("s"):
        pass
    profiling.reset(counters=False)
    assert profiling.records() == [] and profiling.counters() == {"k1.launches": 3, "k2.launches": 1}
    profiling.reset()
    assert profiling.counters() == {}


def test_summary_and_dump_format(tmp_path):
    profiling.enable()
    for start, end in ((0, 1_000_000), (0, 3_000_000), (0, 2_000_000)):
        profiling.add("w", start, end)
    profiling.count("c", 5)
    summary = profiling.summary()
    assert summary == {
        "spans": {"w": {"count": 3, "host_ms_p50": 2.0, "host_ms_p95": pytest.approx(2.9),
                        "device_ms_p50": None, "device_ms_p95": None}},
        "counters": {"c": 5}, "dropped": 0,
    }
    path = profiling.dump(str(tmp_path / "spans.json"))
    with open(path) as f:
        assert json.load(f) == summary
    assert profiling.quantile([], 0.5) is None
    assert profiling.quantile([4.0, 1.0, 2.0, 3.0], 0.5) == 2.5


def test_export_with_tracer_on_holds_no_profiler_op(tiny):
    cfg, model, consts = tiny
    profiling.enable()
    program = texport.export_serving(cfg, model, consts, batch_size=2, variant="eval")
    targets = [str(node.target) for node in program.graph.nodes if node.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    assert profiling.records() == []  # nothing recorded while the trace ran
    # the program runs as the live forward does, and records nothing itself
    args = texport.eval_args(cfg, 2, "cpu")
    with torch.no_grad():
        got = program.module()(*args)
    assert profiling.records() == []
    with torch.no_grad():
        want = texport.EvalServingModule(model, consts)(*args)
    assert {r["name"] for r in profiling.records()} == {"whmr.forward", "whmr.backbone", "whmr.heads", "whmr.maf"}
    torch.testing.assert_close(got["verts"], want["verts"])


def test_serve_queue_wait_under_the_batch_forward(tiny):
    cfg, model, consts = tiny
    from whmr_tpu_torch.data.assets import synthetic_smpl_assets

    pipe = DemoPipeline(cfg, model.state_dict(), synthetic_smpl_assets(), max_people=2, use_camcalib=False,
                        device="cpu")
    ex = BatchingExecutor(pipe, max_wait_ms=1.0, start=False)
    img = np.random.RandomState(0).randint(0, 255, (200, 160, 3), np.uint8)
    profiling.enable()
    results = []
    threads = [threading.Thread(target=lambda: results.append(ex.submit(img, dets=[Detection(80.0, 100.0, 90.0)],
                                                                        timeout=120)))
               for _ in range(2)]
    for t in threads:
        t.start()
    while ex.q.qsize() < 2:
        time.sleep(0.005)
    first = ex.q.get(timeout=30)
    first.dequeued_ns = time.perf_counter_ns()  # as the worker's loop stamps it
    group = [first]
    ex._collect_group(group)
    ex._run_group(group)
    for r in group:
        r.event.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(results) == 2 and ex.stats["requests"] == 2 and ex.stats["device_batches"] == 1
    by_id, by_name = _tree(profiling.records())
    (fwd,) = by_name["whmr.forward"]
    waits = by_name["serve.queue_wait"]
    assert len(waits) == 2
    for w in waits:
        assert w["parent"] == fwd["id"] == w["root"] and w["host_ms"] >= 0
        assert w["host_end_ns"] <= fwd["host_start_ns"]  # dequeued before the forward began
    report = ex.report()
    assert report["queue_wait_p50_ms"] == pytest.approx(profiling.quantile([w["host_ms"] for w in waits], 0.5))
    assert report["queue_wait_p95_ms"] >= report["queue_wait_p50_ms"]
    profiling.disable()
    assert ex.report() == ex.stats == {"requests": 2, "device_batches": 1, "coalesced_requests": 1, "crops": 2,
                                       "camcalib_calls": 0, "camcalib_cache_hits": 0}
