"""The port's one tracer: spans and counters, on the profiler's clock.

A span is a named interval of host work, opened with `span(name)` where the
work happens (`with profiling.span("whmr.backbone"): ...`). Each record
holds its name, the id of its parent span and of its root span (shared by
every span of one forward, one step or one request), the thread, the host
start and end (`time.perf_counter_ns()`) and, on CUDA, its device time: a
pair of pooled CUDA events recorded on the current stream at entry and
exit, read lazily when the records are read (never with a synchronise
inside a span; skipped while the stream captures a CUDA graph).

Spans record while `enable()` is in force and for the life of any
`torch.profiler` session in the process. During a session each span also
opens a `torch.profiler.record_function` range of its name, so that in the
profiler's trace it sits on the same clock as the kernels it launched
(without a session nothing would record the range, so none is opened). Off,
a span costs one flag test: no record, no event, no allocation. Spans are
no-ops while `torch.export` or `torch.compile` traces, so no exported
program gains a profiler op. Records go to a bounded ring that counts what
it drops.

How to read a span's two times: its host ms is the time the host took to
enqueue its work, back-pressure from the launch queue included; its device
ms is the stream's time from the span's first work to its last, idle time
inside it included. Where the two are about equal, the host sets the pace.

Counters (`count(name, n)`) are plain integers that always count: the
kernel wrappers' launches (`k1.launches`, `k1.mma_launches`,
`k1.packed_launches`: those that read the fused qkv projection in place,
`k3.launches`, `k3.mma_launches`, `k2.launches`) and the serving executor's
statistics.

`start_trace` / `stop_trace` write a Chrome trace (`chrome://tracing`,
ui.perfetto.dev) of the host ops and, on the card, the CUDA kernels.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 65536  # span records kept before the oldest are dropped


class _Record:
    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns", "end_ns", "device_ms", "events", "range")

    def as_dict(self) -> Dict:
        return {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
                "thread": self.thread, "host_start_ns": self.start_ns, "host_end_ns": self.end_ns,
                "host_ms": (self.end_ns - self.start_ns) * 1e-6, "device_ms": self.device_ms}


class _Off:
    """What `span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "rec")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        rec = self.rec = _Record()
        rec.name = name

    def __enter__(self) -> _Record:
        t, rec = self.tracer, self.rec
        stack = t._stack()
        rec.id = next(t._ids)
        rec.parent = stack[-1].id if stack else None
        rec.root = stack[-1].root if stack else rec.id
        rec.thread = threading.get_ident()
        rec.device_ms = None
        rec.range = None
        if _autograd_profiler._is_profiler_enabled:
            rec.range = torch.profiler.record_function(rec.name)
            rec.range.__enter__()
        rec.events = t._start_events()
        stack.append(rec)
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        t, rec = self.tracer, self.rec
        rec.end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        if rec.range is not None:
            rec.range.__exit__(*exc)
            rec.range = None
        stack = t._stack()
        if stack and stack[-1] is rec:
            stack.pop()
        if rec.parent is None:
            t._local.last_root = rec
        t._keep(rec)
        return False


class Tracer:
    """Spans and counters; the module's functions act on one shared
    instance, `TRACER`."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.enabled = False
        self.dropped = 0
        self._ring: "collections.deque[_Record]" = collections.deque()
        self._pending: "collections.deque[_Record]" = collections.deque()  # events not yet read
        self._counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._free_events: Dict[int, list] = {}

    # -- spans -----------------------------------------------------------
    def recording(self) -> bool:
        return (self.enabled or _autograd_profiler._is_profiler_enabled) and not torch.compiler.is_compiling()

    def span(self, name: str):
        """A context manager timing the enclosed block as span `name`; it
        yields the record, or None when nothing records."""
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return _OFF
        if torch.compiler.is_compiling():
            return _OFF
        return _Span(self, name)

    def add(self, name: str, start_ns: int, end_ns: int, parent: Optional[_Record] = None) -> None:
        """Records a span of host time only that was not timed as a block
        (a wait between two threads), under `parent` (a record), or as a
        root."""
        if not self.recording():
            return
        rec = _Record()
        rec.name, rec.id, rec.thread = name, next(self._ids), threading.get_ident()
        rec.parent = parent.id if parent is not None else None
        rec.root = parent.root if parent is not None else rec.id
        rec.start_ns, rec.end_ns, rec.device_ms, rec.events, rec.range = start_ns, end_ns, None, None, None
        self._keep(rec)

    def last_root(self) -> Optional[_Record]:
        """The last root span that closed on this thread, or None."""
        return getattr(self._local, "last_root", None)

    def _stack(self) -> List[_Record]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _start_events(self):
        """(start, end, device) timing events of the current device, the
        start recorded on its current stream; None off CUDA and while the
        stream captures a graph."""
        if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
            return None
        dev = torch.cuda.current_device()
        free = self._free_events.get(dev)
        if not free:
            self._reclaim()
            free = self._free_events.get(dev)
        try:
            ev = free.pop()
        except (AttributeError, IndexError):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True), dev)
        ev[0].record()
        return ev

    def _reclaim(self, most: int = 16) -> None:
        """Reads the oldest spans whose end events the card has reached, at
        most `most`, returning their events to the pool (cheaper than
        creating events)."""
        with self._lock:
            for _ in range(min(most, len(self._pending))):
                rec = self._pending[0]
                self._resolve(rec)
                if rec.events is not None:
                    break
                self._pending.popleft()

    def _keep(self, rec: _Record) -> None:
        with self._lock:
            if len(self._ring) >= self.capacity:
                old = self._ring.popleft()
                self.dropped += 1
                self._resolve(old)
            self._ring.append(rec)
            while self._pending and self._pending[0].events is None:  # read by `records`
                self._pending.popleft()
            if rec.events is not None:
                self._pending.append(rec)

    def _resolve(self, rec: _Record) -> None:
        """Reads the device time of `rec` once its end event has completed,
        and returns its events to the pool."""
        ev = rec.events
        if ev is None or not ev[1].query():
            return
        rec.device_ms = ev[0].elapsed_time(ev[1])
        rec.events = None
        self._free_events.setdefault(ev[2], []).append(ev)

    def records(self, name: Optional[str] = None) -> List[Dict]:
        """The kept span records (named `name`, when given), in host start
        order; `device_ms` is None off CUDA and until the card has run the
        span's work."""
        with self._lock:
            recs = [r for r in self._ring if name is None or r.name == name]
            for r in recs:
                self._resolve(r)
        return [r.as_dict() for r in sorted(recs, key=lambda r: r.start_ns)]

    def summary(self) -> Dict:
        """Per span name its count and the median and 95th percentile of its
        host and device ms; the counters; the records dropped."""
        by_name: Dict[str, list] = {}
        for r in self.records():
            by_name.setdefault(r["name"], []).append(r)
        spans = {}
        for name, recs in by_name.items():
            host = [r["host_ms"] for r in recs]
            dev = [r["device_ms"] for r in recs if r["device_ms"] is not None]
            spans[name] = {"count": len(recs), "host_ms_p50": quantile(host, 0.5), "host_ms_p95": quantile(host, 0.95),
                           "device_ms_p50": quantile(dev, 0.5), "device_ms_p95": quantile(dev, 0.95)}
        return {"spans": spans, "counters": self.counters(), "dropped": self.dropped}

    def dump(self, path: str) -> str:
        """Writes `summary()` to `path` as JSON; returns the path."""
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)
        return path

    # -- counters --------------------------------------------------------
    def count(self, name: str, n: int = 1) -> None:
        with self._count_lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def counters(self) -> Dict[str, int]:
        return dict(self._counters)

    # -- state -----------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self, counters: bool = True) -> None:
        """Forgets the span records, the drop count and the pooled events,
        and the counters unless `counters` is False."""
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            self.dropped = 0
            self._free_events.clear()
        if counters:
            with self._count_lock:
                self._counters.clear()


def quantile(values: List[float], q: float) -> Optional[float]:
    """The q-quantile of `values` by linear interpolation, None if empty."""
    if not values:
        return None
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


TRACER = Tracer()
span = TRACER.span
add = TRACER.add
last_root = TRACER.last_root
records = TRACER.records
summary = TRACER.summary
dump = TRACER.dump
count = TRACER.count
counter = TRACER.counter
counters = TRACER.counters
enable = TRACER.enable
disable = TRACER.disable
reset = TRACER.reset


def enabled() -> bool:
    return TRACER.enabled


def start_trace() -> torch.profiler.profile:
    """Start a torch.profiler capture of host ops, and of CUDA kernels when
    there is a card. Stop it with `stop_trace`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: str) -> str:
    """Stop `prof` and write its Chrome trace under `log_dir`; returns the
    file's path."""
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The card's allocator counters (`torch.cuda.memory_stats`), or None
    without a card."""
    if not torch.cuda.is_available():
        return None
    return {k: int(v) for k, v in torch.cuda.memory_stats(device).items()}
