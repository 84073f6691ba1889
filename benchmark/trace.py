"""The device trace of a traced window, reduced in memory.

`traced(fn)` runs `fn` twice, each time under `torch.profiler` and ending
with a device synchronise:

1. with the CUDA activity alone, which records the device's operations and
   leaves the host nearly at its untraced pace. From it come `window_s`,
   the host clock's time from the call to the synchronise; `busy_s`, the
   union of the device's kernel, memcpy and memset intervals (overlaps
   counted once); `kernels`, name -> [launches, seconds] of every device
   operation; and `device_ops`, the ten that took most time;
2. with the CPU activity too, inside a host span named "window", which
   slows the host. From it come only `idle_gaps`: the device's idle time
   inside the span, summed by what the host's dispatching thread was doing
   when each gap began (the innermost host operation then running), the
   ten largest; and, for the record, that pass's own `labelled_busy_s`
   and `labelled_window_s`.

Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function


def _events(prof):
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:
        return []
    return res.events()


def traced(fn: Callable[[], None]) -> Dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    out = device_summary(_events(prof), window_s)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            fn()
            torch.cuda.synchronize()
    labelled = idle_gaps(_events(prof))
    out["idle_gaps"] = labelled.get("idle_gaps", [])
    out["labelled_busy_s"], out["labelled_window_s"] = labelled.get("busy_s"), labelled.get("window_s")
    return out


def _device(events, w0=None, w1=None) -> List[Tuple[int, int, str]]:
    """The device's operations, clipped to [w0, w1] where given, by start."""
    dev = []
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.name() == "window" or e.is_user_annotation():
            continue  # a host span's own mark on the device timeline is no operation
        a, b = e.start_ns(), e.end_ns()
        if w0 is not None:
            a, b = max(a, w0), min(b, w1)
        if b > a:
            dev.append((a, b, e.name()))
    dev.sort()
    return dev


def _union(dev, w0, w1):
    """(busy ns, idle gaps as (start, end)) of sorted device intervals inside [w0, w1]."""
    busy, gaps, cur_a, cur_b = 0, [], None, None
    for a, b, _ in dev:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            gaps.append((w0 if cur_b is None else cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        gaps.append((cur_b, w1))
    return busy, gaps


def device_summary(events, window_s: float) -> Dict:
    dev = _device(events)
    if not dev:
        return {"window_s": window_s, "busy_s": 0.0, "kernels": {}, "device_ops": []}
    busy, _ = _union(dev, dev[0][0], dev[-1][1])
    kernels: Dict[str, list] = {}
    for a, b, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"window_s": window_s, "busy_s": busy * 1e-9, "kernels": kernels,
            "device_ops": [[name[:120], v[1]] for name, v in top]}


def idle_gaps(events) -> Dict:
    win = [e for e in events if e.name() == "window" and e.device_type() == DeviceType.CPU]
    if not win:
        return {}
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    thread = win[0].start_thread_id()
    host = sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                  if e.device_type() == DeviceType.CPU and e.name() != "window" and not e.is_user_annotation()
                  and e.start_thread_id() == thread
                  and e.start_ns() >= w0 and e.duration_ns() > 0)
    busy, gaps = _union(_device(events, w0, w1), w0, w1)
    starts = [h[0] for h in host]
    by_label: Dict[str, float] = {}
    for a, b in gaps:
        if b <= a:
            continue
        i = bisect.bisect_right(starts, a) - 1
        label = "(no host operation)"
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= a:
                label = host[j][2]
                break
        by_label[label] = by_label.get(label, 0.0) + (b - a) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "idle_gaps": [[k[:120], v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:10]]}
