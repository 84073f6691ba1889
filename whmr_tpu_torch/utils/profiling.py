"""Profiling/observability helpers on torch.profiler.

Counterpart of `whmr_tpu/utils/profiling.py`, whose traces come from
jax.profiler. Here a trace is a Chrome trace (`chrome://tracing`,
ui.perfetto.dev) of the host ops and, on the card, the CUDA kernels.
whmr_tpu's `enable_compile_cache` (the persistent XLA compilation cache) has
no counterpart: PyTorch runs eagerly, and the port's CUDA kernels are built
once into `build/` by `ops/cuda_build.py`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, Optional

import torch


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


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a Chrome trace of the enclosed block into `log_dir`."""
    prof = start_trace()
    try:
        yield
    finally:
        stop_trace(prof, log_dir)


class Timer:
    """Host-clock spans. Work on the card is asynchronous: end a span on a
    `torch.cuda.synchronize()` (or a value read back to the host) for it to
    hold the device time."""

    def __init__(self):
        self.records: Dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        return {
            name: sum(v) / len(v) for name, v in self.records.items() if v
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The card's allocator counters (`torch.cuda.memory_stats`), or None
    without a card."""
    if not torch.cuda.is_available():
        return None
    return {k: int(v) for k, v in torch.cuda.memory_stats(device).items()}
