"""The port's own spans in a traced window, for the `program_span` readers.

The port records its spans (`whmr_tpu_torch/utils/profiling.py`) for the
life of any torch.profiler session, and `trace.traced` runs the window's
batches or steps twice under one: the CUDA-only pass first, then the
CPU+CUDA pass, which slows the host. So the CUDA-only pass's spans are
those of the first half of the root spans, in start order. Per root,
`median_ms` sums the host or device ms of the spans of one name under it
(`whmr.heads` is two intervals a forward), and takes the median over the
roots. It returns None where the program recorded no such spans, as a
program without the tracer does.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def records() -> List[Dict]:
    """The port's span records, or none from a port without the tracer."""
    try:
        from whmr_tpu_torch.utils import profiling

        return profiling.records()
    except (ImportError, AttributeError):
        return []


def median_ms(root: str, name: str, clock: str) -> Optional[float]:
    """The median over the CUDA-only pass's `root` spans of the summed
    `clock` ("host" or "device") ms of the `name` spans under each."""
    recs = records()
    roots = sorted((r for r in recs if r["name"] == root and r["parent"] is None), key=lambda r: r["host_start_ns"])
    roots = roots[:len(roots) // 2]
    key = clock + "_ms"
    sums = []
    for rt in roots:
        vals = [r[key] for r in recs if r["root"] == rt["id"] and r["name"] == name]
        if vals and None not in vals:
            sums.append(sum(vals))
    return statistics.median(sums) if sums else None
