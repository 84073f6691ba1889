"""Where the time of whmr_tpu_torch's forward goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_forward.py [--attn pallas] [--out DIR]

Builds the full-width ViT-B WHMR (bf16, seeded random weights, synthetic
SMPL assets), warms it up at B=48, and traces three forwards with
torch.profiler.
Prints the device time by kernel (top rows), the summed device time per
forward, the host wall time per forward, and their ratio (the device's busy
share; kernels that overlap would count twice, and this eager forward runs
one stream), and the same wall time without the profiler. Writes the full
table to DIR/profile_forward_<attn>_b48.txt.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from whmr_tpu_torch.config import WHMRConfig  # noqa: E402
from whmr_tpu_torch.models.whmr import build_model  # noqa: E402
from whmr_tpu_torch.utils.testing import make_example_inputs  # noqa: E402

BATCH = 48
REPS = 3

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--attn", default="pallas", choices=("pallas", "einsum"))
    ap.add_argument("--out", default="build/profiles")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_forward.py needs a CUDA device")

    cfg = WHMRConfig().with_overrides(**{"vit.attn_impl": opts.attn})
    model, consts = build_model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    inp = {k: torch.from_numpy(v).cuda() for k, v in make_example_inputs(cfg, BATCH).items()}
    with torch.inference_mode():
        for _ in range(3):
            model(consts, **inp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            model(consts, **inp)
        torch.cuda.synchronize()
        plain_wall = (time.perf_counter() - t0) / 10
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(REPS):
                model(consts, **inp)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / REPS

    events = prof.key_averages()
    # Kernels only: CPU-side ops also carry the device time of what they launched.
    device_us = sum(
        e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA
    ) / REPS
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    os.makedirs(opts.out, exist_ok=True)
    path = Path(opts.out) / f"profile_forward_{opts.attn}_b{BATCH}.txt"
    path.write_text(table)
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(f"B={BATCH} attn={opts.attn}: device time {device_us / 1e3:.3f} ms a forward, "
          f"wall {wall * 1e3:.3f} ms a forward under the profiler, {plain_wall * 1e3:.3f} ms without; "
          f"device busy share {device_us / 1e3 / (plain_wall * 1e3):.3f} (of the unprofiled wall); "
          f"full table in {path}")


if __name__ == "__main__":
    main()
