"""Where the time of whmr_tpu_torch's forward, or of its train step, goes on
one NVIDIA GPU.

    python3 scripts/profile_torch_forward.py [--attn pallas] [--out DIR]
    python3 scripts/profile_torch_forward.py --train [--out DIR]

Forward: builds the full-width ViT-B WHMR (bf16, seeded random weights,
synthetic SMPL assets), warms it up at B=48, and traces three forwards.
--train: builds the full-width train step at WHMRConfig()'s defaults (bf16
compute, fp32 parameters, GT IUV render through K2, Adam) at B=64, with
keypoints from the GT joints through a plausible crop camera, takes two
warm-up steps, and traces one step.

Prints the device time by kernel (top rows), the summed device time per
forward or step, the host wall time under the profiler, the same wall time
without it, and the device's busy share (summed device time over the
unprofiled wall time; kernels that overlap would count twice, and this
eager code runs one stream). Writes the full table to
DIR/profile_<forward_attn|train>_b<B>.txt.
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
from whmr_tpu_torch.data.assets import synthetic_smpl_assets  # noqa: E402
from whmr_tpu_torch.models.whmr import build_model  # noqa: E402
from whmr_tpu_torch.training import train_step as ts  # noqa: E402
from whmr_tpu_torch.training.gt_renderer import build_render_consts  # noqa: E402
from whmr_tpu_torch.utils.testing import (  # noqa: E402
    make_example_inputs,
    make_example_train_batch,
    make_keypoints_consistent,
)

BATCH = 48
REPS = 3


def forward_fn(attn):
    cfg = WHMRConfig().with_overrides(**{"vit.attn_impl": attn})
    model, consts = build_model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    inp = {k: torch.from_numpy(v).cuda() for k, v in make_example_inputs(cfg, BATCH).items()}

    @torch.inference_mode()
    def run():
        model(consts, **inp)

    return run, BATCH, REPS, f"forward_{attn}", "forward"


def train_fn():
    cfg = WHMRConfig()
    model, consts = build_model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    rc = build_render_consts(synthetic_smpl_assets(0), device="cuda")
    b = cfg.train.batch_size
    batch_np = make_keypoints_consistent(consts, make_example_train_batch(cfg, b))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    state = ts.create_train_state(cfg, model)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run():
        ts.train_step(cfg, model, state, consts, batch, gen, rc)

    return run, b, 1, "train", "step"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--attn", default="pallas", choices=("pallas", "einsum"))
    ap.add_argument("--train", action="store_true", help="profile the train step instead of the forward")
    ap.add_argument("--out", default="build/profiles")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_forward.py needs a CUDA device")

    run, batch, reps, name, unit = train_fn() if opts.train else forward_fn(opts.attn)
    for _ in range(2 if opts.train else 3):
        run()
    torch.cuda.synchronize()
    n_plain = 5 if opts.train else 10
    t0 = time.perf_counter()
    for _ in range(n_plain):
        run()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / n_plain
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps

    events = prof.key_averages()
    # Kernels only: CPU-side ops also carry the device time of what they launched.
    device_us = sum(
        e.self_device_time_total for e in events if e.device_type == DeviceType.CUDA
    ) / reps
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    os.makedirs(opts.out, exist_ok=True)
    path = Path(opts.out) / f"profile_{name}_b{batch}.txt"
    path.write_text(table)
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(f"B={batch} {name}: device time {device_us / 1e3:.3f} ms a {unit}, "
          f"wall {wall * 1e3:.3f} ms a {unit} under the profiler, {plain_wall * 1e3:.3f} ms without; "
          f"device busy share {device_us / 1e3 / (plain_wall * 1e3):.3f} (of the unprofiled wall); "
          f"full table in {path}")


if __name__ == "__main__":
    main()
