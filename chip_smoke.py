"""Smoke run of whmr_tpu_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles every CUDA kernel from the sources in this checkout into
   build/, one nvcc for each source, all started together; prints ptxas's
   registers and spill bytes for each kernel instantiation, and fails on a
   spill in the tensor-core ("mma") variant of K1 and K3 or in any of K2's
   kernels.
3. Kernels: holds each kernel against its plain PyTorch version on the
   card. K1 (attention) and K3 (fused_attention, the same function in K3's
   launch shape) at the forward's shapes, ViT-H's head (D = 80), the
   tensor-core edge N = 256, N = 300 and D = 20 (bf16 on CUDA cores) and a
   ragged shape, in bf16 and fp32, at one bf16 ulp; checks that every bf16
   launch at N <= 256 and D % 8 == 0 took the tensor-core variant and no
   other did, and that K3's bf16 output equals K1's bit for bit. K2
   (rasterizer) at the train step's render (B=64 posed bodies with their
   least-squares GT cameras, the 13,776-face topology, the 128x96 window at
   origin (16, 0)), on a ragged case (ties
   inside and across chunks, padding faces, sides that are no multiple of
   the tile) and with the largest GT camera, which covers every tile; prints
   what the render needs (`raster_work`) and the pairs the chunk cull leaves.
4. Forward path: the full-width WHMR forward (ViT-B, 3 MAF steps, CamCalib,
   world SMPL) in bf16 with vit.attn_impl="pallas", seeded random weights and
   synthetic SMPL assets: B=16 crops without a frame and B=48 crops with one
   600x600 CamCalib frame. Counts every kernel's launches over exactly those
   two forwards (all 24 of K1's on tensor cores), checks shapes and
   finiteness, and compares the vertices and the ViT feature map (which
   the attention drives directly) with the same weights under
   attn_impl="einsum" and in fp32.
5. Train path: 3 steps of the full-width train step at WHMRConfig()'s
   defaults (ViT-B with drop path 0.3, 3 MAF steps, stage 2, the GT IUV
   render, Adam at 5e-5; bf16 compute, fp32 parameters; B=64, keypoints
   from the GT joints through a plausible crop camera). Counts the launches
   over exactly those steps (K2 once a step, K1 never: training runs
   "einsum"), and checks finite metrics, the step count, that every
   parameter the loss reaches moved and stayed finite, that the BatchNorm
   buffers moved, that step 1's GT IUV maps from K2 equal those from the
   plain version, and that step 1's bf16 loss is close to an fp32 twin's
   with the same weights and generator seed.
6. Times (CUDA events / synchronized host clock, after warm-up): each kernel
   beside its bound, its plain version and the PyTorch library call for the
   same function (none for K2), K1 and K3 also in their CUDA-core variant
   at the same bf16 shape, K2 also with its wrapper, its face tables and under
   the largest GT camera; forward crops/s at B=48 with "pallas" and
   with "einsum"; train step ms and crops/s at B=64; peak memory.
7. Trainer path: `Trainer.fit` at the same width, 2 epochs x 3 steps of
   B=64 fed by the port's BatchLoader and device_prefetch from an in-memory
   dataset, log_every=1, an async save every 4 steps and validation over 2
   batches of 48. Counts the launches over the fit (K2 once a step, K1 and
   K3 never), checks 6 finite metric records, the validation count and
   PA-MPJPE, the checkpoints on disk (steps 3, 4, 6 and best/), the step-4
   checkpoint's epoch and batch, and that a fresh Trainer resumes to the
   live parameters, BatchNorm buffers and Adam moments bit for bit. Then a
   SIGTERM after the loader's second batch: SystemExit(0) with a checkpoint
   at step 2, batch 2, and a resume that ends the epoch at step 3. Times the
   fit's ms a step beside the bare step's and its host time by span
   (profiling.Timer), a blocking and an async checkpoint save, the save's
   host snapshot alone into fresh and into reused host pages, and the
   checkpoint's size. Its run directories live under build/ and are deleted
   at the end.
8. CLI path: the two entry points a user runs, in-process through their
   `main(argv)`, at full width (WHMRConfig(), ViT-B, 3 MAF steps) on a
   dataset written to disk from seed 0: 192 PNG images of 480x360 and a
   label npz in the reference schema (keypoints from the GT joints, GT
   camera rotations and world poses), GT part maps of 64 of the images and
   a COCO keypoint json for them. `whmr-train` runs 3 steps of B=64 in
   bf16 with augmentation on (decode, crop and warp on the BatchLoader's
   threads) and the GT render on; the launches of that run are K2 once a
   step and no K1 or K3, every metric record is finite and the epoch
   checkpoint is on disk. `whmr-eval` then runs three times on that
   checkpoint, fp32 with --misc vit.attn_impl pallas, at B=32: the metric
   protocol over the 192 crops, --eval_parts and --coco_ap over the 64;
   each run launches K1 12 times a forward batch, none on tensor cores,
   and never K2; every printed metric is finite and in its range, and the
   metric protocol's PVE/MPJPE/PA-MPJPE equal run_evaluation's on the same
   model and batches within 1e-4 relative. Times: whmr-train's ms a step
   beside the bare step and the fit step, the loader's host ms a batch,
   the eval's crops/s by protocol and the parts render's ms a batch through
   `ops/rasterizer.py::rasterize`. Its run directory lives under build/
   and is deleted at the end.

Output: a line with the card's name and power limit, one JSON line
{"kernels": [...]}, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from whmr_tpu_torch.config import WHMRConfig
from whmr_tpu_torch.data.assets import synthetic_smpl_assets
from whmr_tpu_torch.data import loader as loader_module
from whmr_tpu_torch.data.loader import BatchLoader, device_prefetch
from whmr_tpu_torch.data.npz_dataset import NpzDataset
from whmr_tpu_torch.models.smpl import smpl_forward
from whmr_tpu_torch.models.whmr import WHMR, build_model
from whmr_tpu_torch.ops import attention as k1
from whmr_tpu_torch.ops import cuda_build
from whmr_tpu_torch.ops import rasterizer_kernel as k2
from whmr_tpu_torch.ops.iuv import iuv_img2map
from whmr_tpu_torch.ops.rotation import batch_rodrigues
from whmr_tpu_torch.inference import eval_cli
from whmr_tpu_torch.inference import evaluate as evaluate_module
from whmr_tpu_torch.inference.part_segm import render_part_segmentation
from whmr_tpu_torch.training import cli as train_cli
from whmr_tpu_torch.training import train_step as ts
from whmr_tpu_torch.training import trainer as trainer_module
from whmr_tpu_torch.training.gt_renderer import build_render_consts, raster_inputs
from whmr_tpu_torch.training.trainer import Trainer
from whmr_tpu_torch.utils import profiling
from whmr_tpu_torch.utils.checkpoint import CheckpointManager, _to_host
from whmr_tpu_torch.utils.testing import (
    make_example_inputs,
    make_example_train_batch,
    make_keypoints_consistent,
    make_ragged_raster_case,
    write_npz_dataset,
)

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit).
HBM_BYTES_PER_S = 3.35e12
# torch.cuda._sleep spins for this many clock cycles a second at the H100's
# top SM clock (1.98 GHz); at a lower clock the hold only lasts longer.
SLEEP_CYCLES_PER_S = 1.98e9
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
KERNELS = ("attention", "rasterizer")
# fp32 operations of K2's coverage-and-depth test of one (pixel, face) pair:
# three barycentrics at 2 mul + 2 add, three compares, the depth at
# 3 mul + 2 add, a select and a min.
RASTER_OPS_PER_PAIR = 3 * 4 + 3 + 5 + 2
# K2's kernels: the face pass and the resolve step.
RASTER_INSTANTIATIONS = 2
TRAIN_STEPS = 3
# The trainer path: 2 epochs of 3 steps, validation over 2 batches of 48.
TRAINER_STEPS_PER_EPOCH = 3
VAL_BATCHES, VAL_BATCH = 2, 48
# Parameters whose gradient is structurally zero in the stage-2 train step
# at the default loss weights, in whmr_tpu as here: CamCalib (no full frame
# in training), and the Tz head and global-orientation regressor, which
# reach only the world keypoint loss (loss.kp_2d_w = 0).
UNREACHED = ("cam_model.", "conv.", "transformer_decoder.", "est_Tz.", "global_orient.")
# bf16 step-1 loss against the fp32 twin's, relative: about 10x the reading
# on an H100 80GB HBM3 (4.1e-5).
LOSS_RTOL = 5e-4
# The CLI path: 192 images on disk (3 batches of 64: whmr-train's loader
# drops a partial batch), GT part maps and COCO annotations for 64;
# whmr-train at B=64 for 3 steps, whmr-eval at B=32.
CLI_IMAGES, CLI_ANNOTATED = 192, 64
CLI_TRAIN_BATCH, CLI_TRAIN_STEPS, CLI_EVAL_BATCH = 64, 3, 32
# whmr-eval's metric protocol against run_evaluation called directly.
CLI_METRIC_RTOL = 1e-4


# Each kernel wrapper's launch count, by the name the kernels line gives it.
WRAPPERS = {"attention": k1.attention, "fused_attention": k1.fused_attention, "rasterizer": k2.rasterize_kernel}
# The attention wrappers also count their tensor-core launches.
MMA_WRAPPERS = {"attention": k1.attention, "fused_attention": k1.fused_attention}


def reset_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0
    for fn in MMA_WRAPPERS.values():
        fn.mma_launches = 0


def read_launches():
    """{name: launches} and {name + ".mma": tensor-core launches}."""
    out = {name: fn.launches for name, fn in WRAPPERS.items()}
    out.update({f"{name}.mma": fn.mma_launches for name, fn in MMA_WRAPPERS.items()})
    return out


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean device milliseconds per call of `fn`, by CUDA events around
    `iters` calls. A sleep kernel holds the stream first, for longer than
    the host takes to enqueue the calls, so that the events time the
    device's work and not the host's gaps between launches (K1 and K3 take
    less time on the card than their wrappers take on the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_s = min(0.2, 1.5 * iters * (time.perf_counter() - t0) + 1e-3)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters=200):
    """Host microseconds a call of `fn` takes to enqueue its work (the
    device keeps up, so the queue never fills)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def attention_bound_ms(shape, dtype):
    """Least time for K1's work: q, k, v read once and o written once, against
    4*B*H*N*N*D operations (two products) at the peak for `dtype`."""
    b, h, n, d = shape
    esize = torch.finfo(dtype).bits // 8
    t_bytes = 4 * b * h * n * d * esize / HBM_BYTES_PER_S
    t_ops = 4 * b * h * n * n * d / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_tolerance(want, dtype):
    """fp32: sums in another order. bf16: one output ulp (2**-8 relative,
    2**-7 absolute below 1), since P and the output are rounded to bf16."""
    if dtype == torch.float32:
        return torch.full_like(want, 2e-5, dtype=torch.float32)
    return 2**-7 * want.float().abs().clamp(min=1.0)


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    import cv2

    try:
        import yaml
        have_yaml = f"PyYAML {yaml.__version__}"
    except ImportError:
        have_yaml = "no PyYAML (load_yaml and --cfg_file need it)"
    log(f"host: cv2 {cv2.__version__}; {have_yaml}")
    return smi


def rasterizer_bound_ms(face_bbox, bbox, resolution, tile_hw, origin, n_attr):
    """Least time for K2's work on these inputs, as `k2.raster_work` counts
    it: the table rows of the faces that can shade a pixel read once and zbuf
    and attrs written once, against the coverage-and-depth test of each
    (pixel, face) pair whose pixel centre lies in the face's padded bbox, at
    the fp32 peak. Returns (ms, bound_by, counts), counts holding those pairs,
    the live faces and the bytes, and the pairs the chunk cull leaves (each
    pixel of a tile against each face of a chunk whose bbox meets the tile:
    the count of the first design's bound)."""
    pairs, live, n_bytes = k2.raster_work(face_bbox, resolution, origin, n_attr)
    h, w = resolution
    th, tw = tile_hw
    hits = k2.tile_hits(bbox, resolution, tile_hw, origin)  # (B, tiles, K)
    nbx = -(-w // tw)
    tiles = torch.arange(hits.shape[1], device=hits.device)
    pix = ((h - (tiles // nbx) * th).clamp(max=th) * (w - (tiles % nbx) * tw).clamp(max=tw)).float()
    chunk = face_bbox.shape[2] // bbox.shape[2]
    chunk_pairs = float((hits.float().sum(dim=2) * pix).sum().item()) * chunk
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = pairs * RASTER_OPS_PER_PAIR / PEAK_OPS_PER_S[torch.float32]
    counts = {"pairs": pairs, "live_faces": live, "bytes": n_bytes, "chunk_cull_pairs": chunk_pairs}
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), counts


def k2_work_line(counts):
    return (f"{counts['pairs']:.4g} (pixel, face) pairs in their face's padded bbox, {counts['live_faces']} faces "
            f"that can shade a pixel, {counts['bytes'] / 1e6:.2f} MB; pairs the chunk cull leaves "
            f"{counts['chunk_cull_pairs']:.4g}")


# K1's and K3's tensor-core kernels, one instantiation each for 64, 128,
# 192 and 256 padded keys.
MMA_INSTANTIATIONS = 8


def phase_build():
    """Builds every kernel (even if build/ holds it, so that ptxas reports);
    fails on a spill in a tensor-core kernel or in K2. Returns K2's ptxas
    report by function."""
    t0 = time.perf_counter()
    texts = cuda_build.build_all(KERNELS, force=True)
    log(f"build: {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s (in parallel)")
    mma = 0
    for name, text in texts.items():
        for fn, r in cuda_build.ptxas_report(text).items():
            spills = r.get("spill_stores", 0) + r.get("spill_loads", 0)
            log(f"  {name}: {fn}: {r.get('registers')} registers, {r.get('spill_stores')} bytes spill stores, "
                f"{r.get('spill_loads')} bytes spill loads")
            if "mma_kernel" in fn:
                mma += 1
                check(spills == 0, f"the tensor-core kernel {fn} spills {spills} bytes")
            if "raster_" in fn:
                check(spills == 0, f"K2's {fn} spills {spills} bytes")
    check(mma == MMA_INSTANTIATIONS, f"ptxas reported {mma} tensor-core kernels, want {MMA_INSTANTIATIONS}")
    raster = cuda_build.ptxas_report(texts["rasterizer"])
    check(len(raster) == RASTER_INSTANTIATIONS, f"ptxas reported {len(raster)} K2 kernels, want {RASTER_INSTANTIATIONS}")
    return raster


def phase_kernels():
    """K1 and K3 against their plain version; returns {(shape, dtype): max_abs_err}."""
    errs = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    # The forward's heads at B=16 and 48, ViT-H's (D = 80), a ragged one and
    # D = 20 (no multiple of 8: CUDA cores in bf16); in bf16 also the
    # tensor-core edge N = 256 and N = 300, above it. (fp32 at (256, 128)
    # needs more shared memory than a block has.)
    shapes = [(16, 12, 192, 64), (48, 12, 192, 64), (16, 16, 192, 80), (3, 2, 63, 32), (3, 2, 50, 20)]
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes + ([(2, 4, 256, 128), (2, 2, 300, 64)] if dtype == torch.bfloat16 else []):
            q, k, v = (torch.randn(*shape, device="cuda", generator=g, dtype=dtype) for _ in range(3))
            reset_launches()
            got = k1.attention(q, k, v)
            torch.cuda.synchronize()
            want = k1.attention_reference(q, k, v)
            err = (got.float() - want.float()).abs()
            tol = k1_tolerance(want, dtype)
            errs[(shape, dtype)] = err.max().item()
            log(f"K1 {tuple(shape)} {str(dtype)[6:]}: max_abs_err {errs[(shape, dtype)]:.3g} "
                f"(tolerance {tol.max().item():.3g})")
            check(bool((err <= tol).all()), f"K1 disagrees with its plain version at {shape} {dtype}")
            # K3 computes K1's function with K1's numerics: the same plain
            # version and tolerance.
            got3 = k1.fused_attention(q, k, v)
            torch.cuda.synchronize()
            err3 = (got3.float() - want.float()).abs()
            errs[("K3", shape, dtype)] = err3.max().item()
            log(f"K3 {tuple(shape)} {str(dtype)[6:]}: max_abs_err {err3.max().item():.3g} "
                f"(tolerance {tol.max().item():.3g})")
            check(bool((err3 <= tol).all()), f"K3 disagrees with its plain version at {shape} {dtype}")
            mma = int(k1._variant(shape, dtype) == "mma")
            n = read_launches()
            check((n["attention"], n["attention.mma"], n["fused_attention"], n["fused_attention.mma"])
                  == (1, mma, 1, mma), f"{shape} {dtype}: launches {n}, want {mma} on tensor cores each")
            if dtype == torch.bfloat16:
                check(torch.equal(got3, got), f"K3's bf16 output differs from K1's at {shape}")
    log("K3 equals K1 bit for bit at every bf16 shape; bf16 at N <= 256 and D % 8 == 0 ran on tensor cores, "
        "the rest did not")
    for name, fn in (("K1", k1.attention), ("K3", k1.fused_attention)):
        q = torch.randn(1, 2, 16, 32, device="cuda", requires_grad=True)
        try:
            fn(q, q.detach(), q.detach()).sum().backward()
        except NotImplementedError:
            log(f"{name} backward raises NotImplementedError (forward-only)")
        else:
            raise SmokeError(f"backward through {name} did not raise")
    return errs


def _inputs(cfg, batch, frame, device):
    inp = {k: torch.from_numpy(v).to(device) for k, v in make_example_inputs(cfg, batch).items()}
    if frame:
        ch, cw = cfg.cam_img_size
        full = np.random.RandomState(1).randn(1, ch, cw, 3).astype(np.float32)
        inp["full_x"] = torch.from_numpy(full).to(device)
    return inp


def _verts(out):
    return out["smpl_out"][-1]["verts"], out["global_output"]["global_verts"]


def _twin(cfg, model, dtype, attn_impl):
    """Same weights as `model`, another compute dtype or attention impl."""
    twin = WHMR(cfg.with_overrides(**{"vit.attn_impl": attn_impl}), dtype=dtype)
    twin.load_state_dict(model.state_dict())
    return twin.cuda().eval()


@torch.inference_mode()
def phase_main_path():
    cfg = WHMRConfig().with_overrides(**{"vit.attn_impl": "pallas"})
    t0 = time.perf_counter()
    model, consts = build_model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    log(f"model: ViT-B WHMR, {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    runs = [(16, False), (48, True)]
    inputs = {r: _inputs(cfg, r[0], r[1], "cuda") for r in runs}
    model(consts, **inputs[runs[0]])  # first call: cuDNN/cuBLAS set-up outside the count
    torch.cuda.synchronize()

    reset_launches()
    outs = {r: model(consts, **inputs[r]) for r in runs}
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"main path: {len(runs)} forwards, launches {launches}")
    check(launches["attention"] == 12 * len(runs), f"K1 launched {launches['attention']} times, want 12 a forward")
    check(launches["attention.mma"] == launches["attention"], "a K1 launch of the forward missed the tensor cores")
    check(launches["fused_attention"] == 0 and launches["rasterizer"] == 0, "K2 or K3 launched in the forward")
    for (b, frame), out in outs.items():
        for name, v in zip(("verts", "global_verts"), _verts(out)):
            check(v.shape == (b, 6890, 3), f"{name} shape {tuple(v.shape)} at B={b}")
            check(bool(torch.isfinite(v).all()), f"{name} not finite at B={b}")
        cam = out["vis"]["cam_rotmat"]
        check(bool(torch.isfinite(cam).all()) and cam.shape == (b, 3, 3), "cam_rotmat")
    log("main path: output shapes (B, 6890, 3) and finite")

    # The same weights under "einsum" attention and in fp32. The decoders
    # start at a gain of 0.01, so the vertices move little with the ViT; the
    # feature map is compared too, relative to its largest entry.
    crops = inputs[runs[0]]["x"].permute(0, 3, 1, 2)
    feat = model.feature_extractor(crops).float()
    for label, dtype, impl, verts_tol, feat_tol in (
        ("bf16 einsum", torch.bfloat16, "einsum", 1e-3, 5e-2),
        ("fp32 pallas", torch.float32, "pallas", 2e-3, 5e-2),
    ):
        twin = _twin(cfg, model, dtype, impl)
        for r in runs:
            ref = twin(consts, **inputs[r])
            for name, a, b in zip(("verts", "global_verts"), _verts(outs[r]), _verts(ref)):
                d = (a.float() - b.float()).abs().max().item()
                log(f"compare {label} B={r[0]} {name}: max_abs_diff {d:.4g} m (tolerance {verts_tol} m)")
                check(d <= verts_tol, f"bf16 pallas forward differs from {label} by {d} m")
        ref = twin.feature_extractor(crops).float()
        d = ((feat - ref).abs().max() / ref.abs().max()).item()
        log(f"compare {label} B={runs[0][0]} ViT features: max_abs_diff / max_abs {d:.4g} (tolerance {feat_tol})")
        check(d <= feat_tol, f"bf16 pallas ViT features differ from {label} by {d} relative")
        del twin
    return cfg, model, consts, inputs, launches


@torch.inference_mode()
def phase_times(cfg, model, consts, inputs, launches, errs):
    g = torch.Generator(device="cuda").manual_seed(1)
    kernels = []
    for b in (16, 48):
        shape = (b, 12, 192, 64)
        q, k, v = (torch.randn(*shape, device="cuda", generator=g, dtype=torch.bfloat16) for _ in range(3))
        ms = cuda_ms(lambda: k1.attention(q, k, v), 200)
        ms3 = cuda_ms(lambda: k1.fused_attention(q, k, v), 200)
        # The CUDA-core variant (the first design) at the same shape, for comparison.
        rows_ms = cuda_ms(lambda: k1._launch(q, k, v, False, "rows"), 50)
        rows3_ms = cuda_ms(lambda: k1._launch(q, k, v, True, "rows"), 20)
        plain_ms = cuda_ms(lambda: k1.attention_reference(q, k, v), 50)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 200)
        bound_ms, bound_by = attention_bound_ms(shape, torch.bfloat16)
        hosts = (host_us(lambda: k1.attention(q, k, v)), host_us(lambda: k1.fused_attention(q, k, v)))
        for name, t, rows_t, host in (("K1", ms, rows_ms, hosts[0]), ("K3", ms3, rows3_ms, hosts[1])):
            log(f"{name} B={b} bf16: {t * 1e3:.2f} us ({bound_ms / t:.1%} of the bound), CUDA-core variant "
                f"{rows_t * 1e3:.1f} us; bound {bound_ms * 1e3:.1f} us ({bound_by}); plain {plain_ms * 1e3:.1f} us; "
                f"scaled_dot_product_attention {library_ms * 1e3:.2f} us; the wrapper's host time "
                f"{host:.1f} us a call")
        if b == 48:
            for name, replaces, t in (("attention", "whmr_tpu/ops/attention_pallas.py:79", ms),
                                      ("fused_attention", "whmr_tpu/ops/attention_pallas.py:108", ms3)):
                kernels.append({
                    "name": name,
                    "route": "cuda",
                    "source": "whmr_tpu_torch/csrc/attention.cu",
                    "replaces": replaces,
                    # K3 runs on no path: main() adds the train and fit
                    # paths' counts to the forwards', all checked to be 0
                    "launches": launches[name],
                    "mma_launches": launches[f"{name}.mma"],
                    "max_abs_err": errs[(shape, torch.bfloat16) if name == "attention" else ("K3", shape, torch.bfloat16)],
                    "ms": t,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": library_ms,
                    "share_of_bound": bound_ms / t,
                })

    einsum_model = _twin(cfg, model, torch.bfloat16, "einsum")
    b48 = _inputs(cfg, 48, False, "cuda")
    models = {"pallas": model, "einsum": einsum_model}
    iters, secs = 10, {"pallas": [], "einsum": []}
    for impl in ("pallas", "einsum", "einsum", "pallas"):  # in turns
        m = models[impl]
        for _ in range(2):
            m(consts, **b48)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            m(consts, **b48)
        torch.cuda.synchronize()
        secs[impl].append((time.perf_counter() - t0) / iters)
    for impl, s in secs.items():
        log(f"forward B=48 bf16 attn_impl={impl}: {48 / np.mean(s):.1f} crops/s "
            f"({np.mean(s) * 1e3:.2f} ms a forward; runs {[round(x * 1e3, 2) for x in s]} ms)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model(consts, **inputs[(48, True)])
    torch.cuda.synchronize()
    log(f"forward B=48 bf16 pallas + 600x600 CamCalib frame: {(time.perf_counter() - t0) * 1e3:.2f} ms, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return kernels



def _same_render(got, want, label):
    """Mask and zbuf bit for bit (both round every operation once), attrs
    within 1e-6 (exact ties weight per-j sums in K2, per term in the plain
    version). Returns the attrs' max_abs_err."""
    check(torch.equal(got.mask, want.mask), f"K2 {label}: mask differs from its plain version")
    check(torch.equal(got.zbuf, want.zbuf), f"K2 {label}: zbuf differs from its plain version")
    err = (got.attrs - want.attrs).abs().max().item()
    check(err <= 1e-6, f"K2 {label}: attrs differ from its plain version by {err}")
    return err


def train_setup(cfg):
    """The train path's fixed inputs on the card: body constants, the render
    topology and one B = cfg.train.batch_size batch whose keypoints come from
    the GT joints through a plausible crop camera."""
    model, consts = build_model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    rc = build_render_consts(synthetic_smpl_assets(0), device="cuda")
    batch_np = make_keypoints_consistent(consts, make_example_train_batch(cfg, cfg.train.batch_size))
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    return model, consts, rc, batch


@torch.no_grad()
def train_raster_inputs(cfg, consts, rc, batch, camera=None):
    """What the train step hands K2 for `batch` (train_step.gt_targets):
    the GT mesh under the least-squares GT camera, or under `camera`."""
    rot = batch_rodrigues(batch["pose"].reshape(-1, 3)).reshape(-1, 24, 3, 3)
    gt = smpl_forward(consts.smpl, batch["betas"], rot)
    if camera is None:
        camera = ts.gt_render_camera(cfg, gt.joints, batch["keypoints"])
    return raster_inputs(rc, gt.vertices, camera, cfg.pymaf.dp_heatmap_size, cfg.pymaf.backbone == "vitpose")


def phase_k2(cfg, consts, rc, batch):
    """K2 against its plain version; returns the train render's max_abs_err."""
    k = -(-rc.faces.shape[0] // k2.DEFAULT_CHUNK)
    log(f"render topology: {rc.faces.shape[0]} faces over {rc.vertex_iuv.shape[0]} render vertices, "
        f"{k} chunks of {k2.DEFAULT_CHUNK}")
    check(rc.faces.shape[0] == 13776 and k == 14, "the synthetic render topology changed")
    vp, vz, attrs, res, origin = train_raster_inputs(cfg, consts, rc, batch)
    tile_hw = k2._pick_tile_hw(*res, 128)
    log(f"K2 train render: B={vp.shape[0]}, window {res[0]}x{res[1]} at origin {origin}, tiles {tile_hw}")
    check(res == (128, 96) and origin == (16.0, 0.0) and tile_hw == (16, 8), "the train render's window changed")
    got = k2.rasterize_kernel(vp, vz, attrs, rc.faces, resolution=res, origin=origin)
    torch.cuda.synchronize()
    want = k2.rasterize_kernel_reference(vp, vz, attrs, rc.faces, resolution=res, origin=origin)
    err = _same_render(got, want, "train render")
    _, bbox, fbox = k2.raster_tables(vp, vz, attrs, rc.faces)
    hits = k2.tile_hits(bbox, res, tile_hw, origin)
    _, _, counts = rasterizer_bound_ms(fbox, bbox, res, tile_hw, origin, attrs.shape[-1])
    log(f"K2 train render: equal mask and zbuf, attrs max_abs_err {err:.3g}; foreground "
        f"{got.mask.float().mean().item():.3f} of the pixels; (tile, chunk) pairs hit "
        f"{hits.float().mean().item():.3f}; {k2_work_line(counts)}")

    arrays, kw = make_ragged_raster_case()
    verts, z, at = (torch.from_numpy(a).cuda() for a in arrays[:3])
    want = k2.rasterize_kernel_reference(verts, z, at, arrays[3], **kw)
    for thw in ((16, 8), (8, 8), (4, 32)):
        got = k2.rasterize_kernel(verts, z, at, arrays[3], tile_hw=thw, **kw)
        torch.cuda.synchronize()
        e = _same_render(got, want, f"ragged tiles {thw}")
        log(f"K2 ragged {kw['resolution']} chunk {kw['chunk']} tiles {thw}: equal mask and zbuf, attrs max_abs_err {e:.3g}")
    check(bool(want.mask.any()) and not bool(want.mask.all()), "ragged case: degenerate coverage")

    # The largest scale gt_camera_from_cam_t lets through (tz = 1).
    sub = {key: v[:16] for key, v in batch.items()}
    cam = torch.tensor([[2 * 1000.0 / 256.0, 0.0, 0.0]] * sub["pose"].shape[0], device="cuda")
    vp2, vz2, attrs2, res2, origin2 = train_raster_inputs(cfg, consts, rc, sub, camera=cam)
    _, bbox2, _ = k2.raster_tables(vp2, vz2, attrs2, rc.faces)
    hits2 = k2.tile_hits(bbox2, res2, tile_hw, origin2)
    check(bool(hits2.any(dim=2).all()), "the largest GT camera leaves a tile unhit")
    got = k2.rasterize_kernel(vp2, vz2, attrs2, rc.faces, resolution=res2, origin=origin2)
    torch.cuda.synchronize()
    e = _same_render(got, k2.rasterize_kernel_reference(vp2, vz2, attrs2, rc.faces, resolution=res2,
                                                       origin=origin2), "largest camera")
    log(f"K2 largest GT camera (B={vp2.shape[0]}): every tile hit, (tile, chunk) pairs hit {hits2.float().mean().item():.3f}, "
        f"foreground {got.mask.float().mean().item():.3f}; equal mask and zbuf, attrs max_abs_err {e:.3g}")
    return err


def _moved(before, after):
    return [k for k in after if not torch.equal(before[k], after[k])]


def phase_train(cfg, model, consts, rc, batch):
    """Three full-width train steps through the port's train_step."""
    seed = 1
    # Step 1's bf16 loss against an fp32 twin with the same weights and the
    # same generator seed (so the same drop-path and dropout masks).
    twin = WHMR(cfg, dtype=torch.float32)
    twin.load_state_dict(model.state_dict())
    twin.cuda()
    twin_state = ts.create_train_state(cfg, twin)
    _, twin_losses = ts._microbatch_grads(cfg, twin, twin_state, consts, batch,
                                          torch.Generator(device="cuda").manual_seed(seed), rc)
    loss32 = twin_losses["loss"].item()
    del twin, twin_state, twin_losses
    torch.cuda.empty_cache()

    # Step 1's GT IUV maps through K2 (the step's own call) and through the
    # plain version on the same inputs.
    uvia = ts.gt_targets(cfg, consts, batch, rc)[3]
    vp, vz, attrs, res, origin = train_raster_inputs(cfg, consts, rc, batch)
    plain = k2.rasterize_kernel_reference(vp, vz, attrs, rc.faces, resolution=res, origin=origin)
    uvia_plain = iuv_img2map(plain.attrs * batch["has_smpl"][:, None, None, None])
    for key in ("index", "ann"):
        check(torch.equal(uvia[key], uvia_plain[key]), f"step 1's GT {key} map from K2 differs from the plain version's")
    uv_err = max((uvia[key] - uvia_plain[key]).abs().max().item() for key in ("u", "v"))
    check(uv_err <= 1e-6, f"step 1's GT U/V maps from K2 differ from the plain version's by {uv_err}")
    fg = (uvia["index"][..., 0] == 0).float().mean().item()
    log(f"train: step 1's GT IUV maps from K2 equal the plain version's (index and ann one-hots on "
        f"every pixel, U/V max_abs_err {uv_err:.3g}); foreground {fg:.3f} of the pixels")

    model.train()
    state = ts.create_train_state(cfg, model)
    params0 = {k: p.detach().clone() for k, p in state.params.items()}
    stats0 = {k: b.clone() for k, b in state.batch_stats.items()}
    g = torch.Generator(device="cuda").manual_seed(seed)
    reset_launches()
    history = []
    for _ in range(TRAIN_STEPS):
        state, metrics = ts.train_step(cfg, model, state, consts, batch, g, rc)
        history.append(metrics)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"train path: {TRAIN_STEPS} steps at B={cfg.train.batch_size}, launches {launches}")
    check(launches["rasterizer"] == TRAIN_STEPS, f"K2 launched {launches['rasterizer']} times, want 1 a step")
    check(launches["attention"] == 0 and launches["fused_attention"] == 0,
          "K1 or K3 launched in training, which runs vit.attn_impl='einsum'")
    check(state.step == TRAIN_STEPS and state.opt_state.count == TRAIN_STEPS, f"state.step {state.step}")
    for i, metrics in enumerate(history):
        bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v).all())]
        check(not bad, f"step {i + 1}: non-finite metrics {bad}")
        log(f"train step {i + 1}: loss {metrics['loss'].item():.6g}, grad_norm {metrics['grad_norm'].item():.6g}, "
            f"loss_IndexUV {metrics['loss_IndexUV'].item():.6g}, loss_U {metrics['loss_U'].item():.6g}")
    bad = [k for k, p in state.params.items() if not bool(torch.isfinite(p).all())]
    check(not bad, f"non-finite parameters after {TRAIN_STEPS} steps: {bad[:5]}")
    moved = set(_moved(params0, state.params))
    still = [k for k in state.params if k not in moved]
    reached = [k for k in still if not k.startswith(UNREACHED)]
    check(not reached, f"parameters the loss reaches did not move: {reached[:5]}")
    log(f"train: {len(moved)} of {len(state.params)} parameter tensors moved; the {len(still)} that did not "
        f"are all under {', '.join(p[:-1] for p in UNREACHED)} (no gradient at stage 2)")
    stats_moved = set(_moved(stats0, state.batch_stats))
    stuck = [k for k in state.batch_stats if k not in stats_moved and not k.startswith("cam_model.")]
    check(not stuck, f"BatchNorm buffers that did not move: {stuck[:5]}")
    log(f"train: {len(stats_moved)} of {len(state.batch_stats)} BatchNorm buffers moved (all but CamCalib's)")
    loss16 = history[0]["loss"].item()
    rel = abs(loss16 - loss32) / abs(loss32)
    log(f"compare step 1 loss bf16 {loss16:.6g} vs fp32 twin {loss32:.6g}: relative {rel:.3g} (tolerance {LOSS_RTOL})")
    check(rel <= LOSS_RTOL, f"step 1's bf16 loss differs from the fp32 twin's by {rel} relative")
    return state, launches


def phase_train_times(cfg, model, consts, rc, batch, state, launches, k2_err, k2_ptxas):
    """K2 at the train render beside its bound and plain version; the train
    step's time, throughput and peak memory. Returns the step's ms and K2's
    kernels entry."""
    vp, vz, attrs, res, origin = train_raster_inputs(cfg, consts, rc, batch)
    tile_hw = k2._pick_tile_hw(*res, 128)
    tables, bbox, fbox = k2.raster_tables(vp, vz, attrs, rc.faces)
    ms = cuda_ms(lambda: k2._launch(tables, fbox, res, k2.DEFAULT_CHUNK, origin), 50)
    wrapper_ms = cuda_ms(lambda: k2.rasterize_kernel(vp, vz, attrs, rc.faces, resolution=res, origin=origin), 50)
    tables_ms = cuda_ms(lambda: k2.kernel_inputs(vp, vz, attrs, rc.faces), 50)
    plain_ms = cuda_ms(lambda: k2.rasterize_kernel_reference(vp, vz, attrs, rc.faces, resolution=res,
                                                             origin=origin), 3, warmup=1)
    bound_ms, bound_by, counts = rasterizer_bound_ms(fbox, bbox, res, tile_hw, origin, attrs.shape[-1])
    regs = "; ".join(f"{name} {r.get('registers')} registers, "
                     f"{r.get('spill_stores', 0) + r.get('spill_loads', 0)} bytes spilled"
                     for fn, r in k2_ptxas.items() for name in ("raster_faces", "raster_resolve") if name in fn)
    log(f"K2 B={vp.shape[0]} train render: kernel {ms * 1e3:.2f} us ({bound_ms / ms:.1%} of the bound), "
        f"{wrapper_ms * 1e3:.1f} us with its face tables (the tables alone, `kernel_inputs`, {tables_ms * 1e3:.1f} us; "
        f"both with the host in the events: the tables' pageable index copy waits for the stream); bound "
        f"{bound_ms * 1e3:.2f} us ({bound_by}; {k2_work_line(counts)}; {RASTER_OPS_PER_PAIR} fp32 ops a pair); "
        f"plain {plain_ms * 1e3:.1f} us; library none; {regs}")
    cam = torch.tensor([[2 * 1000.0 / 256.0, 0.0, 0.0]] * vp.shape[0], device="cuda")
    vpd, vzd, attrsd, _, _ = train_raster_inputs(cfg, consts, rc, batch, camera=cam)
    tables_d, bbox_d, fbox_d = k2.raster_tables(vpd, vzd, attrsd, rc.faces)
    ms_d = cuda_ms(lambda: k2._launch(tables_d, fbox_d, res, k2.DEFAULT_CHUNK, origin), 10)
    bound_d, by_d, counts_d = rasterizer_bound_ms(fbox_d, bbox_d, res, tile_hw, origin, attrsd.shape[-1])
    log(f"K2 B={vp.shape[0]} largest GT camera (every tile hit): kernel {ms_d * 1e3:.2f} us; "
        f"bound {bound_d * 1e3:.2f} us ({by_d}; {k2_work_line(counts_d)})")

    targets_ms = cuda_ms(lambda: ts.gt_targets(cfg, consts, batch, rc), 10)
    g = torch.Generator(device="cuda").manual_seed(2)
    for _ in range(2):
        ts.train_step(cfg, model, state, consts, batch, g, rc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(5):
        t0 = time.perf_counter()
        ts.train_step(cfg, model, state, consts, batch, g, rc)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    b = cfg.train.batch_size
    log(f"train step B={b} bf16: {np.mean(steps) * 1e3:.2f} ms a step, {b / np.mean(steps):.1f} crops/s "
        f"(steps {[round(x * 1e3, 2) for x in steps]} ms); GT targets (SMPL, camera fit, render, "
        f"IUV encode) {targets_ms:.2f} ms on the device; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return np.mean(steps) * 1e3, {
        "name": "rasterizer",
        "route": "cuda",
        "source": "whmr_tpu_torch/csrc/rasterizer.cu",
        "replaces": "whmr_tpu/ops/rasterizer_pallas.py:255",
        "launches": launches["rasterizer"],
        "mma_launches": None,  # K2 has no tensor-core variant
        "max_abs_err": k2_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "share_of_bound": bound_ms / ms,
    }


class _SampleDataset:
    """An in-memory dataset of per-sample dicts (the BatchLoader's input)."""

    def __init__(self, batches):
        self.samples = [{k: v[i] for k, v in b.items()} for b in batches for i in range(len(b["img"]))]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _synced_ms(fn, n):
    """Host milliseconds a call of `fn`, each call synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _same_state(a, b):
    """Parameters, BatchNorm buffers and Adam moments bit for bit."""
    pairs = list(zip(a.params.values(), b.params.values()))
    pairs += list(zip(a.batch_stats.values(), b.batch_stats.values()))
    pairs += list(zip(a.opt_state.mu + a.opt_state.nu, b.opt_state.mu + b.opt_state.nu))
    return a.opt_state.count == b.opt_state.count and all(torch.equal(x, y) for x, y in pairs)


def phase_trainer(cfg, consts, train_ms):
    """The trainer path at full width: Trainer.fit over the port's BatchLoader
    and device_prefetch, with validation, an async mid-epoch save, the epoch
    saves, a bit-exact resume, and a SIGTERM preemption save and resume."""
    b = cfg.train.batch_size
    data = [make_keypoints_consistent(consts, make_example_train_batch(cfg, b, seed=i), seed=7 + i)
            for i in range(TRAINER_STEPS_PER_EPOCH)]
    loader = BatchLoader(_SampleDataset(data), batch_size=b, shuffle=True, num_workers=4, seed=0)
    val = [make_example_train_batch(cfg, VAL_BATCH, seed=100 + i) for i in range(VAL_BATCHES)]
    marks = {}

    def loader_factory(epoch):
        marks[f"epoch{epoch}_start"] = time.perf_counter()
        loader.set_epoch(epoch)
        return loader

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_runs"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    log(f"trainer: run dirs under {root}, {shutil.disk_usage(root).free / 2**30:.0f} GiB free")
    try:
        trainer = Trainer(cfg, str(root / "run"), dtype=torch.bfloat16, seed=0,
                          steps_per_epoch=TRAINER_STEPS_PER_EPOCH, device="cuda")
        validate = trainer.make_validate_fn(lambda: iter(val))

        def timed_validate(state):
            marks[f"val{trainer.epoch}"] = time.perf_counter()
            return validate(state)

        # Where the fit's host time goes: the trainer's own spans (a step's
        # enqueue, the host launching its kernels while the card runs
        # behind; the metric read-back; the saves) and each host batch the
        # loader hands device_prefetch, which fetches 2 ahead.
        trainer.timer = timer = profiling.Timer()

        def timed_loader(epoch):
            it = iter(loader_factory(epoch))

            def fetch():
                with timer.span("loader"):
                    return next(it, None)
            return iter(fetch, None)

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        trainer.fit(timed_loader, num_epochs=2, validate_fn=timed_validate, log_every=1, save_every=4)
        torch.cuda.synchronize()
        trainer.timer = None
        peak = profiling.device_memory_stats()["allocated_bytes.all.peak"] / 2**30
        launches = read_launches()
        steps = 2 * TRAINER_STEPS_PER_EPOCH
        log(f"trainer path: Trainer.fit, 2 epochs x {TRAINER_STEPS_PER_EPOCH} steps at B={b}, launches {launches}")
        check(trainer.state.step == steps, f"trainer state.step {trainer.state.step}, want {steps}")
        check(launches["rasterizer"] == steps, f"K2 launched {launches['rasterizer']} times in fit, want {steps}")
        check(launches["attention"] == 0 and launches["fused_attention"] == 0, "attention kernels launched in training")
        recs = _records(trainer.metrics.path)
        train_recs = [r for r in recs if "loss" in r]
        val_recs = [r for r in recs if "val_count" in r]
        check(len(train_recs) == steps and [r["step"] for r in train_recs] == list(range(1, steps + 1)),
              f"metric records at steps {[r['step'] for r in train_recs]}")
        check(all(np.isfinite(v) for r in train_recs for k, v in r.items() if k not in ("step", "time")),
              "non-finite metric records")
        check(len(val_recs) == 2, f"{len(val_recs)} validation records, want 2")
        for r in val_recs:
            check(r["val_count"] == VAL_BATCHES * VAL_BATCH, f"validation count {r['val_count']}")
            check(all(np.isfinite(r[k]) for k in ("val_mpjpe", "val_pa_mpjpe", "val_pve")), f"validation {r}")
        log(f"trainer: losses {[round(r['loss'], 3) for r in train_recs]}; validation (count, PA-MPJPE mm) "
            f"{[(int(r['val_count']), round(r['val_pa_mpjpe'], 2)) for r in val_recs]}")
        check(trainer.ckpt.restore_best() is not None, "no best/ checkpoint")
        check(trainer.ckpt._steps() == [3, 4, 6], f"checkpoint steps {trainer.ckpt._steps()}, want [3, 4, 6]")
        mid = trainer.ckpt.restore(step=4)
        check((mid["epoch"], mid["batch_idx"]) == (1, 1), f"step 4 checkpoint at epoch {mid['epoch']}, batch {mid['batch_idx']}")
        del mid
        fresh = Trainer(cfg, str(root / "run"), dtype=torch.bfloat16, seed=1,
                        steps_per_epoch=TRAINER_STEPS_PER_EPOCH, device="cuda")
        check(fresh.resume(), "resume found no checkpoint")
        check((fresh.state.step, fresh.epoch, fresh.batch_idx) == (steps, 2, 0),
              f"resumed at step {fresh.state.step}, epoch {fresh.epoch}, batch {fresh.batch_idx}")
        check(_same_state(trainer.state, fresh.state), "resumed state differs from the live one")
        log(f"trainer: best/ and steps {trainer.ckpt._steps()} on disk; step 4 at epoch 1, batch 1; a fresh "
            f"Trainer resumed to step {steps}, epoch 2, batch 0 with parameters, BatchNorm buffers and Adam "
            f"moments bit for bit")
        del fresh

        epoch_s = marks["val1"] - marks["epoch1_start"]
        fit_ms = epoch_s / TRAINER_STEPS_PER_EPOCH * 1e3
        t = {r["step"]: r["time"] for r in train_recs}
        log(f"trainer: Trainer.fit {epoch_s / TRAINER_STEPS_PER_EPOCH * 1e3:.2f} ms a step over epoch 2 "
            f"(host clock, {TRAINER_STEPS_PER_EPOCH} steps incl. the step-4 async save's snapshot and a metric "
            f"read-back a step); between metric records (ms): "
            f"{[round((t[i + 1] - t[i]) * 1e3, 2) for i in range(1, steps)]} (3->4 holds the validation and "
            f"the epoch save; 4->6 the step-4 write in flight); bare train_step {train_ms:.2f} ms a step in "
            f"this run; peak memory {peak:.2f} GiB")
        log("trainer: host ms in the fit by span, in order (step: steps 1-6; log: the read-back after each; "
            "save: steps 3, 4 (async), 6; loader: 4 fetches an epoch, the last finding its end): "
            + "; ".join(f"{k} {[round(x * 1e3, 1) for x in v]}" for k, v in timer.records.items()))

        # The checkpoint, and what its background write costs the loop: the
        # trainer's step on one fed batch, synchronised, without and with a
        # write in flight.
        payload = trainer._payload(0)
        ckpt_dir = root / "timing"
        mgr = CheckpointManager(str(ckpt_dir))
        t0 = time.perf_counter()
        mgr.save(1, payload, block=True)
        blocking_s = time.perf_counter() - t0
        fed = next(device_prefetch(iter(data[:1]), size=1, device="cuda"))
        quiet_ms = _synced_ms(lambda: trainer._step(fed), 3)
        t0 = time.perf_counter()
        mgr.save(2, payload, block=False)
        snapshot_s = time.perf_counter() - t0
        busy_ms = _synced_ms(lambda: trainer._step(fed), 3)
        mgr.wait_until_finished()
        async_s = time.perf_counter() - t0
        size = (ckpt_dir / "1" / "payload.pt").stat().st_size
        # The snapshot alone (the save's host copy), into fresh host pages
        # (a third copy while two are held) and into pages freed just before.
        held = [_to_host(payload), _to_host(payload)]
        t0 = time.perf_counter()
        held.append(_to_host(payload))
        fresh_s = time.perf_counter() - t0
        held.clear()
        t0 = time.perf_counter()
        held.append(_to_host(payload))
        reused_s = time.perf_counter() - t0
        del held
        n_params = sum(p.numel() for p in trainer.state.params.values())
        log(f"checkpoint: {n_params / 1e6:.1f} M parameters, {size / 1e9:.3f} GB on disk; blocking save "
            f"{blocking_s:.3f} s; async save returns after its snapshot in {snapshot_s:.3f} s, its write "
            f"ends {async_s:.3f} s after the call; the snapshot alone {fresh_s:.3f} s into fresh host pages, "
            f"{reused_s:.3f} s into pages freed just before")
        log(f"trainer step on a fed batch: {quiet_ms:.2f} ms a step alone, {busy_ms:.2f} ms a step while an "
            f"async checkpoint write runs (3 synchronised steps each)")
        del trainer, payload, mgr, fed
        torch.cuda.empty_cache()

        phase_preemption(cfg, root, loader, loader_factory)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, fit_ms


def phase_preemption(cfg, root, loader, loader_factory):
    """SIGTERM after the loader's second batch: the run saves at the next
    batch boundary (step 2, batch 2) and exits 0; a fresh Trainer resumes
    there and finishes the epoch at step 3."""
    def preempting(epoch):
        for i, batch in enumerate(loader_factory(epoch)):
            yield batch
            if i == 1:
                signal.raise_signal(signal.SIGTERM)

    old = signal.getsignal(signal.SIGTERM)
    try:
        run = Trainer(cfg, str(root / "preempt"), dtype=torch.bfloat16, seed=0,
                      steps_per_epoch=TRAINER_STEPS_PER_EPOCH, device="cuda")
        run.install_preemption_handler()
        try:
            run.fit(preempting, num_epochs=1, log_every=1)
        except SystemExit as e:
            check(e.code == 0, f"preemption exited with code {e.code}")
        else:
            raise SmokeError("SIGTERM did not stop Trainer.fit")
    finally:
        signal.signal(signal.SIGTERM, old)
    saved = run.ckpt.restore()
    check((saved["step"], saved["epoch"], saved["batch_idx"]) == (2, 0, 2),
          f"preemption checkpoint at step {saved['step']}, epoch {saved['epoch']}, batch {saved['batch_idx']}")
    del run, saved
    resumed = Trainer(cfg, str(root / "preempt"), dtype=torch.bfloat16, seed=1,
                      steps_per_epoch=TRAINER_STEPS_PER_EPOCH, device="cuda")
    check(resumed.resume() and (resumed.state.step, resumed.batch_idx) == (2, 2), "resume after preemption")
    reset_launches()
    resumed.fit(loader_factory, num_epochs=1, log_every=1)
    launches = read_launches()
    check(resumed.state.step == TRAINER_STEPS_PER_EPOCH and launches["rasterizer"] == 1,
          f"after the resume the epoch ended at step {resumed.state.step} with {launches}")
    log(f"preemption: SIGTERM after batch 2 -> SystemExit(0) with a checkpoint at step 2, batch 2; "
        f"resume ran the epoch's last batch to step {resumed.state.step}")


class _TimedTrainer(Trainer):
    """The port's Trainer with its opt-in profiling.Timer set, so that
    whmr-train's loop records its host spans ("step", "log", "save")."""

    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.timer = profiling.Timer()
        _TimedTrainer.last = self


class _TimedLoader(BatchLoader):
    """BatchLoader whose batches the training loop waits for under the
    trainer's "loader" span (device_prefetch takes 2 ahead)."""

    def __iter__(self):
        it = super().__iter__()
        while True:
            with _TimedTrainer.last.timer.span("loader"):
                batch = next(it, None)
            if batch is None:
                return
            yield batch


def _subset_npz(src, dst, n):
    labels = np.load(src)
    np.savez(dst, **{k: labels[k][:n] for k in labels.files})
    return str(dst)


def _timed(module, name, out):
    """Wrap module.name so that its synchronised wall seconds land in out[name]."""
    real = getattr(module, name)

    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = real(*args, **kwargs)
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return result
    return run


def phase_cli(consts, train_ms, fit_ms):
    """whmr-train and whmr-eval of the port, in-process through main(argv),
    at full width on a dataset on disk. Returns the launches of each run."""
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    launches = {}
    try:
        t0 = time.perf_counter()
        paths = write_npz_dataset(root / "data", consts, CLI_IMAGES, seed=0, n_parts=CLI_ANNOTATED,
                                  n_coco=CLI_ANNOTATED)
        annotated = _subset_npz(paths["npz"], root / "data" / "annotated.npz", CLI_ANNOTATED)
        log(f"cli: {CLI_IMAGES} PNGs of 480x360 and their labels, {CLI_ANNOTATED} GT part maps and a COCO json "
            f"written in {time.perf_counter() - t0:.1f} s")

        # whmr-train: the real decode, crop and warp on the loader's threads,
        # augmentation on, the GT render on, bf16.
        argv = ["--train_npz", paths["npz"], "--img_dir", paths["img_dir"], "--log_dir", str(root), "--name", "train",
                "--bf16", "--batch_size", str(CLI_TRAIN_BATCH), "--num_epochs", "1",
                "--steps_per_epoch", str(CLI_TRAIN_STEPS), "--log_every", "1", "--device", "cuda"]
        sigterm = signal.getsignal(signal.SIGTERM)  # main installs a preemption handler
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(trainer_module, "Trainer", _TimedTrainer))
            stack.enter_context(mock.patch.object(loader_module, "BatchLoader", _TimedLoader))
            stack.callback(signal.signal, signal.SIGTERM, sigterm)
            reset_launches()
            t0 = time.perf_counter()
            trainer = train_cli.main(argv)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            launches["whmr-train"] = n = read_launches()
        log(f"cli: whmr-train {' '.join(argv)}: {train_s:.1f} s in main; launches {n}")
        check(trainer.state.step == CLI_TRAIN_STEPS, f"whmr-train ended at step {trainer.state.step}")
        check(n["rasterizer"] == CLI_TRAIN_STEPS, f"K2 launched {n['rasterizer']} times in whmr-train, want 1 a step")
        check(n["attention"] == 0 and n["fused_attention"] == 0, "K1 or K3 launched in whmr-train")
        recs = [r for r in _records(trainer.metrics.path) if "loss" in r]
        check([r["step"] for r in recs] == list(range(1, CLI_TRAIN_STEPS + 1)),
              f"whmr-train metric records at steps {[r['step'] for r in recs]}")
        check(all(np.isfinite(v) for r in recs for k, v in r.items() if k not in ("step", "time")),
              "non-finite whmr-train metric records")
        ckpt = root / "train" / "checkpoints" / str(CLI_TRAIN_STEPS) / "payload.pt"
        check(ckpt.is_file(), f"no whmr-train checkpoint at {ckpt}")
        spans = trainer.timer.records
        gaps = [(recs[i + 1]["time"] - recs[i]["time"]) * 1e3 for i in range(len(recs) - 1)]
        log(f"cli: whmr-train losses {[round(r['loss'], 3) for r in recs]}; checkpoint {ckpt.stat().st_size / 1e9:.3f} GB; "
            f"{np.mean(gaps):.2f} ms a step between metric records {[round(g, 2) for g in gaps]} (host clock, each "
            f"with a metric read-back), against the bare train_step's {train_ms:.2f} ms and Trainer.fit's "
            f"{fit_ms:.2f} ms a step in this run; host ms by span: "
            + "; ".join(f"{k} {[round(x * 1e3, 1) for x in v]}" for k, v in spans.items()))
        del trainer
        _TimedTrainer.last = None
        torch.cuda.empty_cache()

        # The loader alone: one epoch of B=64 batches off disk, decode and
        # augmentation on its 8 threads, nothing consuming on the card.
        ds = NpzDataset(WHMRConfig(), paths["npz"], paths["img_dir"], is_train=True, device_norm=True)
        loader = BatchLoader(ds, CLI_TRAIN_BATCH)
        t0 = time.perf_counter()
        n_batches = sum(1 for _ in loader)
        log(f"cli: the loader alone: {(time.perf_counter() - t0) / n_batches * 1e3:.1f} ms a batch of "
            f"{CLI_TRAIN_BATCH} (PNG decode, augmentation, crop; 8 threads; {n_batches} batches)")

        # whmr-eval: three protocols on the checkpoint, fp32, K1 in its CUDA-core variant.
        common = ["--checkpoint", str(root / "train" / "checkpoints"), "--img_dir", paths["img_dir"],
                  "--batch_size", str(CLI_EVAL_BATCH), "--device", "cuda", "--misc", "vit.attn_impl", "pallas"]
        runs = {
            "metric": (["--dataset_npz", paths["npz"], "--result_file", str(root / "result.npz")], CLI_IMAGES),
            "parts": (["--dataset_npz", annotated, "--eval_parts", "--parts_dir", paths["parts_dir"]], CLI_ANNOTATED),
            "coco_ap": (["--dataset_npz", annotated, "--coco_ap", "--coco_gt", paths["coco_gt"]], CLI_ANNOTATED),
        }
        loop_s, results = {}, {}
        for name, (extra, crops) in runs.items():
            with contextlib.ExitStack() as stack:
                stack.enter_context(mock.patch.object(evaluate_module, "run_evaluation",
                                             _timed(evaluate_module, "run_evaluation", loop_s)))
                for fn in ("run_parts_evaluation", "run_coco_ap_evaluation"):
                    stack.enter_context(mock.patch.object(eval_cli, fn, _timed(eval_cli, fn, loop_s)))
                reset_launches()
                t0 = time.perf_counter()
                results[name] = eval_cli.main(common + extra)
                torch.cuda.synchronize()
                main_s = time.perf_counter() - t0
                launches[f"whmr-eval {name}"] = n = read_launches()
            batches = -(-crops // CLI_EVAL_BATCH)
            loop = loop_s.pop(next(iter(loop_s)))
            log(f"cli: whmr-eval {name} over {crops} crops: {crops / loop:.1f} crops/s in the protocol's loop "
                f"({loop:.2f} s; {main_s:.1f} s in main with the model build and the checkpoint read); launches {n}")
            check(n["attention"] == 12 * batches, f"whmr-eval {name}: K1 launched {n['attention']} times, want 12 a "
                  f"forward batch ({batches} batches)")
            check(n["attention.mma"] == 0, f"whmr-eval {name}: a fp32 K1 launch took the tensor-core variant")
            check(n["rasterizer"] == 0 and n["fused_attention"] == 0, f"whmr-eval {name}: K2 or K3 launched")
        m, p, c = results["metric"], results["parts"], results["coco_ap"]
        check(m["count"] == CLI_IMAGES and all(np.isfinite(m[k]) and 0 <= m[k] < 1e4 for k in ("pve", "mpjpe", "pa_mpjpe")),
              f"whmr-eval metric protocol: {m}")
        check(all(0.0 <= p[k] <= 1.0 for k in ("mask_accuracy", "mask_f1", "parts_accuracy")), f"parts: {p}")
        check(all(0.0 <= c[k] <= 1.0 for k in ("AP", "AP50", "AP75", "AR")), f"COCO AP: {c}")
        dump = np.load(root / "result.npz")
        check(dump["pred"].shape == (CLI_IMAGES, 14, 3) and bool(np.isfinite(dump["pred"]).all()), "result file")

        # The metric protocol against run_evaluation called directly on the
        # same model and batches.
        args = eval_cli.build_parser().parse_args(common + runs["metric"][0])
        cfg = WHMRConfig().with_overrides(**{"vit.attn_impl": "pallas"})
        model, consts_e, assets = eval_cli.load_model_state(args, cfg)
        ds = NpzDataset(cfg, paths["npz"], paths["img_dir"], is_train=False)

        def batches():
            for hb in BatchLoader(ds, CLI_EVAL_BATCH, shuffle=False, drop_last=False):
                b, _ = eval_cli.device_eval_batch(hb, extra_keys=("pose", "betas", "gender", "global_pose"),
                                                  device="cuda")
                b["valid"] = torch.from_numpy(hb["has_smpl"]).cuda()
                yield b

        direct = evaluate_module.run_evaluation(cfg, model, consts_e, batches(), log_every=0)
        for k in ("pve", "mpjpe", "pa_mpjpe"):
            rel = abs(m[k] - direct[k]) / abs(direct[k])
            check(rel <= CLI_METRIC_RTOL, f"whmr-eval {k} {m[k]} vs run_evaluation's {direct[k]}: relative {rel}")
        log(f"cli: whmr-eval metric protocol PVE {m['pve']:.3f}, MPJPE {m['mpjpe']:.3f}, PA-MPJPE {m['pa_mpjpe']:.3f} mm, "
            f"equal to run_evaluation's on the same model and batches within {CLI_METRIC_RTOL} relative; parts "
            f"mask accuracy {p['mask_accuracy']:.4f}, F1 {p['mask_f1']:.4f}, parts accuracy {p['parts_accuracy']:.4f}; "
            f"COCO AP {c['AP']:.4f}, AP50 {c['AP50']:.4f}, AR {c['AR']:.4f}")

        # The parts render alone, at the eval batch, through rasterize.
        with torch.no_grad():
            hb = next(iter(BatchLoader(ds, CLI_EVAL_BATCH, shuffle=False)))
            b, _ = eval_cli.device_eval_batch(hb, device="cuda")
            last = eval_cli._forward(model, consts_e, b)["smpl_out"][-1]
            res = (cfg.img_res[1], cfg.img_res[0])
            render_ms = _synced_ms(lambda: render_part_segmentation(assets, last["verts"], last["pred_cam"], res), 5)
        log(f"cli: parts render B={CLI_EVAL_BATCH} at {res[0]}x{res[1]} through ops/rasterizer.py::rasterize: "
            f"{render_ms:.2f} ms a batch (host clock, synchronised: the chunk windows are read back once a call)")

        # K1 as whmr-eval runs it: fp32 at the eval batch, CUDA-core variant.
        shape = (CLI_EVAL_BATCH, 12, 192, 64)
        g = torch.Generator(device="cuda").manual_seed(3)
        q, k, v = (torch.randn(*shape, device="cuda", generator=g) for _ in range(3))
        check(k1._variant(shape, torch.float32) != "mma", "fp32 K1 would take the tensor-core variant")
        err = (k1.attention(q, k, v) - k1.attention_reference(q, k, v)).abs().max().item()
        check(err <= 2e-5, f"fp32 K1 at {shape} disagrees with its plain version by {err}")
        ms = cuda_ms(lambda: k1.attention(q, k, v), 20)
        plain_ms = cuda_ms(lambda: k1.attention_reference(q, k, v), 20)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
        bound_ms, bound_by = attention_bound_ms(shape, torch.float32)
        log(f"cli: K1 {shape} fp32 (whmr-eval's launches, CUDA-core variant): {ms * 1e3:.2f} us ({bound_ms / ms:.1%} of "
            f"the bound), max_abs_err {err:.3g}; bound {bound_ms * 1e3:.2f} us ({bound_by}); plain {plain_ms * 1e3:.1f} us; "
            f"scaled_dot_product_attention {library_ms * 1e3:.2f} us")
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def main():
    smi = phase_device()
    k2_ptxas = phase_build()
    errs = phase_kernels()
    train_cfg = WHMRConfig()
    train_model, train_consts, rc, batch = train_setup(train_cfg)
    k2_err = phase_k2(train_cfg, train_consts, rc, batch)
    cfg, model, consts, inputs, launches = phase_main_path()
    state, train_launches = phase_train(train_cfg, train_model, train_consts, rc, batch)
    kernels = phase_times(cfg, model, consts, inputs, launches, errs)
    train_ms, k2_entry = phase_train_times(train_cfg, train_model, train_consts, rc, batch, state, train_launches, k2_err,
                                           k2_ptxas)
    kernels.append(k2_entry)
    del model, inputs, train_model, state, batch
    torch.cuda.empty_cache()
    fit_launches, fit_ms = phase_trainer(train_cfg, train_consts, train_ms)
    cli_launches = phase_cli(train_consts, train_ms, fit_ms)
    # K3 runs on no path: its count is the forwards', the train steps' and
    # the fit's, each read over its run (and each checked to be 0).
    k3 = next(k for k in kernels if k["name"] == "fused_attention")
    k3["launches"] += train_launches["fused_attention"] + fit_launches["fused_attention"]
    k3["mma_launches"] += train_launches["fused_attention.mma"] + fit_launches["fused_attention.mma"]
    # The CLI path's launches: whmr-eval's K1 (on CUDA cores, fp32) and
    # whmr-train's K2, each read over its run; K3's, checked to be 0.
    for k in kernels:
        k["launches"] += sum(n[k["name"]] for n in cli_launches.values())
        if k["mma_launches"] is not None:
            k["mma_launches"] += sum(n[f"{k['name']}.mma"] for n in cli_launches.values())
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        main()
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
