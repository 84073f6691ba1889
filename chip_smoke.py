"""Smoke run of whmr_tpu_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles every CUDA kernel from the sources in this checkout into
   build/, one nvcc for each source, all started together; prints ptxas's
   registers and spill bytes for each kernel instantiation, and fails on a
   spill in the tensor-core ("mma") variant of K1 and K3 (bf16, and fp32 in
   3xTF32) or in any of K2's kernels.
3. Kernels: holds each kernel against its plain PyTorch version on the
   card. K1 (attention) and K3 (fused_attention, the same function in K3's
   launch shape) at the forward's shapes and the serving batch (B=8),
   whmr-eval's (B=32), ViT-H's head (D = 80), the tensor-core edges (N =
   256 in bf16; D = 128 at N = 192 and N = 193 in fp32), N = 300 (CUDA
   cores), D = 20 (bf16 on CUDA cores) and a ragged shape, in bf16 at one
   bf16 ulp and in fp32 within 2e-5; checks that every launch `_variant`
   sends to tensor cores (bf16 at N <= 256 and D % 8 == 0; fp32 at N <= 192
   and D % 4 == 0) took them and no other did, and that K3's
   output equals K1's bit for bit in bf16 and wherever fp32 ran on tensor
   cores. K1 on the fused qkv projection (`attention_qkv`) at the infer
   cells' heads, (192, 16, 192, 64) and (192, 12, 192, 64): bit for bit
   against attention() on contiguous copies, one packed launch, timed
   beside attention() and the ViT block's former path with its two layout
   copies. K2
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
   two forwards (all 24 of K1's on tensor cores, each reading the qkv
   projection in place: `k1.packed_launches` equals `k1.launches`), checks shapes and
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
   at the same shape, in bf16 at B=16 and 48 and in fp32 at B=32 and 48
   (fp32's bound counts three TF32 products, the CUDA-core figure beside
   it), K2 also with its wrapper, its face tables and under
   the largest GT camera; forward crops/s at B=48 with "pallas" and
   with "einsum"; train step ms and crops/s at B=64; peak memory.
6b. vit.remat (`phase_remat`): configs/vit-l.yaml (ViT-L, full size, remat
   on, drop path 0.5), bf16, B=64, the GT render on: one step's forward,
   loss and backward with the ViT blocks checkpointed and one without, from
   the same weights and generator seed (so the same drop-path masks), then
   a second plain one. The losses equal; the gradients' relative 2-norm
   difference within twice the two plain steps' (the backward's atomics)
   or 1e-4; K2 once a step; the peak allocated lower with remat. Prints
   each step's peak and ms, and the steps timed in turns.
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
   fit's ms a step beside the bare step's and its host time by span (the
   tracer's `fit.*` spans), a blocking and an async checkpoint save, the
   save's host snapshot alone into fresh and into reused host pages, and
   the checkpoint's size. Its run directories live under build/ and are deleted
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
   each run launches K1 12 times a forward batch, all on tensor cores
   (fp32, 3xTF32), and never K2; every printed metric is finite and in its range, and the
   metric protocol's PVE/MPJPE/PA-MPJPE equal run_evaluation's on the same
   model and batches within 1e-4 relative. Times: whmr-train's ms a step
   beside the bare step and the fit step, the loader's host ms a batch,
   the eval's crops/s by protocol and the parts render's ms a batch through
   `ops/rasterizer.py::rasterize`. Its run directory lives under build/
   and is deleted after phases 9 and 10, which use its data and checkpoint.
9. Parallel path, on phase 8's dataset, in two torchrun launches of this
   script in its rank mode (`--rank`), each rank running its jobs one
   after the other (one rank: the unsharded whmr-train and the one-rank
   Trainer with torchrun's variables hidden, so without a process group,
   then (a) and (c) on NCCL; two gloo ranks: (b)), and reporting each
   job's launch counts, peak memory and seconds. The training runs are
   deterministic
   (torch.use_deterministic_algorithms): the step's backward sums with
   atomics, and two plain runs of it differ. (a) `whmr-train` (main(argv)
   in the rank) at one NCCL rank, 3 steps of B=64 as in phase 8, data
   parallel and `--fsdp`: the group statistics, global denominators,
   gradient sync and sharded optimizer all go through NCCL, and the metric
   records and final parameters equal the unsharded `whmr-train` run
   without a process group bit for bit (FSDP within 1e-6 relative, the largest difference
   printed; the difference to phase 8's run is printed); (b) two ranks
   sharing the card over gloo, a Trainer at data parallel (32 rows a rank
   of the global B=64), FSDP and TP (where gloo carries their collectives
   on CUDA tensors; a line names any it does not), 3 fp32 steps with drop
   path and dropout on, against the one-rank Trainer without a process
   group on the same global batches: the loss within 1e-4 relative at each step and the
   parameters within 1e-4 relative (2-norm over the model); (c) `whmr-eval
   --data_parallel 1` (fp32, "pallas", B=32) equal to phase 8's metric
   within 1e-4. K2 launches once a step on
   every rank, K1 12 times a forward batch in (c), K1 and K3 never in
   training; the ranks' counts go into the kernels line. Times: ms a step
   of each run beside the bare step, peak memory a rank. One card cannot
   time scaling across cards.
10. Serving path: the serving CLIs at full width, bf16, vit.attn_impl
   "pallas" (K1 on tensor cores), 8 crops a device batch, on the checkpoint
   of phase 8, in-process through main(argv) or `serve_cli.build_server`
   on 127.0.0.1 port 0. `whmr-export --camcalib split`, and `--eval` with
   --check (12 K1 launches in the program's batch, all on tensor cores: the
   custom op `whmr::attention_qkv` is in the graph). The live
   `whmr-serve` (coalescing and CamCalib on) takes 64 requests with their
   boxes from 8 client threads over 24 composite frames of 1-3 people, a
   `/reload` in the middle; every response equals run_image on its request
   within SERVE_VERTS_TOL, /stats counts the requests and crops, coalesced
   requests and CamCalib cache hits, K1 launches 12 a device batch (and the
   reload's warm-up) on tensor cores; 4 requests in flight at shutdown are
   all answered by the drain. The bundle `whmr-serve` on the split bundle:
   the bundle against the live pipeline on the same crops, 12 K1 launches a
   batch, 16 requests held as above. `whmr-eval --bundle` over 48 of phase
   8's crops equals run_evaluation of the live model in bf16 within 1e-4
   relative. `whmr-demo` renders overlays of 4 images, each person's box
   changed, and `whmr-video` tracks two walking bodies over 12 frames with
   stable ids. Times: requests/s, crops/s and p50/p99 latency of both
   servers, device batches and crops a batch, CamCalib calls, export time
   and bundle size, the demo's img/s, K1 at (8, 12, 192, 64), held against
   its plain version through attention() and the custom op, beside
   scaled_dot_product_attention.
10b. Serving across cards (`phase_serve_mesh`), on the one card, bf16,
   "pallas", max_people 8, on phase 8's checkpoint: `whmr-serve
   --data_parallel 1` (a 1 x 1 grid) under 8 clients, every response equal
   to the mesh-free pipeline's run_image bit for bit; then
   `DemoPipeline(mesh=)` on grids of cuda:0 repeated (1 x 1, d=2, m=2,
   d=2 x m=2; ViT-L of configs/vit-l.yaml on seeded random weights at 1 x 1
   and m=2): run_image without and with CamCalib and a coalescing
   BatchingExecutor under 8 clients, each within 1e-3 m of the same
   weights without a grid; K1 depth x m x d launches a forward, all on
   tensor cores; a bundle with a grid and max_people 6 on a 4 x 1 grid
   refused with whmr_tpu's messages. Times: crops/s, the worker's ms a
   device batch, K1 at each local-head shape beside its bound. One card
   prices the code paths, not scaling across cards.

11. Branches (`phase_branches`), at full width, on phase 8's dataset and
   checkpoint: (f) whmr_tpu's other attention formulations, one name for
   each plain body ("bf16sm", and "xla_dpa" as
   scaled_dot_product_attention; "split", "bhnd" and "bhnd_bf16sm" run
   the same bodies as "einsum" and "bf16sm"), switched in place in the
   ViT-B bf16 forward at B=48: each within 1e-3 m of "einsum", no kernel
   launched; (d) one B=64 step's gradients applied by `train.fused_adam`
   and by the foreach Adam from the same state: parameters within 1e-6;
   (b) the Graphormer model (`pymaf.grph_on`, "pallas") forward at B=48
   with a frame: K1 12 launches on tensor cores, the refined (48, 6890, 3)
   mesh finite, apart from the parametric one and within 5e-2 of its fp32
   twin's move from it, the fp32 twin within 1e-4 m of the same weights on
   the CPU at B=2; 3 steps at B=64 of its "einsum" twin: K2 once a step, no
   parameter losses on the appended stage, every Graphormer tensor moved
   but the key biases; (a) the res50 backbone (256x256 crops, 64x64
   heatmap) forward at B=48 against its fp32 twin (2e-3 m), K2 at its
   64x64 render against the plain version, 3 steps at B=64 (K2 once a
   step, moved parameters and BatchNorm buffers, step 1's loss within
   2e-3 relative of the fp32 twin's); (c) `whmr-train --regressor hmr` 3
   steps of B=64 and `whmr-eval --regressor hmr` on its checkpoint, equal
   to run_evaluation(regressor="hmr") within 1e-4, no launches; (e) phase
   8's weights as a reference {"model": state_dict} .pt through
   `whmr-convert --strict`, and `whmr-eval` on the output equal to phase
   8's metric within 1e-4 (K1 12 a batch). Times: crops/s of every
   forward, ms a step of every step, both Adams' step and update in
   turns, HMR's whmr-train ms a step and whmr-eval crops/s.

Output: a line with the card's name and power limit, one JSON line
{"kernels": [...]}, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request
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
from whmr_tpu_torch.models.layers import Attention
from whmr_tpu_torch.models.regressor import body_consts_from_assets
from whmr_tpu_torch.models.smpl import smpl_forward
from whmr_tpu_torch.models.whmr import WHMR, build_model
from whmr_tpu_torch.ops import attention as k1
from whmr_tpu_torch.ops import cuda_build
from whmr_tpu_torch.ops import rasterizer_kernel as k2
from whmr_tpu_torch.ops.iuv import iuv_img2map
from whmr_tpu_torch.ops.rotation import batch_rodrigues
from whmr_tpu_torch.parallel.mesh import gather_full, init_distributed
from whmr_tpu_torch.inference import demo_cli, eval_cli, export_cli, serve_cli, video_cli
from whmr_tpu_torch.inference import evaluate as evaluate_module
from whmr_tpu_torch.inference.detector_eval import composite_frames, posed_vertices
from whmr_tpu_torch.inference.pipeline import Detection
from whmr_tpu_torch.inference.renderer import render_overlay
from whmr_tpu_torch.inference.part_segm import render_part_segmentation
from whmr_tpu_torch.training import cli as train_cli
from whmr_tpu_torch.training import train_step as ts
from whmr_tpu_torch.training.gt_renderer import build_render_consts, raster_inputs
from whmr_tpu_torch.training.trainer import Trainer
from whmr_tpu_torch.utils import convert_cli, profiling
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
# The tensor cores' TF32 peak: fp32 K1 and K3 take each product as three
# TF32 products (3xTF32, csrc/attention.cu).
PEAK_TF32_OPS_PER_S = 495e12
TF32_PRODUCTS = 3
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
# The parallel path: whmr-train under torchrun at one NCCL rank against
# the unsharded whmr-train (data parallel bit for bit; FSDP within
# FSDP_RTOL, its reductions round in another order); two gloo ranks sharing
# the card against the one-rank step at the global batches (PAR_RTOL);
# whmr-eval --data_parallel 1 against phase_cli's metric (CLI_METRIC_RTOL).
FSDP_RTOL, PAR_RTOL = 1e-6, 1e-4
PAR_BATCHES = 3
# The train step's backward sums with atomics, so two runs of it differ
# (phase_parallel prints its runs' difference to phase_cli's); the
# parallel path's training runs are deterministic
# (torch.use_deterministic_algorithms, which needs this cuBLAS workspace)
# so that they compare bit for bit.
DETERMINISTIC_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
# What torchrun tells a rank of its group.
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# What FSDP2 and DTensor's tensor parallelism call beside all_reduce.
SHARDED_COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor")
# The serving path: bf16, vit.attn_impl="pallas", 8 crops a device batch;
# the live server takes 64 requests from 8 clients (4 more in flight at the
# drain), the bundle server 16; whmr-video a 12-frame clip.
SERVE_PEOPLE = 8
SERVE_MISC = ["vit.attn_impl", "pallas"]
SERVE_REQUESTS, SERVE_CLIENTS, BUNDLE_REQUESTS, DRAIN_REQUESTS = 64, 8, 16, 4
SERVE_EVAL_CROPS = 48  # whmr-eval --bundle: 6 batches of phase_cli's dataset
VIDEO_FRAMES = 12
# Vertices of a served response against run_image on the same request (its
# boxes as sent, in fp32), and of the exported program against the live
# pipeline, m. Both read 0 on an H100 80GB HBM3 (the same kernels on the
# same rows; earlier runs, which fed run_image the boxes in fp64, read
# 2.75e-5 to 1.55e-4 m), against the bf16 forward's limit of 1e-3 m: 1e-6
# m, fp32's resolution at the body's scale, in place of 10x a zero reading.
SERVE_VERTS_TOL = 1e-6
# The remaining branches: forwards at B=48, 3 train steps at B=64 (the
# default train.batch_size); whmr_tpu's other attention formulations.
BRANCH_FWD_BATCH, BRANCH_STEPS = 48, 3
# One name for each plain body other than "einsum"'s (layers.ATTN_BODIES:
# "split" and "bhnd" run "einsum"'s, "bhnd_bf16sm" runs "bf16sm"'s).
ATTN_FORMULATIONS = ("bf16sm", "xla_dpa")
# Vertices of each formulation's bf16 forward against "einsum"'s, m (the
# main path's limit between "pallas" and "einsum").
ATTN_IMPLS_TOL = 1e-3
# The fused Adam's parameters against the foreach Adam's after one step
# from the same state and gradients.
FUSED_ADAM_TOL = 1e-6
# vit.remat (Part A of PR 11's slice): one ViT-L (configs/vit-l.yaml) train
# step at B=64 in bf16 with the blocks checkpointed and one without, from
# the same weights and generator state. The losses equal; the gradients
# differ by the backward's atomics only: their 2-norm difference, relative
# to the gradients' 2-norm, within twice that of two plain steps or
# PAR_RTOL, whichever is larger.
REMAT_CFG = "configs/vit-l.yaml"
# Timed steps: (plain, remat, remat, plain) this many times.
REMAT_TIMED_ROUNDS = 2
# Serving across cards (Part B): grids of repeated cuda:0 devices, (data,
# model); ViT-B at these shapes, ViT-L at 1 x 2, each model's 1 x 1 grid
# first as the baseline its times are read against. Each grid's vertices
# against the same weights without a grid, m (the main path's bf16 limit
# between variants of one forward); a 1 x 1 whmr-serve --data_parallel 1
# against the mesh-free run_image bit for bit. The executor's requests
# cycle over 4 frames of 1-3 people (CamCalib once a frame).
MESH_GRIDS = ((1, 1), (2, 1), (1, 2), (2, 2))
MESH_VIT_L_GRIDS = ((1, 1), (1, 2))
MESH_VERTS_TOL = 1e-3
MESH_REQUESTS = 16
MESH_FRAMES = (0, 9, 17, 20)
# res50 bf16 against its fp32 twin: the vertices, m (the main path's
# fp32 limit), and step 1's loss, relative: about 10x the first reading on
# an H100 80GB HBM3 (2.07e-4), as LOSS_RTOL is set.
RES50_VERTS_TOL, RES50_LOSS_RTOL = 2e-3, 2e-3
# The Graphormer model's refined vertices. bf16 against its fp32 twin on
# the card, relative to the largest move of the fp32 stage (random weights
# at unit gain move the mesh metres, so bf16's rounding shows as cm: 0.0813
# m, 3.096e-2, on an H100 80GB HBM3), at the main path's relative limit for
# the ViT features (which read 1.5-1.9e-2). The fp32 twin against the same
# weights on the CPU at B=2, m (the CPU tests' fp32 tolerance; 4.3-4.5e-6
# read): the check that holds the stage's arithmetic on the card.
GRAPHORMER_BF16_RTOL, GRAPHORMER_CPU_TOL = 5e-2, 1e-4


# Each kernel's launch counter (utils/profiling.py), by the name the kernels
# line gives it.
LAUNCHES = {"attention": "k1.launches", "fused_attention": "k3.launches", "rasterizer": "k2.launches"}
# The attention kernels also count their tensor-core launches, and K1 those
# that read the fused qkv projection in place.
MMA_LAUNCHES = {"attention": "k1.mma_launches", "fused_attention": "k3.mma_launches"}
PACKED_LAUNCHES = {"attention": "k1.packed_launches"}


_LAUNCHES_BEFORE = {}


def reset_launches():
    """Starts a count of launches (the counters as they read now) and
    forgets the tracer's spans; the serving executors' counters run on."""
    _LAUNCHES_BEFORE.update({c: profiling.counter(c) for c in (*LAUNCHES.values(), *MMA_LAUNCHES.values(),
                                                                *PACKED_LAUNCHES.values())})
    profiling.reset(counters=False)


def read_launches():
    """{name: launches}, {name + ".mma": tensor-core launches} and
    {name + ".packed": launches on the qkv projection in place} since
    `reset_launches`."""
    def since(c):
        return profiling.counter(c) - _LAUNCHES_BEFORE.get(c, 0)

    out = {name: since(c) for name, c in LAUNCHES.items()}
    out.update({f"{name}.mma": since(c) for name, c in MMA_LAUNCHES.items()})
    out.update({f"{name}.packed": since(c) for name, c in PACKED_LAUNCHES.items()})
    return out


def fit_spans():
    """{span: [host seconds, in order]} of the tracer's `fit.*` spans (a
    step's enqueue, the metric read-back, a save, a loader fetch)."""
    out = {}
    for r in profiling.records():
        if r["name"].startswith("fit."):
            out.setdefault(r["name"], []).append(r["host_ms"] * 1e-3)
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


def attention_bound_ms(shape, dtype, cuda_cores=False):
    """Least time for K1's work: q, k, v read once and o written once, against
    4*B*H*N*N*D operations (two products) at the peak for `dtype`. fp32 runs
    each product as three TF32 products at the TF32 peak; `cuda_cores`
    counts one fp32 product at the CUDA-core peak instead (the bound of the
    CUDA-core design, kept beside the new one so that its readings stay
    comparable)."""
    b, h, n, d = shape
    esize = torch.finfo(dtype).bits // 8
    t_bytes = 4 * b * h * n * d * esize / HBM_BYTES_PER_S
    ops = 4 * b * h * n * n * d
    if dtype == torch.float32 and not cuda_cores:
        t_ops = TF32_PRODUCTS * ops / PEAK_TF32_OPS_PER_S
    else:
        t_ops = ops / PEAK_OPS_PER_S[dtype]
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


# K1's and K3's tensor-core kernels: in bf16 one instantiation each for 64,
# 128, 192 and 256 padded keys; in fp32 (3xTF32, "_f32_" in the name) one
# each for 64, 128 and 192 by wgmma (D <= 64) and by mma.sync (D > 64).
MMA_INSTANTIATIONS = 8 + 12
F32_MMA_INSTANTIATIONS = 12


def phase_build():
    """Builds every kernel (even if build/ holds it, so that ptxas reports);
    fails on a spill in a tensor-core kernel or in K2. Returns K2's ptxas
    report by function."""
    t0 = time.perf_counter()
    texts = cuda_build.build_all(KERNELS, force=True)
    log(f"build: {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s (in parallel)")
    mma = f32 = 0
    for name, text in texts.items():
        for fn, r in cuda_build.ptxas_report(text).items():
            spills = r.get("spill_stores", 0) + r.get("spill_loads", 0)
            log(f"  {name}: {fn}: {r.get('registers')} registers, {r.get('spill_stores')} bytes spill stores, "
                f"{r.get('spill_loads')} bytes spill loads")
            if "mma_kernel" in fn:
                mma += 1
                f32 += "_f32_" in fn
                check(spills == 0, f"the tensor-core kernel {fn} spills {spills} bytes")
            if "raster_" in fn:
                check(spills == 0, f"K2's {fn} spills {spills} bytes")
    check(mma == MMA_INSTANTIATIONS, f"ptxas reported {mma} tensor-core kernels, want {MMA_INSTANTIATIONS}")
    check(f32 == F32_MMA_INSTANTIATIONS, f"ptxas reported {f32} fp32 tensor-core kernels, want {F32_MMA_INSTANTIATIONS}")
    raster = cuda_build.ptxas_report(texts["rasterizer"])
    check(len(raster) == RASTER_INSTANTIATIONS, f"ptxas reported {len(raster)} K2 kernels, want {RASTER_INSTANTIATIONS}")
    return raster


def phase_kernels():
    """K1 and K3 against their plain version; returns {(shape, dtype): max_abs_err}."""
    errs = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    # The forward's heads at B=8 (the serving batch), 16 and 48, whmr-eval's
    # B=32, ViT-H's (D = 80), a ragged one and D = 20 (no multiple of 8: CUDA
    # cores in bf16, tensor cores in fp32); N = 300, above the tensor-core
    # edge; and the tensor-core edges, N = 256 with D = 128 in bf16 and, in
    # fp32, D = 128 at N = 192 and N = 193, past it.
    shapes = [(8, 12, 192, 64), (16, 12, 192, 64), (32, 12, 192, 64), (48, 12, 192, 64), (16, 16, 192, 80),
              (3, 2, 63, 32), (3, 2, 50, 20), (2, 2, 300, 64)]
    edges = {torch.bfloat16: [(2, 4, 256, 128)], torch.float32: [(2, 4, 192, 128), (2, 3, 193, 64)]}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes + edges[dtype]:
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
            if dtype == torch.bfloat16 or mma:
                check(torch.equal(got3, got), f"K3's output differs from K1's at {shape} {dtype}")
    log("K3 equals K1 bit for bit at every bf16 shape and every fp32 shape on tensor cores; bf16 at N <= 256 and "
        "D % 8 == 0 and fp32 at N <= 192 and D % 4 == 0 ran on tensor cores, the rest did not")
    # K1 on the fused projection, at the infer cells' heads (ViT-L and ViT-B
    # at B = 192) and the main path's (B = 16 and 48): against the plain
    # version on the projection's views, then bit for bit against attention()
    # on contiguous copies; at the infer cells' heads timed beside it and
    # beside the ViT block's former path, the layout copy to (3, B, H, N, D),
    # attention() and the copy back to (B, N, C).
    for shape in ((192, 16, 192, 64), (192, 12, 192, 64), (16, 12, 192, 64), (48, 12, 192, 64)):
        b, h, n_tok, d = shape
        qkv = torch.randn(b, n_tok, 3, h, d, device="cuda", generator=g, dtype=torch.bfloat16)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        reset_launches()
        got = k1.attention_qkv(qkv)
        torch.cuda.synchronize()
        n = read_launches()
        check((n["attention"], n["attention.mma"], n["attention.packed"]) == (1, 1, 1),
              f"attention_qkv {shape}: launches {n}, want 1 on tensor cores, packed")
        want = k1.attention_reference(*qkv.permute(2, 0, 3, 1, 4).unbind(0)).transpose(1, 2)
        err = (got.float() - want.float()).abs()
        tol = k1_tolerance(want, torch.bfloat16)
        errs[("qkv", shape, torch.bfloat16)] = err.max().item()
        log(f"K1 {shape} bf16 on the qkv projection (attention_qkv): max_abs_err {err.max().item():.3g} "
            f"(tolerance {tol.max().item():.3g})")
        check(bool((err <= tol).all()), f"attention_qkv disagrees with the plain version at {shape} bf16")
        check(torch.equal(got, k1.attention(q, k, v).transpose(1, 2)),
              f"attention_qkv differs from attention() on contiguous copies at {shape}")
        if b != 192:
            continue

        def copies():
            x, y, z = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
            return k1.attention(x, y, z).transpose(1, 2).reshape(b, n_tok, h * d)

        packed_ms = cuda_ms(lambda: k1.attention_qkv(qkv), 50)
        k1_ms = cuda_ms(lambda: k1.attention(q, k, v), 50)
        copies_ms = cuda_ms(copies, 50)
        bound_ms, bound_by = attention_bound_ms(shape, torch.bfloat16)
        log(f"K1 {shape} bf16 on the qkv projection (attention_qkv): {packed_ms * 1e3:.2f} us "
            f"({bound_ms / packed_ms:.1%} of the {bound_ms * 1e3:.1f} us bound, {bound_by}), equal bit for bit to "
            f"attention() on contiguous copies, which takes {k1_ms * 1e3:.2f} us ({bound_ms / k1_ms:.1%}); "
            f"the block's former path with its two layout copies {copies_ms * 1e3:.2f} us")
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
    log(f"main path: K1 read the qkv projection in place in {launches['attention.packed']} of its "
        f"{launches['attention']} launches (k1.packed_launches against k1.launches)")
    check(launches["attention.packed"] == launches["attention"],
          "a bf16 K1 launch of the forward did not read the qkv projection in place")
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
                    "packed_launches": launches.get(f"{name}.packed"),
                    "max_abs_err": errs[(shape, torch.bfloat16) if name == "attention" else ("K3", shape, torch.bfloat16)],
                    "ms": t,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": library_ms,
                    "share_of_bound": bound_ms / t,
                })

    # fp32 at whmr-eval's batch (B=32) and the forward's (48): the 3xTF32
    # tensor-core kernels beside the CUDA-core variant, the plain version and
    # SDPA in fp32. The bound counts three TF32 products; the CUDA-core
    # figure (one fp32 product at 67 TFLOP/s, the CUDA-core design's bound)
    # beside it.
    fp32 = {"attention": [], "fused_attention": []}
    for b in (32, 48):
        shape = (b, 12, 192, 64)
        q, k, v = (torch.randn(*shape, device="cuda", generator=g) for _ in range(3))
        check(k1._variant(shape, torch.float32) == "mma", f"fp32 K1 at {shape} would not take the tensor cores")
        ms = cuda_ms(lambda: k1.attention(q, k, v), 200)
        ms3 = cuda_ms(lambda: k1.fused_attention(q, k, v), 200)
        rows_ms = cuda_ms(lambda: k1._launch(q, k, v, False, "rows"), 20)
        rows3_ms = cuda_ms(lambda: k1._launch(q, k, v, True, "rows"), 10)
        plain_ms = cuda_ms(lambda: k1.attention_reference(q, k, v), 50)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 200)
        bound_ms, bound_by = attention_bound_ms(shape, torch.float32)
        cc_ms, cc_by = attention_bound_ms(shape, torch.float32, cuda_cores=True)
        for name, label, t, rows_t in (("attention", "K1", ms, rows_ms), ("fused_attention", "K3", ms3, rows3_ms)):
            err = errs[(shape, torch.float32) if name == "attention" else ("K3", shape, torch.float32)]
            log(f"{label} B={b} fp32 (3xTF32): {t * 1e3:.2f} us ({bound_ms / t:.1%} of the bound), CUDA-core variant "
                f"{rows_t * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us ({bound_by}; one fp32 product on CUDA cores: "
                f"{cc_ms * 1e3:.2f} us, {cc_by}); plain {plain_ms * 1e3:.1f} us; scaled_dot_product_attention "
                f"{library_ms * 1e3:.2f} us; max_abs_err {err:.3g}")
            fp32[name].append({"shape": list(shape), "ms": t, "rows_ms": rows_t, "plain_ms": plain_ms,
                               "bound_ms": bound_ms, "bound_by": bound_by, "cuda_core_bound_ms": cc_ms,
                               "library_ms": library_ms, "max_abs_err": err})
    # ViT-H's head (D = 80) in fp32: the mma.sync routine, beside the
    # CUDA-core variant it replaces there.
    shape = (16, 16, 192, 80)
    q, k, v = (torch.randn(*shape, device="cuda", generator=g) for _ in range(3))
    for label, per_batch in (("K1", False), ("K3", True)):
        t = cuda_ms(lambda: k1._launch(q, k, v, per_batch), 50)
        rows_t = cuda_ms(lambda: k1._launch(q, k, v, per_batch, "rows"), 10)
        log(f"{label} {shape} fp32 (3xTF32 by mma.sync, D > 64): {t * 1e3:.2f} us, CUDA-core variant {rows_t * 1e3:.1f} us")
    # Which kernel SDPA runs in fp32 (the profiler's names for one call).
    q, k, v = (torch.randn(32, 12, 192, 64, device="cuda", generator=g) for _ in range(3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if not e.key.startswith(("cuda", "Activity"))]
    log(f"scaled_dot_product_attention in fp32 at (32, 12, 192, 64) runs: {names}")
    for entry in kernels:
        entry["fp32"] = fp32[entry["name"]]

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


def _grad_rel(got, want):
    """The 2-norm of got - want over every gradient, relative to want's."""
    d = torch.stack(torch._foreach_norm([got[k].float() - want[k].float() for k in want])).norm()
    return (d / torch.stack(torch._foreach_norm([w.float() for w in want.values()])).norm()).item()


def phase_remat():
    """Part A: vit.remat at ViT-L (configs/vit-l.yaml, full size), bf16,
    B=64, the GT render on. One step's gradients with the blocks
    checkpointed against the same step without (same weights, same
    generator seed, so the same drop-path masks): equal losses, gradients
    apart by the backward's atomics only, K2 once a step, and a lower peak.
    Returns the launches of the checked steps."""
    from whmr_tpu_torch.config import load_yaml

    cfg = load_yaml(str(Path(__file__).resolve().parent / REMAT_CFG))
    v = cfg.vit
    check(v.remat and (v.embed_dim, v.depth, v.num_heads) == (1024, 24, 16) and cfg.train.batch_size == 64,
          f"{REMAT_CFG} is no longer ViT-L with remat at B=64: {v}, B={cfg.train.batch_size}")
    model, consts, rc, batch = train_setup(cfg)
    model.train()
    state = ts.create_train_state(cfg, model)
    backbone = model.feature_extractor.backbone
    b = cfg.train.batch_size

    def step(remat):
        backbone.remat = remat
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        grads, losses = ts._microbatch_grads(cfg, model, state, consts, batch,
                                             torch.Generator(device="cuda").manual_seed(1), rc)
        torch.cuda.synchronize()
        return grads, losses["loss"].item(), (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated(), base

    launches, runs = {}, {}
    for label, remat in (("plain", False), ("remat", True), ("plain again", False)):
        reset_launches()
        grads, loss, ms, peak, base = step(remat)
        launches[label] = n = read_launches()
        check(n["rasterizer"] == 1 and n["attention"] == 0 and n["fused_attention"] == 0,
              f"ViT-L {label} step: launches {n}, want K2 once and no K1 or K3")
        if label == "plain":
            ref = grads
            rel = 0.0
        else:
            rel = _grad_rel(grads, ref)
            del grads
        runs[label] = (loss, rel, ms, peak, base)
        log(f"remat: ViT-L B={b} bf16 {label} step (vit.remat={remat}): loss {loss!r}, gradients {rel:.3g} from the "
            f"first plain step's (relative 2-norm; that step is the reference); {ms:.1f} ms with the first call's set-up; peak "
            f"{peak / 2**30:.2f} GiB allocated ({base / 2**30:.2f} GiB before the step); launches {n}")
    del ref
    noise = runs["plain again"][1]
    tol = max(2 * noise, PAR_RTOL)
    check(runs["remat"][0] == runs["plain"][0] == runs["plain again"][0],
          f"ViT-L step loss with remat {runs['remat'][0]!r} differs from without {runs['plain'][0]!r}")
    check(runs["remat"][1] <= tol, f"ViT-L remat gradients {runs['remat'][1]} from the plain step's (tolerance {tol}: "
          f"two plain steps read {noise})")
    saved = runs["plain again"][3] - runs["remat"][3]
    check(saved > 0, f"remat did not lower the ViT-L step's peak: {runs['remat'][3]} vs {runs['plain again'][3]} B")
    times = {False: [], True: []}
    for remat in (False, True, True, False) * REMAT_TIMED_ROUNDS:
        times[remat].append(step(remat)[2])
    log(f"remat: ViT-L B={b} bf16 step (forward, loss, backward; no update): vit.remat=False "
        f"{np.mean(times[False]):.1f} ms ({[round(x, 1) for x in times[False]]}), vit.remat=True "
        f"{np.mean(times[True]):.1f} ms ({[round(x, 1) for x in times[True]]}) (synchronised host clock, in turns); "
        f"peak {runs['plain again'][3] / 2**30:.2f} GiB without remat and {runs['remat'][3] / 2**30:.2f} GiB with it, "
        f"{saved / 2**30:.2f} GiB less, both over {runs['remat'][4] / 2**30:.2f} GiB held before the step; "
        f"equal losses, gradients {runs['remat'][1]:.3g} apart (two plain steps {noise:.3g}, tolerance {tol:.3g})")
    del model, state, batch, consts, rc
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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
        def timed_loader(epoch):
            it = iter(loader_factory(epoch))

            def fetch():
                with profiling.span("fit.loader"):
                    return next(it, None)
            return iter(fetch, None)

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        profiling.enable()
        try:
            trainer.fit(timed_loader, num_epochs=2, validate_fn=timed_validate, log_every=1, save_every=4)
            torch.cuda.synchronize()
        finally:
            profiling.disable()
        spans = fit_spans()
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
        log("trainer: host ms in the fit by span, in order (fit.step: steps 1-6; fit.log: the read-back after "
            "each; fit.save: steps 3, 4 (async), 6; fit.loader: 4 fetches an epoch, the last finding its end): "
            + "; ".join(f"{k} {[round(x * 1e3, 1) for x in v]}" for k, v in spans.items()))

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


class _TimedLoader(BatchLoader):
    """BatchLoader whose batches the training loop waits for under a
    `fit.loader` span (device_prefetch takes 2 ahead)."""

    def __iter__(self):
        it = super().__iter__()
        while True:
            with profiling.span("fit.loader"):
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


def phase_cli(consts, train_ms, fit_ms, root):
    """whmr-train and whmr-eval of the port, in-process through main(argv),
    at full width on a dataset written under `root` (which main deletes
    after phase_serve, which serves the checkpoint trained here). Returns
    the launches of each run and the dataset's paths."""
    launches = {}
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
        stack.enter_context(mock.patch.object(loader_module, "BatchLoader", _TimedLoader))
        stack.callback(signal.signal, signal.SIGTERM, sigterm)
        stack.callback(profiling.disable)
        reset_launches()
        profiling.enable()
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
    spans = fit_spans()
    gaps = [(recs[i + 1]["time"] - recs[i]["time"]) * 1e3 for i in range(len(recs) - 1)]
    log(f"cli: whmr-train losses {[round(r['loss'], 3) for r in recs]}; checkpoint {ckpt.stat().st_size / 1e9:.3f} GB; "
        f"{np.mean(gaps):.2f} ms a step between metric records {[round(g, 2) for g in gaps]} (host clock, each "
        f"with a metric read-back), against the bare train_step's {train_ms:.2f} ms and Trainer.fit's "
        f"{fit_ms:.2f} ms a step in this run; host ms by span: "
        + "; ".join(f"{k} {[round(x * 1e3, 1) for x in v]}" for k, v in spans.items()))
    del trainer
    torch.cuda.empty_cache()

    # The loader alone: one epoch of B=64 batches off disk, decode and
    # augmentation on its 8 threads, nothing consuming on the card.
    ds = NpzDataset(WHMRConfig(), paths["npz"], paths["img_dir"], is_train=True, device_norm=True)
    loader = BatchLoader(ds, CLI_TRAIN_BATCH)
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in loader)
    log(f"cli: the loader alone: {(time.perf_counter() - t0) / n_batches * 1e3:.1f} ms a batch of "
        f"{CLI_TRAIN_BATCH} (PNG decode, augmentation, crop; 8 threads; {n_batches} batches)")

    # whmr-eval: three protocols on the checkpoint, fp32, K1 on tensor cores (3xTF32).
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
        check(n["attention.mma"] == n["attention"], f"whmr-eval {name}: a fp32 K1 launch missed the tensor cores")
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

    held = list(batches())
    direct = evaluate_module.run_evaluation(cfg, model, consts_e, held, log_every=0)
    for k in ("pve", "mpjpe", "pa_mpjpe"):
        rel = abs(m[k] - direct[k]) / abs(direct[k])
        check(rel <= CLI_METRIC_RTOL, f"whmr-eval {k} {m[k]} vs run_evaluation's {direct[k]}: relative {rel}")

    # The protocol's loop on those batches held on the card (no decode),
    # with fp32 K1 on tensor cores and on its CUDA-core variant, in turns:
    # what the tensor-core kernel moves end to end.
    choose = k1._variant

    def cuda_cores(shape, dtype):
        return "rows" if dtype == torch.float32 else choose(shape, dtype)

    loop = {"mma": [], "rows": []}
    for name in ("rows", "mma", "mma", "rows"):
        with mock.patch.object(k1, "_variant", cuda_cores) if name == "rows" else contextlib.nullcontext():
            evaluate_module.run_evaluation(cfg, model, consts_e, held[:1], log_every=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate_module.run_evaluation(cfg, model, consts_e, held, log_every=0)
            torch.cuda.synchronize()
            loop[name].append(time.perf_counter() - t0)
    log("cli: run_evaluation over the metric protocol's 192 crops held on the card, fp32 K1 in turns: "
        + "; ".join(f"{'tensor cores' if k == 'mma' else 'CUDA-core variant'} "
                    f"{CLI_IMAGES / np.mean(v):.1f} crops/s ({[round(x * 1e3, 1) for x in v]} ms)"
                    for k, v in loop.items()))
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

    # K1 as whmr-eval runs it: fp32 at the eval batch, on tensor cores (3xTF32).
    shape = (CLI_EVAL_BATCH, 12, 192, 64)
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(*shape, device="cuda", generator=g) for _ in range(3))
    variant = k1._variant(shape, torch.float32)
    check(variant == "mma", f"fp32 K1 at {shape} would take the {variant} variant, not the tensor cores")
    err = (k1.attention(q, k, v) - k1.attention_reference(q, k, v)).abs().max().item()
    check(err <= 2e-5, f"fp32 K1 at {shape} disagrees with its plain version by {err}")
    ms = cuda_ms(lambda: k1.attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: k1.attention_reference(q, k, v), 20)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    bound_ms, bound_by = attention_bound_ms(shape, torch.float32)
    cc_ms, cc_by = attention_bound_ms(shape, torch.float32, cuda_cores=True)
    log(f"cli: K1 {shape} fp32 (whmr-eval's launches, {variant} variant, 3xTF32): {ms * 1e3:.2f} us "
        f"({bound_ms / ms:.1%} of the bound), max_abs_err {err:.3g}; bound {bound_ms * 1e3:.2f} us ({bound_by}; one "
        f"fp32 product on CUDA cores: {cc_ms * 1e3:.2f} us, {cc_by}); plain {plain_ms * 1e3:.1f} us; "
        f"scaled_dot_product_attention {library_ms * 1e3:.2f} us")
    del model
    torch.cuda.empty_cache()
    return launches, paths, m


def _launch(nproc, root, label, jobs, timeout=600):
    """`chip_smoke.py --rank REPORT JOBS` on `nproc` ranks under torchrun,
    with a fixed cuBLAS workspace (DETERMINISTIC_ENV). JOBS, a list of
    (mode, name, argv, alone), run one after the other in each rank, so the
    launch pays its process start, kernel load and imports once. Returns
    each job's reports by rank (`rank_main`) and the launch's seconds."""
    report = root / f"ranks-{label}"
    script = [str(Path(__file__).resolve()), "--rank", str(report), json.dumps(jobs)]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc), *script]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=Path(__file__).resolve().parent,
                         env={**os.environ, **DETERMINISTIC_ENV})
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-3000:], flush=True)
        print(res.stderr[-8000:], file=sys.stderr, flush=True)
    check(res.returncode == 0, f"the {label} launch ({' '.join(cmd[1:6])} ...) exited {res.returncode}")
    ranks = []
    for r in range(nproc):
        with open(f"{report}.{r}.json") as f:
            ranks.append(json.load(f))
    return {job[1]: [rank[job[1]] for rank in ranks] for job in jobs}, secs


@contextlib.contextmanager
def _without_group_env():
    """torchrun's variables hidden: whmr-train, init_distributed() and
    `_par_rank` then take their paths without a process group."""
    saved = {k: os.environ.pop(k) for k in TORCHRUN_ENV if k in os.environ}
    try:
        yield
    finally:
        os.environ.update(saved)


def _par_batches(cfg, consts):
    """The global batches of the two-rank run: B = cfg.train.batch_size,
    keypoints from the GT joints."""
    b = cfg.train.batch_size
    return [make_keypoints_consistent(consts, make_example_train_batch(cfg, b, seed=10 + i), seed=20 + i)
            for i in range(PAR_BATCHES)]


def _rel(got, want):
    """max |got - want| / max |want| over a dict of tensors, worst leaf."""
    worst = 0.0
    for k, w in want.items():
        w = w.float()
        worst = max(worst, (got[k].float() - w).abs().max().item() / max(w.abs().max().item(), 1e-30))
    return worst


def _norm_rel(got, want):
    """|got - want| / |want|, 2-norms over every tensor of a dict: Adam
    moves each parameter by about the learning rate a step whatever the
    gradient's size, so a near-zero gradient whose sign rounds the other
    way moves a zero-initialised leaf by its whole scale; the norm over the
    model weighs such elements by their size."""
    num = sum((got[k].double() - w.double()).square().sum().item() for k, w in want.items())
    den = sum(w.double().square().sum().item() for w in want.values())
    return (num / den) ** 0.5


def _par_rank(out):
    """The two-rank run's Trainer steps: with a process group (two ranks on
    one card over gloo), data parallel and, where gloo carries their
    collectives on CUDA tensors, FSDP and TP; without one, the one-rank
    reference. Each fed the same global batches; rank 0 saves each case's
    gathered parameters beside `out`. In fp32: in bf16 a GEMM of 32 rows
    and one of 64 round some outputs a bf16 ulp apart, and Adam turns the
    sign of each near-zero gradient into a whole step (the two-rank bf16
    parameters read 1.3e-4 relative on an H100), which would hide the
    sharded arithmetic this compares."""
    cases, missing, rank = [("one", 1, False)], [], 0
    if "WORLD_SIZE" in os.environ:
        init_distributed(backend="gloo")
        rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
        x = torch.ones(4, device="cuda")
        for name in SHARDED_COLLECTIVES:
            try:
                if name == "all_gather_into_tensor":
                    torch.distributed.all_gather_into_tensor(torch.empty(4 * world, device="cuda"), x)
                else:
                    torch.distributed.reduce_scatter_tensor(torch.empty(4 // world, device="cuda"), x)
                torch.cuda.synchronize()
            except (RuntimeError, ValueError) as e:  # gloo names what it does not support
                missing.append(f"{name}: {type(e).__name__}: {str(e)[:120]}")
        cases = [("dp", 1, False)] + ([] if missing else [("fsdp", 1, True), ("tp", world, False)])
    cfg = WHMRConfig()
    report = {"missing": missing, "cases": {}}
    for name, model_parallel, fsdp in cases:
        tr = Trainer(cfg, f"{out}-{name}", dtype=torch.float32, device="cuda", seed=0,
                     model_parallel=model_parallel, fsdp=fsdp)
        tr.train_epoch(iter(_par_batches(cfg, tr.consts)), log_every=1)
        torch.cuda.synchronize()
        params = gather_full(tr.model, tr.state.params)
        if rank == 0:
            torch.save(params, f"{out}-{name}.pt")
            report["cases"][name] = [r for r in _records(tr.metrics.path) if "loss" in r]
        del tr, params
        torch.cuda.empty_cache()
    return report


def rank_main(argv):
    """`chip_smoke.py --rank REPORT JOBS`: one rank of a phase_parallel
    launch under torchrun. Runs each job of JOBS (a JSON list of [mode,
    name, argv, alone]) in turn: mode train runs whmr-train's main(argv),
    eval whmr-eval's, steps `_par_rank` on files named after `name` under
    REPORT's directory; an `alone` job runs with torchrun's variables
    hidden, as a plain process would, and must come before any job that
    joins the process group. The training modes run with
    torch.use_deterministic_algorithms (the backward's atomics otherwise
    make two runs of the same step differ). Writes REPORT.<rank>.json with
    each job's launch counts, peak device memory, seconds and result."""
    report, jobs = argv[0], json.loads(argv[1])
    out = {}
    for mode, name, job_argv, alone in jobs:
        torch.use_deterministic_algorithms(mode != "eval")
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with _without_group_env() if alone else contextlib.nullcontext():
            check(not (alone and torch.distributed.is_initialized()), f"job {name} must run before the group")
            if mode == "train":
                result = {"step": train_cli.main(job_argv).state.step}
            elif mode == "eval":
                result = eval_cli.main(job_argv)
            else:
                result = _par_rank(str(Path(report).parent / name))
        torch.cuda.synchronize()
        out[name] = {"launches": read_launches(), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "secs": time.perf_counter() - t0, "result": result}
        gc.collect()
        torch.cuda.empty_cache()
    with open(f"{report}.{os.environ.get('RANK', '0')}.json", "w") as f:
        json.dump(out, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _train_launches_ok(n, steps, label):
    check(n["rasterizer"] == steps, f"{label}: K2 launched {n['rasterizer']} times, want 1 a step ({steps})")
    check(n["attention"] == 0 and n["fused_attention"] == 0, f"{label}: K1 or K3 launched in training")


def _gaps(recs):
    return [(recs[i + 1]["time"] - recs[i]["time"]) * 1e3 for i in range(len(recs) - 1)]


def _compare_runs(root, name, ref, parts=("params", "batch_stats")):
    """(records' relative difference, parameters' and BatchNorm buffers'
    relative and absolute difference, bit for bit?) of run `name` against
    run `ref`, both whmr-train runs under `root`."""
    recs = [r for r in _records(root / name / "metrics.jsonl") if "loss" in r]
    want_recs = [r for r in _records(root / ref / "metrics.jsonl") if "loss" in r]
    check([r["step"] for r in recs] == [r["step"] for r in want_recs], f"{name}: records at {recs}")
    rec_rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                  for g, w in zip(recs, want_recs) for k in w if k not in ("time", "step"))
    ckpt = Path("checkpoints") / str(CLI_TRAIN_STEPS) / "payload.pt"
    got = torch.load(root / name / ckpt, weights_only=True, mmap=True)
    want = torch.load(root / ref / ckpt, weights_only=True, mmap=True)
    par_rel = max(_rel(got[part], want[part]) for part in parts)
    par_abs = max((got[part][k] - v).abs().max().item() for part in parts for k, v in want[part].items())
    exact = rec_rel == 0.0 and all(torch.equal(got[part][k], v) for part in parts for k, v in want[part].items())
    return recs, rec_rel, par_rel, par_abs, exact


def phase_parallel(root, paths, cli_metric, train_ms):
    """The parallel path (the module's docstring, phase 9), in two torchrun
    launches: one rank for the unsharded whmr-train and the one-rank
    Trainer (without a process group), then whmr-train's data parallel and
    --fsdp runs and whmr-eval --data_parallel 1 on NCCL; two gloo ranks for
    the Trainer steps. Returns the launch counts of every rank of every
    run."""
    t_phase = time.perf_counter()
    train = ["--train_npz", paths["npz"], "--img_dir", paths["img_dir"], "--log_dir", str(root), "--bf16",
             "--batch_size", str(CLI_TRAIN_BATCH), "--num_epochs", "1", "--steps_per_epoch", str(CLI_TRAIN_STEPS),
             "--log_every", "1", "--device", "cuda"]
    evaluate = ["--checkpoint", str(root / "train" / "checkpoints"), "--img_dir", paths["img_dir"],
                "--dataset_npz", paths["npz"], "--batch_size", str(CLI_EVAL_BATCH), "--device", "cuda",
                "--data_parallel", "1", "--misc", "vit.attn_impl", "pallas"]
    nccl, nccl_secs = _launch(1, root, "nccl", [("train", "one", train + ["--name", "one"], True),
                                                ("steps", "steps-one", [], True),
                                                ("train", "dp1", train + ["--name", "dp1"], False),
                                                ("train", "fsdp1", train + ["--name", "fsdp1", "--fsdp"], False),
                                                ("eval", "eval-dp1", evaluate, False)])
    gloo, gloo_secs = _launch(2, root, "gloo", [("steps", "steps", [], False)])
    log(f"parallel: the launches took {nccl_secs:.1f} s one rank (whmr-train and the Trainer without a group, "
        f"then whmr-train dp and --fsdp and whmr-eval on NCCL), {gloo_secs:.1f} s two gloo ranks")
    runs = {**nccl, **gloo}
    launches = [rep["launches"] for reps in runs.values() for rep in reps]

    # (a) whmr-train under torchrun at one NCCL rank, data parallel and
    # FSDP, against the unsharded whmr-train run without a process group,
    # each run deterministic.
    for name in ("one", "dp1", "fsdp1"):
        (rep,) = runs[name]
        _train_launches_ok(rep["launches"], CLI_TRAIN_STEPS, f"whmr-train {name}")
        recs, rec_rel, par_rel, par_abs, exact = _compare_runs(root, name, "one")
        _, cli_rel, cli_par, _, _ = _compare_runs(root, name, "train")
        if name == "dp1":
            check(exact, f"whmr-train under torchrun (data parallel, one rank) differs from the unsharded run: "
                         f"records {rec_rel:.3g}, parameters {par_rel:.3g} relative ({par_abs:.3g} absolute)")
        elif name == "fsdp1":
            check(rec_rel <= FSDP_RTOL and par_rel <= FSDP_RTOL,
                  f"whmr-train --fsdp (one rank) against the unsharded run: records {rec_rel:.3g}, parameters "
                  f"{par_rel:.3g} relative, want <= {FSDP_RTOL}")
        how = {"one": "alone (no process group)", "dp1": "under torchrun, one NCCL rank, data parallel",
               "fsdp1": "under torchrun, one NCCL rank, --fsdp"}[name]
        log(f"parallel: whmr-train {how}, deterministic: "
            + ("" if name == "one" else
               f"{'bit for bit' if exact else 'not bit for bit'} against the unsharded run (records "
               f"{rec_rel:.3g}, parameters and BatchNorm buffers {par_rel:.3g} relative, {par_abs:.3g} absolute); ")
            + f"against phase_cli's run (not deterministic) records {cli_rel:.3g}, parameters {cli_par:.3g}; "
            f"{np.mean(_gaps(recs)):.2f} ms a step between metric records {[round(g, 2) for g in _gaps(recs)]} "
            f"against the bare train_step's {train_ms:.2f} ms; peak {rep['peak_gib']:.2f} GiB; launches "
            f"{rep['launches']}; {rep['secs']:.1f} s the run in its launch")

    # (b) Two gloo ranks sharing the card against the one-rank Trainer at
    # the same global batches.
    (one,), reps = runs["steps-one"], runs["steps"]
    one_recs = one["result"]["cases"]["one"]
    one_params = torch.load(root / "steps-one-one.pt", weights_only=True, mmap=True)
    result = reps[0]["result"]
    for line in result["missing"]:
        log(f"parallel: gloo does not carry {line} on CUDA tensors: the two-rank FSDP and TP cases rest on "
            f"tests/test_torch_parallel.py (CPU)")
    check("dp" in result["cases"], "the two-rank data-parallel run reported nothing")
    _train_launches_ok(one["launches"], PAR_BATCHES, "the one-rank Trainer")
    per_rank = PAR_BATCHES * len(result["cases"])
    for r, rep in enumerate(reps):
        _train_launches_ok(rep["launches"], per_rank, f"gloo rank {r}")
    b = WHMRConfig().train.batch_size
    for name, recs in result["cases"].items():
        loss_rel = [abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(recs, one_recs)]
        term_rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                       for g, w in zip(recs, one_recs) for k in w if k.startswith("loss_"))
        norm_rel = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"] for g, w in zip(recs, one_recs))
        got = torch.load(root / f"steps-{name}.pt", weights_only=True, mmap=True)
        par_rel = _norm_rel(got, one_params)
        par_abs = max((got[k] - v).abs().max().item() for k, v in one_params.items())
        rows = b // 2 if name != "tp" else b
        log(f"parallel: two gloo ranks on one card, {name} ({rows} rows a rank of the global B={b}), fp32, "
            f"deterministic: "
            f"loss {[f'{x:.3g}' for x in loss_rel]} relative to the one-rank Trainer's, step by step (the worst "
            f"loss term {term_rel:.3g}, grad_norm {norm_rel:.3g}); parameters {par_rel:.3g} relative (2-norm over "
            f"the model; {par_abs:.3g} the largest element's difference); {np.mean(_gaps(recs)):.2f} ms a step "
            f"between metric records {[round(g, 2) for g in _gaps(recs)]} against the one-rank Trainer's "
            f"{np.mean(_gaps(one_recs)):.2f} ms and the bare train_step's {train_ms:.2f} ms")
        check(len(recs) == PAR_BATCHES and max(loss_rel) <= PAR_RTOL and par_rel <= PAR_RTOL,
              f"two gloo ranks ({name}) against the one-rank step: loss {max(loss_rel):.3g}, parameters "
              f"{par_rel:.3g} relative, want <= {PAR_RTOL}")
    log(f"parallel: peak {one['peak_gib']:.2f} GiB one rank, {[round(rep['peak_gib'], 2) for rep in reps]} GiB the "
        f"gloo ranks; launches {[rep['launches'] for rep in reps]}; {one['secs']:.1f} s the one-rank run and "
        f"{reps[0]['secs']:.1f} s the two-rank runs in their launches")

    # (c) whmr-eval --data_parallel 1 under torchrun against phase_cli's metric.
    (rep,) = runs["eval-dp1"]
    m, n = rep["result"], rep["launches"]
    batches = -(-CLI_IMAGES // CLI_EVAL_BATCH)
    check(n["attention"] == n["attention.mma"] == 12 * batches,
          f"whmr-eval --data_parallel 1: K1 launched {n['attention']} times ({n['attention.mma']} on tensor cores), "
          f"want 12 a forward batch ({batches} batches), all on tensor cores")
    check(n["rasterizer"] == 0 and n["fused_attention"] == 0, "whmr-eval --data_parallel 1: K2 or K3 launched")
    rel = max(abs(m[k] - cli_metric[k]) / abs(cli_metric[k]) for k in ("pve", "mpjpe", "pa_mpjpe"))
    check(m["count"] == CLI_IMAGES and rel <= CLI_METRIC_RTOL,
          f"whmr-eval --data_parallel 1 {m} against phase_cli's {cli_metric}: relative {rel}")
    log(f"parallel: whmr-eval --data_parallel 1 under torchrun: PVE {m['pve']:.3f}, MPJPE {m['mpjpe']:.3f}, "
        f"PA-MPJPE {m['pa_mpjpe']:.3f} mm, {rel:.3g} relative to phase_cli's one-process run; peak "
        f"{rep['peak_gib']:.2f} GiB; launches {n}; {rep['secs']:.1f} s the run in its launch")
    log(f"parallel: phase_parallel took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _request(img, dets):
    """An /infer body: the image and its people's boxes [cx, cy, size]."""
    buf = io.BytesIO()
    np.savez(buf, image=img, bboxes=np.array([[d.cx, d.cy, d.size] for d in dets], np.float32))
    return buf.getvalue()


def _serve_frames():
    """24 composite frames of 480x360 with 1, 2 or 3 posed bodies each (8
    of each) and their GT boxes, from seeds 1-3."""
    frames, boxes = [], []
    for k in (1, 2, 3):
        f, g = composite_frames(8, people_per_frame=k, seed=k)
        frames += f
        boxes += g
    return frames, boxes


def _drive(url, jobs, clients, during=None):
    """POST each job's body from `clients` threads, each taking the next job
    when its last one is answered. `during` runs on a thread of its own once
    a quarter of the jobs are answered. Returns the latencies (s), the
    parsed responses by job and the wall seconds; fails on any error."""
    nxt, done, lock = iter(range(len(jobs))), [], threading.Lock()
    lat, out, errors = [0.0] * len(jobs), [None] * len(jobs), []

    def client():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            t0 = time.perf_counter()
            try:
                status, body = _post(url + "/infer", jobs[i])
                lat[i] = time.perf_counter() - t0
                check(status == 200, f"/infer answered {status}")
                out[i] = dict(np.load(io.BytesIO(body)))
            except Exception as e:  # noqa: BLE001 — collected, and the phase fails on it below
                errors.append(f"request {i}: {type(e).__name__}: {e}")
            with lock:
                done.append(i)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    side = None
    if during is not None:
        while len(done) < len(jobs) // 4 and any(t.is_alive() for t in threads):
            time.sleep(0.005)
        side = threading.Thread(target=during)
        side.start()
    for t in threads:
        t.join(timeout=600)
        check(not t.is_alive(), "a client thread hung")
    wall = time.perf_counter() - t0
    if side is not None:
        side.join(timeout=600)
        check(not side.is_alive(), "the side task hung")
    check(not errors, f"{len(errors)} requests failed: {errors[:3]}")
    return lat, out, wall


def _sent(dets):
    """The boxes as the server reads them from a request: fp32."""
    return [Detection(*(float(np.float32(x)) for x in (d.cx, d.cy, d.size))) for d in dets]


def _held(responses, jobs_frames, pipeline, tol, label):
    """Each response against run_image on the same request (its boxes as
    sent, in fp32): vertices within `tol` m. Returns the largest difference."""
    worst, refs = 0.0, {}
    for resp, (fi, frame, dets) in zip(responses, jobs_frames):
        if fi not in refs:
            refs[fi] = pipeline.run_image(frame, dets=_sent(dets))
        ref = refs[fi]
        check(int(resp["n_people"]) == ref["n_people"] == len(dets), f"{label}: people")
        for k in ("verts", "verts_world"):
            worst = max(worst, float(np.abs(resp[k] - ref[k]).max()))
    check(worst <= tol, f"{label}: a response differs from run_image by {worst} m (tolerance {tol} m)")
    return worst


def _latency_line(label, lat, wall, stats, crops):
    ms = np.sort(np.asarray(lat)) * 1e3
    p50, p99 = np.percentile(ms, 50), np.percentile(ms, 99)
    return (f"{label}: {len(lat) / wall:.2f} requests/s, {crops / wall:.2f} crops/s, latency p50 {p50:.2f} ms, "
            f"p99 {p99:.2f} ms ({len(lat)} requests in {wall:.2f} s); {stats['device_batches']} device batches, "
            f"{stats['crops'] / max(stats['device_batches'], 1):.2f} crops a batch, {stats['camcalib_calls']} "
            f"CamCalib calls, {stats['camcalib_cache_hits']} cache hits, {stats['coalesced_requests']} "
            f"coalesced requests")


def _host_timed(fn, out):
    """`fn`, appending the host seconds of each call to `out`."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            out.append(time.perf_counter() - t0)
    return run


def _tracking_clip(path, n_frames, width=480, height=360):
    """An mp4 of two posed bodies walking right over a fixed background,
    and their GT boxes by frame name ([x1, y1, x2, y2], as BboxFileDetector
    reads them)."""
    import cv2

    assets = synthetic_smpl_assets()
    rng = np.random.RandomState(5)
    pose = (rng.randn(2, 72) * 0.25).astype(np.float32)
    pose[:, :3] = 0.0
    verts = posed_vertices(assets, pose, (rng.randn(2, 10) * 0.5).astype(np.float32))
    focal = float(np.hypot(width, height))
    bg = cv2.resize(rng.randint(40, 215, (6, 8, 3)).astype(np.uint8), (width, height), interpolation=cv2.INTER_CUBIC)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (width, height))
    check(writer.isOpened(), "cv2 cannot write an mp4v video here")
    boxes = {}
    for i in range(n_frames):
        ts = [np.array([-1.2 + 0.04 * i, 0.0, 7.0], np.float32), np.array([0.6 + 0.04 * i, 0.1, 7.5], np.float32)]
        frame = render_overlay(bg, list(verts), ts, assets.faces, [focal] * 2, color=(0.65, 0.74, 0.86, 1.0))
        writer.write(frame[:, :, ::-1])
        boxes[f"{i:06d}.png"] = []
        for v, t in zip(verts, ts):
            pj = v + t
            pix = focal * pj[:, :2] / pj[:, 2:3] + np.array([width / 2.0, height / 2.0])
            boxes[f"{i:06d}.png"].append([*map(float, pix.min(axis=0)), *map(float, pix.max(axis=0))])
    writer.release()
    return boxes


def phase_serve(root, paths, cli_metric):
    """The serving slice at full width, bf16, vit.attn_impl="pallas",
    max_people 8, on the checkpoint phase_cli trained, in-process through
    each CLI's main(argv) or its building blocks, on 127.0.0.1 port 0.
    Returns the launches of each run."""
    import cv2

    ckpt = str(root / "train" / "checkpoints")
    cap = str(SERVE_PEOPLE)
    launches = {}
    t0 = time.perf_counter()
    frames, boxes = _serve_frames()
    log(f"serve: {len(frames)} composite frames posed and rendered in {time.perf_counter() - t0:.1f} s (host)")

    # 1. whmr-export: a split-CamCalib demo bundle and an eval bundle with
    # --check. The demo bundle goes without: the bundle whmr-serve below
    # loads it, runs it and holds it against the live pipeline.
    bundles = {"demo": str(root / "bundle_demo"), "eval": str(root / "bundle_eval")}
    for name, extra in (("demo", ["--camcalib", "split"]), ("eval", ["--eval", "--check"])):
        reset_launches()
        t0 = time.perf_counter()
        export_cli.main(["--checkpoint", ckpt, "--output", bundles[name], *extra, "--bf16", "--batch_size", cap,
                         "--device", "cuda", "--misc", *SERVE_MISC])
        torch.cuda.synchronize()
        launches[f"whmr-export {name}"] = n = read_launches()
        log(f"serve: whmr-export {' '.join(extra)} (bf16, batch {cap}): {time.perf_counter() - t0:.1f} s with the "
            f"model build, trace and save{', reload and check batch' if '--check' in extra else ''}; bundle "
            f"{export_cli.bundle_bytes(bundles[name]) / 1e6:.1f} MB ({', '.join(sorted(os.listdir(bundles[name])))}); "
            f"launches {n}")
        want = 12 if "--check" in extra else 0  # the trace runs on fake tensors and launches nothing
        check(n["attention"] == n["attention.mma"] == want, f"whmr-export {name}: K1 launches {n}, want {want} "
              "on tensor cores (12 in the check's one batch: the custom op, not a traced plain version)")

    # 2. The live whmr-serve: coalescing and CamCalib on, 8 clients, 64
    # requests with their boxes (some frames repeat), one /reload under load.
    jobs = [(i % len(frames), frames[i % len(frames)], boxes[i % len(frames)]) for i in range(SERVE_REQUESTS)]
    bodies = [_request(f, d) for _, f, d in jobs]
    crops = sum(len(d) for _, _, d in jobs)
    t0 = time.perf_counter()
    live = serve_cli.build_server(["--checkpoint", ckpt, "--port", "0", "--dtype", "bf16", "--max_people", cap,
                                   "--detector", "full", "--warmup", "--device", "cuda", "--misc", *SERVE_MISC])
    url = f"http://127.0.0.1:{live.httpd.server_address[1]}"
    server_thread = threading.Thread(target=live.httpd.serve_forever, daemon=True)
    server_thread.start()
    log(f"serve: live whmr-serve up in {time.perf_counter() - t0:.1f} s (model build, checkpoint, warm-up)")
    spans = {"worker": [], "camcalib": []}
    for attr, key in (("_run_group", "worker"), ("_camcalib_for", "camcalib")):
        setattr(live.executor, attr, _host_timed(getattr(live.executor, attr), spans[key]))
    reloaded = {}

    def reload():
        status, body = _post(url + "/reload", json.dumps({"checkpoint": ckpt}).encode())
        reloaded.update(status=status, body=json.loads(body))

    reset_launches()
    lat, out, wall = _drive(url, bodies, SERVE_CLIENTS, during=reload)
    torch.cuda.synchronize()
    n = read_launches()
    stats = _get(url + "/stats")
    check(reloaded.get("status") == 200 and reloaded["body"]["reloads"] == 1, f"/reload under load: {reloaded}")
    log(_latency_line(f"serve: live whmr-serve, {SERVE_CLIENTS} clients", lat, wall, stats, crops))
    check(stats["requests"] == SERVE_REQUESTS and stats["crops"] == crops,
          f"/stats {stats}: want {SERVE_REQUESTS} requests and {crops} crops")
    check(stats["coalesced_requests"] > 0 and stats["camcalib_cache_hits"] > 0, f"/stats {stats}")
    # the reload's warm-up runs one device batch of its own
    want = 12 * (stats["device_batches"] + 1)
    check(n["attention"] == n["attention.mma"] == want, f"live whmr-serve: K1 launches {n}, want {want} on "
          f"tensor cores (12 a device batch, {stats['device_batches']} batches and the reload's warm-up)")
    check(n["rasterizer"] == 0 and n["fused_attention"] == 0, "K2 or K3 launched in whmr-serve")
    launches["whmr-serve live"] = n
    live_pipe = live.pipeline
    alone = _synced_ms(lambda: live_pipe.run_image(frames[2], dets=boxes[2]), 8)
    # dispatch-ahead: dispatch_image returns once the forward is enqueued;
    # collect then waits for the card
    overlap = []
    for fi in range(2, 10):
        t0 = time.perf_counter()
        pending = live_pipe.dispatch_image(frames[fi], dets=boxes[fi])
        t1 = time.perf_counter()
        busy = not torch.cuda.current_stream().query()
        live_pipe.collect(pending)
        overlap.append((t1 - t0, busy, time.perf_counter() - t1))
    log(f"serve: dispatch_image {np.mean([o[0] for o in overlap]) * 1e3:.2f} ms of host time, the stream still "
        f"busy when it returned in {sum(o[1] for o in overlap)} of {len(overlap)} images, collect then waiting "
        f"{np.mean([o[2] for o in overlap]) * 1e3:.2f} ms (B={cap}, 1-3 people)")
    log(f"serve: where a live request's time goes (host clock): the worker {np.mean(spans['worker']) * 1e3:.2f} ms "
        f"a device batch ({len(spans['worker'])} batches, the fetch included), CamCalib "
        f"{np.mean(spans['camcalib']) * 1e3:.2f} ms a call on the request threads (a cache hit included); "
        f"run_image alone, no server, {alone:.2f} ms an image of 3 people at B={cap}")
    worst = _held(out, jobs, live_pipe, SERVE_VERTS_TOL, "live whmr-serve")
    log(f"serve: every live response equals run_image on its request within {worst:.3g} m (tolerance "
        f"{SERVE_VERTS_TOL} m); /reload under load answered {reloaded['body']}")

    # The drain: requests in flight when the server stops are all answered.
    entered, real_submit = [], live.executor.submit

    def counting_submit(*a, **kw):
        entered.append(1)
        return real_submit(*a, **kw)

    live.executor.submit = counting_submit
    drained = {}

    def drain_client(i):
        drained[i] = _post(url + "/infer", bodies[i])[0]

    reset_launches()
    clients = [threading.Thread(target=drain_client, args=(i,)) for i in range(DRAIN_REQUESTS)]
    for t in clients:
        t.start()
    deadline = time.time() + 120
    while len(entered) < DRAIN_REQUESTS and time.time() < deadline:
        time.sleep(0.001)
    check(len(entered) == DRAIN_REQUESTS, "the drain's requests did not reach the server")
    live.httpd.shutdown()
    live.drain()
    for t in clients:
        t.join(timeout=120)
    server_thread.join(timeout=60)
    check(sorted(drained.values()) == [200] * DRAIN_REQUESTS and not server_thread.is_alive(),
          f"drain: answers {drained}")
    launches["whmr-serve drain"] = read_launches()
    log(f"serve: drain: {DRAIN_REQUESTS} requests in flight at shutdown, all answered 200; the server stopped")

    # 3. The bundle whmr-serve (the split bundle): held against the live
    # pipeline first, then 16 requests.
    t0 = time.perf_counter()
    frozen = serve_cli.build_server(["--bundle", bundles["demo"], "--port", "0", "--max_people", cap,
                                     "--detector", "full", "--warmup", "--device", "cuda", "--misc", *SERVE_MISC])
    log(f"serve: bundle whmr-serve up in {time.perf_counter() - t0:.1f} s (program load, warm-up)")
    bpipe = frozen.pipeline
    held = 0.0
    for fi in range(0, len(frames), 3):
        a, b = bpipe.run_image(frames[fi], dets=boxes[fi]), live_pipe.run_image(frames[fi], dets=boxes[fi])
        held = max(held, *(float(np.abs(a[k] - b[k]).max()) for k in ("verts", "verts_world")))
    log(f"serve: the split bundle against the live pipeline on the same crops: vertices within {held:.4g} m "
        f"(tolerance {SERVE_VERTS_TOL} m)")
    check(held <= SERVE_VERTS_TOL, f"the bundle differs from the live pipeline by {held} m")
    reset_launches()
    bpipe.run_image(frames[0], dets=boxes[0])
    torch.cuda.synchronize()
    n = read_launches()
    check(n["attention"] == n["attention.mma"] == 12, f"one batch of the exported program: K1 launches {n}, "
          "want 12 on tensor cores")
    spans = {"worker": [], "camcalib": []}
    for attr, key in (("_run_group", "worker"), ("_camcalib_for", "camcalib")):
        setattr(frozen.executor, attr, _host_timed(getattr(frozen.executor, attr), spans[key]))
    url = f"http://127.0.0.1:{frozen.httpd.server_address[1]}"
    server_thread = threading.Thread(target=frozen.httpd.serve_forever, daemon=True)
    server_thread.start()
    jobs_b = jobs[:BUNDLE_REQUESTS]
    reset_launches()
    lat, out, wall = _drive(url, bodies[:BUNDLE_REQUESTS], SERVE_CLIENTS)
    torch.cuda.synchronize()
    n = read_launches()
    stats = _get(url + "/stats")
    frozen.httpd.shutdown()
    frozen.drain()
    server_thread.join(timeout=60)
    crops_b = sum(len(d) for _, _, d in jobs_b)
    log(_latency_line(f"serve: bundle whmr-serve, {SERVE_CLIENTS} clients", lat, wall, stats, crops_b))
    log(f"serve: bundle whmr-serve (host clock): the worker {np.mean(spans['worker']) * 1e3:.2f} ms a device batch "
        f"({len(spans['worker'])} batches, the fetch included), the CamCalib program "
        f"{np.mean(spans['camcalib']) * 1e3:.2f} ms a call on the request threads")
    check(stats["crops"] == crops_b and stats["requests"] == BUNDLE_REQUESTS, f"bundle /stats {stats}")
    check(n["attention"] == n["attention.mma"] == 12 * stats["device_batches"],
          f"bundle whmr-serve: K1 launches {n}, want 12 a device batch on tensor cores ({stats['device_batches']})")
    launches["whmr-serve bundle"] = n
    worst = _held(out, jobs_b, live_pipe, SERVE_VERTS_TOL, "bundle whmr-serve")
    log(f"serve: every bundle response equals the live run_image within {worst:.3g} m")
    del frozen, bpipe, live, live_pipe
    torch.cuda.empty_cache()

    # whmr-eval --bundle on the first crops of phase_cli's dataset against
    # run_evaluation of the live model in the bundle's dtype (bf16) on the
    # same batches.
    npz = _subset_npz(paths["npz"], root / "serve_eval.npz", SERVE_EVAL_CROPS)
    argv = ["--dataset_npz", npz, "--img_dir", paths["img_dir"], "--batch_size", cap, "--device", "cuda",
            "--log_freq", "0", "--misc", *SERVE_MISC]
    reset_launches()
    t0 = time.perf_counter()
    got = eval_cli.main(["--bundle", bundles["eval"], *argv])
    torch.cuda.synchronize()
    launches["whmr-eval --bundle"] = n = read_launches()
    n_batches = -(-SERVE_EVAL_CROPS // SERVE_PEOPLE)
    log(f"serve: whmr-eval --bundle over {SERVE_EVAL_CROPS} crops at B={cap}: {time.perf_counter() - t0:.1f} s in "
        f"main with the program load; launches {n}")
    check(n["attention"] == n["attention.mma"] == 12 * n_batches, f"whmr-eval --bundle: K1 launches {n}, want "
          f"12 a batch ({n_batches}) on tensor cores")
    args = eval_cli.build_parser().parse_args(["--checkpoint", ckpt, *argv])
    cfg = WHMRConfig().with_overrides(**dict(zip(SERVE_MISC[::2], SERVE_MISC[1::2])))
    model, consts_e, _ = eval_cli.load_model_state(args, cfg)
    twin = WHMR(cfg, dtype=torch.bfloat16)
    twin.load_state_dict(model.state_dict())
    twin = twin.cuda().eval()
    del model
    ds = NpzDataset(cfg, npz, paths["img_dir"], is_train=False)

    def batches():
        for hb in BatchLoader(ds, SERVE_PEOPLE, shuffle=False, drop_last=False):
            b, _ = eval_cli.device_eval_batch(hb, extra_keys=("pose", "betas", "gender", "global_pose"), device="cuda")
            b["valid"] = torch.from_numpy(hb["has_smpl"]).cuda()
            yield b

    want = evaluate_module.run_evaluation(cfg, twin, consts_e, batches(), log_every=0)
    for k in ("pve", "mpjpe", "pa_mpjpe"):
        rel = abs(got[k] - want[k]) / abs(want[k])
        check(rel <= CLI_METRIC_RTOL, f"whmr-eval --bundle {k} {got[k]} vs the live bf16 model's {want[k]}: {rel}")
    log(f"serve: whmr-eval --bundle PVE {got['pve']:.3f}, MPJPE {got['mpjpe']:.3f}, PA-MPJPE {got['pa_mpjpe']:.3f} "
        f"mm over {SERVE_EVAL_CROPS} crops, equal to run_evaluation of the live bf16 model within {CLI_METRIC_RTOL} "
        f"relative ({time.perf_counter() - t0:.1f} s with the live model's build and run); the fp32 whmr-eval of "
        f"phase_cli over all {CLI_IMAGES} crops (B={CLI_EVAL_BATCH}) read PVE {cli_metric['pve']:.3f}, MPJPE "
        f"{cli_metric['mpjpe']:.3f}, PA-MPJPE {cli_metric['pa_mpjpe']:.3f}")
    del twin
    torch.cuda.empty_cache()

    # 4. whmr-demo on 4 composite images with rendering, and whmr-video on a
    # 12-frame mp4 with tracking, both through a bbox file.
    imgs, out_dir = root / "demo_in", root / "demo_out"
    imgs.mkdir()
    picks = [0, 9, 17, 20]
    bbox = {}
    for fi in picks:
        cv2.imwrite(str(imgs / f"f{fi:02d}.png"), frames[fi][:, :, ::-1])
        bbox[f"f{fi:02d}.png"] = [[d.cx - d.size / 2, d.cy - d.size / 2, d.cx + d.size / 2, d.cy + d.size / 2]
                                  for d in boxes[fi]]
    (root / "demo_boxes.json").write_text(json.dumps(bbox))
    reset_launches()
    t0 = time.perf_counter()
    stats = demo_cli.main(["--image_folder", str(imgs), "--output_folder", str(out_dir), "--checkpoint", ckpt,
                           "--detector", "file", "--bbox_file", str(root / "demo_boxes.json"), "--dtype", "bf16",
                           "--max_people", cap, "--device", "cuda", "--misc", *SERVE_MISC])
    torch.cuda.synchronize()
    launches["whmr-demo"] = n = read_launches()
    check(stats["images"] == len(picks) and stats["people"] == sum(len(boxes[fi]) for fi in picks), f"demo {stats}")
    check(n["attention"] == n["attention.mma"] == 12 * len(picks), f"whmr-demo: K1 launches {n}")
    for fi in picks:
        panel = cv2.imread(str(out_dir / f"f{fi:02d}_overlay.png"))
        check(panel is not None, f"no overlay for f{fi:02d}")
        src = frames[fi][:, :, ::-1]
        for d in boxes[fi]:
            y0, y1 = int(max(d.cy - d.size / 2, 0)), int(min(d.cy + d.size / 2, src.shape[0]))
            x0, x1 = int(max(d.cx - d.size / 2, 0)), int(min(d.cx + d.size / 2, src.shape[1]))
            check((panel[y0:y1, x0:x1] != src[y0:y1, x0:x1]).any(), f"f{fi:02d}: the overlay left a person bare")
    log(f"serve: whmr-demo over {len(picks)} images with rendering: {stats['fps']:.2f} img/s (host clock; the model "
        f"build and checkpoint read are outside it; {time.perf_counter() - t0:.1f} s in main), {stats['people']} "
        f"people, overlays differ from the input in every person's box; launches {n}")
    t0 = time.perf_counter()

    clip_boxes = _tracking_clip(root / "clip.mp4", VIDEO_FRAMES)
    (root / "clip_boxes.json").write_text(json.dumps(clip_boxes))
    reset_launches()
    stats = video_cli.main(["--video", str(root / "clip.mp4"), "--output_folder", str(root / "video_out"),
                            "--checkpoint", ckpt, "--detector", "file", "--bbox_file", str(root / "clip_boxes.json"),
                            "--dtype", "bf16", "--max_people", cap, "--device", "cuda", "--misc", *SERVE_MISC])
    torch.cuda.synchronize()
    launches["whmr-video"] = n = read_launches()
    tracks = []
    for i in range(VIDEO_FRAMES):
        with open(root / "video_out" / "results" / f"{i:06d}.pkl", "rb") as f:
            det = pickle.load(f)["detections"]
        tracks.append(tuple(int(t) for t in det[np.argsort(det[:, 0]), 4]))
    check(stats["images"] == VIDEO_FRAMES and (root / "video_out" / "result.mp4").is_file(), f"video {stats}")
    check(len(set(tracks)) == 1 and len(tracks[0]) == 2 and -1 not in tracks[0],
          f"whmr-video track ids by frame (left to right): {tracks}")
    check(n["attention"] == n["attention.mma"] == 12 * VIDEO_FRAMES, f"whmr-video: K1 launches {n}")
    log(f"serve: whmr-video over {VIDEO_FRAMES} frames: {stats['fps']:.2f} frames/s, track ids {tracks[0]} in every "
        f"frame, left to right ({time.perf_counter() - t0:.1f} s with the clip's render and the model build); "
        f"launches {n}")

    # 5. K1 at the serving shape: held against its plain version through
    # attention_qkv() on a packed projection and through the custom op that
    # exported and serving programs call (whmr::attention_qkv), and through
    # attention() and whmr::attention, the op that bundles exported before
    # the packed entry hold; timed beside scaled_dot_product_attention.
    shape = (SERVE_PEOPLE, 12, 192, 64)
    g = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn(shape[0], shape[2], 3, shape[1], shape[3], device="cuda", generator=g, dtype=torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
    want = k1.attention_reference(q, k, v)
    tol = k1_tolerance(want, torch.bfloat16)
    serve_errs = {}
    for label, fn, packed in (("attention_qkv()", lambda: k1.attention_qkv(qkv).transpose(1, 2), 1),
                              ("torch.ops.whmr.attention_qkv",
                               lambda: torch.ops.whmr.attention_qkv(qkv).transpose(1, 2), 1),
                              ("attention()", lambda: k1.attention(q, k, v), 0),
                              ("torch.ops.whmr.attention", lambda: torch.ops.whmr.attention(q, k, v), 0)):
        reset_launches()
        got = fn()
        torch.cuda.synchronize()
        n = read_launches()
        check((n["attention"], n["attention.mma"], n["attention.packed"]) == (1, 1, packed),
              f"K1 {shape} through {label}: launches {n}, want 1 on tensor cores, {packed} packed")
        err = (got.float() - want.float()).abs()
        serve_errs[label] = err.max().item()
        check(bool((err <= tol).all()), f"K1 disagrees with its plain version at the serving shape {shape} bf16 "
              f"through {label}: max_abs_err {serve_errs[label]}")
    qkv_ms = cuda_ms(lambda: k1.attention_qkv(qkv), 200)
    op_ms = cuda_ms(lambda: torch.ops.whmr.attention_qkv(qkv), 200)
    ms = cuda_ms(lambda: k1.attention(q, k, v), 200)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 200)
    bound_ms, bound_by = attention_bound_ms(shape, torch.bfloat16)
    log(f"serve: K1 {shape} bf16 (the serving shape): max_abs_err "
        + ", ".join(f"{e:.3g} through {label}" for label, e in serve_errs.items())
        + f" (tolerance {tol.max().item():.3g}); {qkv_ms * 1e3:.2f} us through attention_qkv(), {op_ms * 1e3:.2f} us "
        f"through torch.ops.whmr.attention_qkv ({bound_ms / op_ms:.1%} of the {bound_ms * 1e3:.2f} us bound, "
        f"{bound_by}), {ms * 1e3:.2f} us through attention() on contiguous q, k, v; scaled_dot_product_attention "
        f"{library_ms * 1e3:.2f} us; host time a call through attention_qkv() "
        f"{host_us(lambda: k1.attention_qkv(qkv)):.1f} us, through the custom op (what an exported program calls) "
        f"{host_us(lambda: torch.ops.whmr.attention_qkv(qkv)):.1f} us, through the wrapper's launch alone "
        f"{host_us(lambda: k1._forward_qkv(qkv)):.1f} us")
    return launches


def _mesh_pipeline(cfg, weights, grid, camcalib=True):
    """The live bf16 pipeline on a grid of cuda:0 repeated ((data, model),
    or None for no grid), the full-image detector."""
    from whmr_tpu_torch.inference.pipeline import DemoPipeline
    from whmr_tpu_torch.parallel import ServingGrid

    mesh = None if grid is None else ServingGrid([["cuda:0"] * grid[1]] * grid[0])
    return DemoPipeline(cfg, weights, synthetic_smpl_assets(), max_people=SERVE_PEOPLE, use_camcalib=camcalib,
                        dtype=torch.bfloat16, mesh=mesh, device="cuda")


def _mesh_run(label, cfg, pipe, ref, frames, boxes):
    """One grid's checks and times: run_image without and with CamCalib and
    a coalescing BatchingExecutor under 8 client threads, each against the
    pipeline without a grid on the same weights within MESH_VERTS_TOL m; K1
    depth x m times a replica a forward (once a block a shard), all on
    tensor cores; K1 at the local-head shape. Returns the launches."""
    d, m = pipe.mesh.shape["data"], pipe.mesh.shape["model"]
    per_forward = cfg.vit.depth * m * d
    worst, launches = 0.0, {}
    picks = MESH_FRAMES
    for cam in (False, True):
        pipe.use_camcalib = ref.use_camcalib = cam
        reset_launches()
        got = [pipe.run_image(frames[fi], dets=boxes[fi]) for fi in picks]
        torch.cuda.synchronize()
        launches[f"run_image camcalib={cam}"] = n = read_launches()
        check(n["attention"] == n["attention.mma"] == per_forward * len(picks)
              and n["rasterizer"] == n["fused_attention"] == 0,
              f"{label} run_image camcalib={cam}: launches {n}, want K1 {per_forward} a forward on tensor cores "
              f"({cfg.vit.depth} blocks x {m} shards x {d} replicas)")
        for fi, g in zip(picks, got):
            want = ref.run_image(frames[fi], dets=boxes[fi])
            check(g["n_people"] == want["n_people"] == len(boxes[fi]), f"{label}: people")
            keys = ("verts", "verts_world") + (("cam_rotmat", "render_rotmat") if cam else ())
            worst = max(worst, *(float(np.abs(g[k] - want[k]).max()) for k in keys))
    check(worst <= MESH_VERTS_TOL, f"{label}: run_image differs from the pipeline without a grid by {worst} m")

    # the coalescing executor (CamCalib on, per-frame rotations from the
    # lead replica) under 8 client threads
    jobs = [(fi, frames[fi], boxes[fi]) for fi in (picks[i % len(picks)] for i in range(MESH_REQUESTS))]
    ex = serve_cli.BatchingExecutor(pipe, max_wait_ms=2.0)
    spans = []
    ex._run_group = _host_timed(ex._run_group, spans)
    out = [None] * len(jobs)

    def client(k):
        for i in range(k, len(jobs), SERVE_CLIENTS):
            out[i] = ex.submit(jobs[i][1], dets=jobs[i][2])

    reset_launches()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    ex.shutdown()
    launches["executor"] = n = read_launches()
    check(all(o is not None for o in out), f"{label}: an executor request went unanswered")
    stats = ex.stats
    check(n["attention"] == n["attention.mma"] == per_forward * stats["device_batches"],
          f"{label} executor: launches {n}, want K1 {per_forward} a device batch on tensor cores "
          f"({stats['device_batches']} batches)")
    held = _held(out, jobs, ref, MESH_VERTS_TOL, f"{label} executor")
    crops = sum(len(dets) for _, _, dets in jobs)
    shape = (SERVE_PEOPLE // d, cfg.vit.num_heads // m, 192, cfg.vit.embed_dim // cfg.vit.num_heads)
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(*shape, device="cuda", generator=g, dtype=torch.bfloat16) for _ in range(3))
    want = k1.attention_reference(q, k, v)
    tol = k1_tolerance(want, torch.bfloat16)
    reset_launches()
    diff = (k1.attention(q, k, v).float() - want.float()).abs()
    torch.cuda.synchronize()
    n = read_launches()
    check(n["attention"] == n["attention.mma"] == 1, f"K1 at {shape}: launches {n}, want 1 on tensor cores")
    err = diff.max().item()
    check(bool((diff <= tol).all()), f"K1 disagrees with its plain version at the local-head shape {shape} bf16: "
          f"max_abs_err {err}")
    k1_ms = cuda_ms(lambda: k1.attention(q, k, v), 200)
    bound_ms, bound_by = attention_bound_ms(shape, torch.bfloat16)
    log(f"mesh: {label} (grid {d} x {m} of cuda:0; the figures price the code path on one card, not scaling "
        f"across cards): run_image with and without CamCalib within {worst:.3g} m of the pipeline without a grid, "
        f"the executor's {len(jobs)} responses within {held:.3g} m (tolerance {MESH_VERTS_TOL} m); executor "
        f"{crops / wall:.1f} crops/s ({len(jobs)} requests, {crops} crops, {SERVE_CLIENTS} clients, {wall:.2f} s), "
        f"the worker {np.mean(spans) * 1e3:.2f} ms a device batch ({min(spans) * 1e3:.2f}-{max(spans) * 1e3:.2f}; "
        f"{stats['device_batches']} batches, host clock, the fetch included), {stats['camcalib_calls']} CamCalib calls, {stats['camcalib_cache_hits']} cache hits; K1 "
        f"{per_forward} launches a forward on tensor "
        f"cores; K1 at the local-head shape {shape} {k1_ms * 1e3:.2f} us ({bound_ms / k1_ms:.1%} of the "
        f"{bound_ms * 1e3:.2f} us bound, {bound_by}), max_abs_err {err:.3g} (tolerance {tol.max().item():.3g})")
    return launches


def phase_serve_mesh(root):
    """Part B: serving across cards, on the one card the machine has, at
    full width (WHMRConfig(), bf16, "pallas", max_people 8) on phase_cli's
    checkpoint: whmr-serve --data_parallel 1 through the CLI against the
    mesh-free run_image bit for bit, then grids of cuda:0 repeated (1 x 1,
    d=2, m=2, d=2 x m=2; ViT-L on seeded random weights at 1 x 1 and m=2),
    and the refusals. Returns the launches of each run."""
    from whmr_tpu_torch.config import load_yaml
    from whmr_tpu_torch.inference.pipeline import DemoPipeline
    from whmr_tpu_torch.parallel import ServingGrid

    ckpt = str(root / "train" / "checkpoints")
    cap = str(SERVE_PEOPLE)
    launches = {}
    frames, boxes = _serve_frames()
    cfg = WHMRConfig().with_overrides(**dict(zip(SERVE_MISC[::2], SERVE_MISC[1::2])))
    weights = demo_cli.live_weights(demo_cli.build_parser().parse_args(["--image_folder", ".", "--checkpoint", ckpt]),
                                    cfg)
    ref = _mesh_pipeline(cfg, weights, None)

    # 1. whmr-serve --data_parallel 1: a 1 x 1 grid through the CLI, its
    # coalesced responses equal to run_image without a grid bit for bit
    t0 = time.perf_counter()
    srv = serve_cli.build_server(["--checkpoint", ckpt, "--port", "0", "--dtype", "bf16", "--max_people", cap,
                                  "--detector", "full", "--data_parallel", "1", "--warmup", "--device", "cuda",
                                  "--misc", *SERVE_MISC])
    check(srv.meta.get("mesh") == {"data": 1, "model": 1} and srv.executor is not None, f"/meta {srv.meta}")
    url = f"http://127.0.0.1:{srv.httpd.server_address[1]}"
    server_thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    server_thread.start()
    jobs = [(i % len(frames), frames[i % len(frames)], boxes[i % len(frames)]) for i in range(MESH_REQUESTS)]
    reset_launches()
    lat, out, wall = _drive(url, [_request(f, d) for _, f, d in jobs], SERVE_CLIENTS)
    torch.cuda.synchronize()
    launches["whmr-serve --data_parallel 1"] = n = read_launches()
    stats = _get(url + "/stats")
    srv.httpd.shutdown()
    srv.drain()
    server_thread.join(timeout=60)
    check(n["attention"] == n["attention.mma"] == 12 * stats["device_batches"],
          f"whmr-serve --data_parallel 1: K1 launches {n}, want 12 a device batch on tensor cores")
    worst = _held(out, jobs, ref, 0.0, "whmr-serve --data_parallel 1")
    log(_latency_line("mesh: whmr-serve --data_parallel 1 (a 1 x 1 grid)", lat, wall, stats,
                      sum(len(d) for _, _, d in jobs))
        + f"; every response equals run_image without a grid (largest difference {worst} m); "
        f"{time.perf_counter() - t0:.1f} s with the build and warm-up")
    del srv

    # 2-4. ViT-B on grids of cuda:0 repeated
    for grid in MESH_GRIDS:
        t0 = time.perf_counter()
        pipe = _mesh_pipeline(cfg, weights, grid)
        label = f"ViT-B d={grid[0]} x m={grid[1]}"
        for name, n in _mesh_run(label, cfg, pipe, ref, frames, boxes).items():
            launches[f"{label} {name}"] = n
        log(f"mesh: {label}: {time.perf_counter() - t0:.1f} s with the pipeline's build")
        del pipe
    del ref, weights
    torch.cuda.empty_cache()

    # 5. ViT-L (configs/vit-l.yaml) at m=2 on seeded random weights
    t0 = time.perf_counter()
    lcfg = load_yaml(str(Path(__file__).resolve().parent / REMAT_CFG)).with_overrides(
        **dict(zip(SERVE_MISC[::2], SERVE_MISC[1::2])))
    lmodel, _ = build_model(lcfg, dtype=torch.float32, device="cpu", seed=0)
    lweights = lmodel.state_dict()
    del lmodel
    lref = _mesh_pipeline(lcfg, lweights, None)
    log(f"mesh: ViT-L weights' init and the pipeline without a grid: {time.perf_counter() - t0:.1f} s")
    for grid in MESH_VIT_L_GRIDS:
        t0 = time.perf_counter()
        lpipe = _mesh_pipeline(lcfg, lweights, grid)
        label = f"ViT-L d={grid[0]} x m={grid[1]}"
        for name, n in _mesh_run(label, lcfg, lpipe, lref, frames, boxes).items():
            launches[f"{label} {name}"] = n
        log(f"mesh: {label}: {time.perf_counter() - t0:.1f} s with the pipeline's build")
        del lpipe
    del lref, lweights
    torch.cuda.empty_cache()

    # the refusals, with whmr_tpu's messages
    for kw, msg in (({"bundle": str(root / "bundle_demo"), "max_people": SERVE_PEOPLE, "grid": (2, 1)}, "single device"),
                    ({"max_people": 6, "grid": (4, 1)}, "divisible")):
        grid = kw.pop("grid")
        mesh = ServingGrid([["cuda:0"] * grid[1]] * grid[0])
        try:
            DemoPipeline(cfg, None, synthetic_smpl_assets(), mesh=mesh, **kw)
        except ValueError as e:
            check(msg in str(e), f"the refusal of {kw} with a {grid} grid says {e}")
        else:
            check(False, f"a {grid} grid with {kw} was not refused")
    log("mesh: a bundle with a grid and max_people=6 on a 4 x 1 grid are refused with whmr_tpu's messages")
    return launches


def _set_attn_impl(model, impl):
    """The ViT blocks' attention formulation, switched in place (the Tz
    head's block always runs "einsum")."""
    for m in model.feature_extractor.modules():
        if isinstance(m, Attention):
            m.impl = impl


def _forward_ms(model, consts, inputs, iters=5):
    """Synchronised host ms of a forward after 2 warm-up calls."""
    for _ in range(2):
        model(consts, **inputs)
    return _synced_ms(lambda: model(consts, **inputs), iters)


def _steps(cfg, model, state, consts, batch, g, rc, n):
    """`n` train steps; returns the metrics of each."""
    out = []
    for _ in range(n):
        state, metrics = ts.train_step(cfg, model, state, consts, batch, g, rc)
        out.append(metrics)
    torch.cuda.synchronize()
    return out


def _check_metrics(history, label):
    for i, metrics in enumerate(history):
        bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v).all())]
        check(not bad, f"{label} step {i + 1}: non-finite metrics {bad}")


def _step_ms(cfg, model, state, consts, batch, g, rc):
    """Synchronised host ms a train step, after one warm-up step."""
    ts.train_step(cfg, model, state, consts, batch, g, rc)
    return _synced_ms(lambda: ts.train_step(cfg, model, state, consts, batch, g, rc), BRANCH_STEPS)


def _branch_batch(cfg, consts):
    np_batch = make_keypoints_consistent(consts, make_example_train_batch(cfg, cfg.train.batch_size))
    return {k: torch.from_numpy(v).cuda() for k, v in np_batch.items()}


def branch_attention_and_fused_adam(rc, launches):
    """(f) the other plain attention bodies in the ViT-B bf16 forward at
    B=48 against "einsum"; (d) a B=64 train step's gradients applied by
    the fused and by the foreach Adam from the same state, and the step
    timed with each."""
    cfg = WHMRConfig()
    model, consts = build_model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    inputs = _inputs(cfg, BRANCH_FWD_BATCH, False, "cuda")
    with torch.inference_mode():
        ref = _verts(model(consts, **inputs))
        for impl in ATTN_FORMULATIONS:
            _set_attn_impl(model, impl)
            model(consts, **inputs)
            reset_launches()
            out = _verts(model(consts, **inputs))
            torch.cuda.synchronize()
            launches[f"attention {impl}"] = n = read_launches()
            check(not any(n.values()), f"the {impl} formulation launched a kernel: {n}")
            d = max((a.float() - b.float()).abs().max().item() for a, b in zip(out, ref))
            check(all(bool(torch.isfinite(v).all()) for v in out), f"{impl}: non-finite vertices")
            ms = _forward_ms(model, consts, inputs)
            log(f"branches (f): ViT-B bf16 forward B={BRANCH_FWD_BATCH} attn_impl={impl}: vertices "
                f"max_abs_diff {d:.4g} m against einsum (tolerance {ATTN_IMPLS_TOL} m); {BRANCH_FWD_BATCH / ms * 1e3:.1f} "
                f"crops/s ({ms:.2f} ms a forward)")
            check(d <= ATTN_IMPLS_TOL, f"the {impl} formulation differs from einsum by {d} m")
        _set_attn_impl(model, "einsum")
        ms = _forward_ms(model, consts, inputs)
        log(f"branches (f): ViT-B bf16 forward B={BRANCH_FWD_BATCH} attn_impl=einsum: "
            f"{BRANCH_FWD_BATCH / ms * 1e3:.1f} crops/s ({ms:.2f} ms a forward)")

    # (d) One step's gradients, applied from the same parameters by each
    # optimizer (two backwards would differ: the step's sums use atomics).
    batch = _branch_batch(cfg, consts)
    model.train()
    state = ts.create_train_state(cfg, model)
    grads, _ = ts._microbatch_grads(cfg, model, state, consts, batch, torch.Generator(device="cuda").manual_seed(1), rc)
    norm = state.grad_norm(list(grads.values()))
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    state.apply_gradients(grads, norm)
    foreach = {k: p.detach().clone() for k, p in state.params.items()}
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(p0[k])
    fused_cfg = cfg.with_overrides(**{"train.fused_adam": True})
    fstate = ts.create_train_state(fused_cfg, model)
    check(type(fstate.tx).__name__ == "FusedAdam", f"train.fused_adam made a {type(fstate.tx).__name__}")
    fstate.apply_gradients(grads, norm)
    d = max((fstate.params[k].detach() - foreach[k]).abs().max().item() for k in foreach)
    moved = max((foreach[k] - p0[k]).abs().max().item() for k in foreach)
    log(f"branches (d): the fused Adam's parameters after one B={cfg.train.batch_size} step against the foreach "
        f"Adam's from the same state and gradients: max_abs_diff {d:.3g} (tolerance {FUSED_ADAM_TOL}; the step moved "
        f"parameters by up to {moved:.3g})")
    check(d <= FUSED_ADAM_TOL and moved > 0, f"fused Adam differs from the foreach Adam by {d}")
    g = torch.Generator(device="cuda").manual_seed(2)
    upd = {"foreach": [], "fused": []}
    step = {"foreach": [], "fused": []}
    retries = {"foreach": 0, "fused": 0}
    states = {"foreach": state, "fused": fstate}
    for name in ("foreach", "fused", "fused", "foreach"):
        st = states[name]
        before = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        upd[name].append(_synced_ms(lambda: st.apply_gradients(grads, norm), 5))
        step[name].append(_step_ms(cfg, model, st, consts, batch, g, rc))
        retries[name] += torch.cuda.memory_stats().get("num_alloc_retries", 0) - before
    del grads, p0, foreach
    log(f"branches (d): B={cfg.train.batch_size} bf16 train step (ViT-B, GT render) " + "; ".join(
        f"{name} Adam {np.mean(step[name]):.2f} ms a step ({[round(x, 2) for x in step[name]]}), the update alone "
        f"{np.mean(upd[name]):.2f} ms ({[round(x, 2) for x in upd[name]]}), {retries[name]} allocator retries"
        for name in step) + f" (synchronised host clock, in turns); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return consts


def branch_graphormer(consts, rc, launches):
    """(b) the Graphormer model: the bf16 forward at B=48 with "pallas"
    attention, and 3 train steps at B=64 (its einsum twin: K1 is
    forward-only)."""
    cfg = WHMRConfig().with_overrides(**{"pymaf.grph_on": True, "vit.attn_impl": "pallas"})
    model, _ = build_model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    inputs = _inputs(cfg, BRANCH_FWD_BATCH, True, "cuda")
    with torch.inference_mode():
        model(consts, **inputs)
        reset_launches()
        out = model(consts, **inputs)
        torch.cuda.synchronize()
        launches["graphormer forward"] = n = read_launches()
        check(n["attention"] == n["attention.mma"] == 12, f"Graphormer forward: K1 launches {n}, want 12 on tensor cores")
        check(n["rasterizer"] == n["fused_attention"] == 0, f"Graphormer forward: K2 or K3 launched: {n}")
        check(len(out["smpl_out"]) == 5 and out["refined"] is out["smpl_out"][-1], "Graphormer: no appended stage")
        refined, last = out["refined"]["verts"], out["smpl_out"][3]["verts"]
        check(refined.shape == (BRANCH_FWD_BATCH, 6890, 3) and bool(torch.isfinite(refined).all()),
              f"refined verts {tuple(refined.shape)}, finite {bool(torch.isfinite(refined).all())}")
        d = (refined - last.float()).abs().max().item()
        check(d > 1e-3, f"the refined mesh equals the parametric step's (max_abs_diff {d} m)")
        # The refined mesh against the fp32 twin's on the card, relative to
        # how far the fp32 stage moves the mesh, and the fp32 twin against
        # the same weights on the CPU at B=2.
        twin = _twin(cfg, model, torch.float32, "pallas")
        ref = twin(consts, **inputs)
        d_twin = (refined.float() - ref["refined"]["verts"]).abs().max().item()
        rel_twin = d_twin / (ref["refined"]["verts"] - ref["smpl_out"][3]["verts"]).abs().max().item()
        del ref
        small = _inputs(cfg, 2, True, "cuda")
        got = twin(consts, **small)["refined"]["verts"].cpu()
        cpu = WHMR(cfg, dtype=torch.float32)
        cpu.load_state_dict(model.state_dict())
        want = cpu.eval()(body_consts_from_assets(synthetic_smpl_assets(0), device="cpu"),
                          **{k: v.cpu() for k, v in small.items()})["refined"]["verts"]
        d_cpu = (got - want).abs().max().item()
        del twin, cpu
        ms = _forward_ms(model, consts, _inputs(cfg, BRANCH_FWD_BATCH, False, "cuda"))
    log(f"branches (b): Graphormer bf16 forward B={BRANCH_FWD_BATCH} (pallas, 600x600 frame): launches {n}; "
        f"refined verts {tuple(refined.shape)} finite, {d:.3g} m from the last parametric step's at most, "
        f"max_abs_diff {d_twin:.4g} m against the fp32 twin, {rel_twin:.4g} of the fp32 stage's largest move "
        f"(tolerance {GRAPHORMER_BF16_RTOL}); the fp32 twin at B=2 {d_cpu:.4g} m from the CPU's (tolerance "
        f"{GRAPHORMER_CPU_TOL} m); without a frame {BRANCH_FWD_BATCH / ms * 1e3:.1f} crops/s ({ms:.2f} ms a forward)")
    check(rel_twin <= GRAPHORMER_BF16_RTOL, f"the Graphormer bf16 refined mesh differs from fp32 by {d_twin} m, "
          f"{rel_twin} of the stage's move")
    check(d_cpu <= GRAPHORMER_CPU_TOL, f"the Graphormer fp32 refined mesh differs from the CPU's by {d_cpu} m")

    tcfg = cfg.with_overrides(**{"vit.attn_impl": "einsum"})
    twin = WHMR(tcfg, dtype=torch.bfloat16)
    twin.load_state_dict(model.state_dict())
    del model
    twin.cuda()
    batch = _branch_batch(tcfg, consts)
    state = ts.create_train_state(tcfg, twin)
    graph0 = {k: p.detach().clone() for k, p in state.params.items() if k.startswith("transformer.")}
    g = torch.Generator(device="cuda").manual_seed(1)
    reset_launches()
    history = _steps(tcfg, twin, state, consts, batch, g, rc, BRANCH_STEPS)
    launches["graphormer steps"] = n = read_launches()
    check(n["rasterizer"] == BRANCH_STEPS and n["attention"] == n["fused_attention"] == 0,
          f"Graphormer steps: launches {n}, want K2 once a step")
    _check_metrics(history, "Graphormer")
    m = history[-1]
    check("loss_regr_pose_4" not in m and "loss_cam_4" not in m and "loss_shape_4" in m,
          f"the Graphormer stage's losses: {sorted(k for k in m if k.endswith('_4'))}")
    # the key biases' gradients vanish in exact arithmetic (a per-query shift
    # the softmax removes)
    still = [k for k in graph0 if torch.equal(graph0[k], state.params[k]) and not k.endswith("self.key.bias")]
    check(not still, f"Graphormer parameters that did not move: {still[:5]}")
    ms = _step_ms(tcfg, twin, state, consts, batch, g, rc)
    log(f"branches (b): Graphormer {BRANCH_STEPS} train steps B={tcfg.train.batch_size} bf16: launches {n}; losses "
        f"{[round(h['loss'].item(), 3) for h in history]}, loss_shape_4 {m['loss_shape_4'].item():.4g}, no parameter "
        f"losses on stage 4; all {len(graph0)} Graphormer tensors moved but the key biases; "
        f"{ms:.2f} ms a step ({tcfg.train.batch_size / ms * 1e3:.1f} crops/s)")


def branch_res50(rc, launches):
    """(a) the res50 backbone: the bf16 forward at B=48 against its fp32
    twin, and 3 train steps at B=64 with the GT render."""
    cfg = WHMRConfig().with_overrides(**{"pymaf.backbone": "res50", "pymaf.dp_heatmap_size": (64, 64)})
    model, consts = build_model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    inputs = _inputs(cfg, BRANCH_FWD_BATCH, True, "cuda")
    twin = WHMR(cfg, dtype=torch.float32)
    twin.load_state_dict(model.state_dict())
    twin.cuda().eval()
    with torch.inference_mode():
        model(consts, **inputs)
        reset_launches()
        out = _verts(model(consts, **inputs))
        torch.cuda.synchronize()
        launches["res50 forward"] = n = read_launches()
        check(not any(n.values()), f"the res50 forward launched a kernel: {n}")
        for name, v in zip(("verts", "global_verts"), out):
            check(v.shape == (BRANCH_FWD_BATCH, 6890, 3) and bool(torch.isfinite(v).all()), f"res50 {name}")
        ref = _verts(twin(consts, **inputs))
        d = max((a.float() - b.float()).abs().max().item() for a, b in zip(out, ref))
        ms = _forward_ms(model, consts, _inputs(cfg, BRANCH_FWD_BATCH, False, "cuda"))
    log(f"branches (a): res50 bf16 forward B={BRANCH_FWD_BATCH} (256x256 crops, 600x600 frame): vertices "
        f"max_abs_diff {d:.4g} m against the fp32 twin (tolerance {RES50_VERTS_TOL} m); without a frame "
        f"{BRANCH_FWD_BATCH / ms * 1e3:.1f} crops/s ({ms:.2f} ms a forward)")
    check(d <= RES50_VERTS_TOL, f"the res50 bf16 forward differs from fp32 by {d} m")

    batch = _branch_batch(cfg, consts)
    # K2 at the res50 render (the whole 64x64 map, no ViT slice) against
    # its plain version on this batch.
    vp, vz, attrs, res, origin = train_raster_inputs(cfg, consts, rc, batch)
    check(res == (64, 64) and origin == (0.0, 0.0), f"the res50 render window {res} at {origin}")
    got = k2.rasterize_kernel(vp, vz, attrs, rc.faces, resolution=res, origin=origin)
    torch.cuda.synchronize()
    err = _same_render(got, k2.rasterize_kernel_reference(vp, vz, attrs, rc.faces, resolution=res, origin=origin),
                       "res50 render")
    log(f"branches (a): K2 at the res50 train render (B={vp.shape[0]}, {res[0]}x{res[1]} at {origin}): equal mask "
        f"and zbuf, attrs max_abs_err {err:.3g}; foreground {got.mask.float().mean().item():.3f} of the pixels")
    twin.train()
    twin_state = ts.create_train_state(cfg, twin)
    _, twin_losses = ts._microbatch_grads(cfg, twin, twin_state, consts, batch,
                                          torch.Generator(device="cuda").manual_seed(1), rc)
    loss32 = twin_losses["loss"].item()
    del twin, twin_state, twin_losses
    torch.cuda.empty_cache()
    state = ts.create_train_state(cfg, model)
    params0 = {k: p.detach().clone() for k, p in state.params.items()}
    stats0 = {k: b.clone() for k, b in state.batch_stats.items()}
    g = torch.Generator(device="cuda").manual_seed(1)
    reset_launches()
    history = _steps(cfg, model, state, consts, batch, g, rc, BRANCH_STEPS)
    launches["res50 steps"] = n = read_launches()
    check(n["rasterizer"] == BRANCH_STEPS and n["attention"] == n["fused_attention"] == 0,
          f"res50 steps: launches {n}, want K2 once a step")
    _check_metrics(history, "res50")
    still = [k for k in state.params if torch.equal(params0[k], state.params[k])]
    reached = [k for k in still if not k.startswith(UNREACHED)]
    check(not reached, f"res50: parameters the loss reaches did not move: {reached[:5]}")
    stuck = [k for k in state.batch_stats if torch.equal(stats0[k], state.batch_stats[k]) and not k.startswith("cam_model.")]
    check(not stuck, f"res50: BatchNorm buffers that did not move: {stuck[:5]}")
    loss16 = history[0]["loss"].item()
    rel = abs(loss16 - loss32) / abs(loss32)
    ms = _step_ms(cfg, model, state, consts, batch, g, rc)
    log(f"branches (a): res50 {BRANCH_STEPS} train steps B={cfg.train.batch_size} bf16 (GT render 64x64): launches "
        f"{n}; losses {[round(h['loss'].item(), 3) for h in history]}; {len(state.params) - len(still)} of "
        f"{len(state.params)} parameter tensors moved (the rest under {', '.join(p[:-1] for p in UNREACHED)}); step 1 "
        f"loss bf16 {loss16:.6g} vs fp32 twin {loss32:.6g}: relative {rel:.3g} (tolerance {RES50_LOSS_RTOL}); "
        f"{ms:.2f} ms a step ({cfg.train.batch_size / ms * 1e3:.1f} crops/s)")
    check(rel <= RES50_LOSS_RTOL, f"res50: step 1's bf16 loss differs from the fp32 twin's by {rel} relative")


def _eval_direct(args, regressor, paths, cfg):
    """run_evaluation on the model whmr-eval loads for `args`, over the
    metric protocol's batches."""
    model, consts, _ = eval_cli.load_model_state(args, cfg)
    ds = NpzDataset(cfg, paths["npz"], paths["img_dir"], is_train=False)

    def batches():
        for hb in BatchLoader(ds, CLI_EVAL_BATCH, shuffle=False, drop_last=False):
            b, _ = eval_cli.device_eval_batch(hb, extra_keys=("pose", "betas", "gender", "global_pose"), device="cuda")
            b["valid"] = torch.from_numpy(hb["has_smpl"]).cuda()
            yield b

    return evaluate_module.run_evaluation(cfg, model, consts, batches(), log_every=0, regressor=regressor)


def branch_hmr(root, paths, launches):
    """(c) whmr-train --regressor hmr, 3 steps of B=64 on phase_cli's
    dataset, then whmr-eval --regressor hmr on its checkpoint against
    run_evaluation(regressor="hmr")."""
    argv = ["--train_npz", paths["npz"], "--img_dir", paths["img_dir"], "--log_dir", str(root), "--name", "hmr",
            "--regressor", "hmr", "--bf16", "--batch_size", str(CLI_TRAIN_BATCH), "--num_epochs", "1",
            "--steps_per_epoch", str(BRANCH_STEPS), "--log_every", "1", "--device", "cuda"]
    sigterm = signal.getsignal(signal.SIGTERM)
    with contextlib.ExitStack() as stack:
        stack.callback(signal.signal, signal.SIGTERM, sigterm)
        stack.callback(profiling.disable)
        reset_launches()
        profiling.enable()
        t0 = time.perf_counter()
        trainer = train_cli.main(argv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches["whmr-train hmr"] = n = read_launches()
    check(type(trainer.model).__name__ == "HMR" and trainer.state.step == BRANCH_STEPS,
          f"whmr-train --regressor hmr: {type(trainer.model).__name__} at step {trainer.state.step}")
    check(not any(n.values()), f"whmr-train --regressor hmr launched a kernel: {n}")
    recs = [r for r in _records(trainer.metrics.path) if "loss" in r]
    check(len(recs) == BRANCH_STEPS and all(np.isfinite(v) for r in recs for k, v in r.items() if k != "time"),
          f"whmr-train --regressor hmr metric records {recs}")
    steps = fit_spans().get("fit.step", [])
    gaps = [(recs[i + 1]["time"] - recs[i]["time"]) * 1e3 for i in range(len(recs) - 1)]
    log(f"branches (c): whmr-train --regressor hmr --bf16, {BRANCH_STEPS} steps of B={CLI_TRAIN_BATCH}: {train_s:.1f} s "
        f"in main; launches {n}; losses {[round(r['loss'], 3) for r in recs]}; {np.mean(gaps):.2f} ms a step between "
        f"metric records {[round(x, 2) for x in gaps]} (host clock, each with a metric read-back); host ms of the "
        f"step span {[round(x * 1e3, 1) for x in steps]}")
    del trainer
    torch.cuda.empty_cache()

    common = ["--checkpoint", str(root / "hmr" / "checkpoints"), "--dataset_npz", paths["npz"], "--img_dir",
              paths["img_dir"], "--batch_size", str(CLI_EVAL_BATCH), "--regressor", "hmr", "--device", "cuda"]
    loop_s = {}
    with mock.patch.object(evaluate_module, "run_evaluation", _timed(evaluate_module, "run_evaluation", loop_s)):
        reset_launches()
        got = eval_cli.main(common)
        torch.cuda.synchronize()
        launches["whmr-eval hmr"] = n = read_launches()
    check(not any(n.values()), f"whmr-eval --regressor hmr launched a kernel: {n}")
    want = _eval_direct(eval_cli.build_parser().parse_args(common), "hmr", paths, WHMRConfig())
    for k in ("pve", "mpjpe", "pa_mpjpe"):
        rel = abs(got[k] - want[k]) / abs(want[k])
        check(got["count"] == CLI_IMAGES and rel <= CLI_METRIC_RTOL,
              f"whmr-eval --regressor hmr {k} {got[k]} vs run_evaluation's {want[k]}: relative {rel}")
    log(f"branches (c): whmr-eval --regressor hmr over {CLI_IMAGES} crops (fp32, B={CLI_EVAL_BATCH}): "
        f"{CLI_IMAGES / loop_s['run_evaluation']:.1f} crops/s in the protocol's loop; launches {n}; PVE "
        f"{got['pve']:.3f}, MPJPE {got['mpjpe']:.3f}, PA-MPJPE {got['pa_mpjpe']:.3f} mm, equal to "
        f"run_evaluation(regressor='hmr') within {CLI_METRIC_RTOL} relative")


def branch_convert(root, paths, cli_metric, launches):
    """(e) phase_cli's weights as a reference {"model": state_dict} .pt ->
    whmr-convert --strict -> whmr-eval, against phase_cli's metric."""
    payload = CheckpointManager(str(root / "train" / "checkpoints")).restore()
    sd = {"module." + k: v for k, v in {**payload["params"], **payload["batch_stats"]}.items()}
    sd["points_grid"] = torch.zeros(1, 2, 63)  # a reference constant the conversion drops
    ref = root / "reference.pt"
    torch.save({"model": sd}, ref)
    n_params = len(payload["params"])
    del payload, sd
    t0 = time.perf_counter()
    out = root / "converted"
    report = convert_cli.main(["--torch_ckpt", str(ref), "--out", str(out), "--strict", "--device", "cuda"])
    convert_s = time.perf_counter() - t0
    check(report["params"]["matched"] == n_params and not report["unrecognized"],
          f"whmr-convert matched {report['params']['matched']} of {n_params} parameters")
    reset_launches()
    got = eval_cli.main(["--checkpoint", str(out), "--dataset_npz", paths["npz"], "--img_dir", paths["img_dir"],
                         "--batch_size", str(CLI_EVAL_BATCH), "--device", "cuda", "--misc", "vit.attn_impl", "pallas"])
    torch.cuda.synchronize()
    launches["whmr-eval converted"] = n = read_launches()
    batches = -(-CLI_IMAGES // CLI_EVAL_BATCH)
    check(n["attention"] == n["attention.mma"] == 12 * batches and n["rasterizer"] == 0,
          f"whmr-eval of the converted checkpoint: launches {n}")
    for k in ("pve", "mpjpe", "pa_mpjpe"):
        rel = abs(got[k] - cli_metric[k]) / abs(cli_metric[k])
        check(rel <= CLI_METRIC_RTOL, f"whmr-eval of the converted checkpoint: {k} {got[k]} vs phase_cli's "
              f"{cli_metric[k]}: relative {rel}")
    log(f"branches (e): whmr-convert --strict of a {ref.stat().st_size / 1e9:.2f} GB reference .pt: "
        f"{report['params']['matched']} parameters (+{report['batch_stats']['matched']} BatchNorm statistics) matched, "
        f"nothing unrecognized or mismatched, {convert_s:.1f} s with the template model's build; whmr-eval on it: PVE "
        f"{got['pve']:.3f}, MPJPE {got['mpjpe']:.3f}, PA-MPJPE {got['pa_mpjpe']:.3f} mm, equal to phase_cli's within "
        f"{CLI_METRIC_RTOL} relative; launches {n}")


def phase_branches(root, paths, cli_metric):
    """The remaining model branches at full width, on phase_cli's dataset
    and checkpoint under `root`: (f) the attention formulations and (d)
    fused Adam on ViT-B, (b) the Graphormer model, (a) the res50 backbone,
    (c) the HMR baseline through whmr-train and whmr-eval, (e)
    whmr-convert. Returns the launches of each run."""
    launches, secs = {}, {}
    rc = build_render_consts(synthetic_smpl_assets(0), device="cuda")

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
        return out

    consts = timed("f, d", branch_attention_and_fused_adam, rc, launches)
    timed("b", branch_graphormer, consts, rc, launches)
    timed("a", branch_res50, rc, launches)
    timed("c", branch_hmr, root, paths, launches)
    timed("e", branch_convert, root, paths, cli_metric, launches)
    log("branches: seconds by run " + "; ".join(f"({k}) {v:.1f}" for k, v in secs.items()))
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
    t0 = time.perf_counter()
    remat_launches = phase_remat()
    log(f"remat: phase_remat took {time.perf_counter() - t0:.1f} s")
    fit_launches, fit_ms = phase_trainer(train_cfg, train_consts, train_ms)
    # phase_serve serves the checkpoint phase_cli trains, on its dataset
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        cli_launches, paths, cli_metric = phase_cli(train_consts, train_ms, fit_ms, root)
        par_launches = phase_parallel(root, paths, cli_metric, train_ms)
        t0 = time.perf_counter()
        serve_launches = phase_serve(root, paths, cli_metric)
        log(f"serve: phase_serve took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mesh_launches = phase_serve_mesh(root)
        log(f"mesh: phase_serve_mesh took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        branch_launches = phase_branches(root, paths, cli_metric)
        log(f"branches: phase_branches took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # K3 runs on no path: its count is the forwards', the train steps' and
    # the fit's, each read over its run (and each checked to be 0).
    k3 = next(k for k in kernels if k["name"] == "fused_attention")
    k3["launches"] += train_launches["fused_attention"] + fit_launches["fused_attention"]
    k3["mma_launches"] += train_launches["fused_attention.mma"] + fit_launches["fused_attention.mma"]
    # The CLI path's launches (whmr-eval's K1 on tensor cores, fp32, and
    # whmr-train's K2) and the serving path's (K1 on tensor cores in every
    # export check, server, eval, demo and video run), each read over its
    # run; K3's, checked to be 0.
    # The remat steps' K2 and the grids' K1, each read over its run.
    runs = (list(cli_launches.values()) + par_launches + list(serve_launches.values())
            + list(branch_launches.values()) + list(remat_launches.values()) + list(mesh_launches.values()))
    for k in kernels:
        k["launches"] += sum(n[k["name"]] for n in runs)
        if k["mma_launches"] is not None:
            k["mma_launches"] += sum(n[f"{k['name']}.mma"] for n in runs)
        if k.get("packed_launches") is not None:
            k["packed_launches"] += sum(n.get(f"{k['name']}.packed", 0) for n in runs)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--rank"]:
            rank_main(sys.argv[2:])
        else:
            main()
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
