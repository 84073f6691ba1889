"""Smoke run of whmr_tpu_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles every CUDA kernel from the sources in this checkout into
   build/, one nvcc for each source, all started together; prints ptxas's
   registers and spills.
3. Kernels: holds each kernel against its plain PyTorch version on the
   card. K1 (attention) at the forward's shapes and a ragged one, in bf16 and
   fp32. K2 (rasterizer) at the train step's render (B=64 posed bodies with
   their least-squares GT cameras, the 13,776-face topology, the 128x96
   window at origin (16, 0)), on a ragged case (ties inside and across
   chunks, padding faces, sides that are no multiple of the tile) and with
   the largest GT camera, which covers every tile.
4. Forward path: the full-width WHMR forward (ViT-B, 3 MAF steps, CamCalib,
   world SMPL) in bf16 with vit.attn_impl="pallas", seeded random weights and
   synthetic SMPL assets: B=16 crops without a frame and B=48 crops with one
   600x600 CamCalib frame. Counts every kernel's launches over exactly those
   two forwards, checks shapes and finiteness, and compares the vertices and
   the ViT feature map (which the attention drives directly) with the same
   weights under attn_impl="einsum" and in fp32.
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
   same function (none for K2); forward crops/s at B=48 with "pallas" and
   with "einsum"; train step ms and crops/s at B=64; peak memory.

Output: a line with the card's name and power limit, one JSON line
{"kernels": [...]}, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from whmr_tpu_torch.config import WHMRConfig
from whmr_tpu_torch.data.assets import synthetic_smpl_assets
from whmr_tpu_torch.models.smpl import smpl_forward
from whmr_tpu_torch.models.whmr import WHMR, build_model
from whmr_tpu_torch.ops import attention as k1
from whmr_tpu_torch.ops import cuda_build
from whmr_tpu_torch.ops import rasterizer_kernel as k2
from whmr_tpu_torch.ops.iuv import iuv_img2map
from whmr_tpu_torch.ops.rotation import batch_rodrigues
from whmr_tpu_torch.training import train_step as ts
from whmr_tpu_torch.training.gt_renderer import build_render_consts, raster_inputs
from whmr_tpu_torch.utils.testing import (
    make_example_inputs,
    make_example_train_batch,
    make_keypoints_consistent,
    make_ragged_raster_case,
)

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
KERNELS = ("attention", "rasterizer")
# fp32 operations of K2's coverage-and-depth test of one (pixel, face) pair:
# three barycentrics at 2 mul + 2 add, three compares, the depth at
# 3 mul + 2 add, a select and a min.
RASTER_OPS_PER_PAIR = 3 * 4 + 3 + 5 + 2
TRAIN_STEPS = 3
# Parameters whose gradient is structurally zero in the stage-2 train step
# at the default loss weights, in whmr_tpu as here: CamCalib (no full frame
# in training), and the Tz head and global-orientation regressor, which
# reach only the world keypoint loss (loss.kp_2d_w = 0).
UNREACHED = ("cam_model.", "conv.", "transformer_decoder.", "est_Tz.", "global_orient.")
# bf16 step-1 loss against the fp32 twin's, relative: about 10x the reading
# on an H100 80GB HBM3 (4.1e-5).
LOSS_RTOL = 5e-4


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters, warmup=3):
    """Mean device milliseconds per call of `fn`, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    return smi


def rasterizer_bound_ms(tables, bbox, resolution, tile_hw, origin, chunk):
    """Least time for K2's work on these inputs: the face tables and bboxes
    read once and zbuf and attrs written once, against the coverage-and-depth
    test of every (pixel, face) pair of the chunks that pass the cull, at the
    fp32 peak. Returns (ms, bound_by, pairs)."""
    h, w = resolution
    th, tw = tile_hw
    hits = k2.tile_hits(bbox, resolution, tile_hw, origin)  # (B, tiles, K)
    nbx = -(-w // tw)
    tiles = torch.arange(hits.shape[1], device=hits.device)
    pix = ((h - (tiles // nbx) * th).clamp(max=th) * (w - (tiles % nbx) * tw).clamp(max=tw)).float()
    pairs = float((hits.float().sum(dim=2) * pix).sum().item()) * chunk
    b, c = bbox.shape[0], tables[4].shape[1] // 3
    n_bytes = 4 * (sum(t.numel() for t in tables) + bbox.numel() + b * h * w * (1 + c))
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = pairs * RASTER_OPS_PER_PAIR / PEAK_OPS_PER_S[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), pairs


def phase_build():
    t0 = time.perf_counter()
    texts = cuda_build.build_all(KERNELS)
    log(f"build: {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s (in parallel)")
    for name, text in texts.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels():
    """K1 against its plain version; returns {(shape, dtype): max_abs_err}."""
    errs = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(16, 12, 192, 64), (48, 12, 192, 64), (3, 2, 63, 32)]
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes:
            q, k, v = (torch.randn(*shape, device="cuda", generator=g, dtype=dtype) for _ in range(3))
            got = k1.attention(q, k, v)
            torch.cuda.synchronize()
            want = k1.attention_reference(q, k, v)
            err = (got.float() - want.float()).abs()
            tol = k1_tolerance(want, dtype)
            errs[(shape, dtype)] = err.max().item()
            log(f"K1 {tuple(shape)} {str(dtype)[6:]}: max_abs_err {errs[(shape, dtype)]:.3g} "
                f"(tolerance {tol.max().item():.3g})")
            check(bool((err <= tol).all()), f"K1 disagrees with its plain version at {shape} {dtype}")
    q = torch.randn(1, 2, 16, 32, device="cuda", requires_grad=True)
    try:
        k1.attention(q, q.detach(), q.detach()).sum().backward()
    except NotImplementedError:
        log("K1 backward raises NotImplementedError (forward-only)")
    else:
        raise SmokeError("backward through K1 did not raise")
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

    k1.attention.launches = 0
    outs = {r: model(consts, **inputs[r]) for r in runs}
    torch.cuda.synchronize()
    launches = {"attention": k1.attention.launches}
    log(f"main path: {len(runs)} forwards, launches {launches}")
    check(launches["attention"] == 12 * len(runs), f"K1 launched {launches['attention']} times, want 12 a forward")
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
        plain_ms = cuda_ms(lambda: k1.attention_reference(q, k, v), 50)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 200)
        bound_ms, bound_by = attention_bound_ms(shape, torch.bfloat16)
        log(f"K1 B={b} bf16: {ms * 1e3:.1f} us; bound {bound_ms * 1e3:.1f} us ({bound_by}); "
            f"plain {plain_ms * 1e3:.1f} us; scaled_dot_product_attention {library_ms * 1e3:.1f} us")
        if b == 48:
            kernels.append({
                "name": "attention",
                "route": "cuda",
                "source": "whmr_tpu_torch/csrc/attention.cu",
                "replaces": "whmr_tpu/ops/attention_pallas.py:79",
                "launches": launches["attention"],
                "max_abs_err": errs[(shape, torch.bfloat16)],
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
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
    _, bbox = k2.raster_tables(vp, vz, attrs, rc.faces)
    hits = k2.tile_hits(bbox, res, tile_hw, origin)
    log(f"K2 train render: equal mask and zbuf, attrs max_abs_err {err:.3g}; foreground "
        f"{got.mask.float().mean().item():.3f} of the pixels; (tile, chunk) pairs hit "
        f"{hits.float().mean().item():.3f}")

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
    _, bbox2 = k2.raster_tables(vp2, vz2, attrs2, rc.faces)
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
    k1.attention.launches = 0
    k2.rasterize_kernel.launches = 0
    history = []
    for _ in range(TRAIN_STEPS):
        state, metrics = ts.train_step(cfg, model, state, consts, batch, g, rc)
        history.append(metrics)
    torch.cuda.synchronize()
    launches = {"attention": k1.attention.launches, "rasterizer": k2.rasterize_kernel.launches}
    log(f"train path: {TRAIN_STEPS} steps at B={cfg.train.batch_size}, launches {launches}")
    check(launches["rasterizer"] == TRAIN_STEPS, f"K2 launched {launches['rasterizer']} times, want 1 a step")
    check(launches["attention"] == 0, "K1 launched in training, which runs vit.attn_impl='einsum'")
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


def phase_train_times(cfg, model, consts, rc, batch, state, launches, k2_err):
    """K2 at the train render beside its bound and plain version; the train
    step's time, throughput and peak memory. Returns K2's kernels entry."""
    vp, vz, attrs, res, origin = train_raster_inputs(cfg, consts, rc, batch)
    tile_hw = k2._pick_tile_hw(*res, 128)
    tables, bbox = k2.raster_tables(vp, vz, attrs, rc.faces)
    ms = cuda_ms(lambda: k2._launch(tables, bbox, res, k2.DEFAULT_CHUNK, tile_hw, origin), 50)
    wrapper_ms = cuda_ms(lambda: k2.rasterize_kernel(vp, vz, attrs, rc.faces, resolution=res, origin=origin), 50)
    plain_ms = cuda_ms(lambda: k2.rasterize_kernel_reference(vp, vz, attrs, rc.faces, resolution=res,
                                                             origin=origin), 3, warmup=1)
    bound_ms, bound_by, pairs = rasterizer_bound_ms(tables, bbox, res, tile_hw, origin, k2.DEFAULT_CHUNK)
    log(f"K2 B={vp.shape[0]} train render: kernel {ms * 1e3:.1f} us ({wrapper_ms * 1e3:.1f} us with its face tables); "
        f"bound {bound_ms * 1e3:.1f} us ({bound_by}: {pairs:.4g} pixel-face pairs after the cull, "
        f"{RASTER_OPS_PER_PAIR} fp32 ops each); plain {plain_ms * 1e3:.1f} us; library none")
    cam = torch.tensor([[2 * 1000.0 / 256.0, 0.0, 0.0]] * vp.shape[0], device="cuda")
    vpd, vzd, attrsd, _, _ = train_raster_inputs(cfg, consts, rc, batch, camera=cam)
    tables_d, bbox_d = k2.raster_tables(vpd, vzd, attrsd, rc.faces)
    ms_d = cuda_ms(lambda: k2._launch(tables_d, bbox_d, res, k2.DEFAULT_CHUNK, tile_hw, origin), 10)
    bound_d = rasterizer_bound_ms(tables_d, bbox_d, res, tile_hw, origin, k2.DEFAULT_CHUNK)
    log(f"K2 B={vp.shape[0]} largest GT camera (every tile hit): kernel {ms_d * 1e3:.1f} us; "
        f"bound {bound_d[0] * 1e3:.1f} us ({bound_d[1]}, {bound_d[2]:.4g} pairs)")

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
    return {
        "name": "rasterizer",
        "route": "cuda",
        "source": "whmr_tpu_torch/csrc/rasterizer.cu",
        "replaces": "whmr_tpu/ops/rasterizer_pallas.py:255",
        "launches": launches["rasterizer"],
        "max_abs_err": k2_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def main():
    smi = phase_device()
    phase_build()
    errs = phase_kernels()
    train_cfg = WHMRConfig()
    train_model, train_consts, rc, batch = train_setup(train_cfg)
    k2_err = phase_k2(train_cfg, train_consts, rc, batch)
    cfg, model, consts, inputs, launches = phase_main_path()
    state, train_launches = phase_train(train_cfg, train_model, train_consts, rc, batch)
    kernels = phase_times(cfg, model, consts, inputs, launches, errs)
    kernels.append(phase_train_times(train_cfg, train_model, train_consts, rc, batch, state, train_launches, k2_err))
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
