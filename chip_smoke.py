"""Smoke run of whmr_tpu_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles the forward's CUDA kernel from the source in this
   checkout into build/.
3. Kernels: holds each kernel against its plain PyTorch version on the
   card, at the main path's shapes and a ragged one, in bf16 and fp32.
4. Main path: the full-width WHMR forward (ViT-B, 3 MAF steps, CamCalib,
   world SMPL) in bf16 with vit.attn_impl="pallas", seeded random weights and
   synthetic SMPL assets: B=16 crops without a frame and B=48 crops with one
   600x600 CamCalib frame. Counts every kernel's launches over exactly those
   two forwards, checks shapes and finiteness, and compares the vertices and
   the ViT feature map (which the attention drives directly) with the same
   weights under attn_impl="einsum" and in fp32.
5. Times (CUDA events / synchronized host clock, after warm-up): each kernel
   beside its bound, its plain version and the PyTorch library call for the
   same function; forward crops/s at B=48 with "pallas" and with "einsum".

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
from whmr_tpu_torch.models.whmr import WHMR, build_model
from whmr_tpu_torch.ops import attention as k1
from whmr_tpu_torch.ops import cuda_build
from whmr_tpu_torch.utils.testing import make_example_inputs

# H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}


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


def phase_build():
    t0 = time.perf_counter()
    text = cuda_build.build("attention")
    log(f"build: attention in {time.perf_counter() - t0:.1f} s")
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  attention: {line.strip()}")


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


def main():
    smi = phase_device()
    phase_build()
    errs = phase_kernels()
    cfg, model, consts, inputs, launches = phase_main_path()
    kernels = phase_times(cfg, model, consts, inputs, launches, errs)
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
