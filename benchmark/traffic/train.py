"""Training: the port's `train_step` on seeded batches held on the device.

Set-up builds one train state (the model in train mode, Adam, the GT
render's constants) and drives it through its first `check_steps` steps,
on pool batches 0, 1, 2 (rows that all differ), through the same call
and feed as the window. Those steps are the check's: their losses, the
first step's gradient of each leaf (from Adam's first moment after one
step, mu = 0.1 g) and each leaf's change over the steps. The window then
dispatches steps back to back, cycling the pool, and reads nothing back
until it closes. Each batch lays its rows out in strata
(`inputs.stratified_order`), so that a step over half of a batch reads
another loss than one over all of it.

After the window the plain reference repeats the first steps from the
same weights, batches and dropout generator in float32, and the check
compares:
- `loss_gap`: the widest gap over the check steps between the program's
  loss and the reference's, over the reference's;
- `head_grad_err`: the first gradient of the IUV head (`dp_head`), as one
  vector: the norm of its difference from the reference's over the
  reference's norm. The head sits on the feed-forward path (ViT, deconv
  pyramid, IUV head, cross-entropy and smooth-L1 losses), so its gradient
  shows the compute precision; the leaves below the MAF loop also take
  the L1 vertex losses, whose gradients flip sign with any rounding;
- `update_gap`: the largest gap between a leaf's change over the steps and
  the reference's, over the larger of the reference leaf's change and the
  median leaf's, counted over the elements whose reference first gradient
  is at least a thousandth of the median leaf's RMS gradient (the others,
  such as the key bias under softmax, move under Adam by round-off alone).
A leaf of the port that the reference lacks (the unused CamCalib network)
must not move at all. The IUV head's gap of first-gradient norms, and the
median leaf's gap of first-gradient norms and its first-gradient error are
logged beside them: neither the float8 control nor a fault moves them
three or ten times beyond a sound run's readings.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

import assets as assets_mod
import inputs
import port
import trace as trace_mod
import weights as weights_mod
from counts import flops, raster
from reference.model import build_reference
from reference.smpl import batch_rodrigues, smpl49, smpl_arrays
from reference.train import gt_camera, estimate_translation, project_to_pixels, reference_steps, synthetic_chart

HEAD = "dp_head."
LOSS_KEYS = ("pose_w", "shape_w", "kp_3d_w", "vert_w", "index_weights", "part_weights", "point_regression_weights")


def make_pool(h, sizes, smpl, dev):
    t = h.traffic

    def joints(pose, betas):
        rot = batch_rodrigues(pose.reshape(-1, 3)).reshape(-1, 24, 3, 3)
        return smpl49(smpl, betas, rot)[1]

    with torch.no_grad():
        return [inputs.train_batch(t["batch"], tuple(sizes["vit.img_size"]), h.seed, i, dev, joints, t["keypoint_camera"])
                for i in range(t["pool"])]


@torch.no_grad()
def k2_bounds(smpl, chart, batches, heatmap=(128, 128)) -> List[float]:
    """K2's least time for each batch's GT render (counts/raster.py)."""
    out = []
    for b in batches:
        rot = batch_rodrigues(b["pose"].reshape(-1, 3)).reshape(-1, 24, 3, 3)
        verts, joints, _ = smpl49(smpl, b["betas"], rot)
        kp = b["keypoints"]
        kp_pix = torch.cat([0.5 * 256.0 * (kp[..., :2] + 1.0), kp[..., 2:]], dim=-1)
        cam = gt_camera(estimate_translation(joints, kp_pix, 1000.0, (256.0, 256.0)))
        vp, _ = project_to_pixels(verts[:, chart.vertex_map], cam, heatmap)
        margin = heatmap[1] // 8
        fbox = raster.face_bbox(vp, torch.as_tensor(chart.faces, device=vp.device))
        pairs, _, n_bytes = raster.raster_work(fbox, (heatmap[0], heatmap[1] - 2 * margin), (float(margin), 0.0), 3)
        out.append(raster.raster_bound_s(pairs, n_bytes))
    return out


def run(h) -> Dict:
    from whmr_tpu_torch.training import train_step as ts
    from whmr_tpu_torch.training.gt_renderer import build_render_consts

    dev, t, sizes = h.device, h.traffic, h.config["model"]
    cfg = port.port_config({**sizes, **h.config.get("train", {})}, t.get("overrides", {}))
    assets = assets_mod.synthetic_assets()
    smpl = smpl_arrays(assets, dev)
    h.phase("imports and assets")
    model, consts, spec = port.build(cfg, assets, getattr(torch, t["dtype"]), h.seed, dev)
    state = ts.create_train_state(cfg, model)
    h.phase("model, weights and Adam on the card")
    rc = build_render_consts(port.port_assets(assets), device=dev)
    pool = make_pool(h, sizes, smpl, dev)
    h.phase("render constants and pool")
    drop_seed = inputs.generator(h.seed, 7, dev).initial_seed()
    gen = torch.Generator(device=dev).manual_seed(drop_seed)
    names = list(state.params)
    step_fn = h.hooks.get("train_step", ts.train_step)

    def step(i):
        _, metrics = step_fn(cfg, model, state, consts, pool[i % len(pool)], gen, rc)
        return metrics["loss"]

    n_check = t["check_steps"]
    losses = []
    for i in range(n_check):
        losses.append(step(i))
        if i == 0:  # Adam's first moment after one step is 0.1 g
            g1 = {k: (m.detach() / 0.1).cpu() for k, m in zip(names, state.opt_state.mu)}
    w0 = weights_mod.generate(spec, h.seed, dev)
    with torch.no_grad():
        delta = {k: (state.params[k].detach() - w0[k]).cpu() for k in names}
    del w0
    check_losses = [float(v) for v in losses]
    h.phase("check steps")
    for i in range(t["warmup_steps"]):
        step(n_check + i)

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    h.mark_setup_done()
    first = n_check + t["warmup_steps"]
    t_start = time.perf_counter()
    i, window_losses = first, []
    while time.perf_counter() - t_start < h.seconds:
        window_losses.append(step(i))
        i += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_start
    n = i - first
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    failed = sum(1 for v in torch.stack(window_losses).tolist() if v != v or abs(v) == float("inf"))

    ctx = {
        "window": {"seconds": window_s, "crops": n * t["batch"], "steps": n},
        "flops_per_crop": flops.train_flops(sizes),
        "peak_bytes": peak,
    }
    if h.trace:
        k = t["traced_steps"]
        traced_idx = list(range(i, i + k))
        ctx["trace"] = trace_mod.traced(lambda: [step(j) for j in traced_idx])
        chart = synthetic_chart(assets, dev)
        bounds = k2_bounds(smpl, chart, [pool[j % len(pool)] for j in range(len(pool))])
        ctx["k2_bound_s"] = statistics.mean(bounds[j % len(pool)] for j in traced_idx)

    del model, state, rc, consts
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(h, sizes, spec, assets, smpl, pool[:n_check], drop_seed, names, check_losses, g1, delta)
    return {"attempted": n, "failed": failed, "e2e": {"train_crops_per_s": n * t["batch"] / window_s},
            "ctx": ctx, "checks": checks, "memory_peak_bytes": peak}


def reference_readings(h, sizes, spec, assets, smpl, batches, drop_seed, fp8=False):
    """(losses, first gradients by name, changes by name) of the reference."""
    dev = h.device
    w0 = weights_mod.generate(spec, h.seed, dev)
    ref = build_reference(sizes, smpl, w0, dev)
    ref.set_fp8(fp8)
    rnames = [k for k, _ in ref.named_parameters()]
    tr = h.config.get("train", {})
    loss_w = {k: tr.get("loss." + k) for k in LOSS_KEYS}
    gen = torch.Generator(device=dev).manual_seed(drop_seed)
    losses, g1 = reference_steps(ref, smpl, synthetic_chart(assets, dev), batches, loss_w, tr["train.base_lr"], gen, rnames)
    params = dict(ref.named_parameters())
    with torch.no_grad():
        delta = {k: (params[k] - w0[k]).detach() for k in rnames}
    return losses, dict(zip(rnames, g1)), delta


def leaf_gaps(names, g1, delta, ref_g1: Dict, ref_delta: Dict):
    """{leaf: gap} of the first-gradient norms, of the first gradients
    themselves (the norm of the difference), and of the changes over the
    elements the reference's first gradient moves. `g1` and `delta`: the
    program's first gradients and changes by name."""
    shared = [k for k in names if k in ref_g1]
    ref_norm = {k: torch.linalg.vector_norm(ref_g1[k]).item() for k in shared}
    g_med = statistics.median(ref_norm.values())
    grad, err = {}, {}
    for k in shared:
        g = g1[k].to(ref_g1[k].device)
        grad[k] = abs(torch.linalg.vector_norm(g).item() - ref_norm[k]) / max(ref_norm[k], g_med)
        err[k] = torch.linalg.vector_norm(g - ref_g1[k]).item() / max(ref_norm[k], g_med)
    rms = statistics.median(ref_norm[k] / ref_g1[k].numel() ** 0.5 for k in shared)
    dp, dr = {}, {}
    for k in shared:
        mask = ref_g1[k].abs() >= 1e-3 * rms
        if bool(mask.any()):
            dr[k] = torch.linalg.vector_norm(ref_delta[k][mask]).item()
            dp[k] = torch.linalg.vector_norm(delta[k].to(mask.device)[mask]).item()
    d_med = statistics.median(dr.values())
    upd = {k: abs(dp[k] - dr[k]) / max(dr[k], d_med) for k in dr}
    return grad, err, upd


def compare(names, losses, g1, delta, ref_losses, ref_g1: Dict, ref_delta: Dict):
    """(per-step loss gaps, {compared number: value}, leaves the port moves
    that the reference lacks, {logged number: value})."""
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    grad, err, upd = leaf_gaps(names, g1, delta, ref_g1, ref_delta)
    stray = [k for k in names if k not in ref_g1 and bool(delta[k].any())]
    head = [k for k in names if k.startswith(HEAD) and k in ref_g1]
    diff = sum(torch.linalg.vector_norm(g1[k].to(ref_g1[k].device) - ref_g1[k]).item() ** 2 for k in head)
    ref = sum(torch.linalg.vector_norm(ref_g1[k]).item() ** 2 for k in head)
    got = sum(torch.linalg.vector_norm(g1[k]).item() ** 2 for k in head)
    numbers = {"loss_gap": max(loss_gaps), "head_grad_err": (diff / ref) ** 0.5, "update_gap": max(upd.values())}
    logged = {"head_grad_gap": abs(got ** 0.5 - ref ** 0.5) / ref ** 0.5,
              "grad_gap": statistics.median(grad.values()), "grad_err": statistics.median(err.values())}
    return loss_gaps, numbers, stray, logged


def check(h, sizes, spec, assets, smpl, batches, drop_seed, names, losses, g1, delta):
    ref_losses, ref_g1, ref_delta = reference_readings(h, sizes, spec, assets, smpl, batches, drop_seed)
    loss_gaps, numbers, stray, logged = compare(names, losses, g1, delta, ref_losses, ref_g1, ref_delta)
    h.log(f"losses {losses}; reference {ref_losses}; gaps by step {loss_gaps}; median leaf: {logged}")
    for label, gaps in zip(("first-gradient norm", "first-gradient", "change"),
                           leaf_gaps(names, g1, delta, ref_g1, ref_delta)):
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        h.log(f"largest {label} gaps: " + ", ".join(f"{k} {v:.4g}" for k, v in top)
              + f"; median leaf {statistics.median(gaps.values()):.4g}")
    if stray:
        h.log(f"leaves the reference does not have moved: {stray[:5]}")
    checks = {k: (v, h.limits[k]) for k, v in numbers.items()}
    checks["stray_leaves"] = (float(len(stray)), 0.0)
    return checks
