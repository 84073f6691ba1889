"""Batched inference: the eval forward on full batches of crops, as
`whmr-eval` and the serving executor drive it.

A pool of seeded batches lives on the device; batch i is pool entry
i mod pool. Each batch is one `WHMR.forward` (eval mode, inference mode)
with every crop's own `cam_rotmat`, followed by copies of its outputs
(SMPL vertices and joints, world vertices, camera translation, focal
length, pose rotations and shape) into pinned host memory and an event.
`in_flight` batches are kept queued: a thread waits on each batch's event
and records when its outputs landed, and the next batch is dispatched as
soon as one lands. A batch's latency runs from the start of its dispatch
to that moment.

After the window, a sample of the window's batches drawn from the seed,
and its last batch, are recomputed by the plain reference. Each crop's gap
is its widest elementwise gap over the fetched outputs, each output's gap
taken over the reference's widest spread of that output across the batch.
The check compares `out_gap`, the 75th percentile of the crops' gaps, and
`crops_over_pct`, the share of the checked crops, in %, whose gap exceeds
the per-crop limit `crop_limit`: so that a few wrong crops fail too. (The
widest crop swings from seed to seed: with random weights a few crops sit
where the MAF loop's sampling and Gram-Schmidt amplify rounding; it is
logged, and `crop_limit` lies well above it.)
"""

from __future__ import annotations

import queue
import random
import statistics
import threading
import time
from typing import Dict

import torch

import assets as assets_mod
import inputs
import port
import trace as trace_mod
import weights as weights_mod
from counts import attention, flops
from reference.model import build_reference
from reference.smpl import smpl_arrays

OUTPUTS = ("verts", "joints", "global_verts", "cam_t", "focal", "rotmat", "shape")


def port_outputs(out) -> Dict[str, torch.Tensor]:
    last = out["smpl_out"][-1]
    return {"verts": out["vis"]["local_smpl_vertices"], "joints": last["kp_3d"],
            "global_verts": out["global_output"]["global_verts"], "cam_t": out["vis"]["pred_cam_t"],
            "focal": out["vis"]["focal_length"], "rotmat": out["global_output"]["global_rotmat"],
            "shape": out["vis"]["shape"]}


def reference_outputs(out) -> Dict[str, torch.Tensor]:
    last = out["smpl_out"][-1]
    return {"verts": last["verts"], "joints": last["kp_3d"], "global_verts": out["global_verts"],
            "cam_t": last["pred_cam_t"], "focal": last["focal_length"], "rotmat": out["global_rotmat"],
            "shape": last["pred_shape"]}


def crop_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{output: (B,) each crop's widest gap over the output's spread}."""
    gaps = {}
    for k in OUTPUTS:
        g, w = got[k].float().cpu(), want[k].float().cpu()
        spread = (w - w.mean(dim=0, keepdim=True)).abs().max().item()
        gaps[k] = (g - w).abs().reshape(w.shape[0], -1).amax(dim=1) / max(spread, 1e-12)
    return gaps


def forward(model, consts, b):
    return model(consts, b["x"], b["center"], b["scale"], b["bbox_height"], b["orig_shape"], b["bbox_info"],
                 cam_rotmat=b["cam_rotmat"])


def run(h) -> Dict:
    dev, t, sizes = h.device, h.traffic, h.config["model"]
    dtype = getattr(torch, t["dtype"])
    cfg = port.port_config(sizes, t.get("overrides", {}))
    assets = assets_mod.synthetic_assets()
    h.phase("imports and assets")
    model, consts, spec = port.build(cfg, assets, dtype, h.seed, dev)
    h.phase("model and weights on the card")
    hw = tuple(sizes["vit.img_size"])
    pool = [inputs.infer_batch(t["batch"], hw, h.seed, i, dev) for i in range(t["pool"])]
    fwd = h.hooks.get("forward", forward)
    n_slots = t["in_flight"] + 1
    slots, sample = [], {}
    rng = random.Random(h.seed)
    sampled = set(rng.sample(range(t["check_from_first"]), t["check_sampled"]))

    with torch.inference_mode():
        out = port_outputs(fwd(model, consts, pool[0]))
        for _ in range(n_slots):
            slots.append({k: torch.empty(v.shape, dtype=v.dtype, pin_memory=dev.type == "cuda") for k, v in out.items()})
        del out
        h.phase("pool and first forward")

        lat, enq = [], []
        errors = []
        pending: "queue.Queue" = queue.Queue()
        room = threading.Semaphore(t["in_flight"])

        def completer():
            while True:
                item = pending.get()
                if item is None:
                    return
                i, t0, ev = item
                try:
                    ev.synchronize()
                    lat.append(time.perf_counter() - t0)
                    if i in sampled:
                        sample[i] = {k: v.clone() for k, v in slots[i % n_slots].items()}
                except Exception as e:  # noqa: BLE001 - reported after the window
                    errors.append(e)
                finally:
                    room.release()

        def dispatch(i):
            room.acquire()
            b = pool[i % len(pool)]
            t0 = time.perf_counter()
            out = fwd(model, consts, b)
            t1 = time.perf_counter()
            for k, v in port_outputs(out).items():
                slots[i % n_slots][k].copy_(v, non_blocking=True)
            ev = torch.cuda.Event() if dev.type == "cuda" else _DoneEvent()
            ev.record()
            enq.append(t1 - t0)
            pending.put((i, t0, ev))

        def loop(n_batches=None, seconds=None, first=0):
            worker = threading.Thread(target=completer, daemon=True)
            worker.start()
            t_start = time.perf_counter()
            i = first
            while (n_batches is not None and i < first + n_batches) or (
                    seconds is not None and time.perf_counter() - t_start < seconds):
                dispatch(i)
                i += 1
            pending.put(None)
            worker.join()
            if errors:
                raise errors[0]
            return t_start, time.perf_counter(), i - first

        loop(n_batches=t["warmup_batches"], first=-t["warmup_batches"])
        lat.clear(), enq.clear(), sample.clear()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        h.mark_setup_done()
        t_start, t_end, n = loop(seconds=h.seconds)
        window_s = t_end - t_start
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        last = n - 1
        sample[last] = {k: v.clone() for k, v in slots[last % n_slots].items()}
        sample = {i: v for i, v in sample.items() if i < n}
        lat_window = list(lat)
        enq_window = list(enq)

        crops_per_batch = t["batch"]
        ctx = {
            "window": {"seconds": window_s, "crops": n * crops_per_batch, "batches": n},
            "spans": {"enqueue_s": enq_window},
            "flops_per_crop": flops.forward_flops(sizes),
            "k1_bound_s": attention.attention_bound_s(
                (crops_per_batch, sizes["vit.num_heads"], _tokens(sizes),
                 sizes["vit.embed_dim"] // sizes["vit.num_heads"]), t["dtype"]),
        }
        if h.trace:
            ctx["trace"] = trace_mod.traced(lambda: loop(n_batches=t["traced_batches"], first=n))

    e2e = {
        "infer_crops_per_s": n * crops_per_batch / window_s,
        "infer_batch_p95_ms": statistics.quantiles(lat_window, n=20)[-1] * 1e3 if len(lat_window) > 1 else float("nan"),
    }
    del model, consts, pool, slots
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = check(h, sizes, spec, assets, sample, hw, dev)
    return {"attempted": n, "failed": 0, "e2e": e2e, "ctx": ctx, "checks": checks, "memory_peak_bytes": peak}


class _DoneEvent:
    """The CPU stand-in of a CUDA event: work on the host is done when enqueued."""

    def record(self):
        pass

    def synchronize(self):
        pass


def _tokens(s):
    patch, pad = s["vit.patch_size"], s["vit.patch_padding"]
    h, w = s["vit.img_size"]
    return ((h + 2 * pad - patch) // patch + 1) * ((w + 2 * pad - patch) // patch + 1)


@torch.no_grad()
def reference_answers(h, ref, hw, dev, index) -> Dict[str, torch.Tensor]:
    """`ref`'s outputs (on the host) for pool batch `index % pool` of the
    seed, in blocks of `check_rows` rows."""
    t = h.traffic
    b = inputs.infer_batch(t["batch"], hw, h.seed, index % t["pool"], dev)
    parts = []
    for r0 in range(0, t["batch"], t["check_rows"]):
        sl = {k: v[r0:r0 + t["check_rows"]] for k, v in b.items()}
        out = ref(sl["x"], sl["center"], sl["scale"], sl["bbox_height"], sl["orig_shape"], sl["bbox_info"],
                  sl["cam_rotmat"])
        parts.append({k: v.float().cpu() for k, v in reference_outputs(out).items()})
    return {k: torch.cat([p[k] for p in parts]) for k in OUTPUTS}


@torch.no_grad()
def check(h, sizes, spec, assets, sample, hw, dev) -> Dict[str, tuple]:
    """The float32 reference over the checked batches; {number: (value, limit)}."""
    ref = build_reference(sizes, smpl_arrays(assets, dev), weights_mod.generate(spec, h.seed, dev), dev).eval()
    per, crops = {}, []
    for i, got in sorted(sample.items()):
        gaps = crop_gaps(got, reference_answers(h, ref, hw, dev, i))
        for k, v in gaps.items():
            per[k] = max(per.get(k, 0.0), v.max().item())
        crops.append(torch.stack(list(gaps.values())).amax(dim=0))
    crops = torch.cat(crops)
    h.log(f"widest gap by output over the checked batches {sorted(sample)}: "
          + ", ".join(f"{k} {v:.6g}" for k, v in per.items())
          + f"; crops' gaps: median {crops.median().item():.6g}, widest {crops.max().item():.6g}")
    over = 100.0 * (crops > h.limits["crop_limit"]).float().mean().item()
    return {"out_gap": (torch.quantile(crops, 0.75).item(), h.limits["out_gap"]),
            "crops_over_pct": (over, h.limits["crops_over_pct"])}
