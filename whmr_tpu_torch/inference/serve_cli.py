"""`whmr-serve` of the port: an HTTP serving daemon over the demo pipeline.

Counterpart of `whmr_tpu/inference/serve_cli.py`, with the same protocol
and guards. Net-new vs the reference, whose only deployment story is
running its demo script in-process (demo/whmr_demo.py:38-91). It turns an
exported bundle (or a live checkpoint) into a network service:

    python -m whmr_tpu_torch.inference.serve_cli --bundle bundle/ --port 8080
    curl -s -X POST --data-binary @img.jpg localhost:8080/infer > out.npz

Protocol (stdlib-only on both sides — no framework needed in clients):

- `GET /healthz` — liveness + pipeline summary (json).
- `GET /meta`    — the bundle's meta.json (or live-model config summary).
- `POST /infer`  — request body is either
    (a) encoded image bytes (jpeg/png — anything cv2.imdecode reads), or
    (b) an npz with `image` ((H, W, 3) uint8; BGR like cv2.imread) and
        optionally `bboxes` ((N, 3|4) [cx, cy, size(, score)]) to skip
        the server-side detector for that request.
  Response is an npz of the pipeline result (verts, verts_world,
  pred_cam_t, focal_length, ..., n_people, detections); pass
  `?format=json` for a json body instead (lists — large!).

It runs on the card unless `--device cpu` is given, and raises when there
is no card.

Concurrency: requests are decoded in parallel (ThreadingHTTPServer) and
their person crops are COALESCED into shared device batches
(`BatchingExecutor`): the card sees one padded batch of `max_people`
rows regardless of how many clients contributed, so concurrent load
raises utilization instead of queueing whole-batch launches. With
CamCalib on, the calibration net runs ONCE per unique frame
(content-hash cache) through a standalone graph — live model or a
`whmr-export --camcalib split` bundle (which carries a second frozen
CamCalib graph) — and its rotation rides each crop row as `cam_rotmat`:
the reference's own per-image protocol (tester.py:100-104,151-162) at
coalesced throughput. Batch-mode camcalib bundles (bare `--camcalib`)
trace the full frame into the batch-global graph and fall back to one
device call per request behind a lock. `GET /stats` reports the
coalescing ratio and the CamCalib cache hit rate (the executor's tracer
counters, utils/profiling.py) and, while the tracer is on, the median and
95th percentile of `serve.queue_wait`: a request's time from its enqueue to
the worker's dequeue, a span under the device batch's `whmr.forward` root.

Scale-out: `--data_parallel N --tensor_parallel M` serves the live model
from this one process over a grid of N x M devices (`parallel/serving.py`):
each device batch splits into N row blocks, one to each model replica, and
each replica's ViT blocks split over its row's M devices. The executor,
the CamCalib cache, `/reload` (which rebuilds on the same grid) and the
drain are unchanged; `/meta` reports the grid's shape.

Warm weight swap: `POST /reload` (optional json body
{"checkpoint": dir} or {"bundle": dir}; default re-reads the configured
source — a checkpoint dir picks up its latest save, a bundle dir is
re-loaded) rebuilds the pipeline, warms it on the card while the old one
serves, and atomically repoints the daemon — in-flight requests finish on the old weights, later
ones use the new; no restart, no dropped requests. Bundle daemons swap to
a re-exported artifact the same way (the artifact itself stays immutable;
the daemon just changes which one it serves).
"""

from __future__ import annotations

import argparse
import io
import itertools
import json
import queue
import threading
import time

from whmr_tpu_torch.utils import profiling

# The executor's statistics, each a tracer counter under the executor's
# own prefix ("serve.<n>."), so that executors in one process count apart.
STATS = ("requests", "device_batches", "coalesced_requests", "crops", "camcalib_calls", "camcalib_cache_hits")
_EXECUTORS = itertools.count()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WHMR HTTP serving daemon (PyTorch port)")
    p.add_argument("--bundle", default=None,
                   help="whmr-export bundle dir (a frozen torch.export "
                        "program, no model build)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir of the port (live model instead of "
                        "a bundle)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--detector", default=None,
                   choices=["full", "iuv", "contour"],
                   help="server-side detector for requests without bboxes "
                        "(same semantics as whmr-demo)")
    p.add_argument("--max_people", type=int, default=8)
    p.add_argument("--data_parallel", type=int, default=0, metavar="N",
                   help="split each device batch over N model replicas, one a device row")
    p.add_argument("--tensor_parallel", type=int, default=0, metavar="M",
                   help="split ViT block weights over the M devices of each row")
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                   help="live-model compute dtype (bundles fix theirs at export)")
    p.add_argument("--no_camcalib", action="store_true")
    p.add_argument("--no_coalesce", action="store_true",
                   help="disable cross-request crop coalescing (one device "
                        "call per request behind a lock); coalescing is "
                        "automatic when camcalib is off")
    p.add_argument("--coalesce_wait_ms", type=float, default=2.0,
                   help="max time the batcher waits for more requests "
                        "after the first one")
    p.add_argument("--warmup", action="store_true",
                   help="run the serving path once on a dummy request "
                        "before accepting traffic (kernel builds and "
                        "library set-up then happen before the first "
                        "client call)")
    p.add_argument("--data_dir", default=None, help="asset dir")
    p.add_argument("--cfg_file", default=None,
                   help="reference-style YAML config")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, or cpu); no fall back")
    p.add_argument("--misc", nargs="*", default=[],
                   help="dotted config overrides: key value [key value ...]")
    return p


def _result_to_npz_bytes(result) -> bytes:
    import numpy as np

    buf = io.BytesIO()
    # results are numpy (pipeline/export `fetch` casts bf16 outputs to fp32)
    np.savez(buf, **{k: np.asarray(v) for k, v in result.items()})
    return buf.getvalue()


def _result_to_json_bytes(result) -> bytes:
    import numpy as np

    payload = {
        k: np.asarray(v).tolist() if not np.isscalar(v) else v
        for k, v in result.items()
    }
    return json.dumps(payload).encode()


def _parse_infer_body(body: bytes):
    """-> (image (H, W, 3) uint8 BGR, dets or None). Raises ValueError."""
    import cv2
    import numpy as np

    from whmr_tpu_torch.inference.pipeline import Detection

    if body[:6] == b"\x93NUMPY":
        raise ValueError(
            "bare .npy is not accepted; send an .npz container with an "
            "'image' array (and optional 'bboxes')"
        )
    if body[:4] == b"PK\x03\x04":  # npz = zip
        try:
            z = np.load(io.BytesIO(body))
        except Exception as e:  # truncated/corrupt zip -> 400, not a crash
            raise ValueError(f"unreadable npz request body: {e}")
        if "image" not in z:
            raise ValueError("npz request must carry an 'image' array")
        img = np.ascontiguousarray(z["image"])
        if img.ndim != 3 or img.shape[-1] != 3 or img.dtype != np.uint8:
            raise ValueError(
                f"'image' must be (H, W, 3) uint8, got "
                f"{img.shape} {img.dtype}"
            )
        dets = None
        if "bboxes" in z:
            bb = np.asarray(z["bboxes"], np.float32).reshape(-1, z["bboxes"].shape[-1])
            if bb.shape[-1] not in (3, 4):
                raise ValueError("'bboxes' must be (N, 3|4) [cx, cy, size(, score)]")
            dets = [
                Detection(float(r[0]), float(r[1]), float(r[2]),
                          float(r[3]) if len(r) > 3 else 1.0)
                for r in bb
            ]
        return img, dets
    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(
            "request body is neither a decodable image nor an npz with "
            "an 'image' array"
        )
    return img, None


class _Request:
    __slots__ = ("batch", "n", "dets", "event", "result", "error",
                 "cancelled", "render_rotmat", "enqueued_ns", "dequeued_ns")

    def __init__(self, batch, n, dets, render_rotmat=None):
        self.batch = batch      # unpadded host arrays, n rows each
        self.n = n              # valid crops (0 = no detections)
        self.dets = dets
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.cancelled = False  # set by a timed-out submit; worker skips it
        # camcalib coalescing: the pitch-flipped overlay rotation computed
        # by the per-frame CamCalib call (the batched graph only sees
        # cam_rotmat and would echo it back as render_rotmat)
        self.render_rotmat = render_rotmat
        # host clock (perf_counter_ns) of the submit's enqueue and of the
        # worker's dequeue: the `serve.queue_wait` span
        self.enqueued_ns = self.dequeued_ns = None


class BatchingExecutor:
    """Cross-request crop coalescing onto one device.

    Host-side work (detector, crops) runs in the REQUEST thread; only the
    forward is centralized. The worker drains queued requests until the
    batch capacity (= the pipeline/bundle batch) is full or `max_wait_ms`
    elapses after the first one, pads to capacity, runs ONE forward, and
    scatters row ranges back. Rows are independent in the eval-mode graph
    (with CamCalib on, the only cross-crop input — the full frame — is
    replaced by a per-crop `cam_rotmat` computed once per unique frame),
    so results equal per-request calls (tests/test_torch_serve.py).

    The forward runs on the worker thread. K1 launches on the calling
    thread's current stream (ops/attention.py::_launch), and the worker
    uses one stream (the default one, as the request threads that run the
    IUV detector do), so no kernel reads a tensor that another stream is
    still writing."""

    def __init__(self, pipeline, max_wait_ms: float = 2.0, start: bool = True,
                 cam_cache_size: int = 64):
        if pipeline.use_camcalib and getattr(pipeline, "_cam_fwd", None) is None:
            raise ValueError(
                "camcalib coalescing needs a per-frame CamCalib entry: this "
                "frozen bundle traces CamCalib inside the whole-batch graph "
                "(its frame is batch-global), so crops from different images "
                "cannot share one forward — serve it with --no_coalesce, or "
                "re-export with `whmr-export --camcalib split` (separate "
                "per-frame camcalib graph + per-crop cam_rotmat)"
            )
        self.pipeline = pipeline
        self.capacity = int(pipeline.max_people)
        self.max_wait = max_wait_ms / 1e3
        self.q: "queue.Queue[_Request]" = queue.Queue()
        self._carry = None  # request that did not fit the previous batch
        self._stop = threading.Event()
        self._prefix = f"serve.{next(_EXECUTORS)}."
        # Per-frame CamCalib cache: CamCalib runs ONCE per unique
        # image (content-hashed), its rotation rides each crop row as
        # `cam_rotmat`, and crops from different frames share device
        # batches — the reference's own per-image protocol
        # (tester.py:100-104,151-162) at coalesced throughput.
        self._cam_cache: "dict[bytes, tuple]" = {}
        self._cam_cache_size = int(cam_cache_size)
        self._cam_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        if start:
            self._thread.start()

    @property
    def stats(self) -> dict:
        """The executor's statistics by `STATS` key, from its counters."""
        return {k: profiling.counter(self._prefix + k) for k in STATS}

    def _count(self, key: str, n: int = 1) -> None:
        profiling.count(self._prefix + key, n)

    def _camcalib_for(self, image):
        """(cam_rotmat (3,3), render_rotmat (3,3)) for a frame, cached by
        content hash. The CamCalib-only graph runs at most once per unique
        image; repeated frames (video streams, multi-crop clients) hit the
        cache."""
        import hashlib

        import numpy as np

        from whmr_tpu_torch.inference.pipeline import prepare_full_image

        key = hashlib.sha1(np.ascontiguousarray(image)).digest()
        with self._cam_lock:
            hit = self._cam_cache.get(key)
            if hit is not None:
                self._count("camcalib_cache_hits")
                return hit
        from whmr_tpu_torch.inference.export import fetch

        full_u8 = prepare_full_image(
            self.pipeline.cfg, image, raw_uint8=True
        )[None]  # batched (1, H, W, 3) — the graph is traced batch-first
        cam, render = self.pipeline._cam_fwd(full_u8)
        # fetch returns fp32 (a bf16 model's rotations are cast)
        host = fetch({"cam": cam, "render": render})
        out = (host["cam"][0], host["render"][0])
        with self._cam_lock:
            self._count("camcalib_calls")
            if len(self._cam_cache) >= self._cam_cache_size:
                # drop the oldest entry (dict preserves insertion order)
                self._cam_cache.pop(next(iter(self._cam_cache)))
            self._cam_cache[key] = out
        return out

    # -- request side ----------------------------------------------------
    def submit(self, image, dets=None, timeout: float = 600.0):
        import numpy as np

        from whmr_tpu_torch.inference.pipeline import prepare_crop_batch

        pl = self.pipeline
        if dets is None:
            from whmr_tpu_torch.inference.pipeline import call_detector

            dets = call_detector(pl.detector, image)
        dets = list(dets)[: self.capacity]
        n = len(dets)
        # unpadded rows (max_people == n); n=0 keeps a single masked row so
        # array shapes stay valid, and the empty result is sliced back out
        batch = prepare_crop_batch(pl.cfg, image, dets, max(n, 1),
                                   raw_uint8=True)
        batch = {k: v for k, v in batch.items() if k != "valid"}
        render_rotmat = None
        if pl.use_camcalib:
            if n:
                cam, render_rotmat = self._camcalib_for(image)
            else:
                # zero detections: every row is masked padding, so don't
                # pay the per-frame hash + device call — identity rotation
                # like the worker's padding rows keeps Gram-Schmidt finite
                cam = np.eye(3, dtype=np.float32)
            batch["cam_rotmat"] = np.tile(
                cam[None].astype(np.float32), (max(n, 1), 1, 1)
            )
        req = _Request(batch, n, dets, render_rotmat=render_rotmat)
        req.enqueued_ns = time.perf_counter_ns()
        self.q.put(req)
        if not req.event.wait(timeout):
            # best-effort: if the worker has not yet grouped it, the orphan
            # won't burn device-batch capacity on a result nobody reads
            req.cancelled = True
            raise TimeoutError("inference timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def shutdown(self):
        self._stop.set()

    def report(self) -> dict:
        """`GET /stats`: the statistics and, while the tracer is on, the
        median and 95th percentile of `serve.queue_wait` in ms."""
        out = self.stats
        if profiling.enabled():
            waits = [r["host_ms"] for r in profiling.records("serve.queue_wait")]
            out["queue_wait_p50_ms"] = profiling.quantile(waits, 0.5)
            out["queue_wait_p95_ms"] = profiling.quantile(waits, 0.95)
        return out

    # -- worker side -----------------------------------------------------
    def _collect_group(self, group):
        """Append to `group` (seeded with the first request) whatever else
        fits within capacity/max_wait. Appends IN PLACE so that if this
        raises mid-collection, the caller still sees every request it has
        dequeued and can fail them — a request dropped here would leave
        its client hanging for the full submit timeout."""
        import time

        total = max(group[0].n, 1)
        deadline = time.monotonic() + self.max_wait
        while total < self.capacity:
            wait = deadline - time.monotonic()
            try:
                item = self.q.get(timeout=wait) if wait > 0 else self.q.get_nowait()
            except queue.Empty:
                break
            item.dequeued_ns = time.perf_counter_ns()
            if item.cancelled:  # timed-out orphan: drop, don't compute
                item.event.set()
                continue
            if total + max(item.n, 1) > self.capacity:
                self._carry = item  # starts the next batch
                break
            group.append(item)
            total += max(item.n, 1)

    def _run_group(self, group):
        import numpy as np

        from whmr_tpu_torch.inference.export import fetch
        from whmr_tpu_torch.inference.pipeline import detections_array

        pl = self.pipeline
        # Chunk size comes from the SNAPSHOT pipeline, not self.capacity: a
        # concurrent /reload may swap pipeline+capacity between these two
        # reads, and the chunk size must match the graph we actually call.
        cap = int(pl.max_people)
        parts = {k: [r.batch[k] for r in group] for k in group[0].batch}
        rows = sum(v.shape[0] for v in parts["x"])
        combined = {k: np.concatenate(v) for k, v in parts.items()}
        # Normally one chunk (collection clamps the group against capacity),
        # but a /reload that SHRINKS capacity can leave already-queued groups
        # larger than the new device batch — slice them instead of crashing
        # every request in the group with a negative pad.
        out_parts = []
        before = profiling.last_root()
        for lo in range(0, rows, cap):
            chunk = {k: v[lo:lo + cap] for k, v in combined.items()}
            m = chunk["x"].shape[0]
            pad = cap - m
            if pad:
                # same padding convention as prepare_crop_batch's masked
                # rows: finite, row-independent, never read back
                last_shape = chunk["orig_shape"][-1:]
                chunk = {
                    k: np.concatenate([v, np.zeros((pad, *v.shape[1:]), v.dtype)])
                    for k, v in chunk.items()
                }
                chunk["scale"][m:] = 1.0
                chunk["bbox_height"][m:] = 1.0
                chunk["orig_shape"][m:] = last_shape
                if "cam_rotmat" in chunk:
                    # identity, not zeros: a zero rotmat feeds Gram-Schmidt
                    # a zero vector (NaN row) in the global-orient head
                    chunk["cam_rotmat"][m:] = np.eye(3, dtype=np.float32)
            out = pl._fwd(chunk, None)
            out_parts.append({k: v[:m] for k, v in fetch(out).items()})
        root = profiling.last_root()
        for r in group:
            if r.enqueued_ns is not None and r.dequeued_ns is not None:
                profiling.add("serve.queue_wait", r.enqueued_ns, r.dequeued_ns,
                              parent=root if root is not before else None)
        out_host = (
            out_parts[0] if len(out_parts) == 1
            else {k: np.concatenate([p[k] for p in out_parts])
                  for k in out_parts[0]}
        )
        start = 0
        for r in group:
            span = max(r.n, 1)
            result = {k: v[start:start + r.n] for k, v in out_host.items()}
            if r.render_rotmat is not None and r.n:
                # the batched forward echoes cam_rotmat as render_rotmat
                # (models/whmr.py explicit-rotation branch); substitute the
                # per-frame pitch-flipped overlay rotation CamCalib computed
                result["render_rotmat"] = np.tile(
                    r.render_rotmat[None], (r.n, 1, 1)
                )
            result["n_people"] = r.n
            result["detections"] = detections_array(r.dets)
            r.result = result
            start += span
        self._count("requests", len(group))
        self._count("device_batches")
        self._count("coalesced_requests", len(group) - 1)
        self._count("crops", rows)

    def _loop(self):
        while not self._stop.is_set():
            group = None
            try:
                if self._carry is not None:
                    first, self._carry = self._carry, None
                else:
                    try:
                        first = self.q.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    first.dequeued_ns = time.perf_counter_ns()
                if first.cancelled:
                    first.event.set()
                    continue
                group = [first]
                self._collect_group(group)
                self._run_group(group)
            except Exception as e:
                # Fail the affected requests but NEVER let the worker die:
                # a dead worker silently turns every future request into a
                # timeout (clients see 500s, /healthz executor_alive flips)
                for r in group or []:
                    r.error = e
            finally:
                for r in group or []:
                    r.event.set()


class WHMRServer:
    """The pipeline + an http.server around it. `serve_forever()` blocks;
    tests drive `httpd.serve_forever` in a thread and call `shutdown()`."""

    def __init__(self, pipeline, meta: dict, executor: "BatchingExecutor" = None,
                 reload_fn=None):
        """reload_fn(checkpoint=..., bundle=...) -> new DemoPipeline:
        enables POST /reload (warm weight swap without downtime) for both
        live-checkpoint and frozen-bundle daemons; None disables the
        endpoint."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.pipeline = pipeline
        self.meta = meta
        self.executor = executor
        self.reload_fn = reload_fn
        self.reloads = 0
        self._device_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            # quiet default request logging; errors still surface
            def log_message(self, fmt, *args):  # noqa: N802
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj) -> None:
                self._reply(code, json.dumps(obj).encode(), "application/json")

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    ex = server.executor
                    self._json(200, {
                        "status": "ok",
                        "max_people": server.pipeline.max_people,
                        "camcalib": server.pipeline.use_camcalib,
                        "frozen": server.pipeline.model is None,
                        "coalescing": ex is not None,
                        "executor_alive": (ex._thread.is_alive()
                                           if ex is not None else None),
                        "reloads": server.reloads,
                    })
                elif self.path == "/meta":
                    self._json(200, server.meta)
                elif self.path == "/stats":
                    self._json(200, server.executor.report()
                               if server.executor else
                               {"coalescing": False})
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):  # noqa: N802
                if self.path == "/reload":
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    try:
                        parsed = json.loads(body) if body else {}
                        if not isinstance(parsed, dict):
                            raise ValueError(
                                f"expected a json object, got "
                                f"{type(parsed).__name__}"
                            )
                        ckpt = parsed.get("checkpoint")
                        bundle = parsed.get("bundle")
                        if ckpt and bundle:
                            raise ValueError(
                                "pass 'checkpoint' OR 'bundle', not both"
                            )
                    except (json.JSONDecodeError, ValueError) as e:
                        self._json(400, {"error": f"bad /reload body: {e}"})
                        return
                    try:
                        info = server.reload(ckpt, bundle=bundle)
                    except _ReloadUnsupported as e:
                        self._json(409, {"error": str(e)})
                        return
                    except ValueError as e:  # incompatible source: client error
                        self._json(400, {"error": str(e)})
                        return
                    except Exception as e:
                        self._json(500, {"error": f"{type(e).__name__}: {e}"})
                        return
                    self._json(200, info)
                    return
                if not self.path.startswith("/infer"):
                    self._json(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    img, dets = _parse_infer_body(self.rfile.read(length))
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                try:
                    if server.executor is not None:
                        result = server.executor.submit(img, dets=dets)
                    else:
                        with server._device_lock:
                            result = server.pipeline.run_image(img, dets=dets)
                except Exception as e:  # surface as 500, keep serving
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                query = (self.path.split("?", 1) + [""])[1]
                # ?fields=a,b,c — project the response to chosen output
                # keys (scalars n_people/detections always ride along):
                # the full payload is verts-dominated (~160 KB/person),
                # and many clients only want the parametric outputs
                from urllib.parse import parse_qs

                q = parse_qs(query)
                want = q.get("fields", [""])[0]
                if want:
                    keep = {f.strip() for f in want.split(",") if f.strip()}
                    keep |= {"n_people", "detections"}
                    unknown = keep - set(result)
                    if unknown:
                        self._json(400, {
                            "error": f"unknown fields {sorted(unknown)}",
                            "available": sorted(result),
                        })
                        return
                    result = {k: v for k, v in result.items() if k in keep}
                if "json" in q.get("format", []):
                    self._reply(200, _result_to_json_bytes(result),
                                "application/json")
                else:
                    self._reply(200, _result_to_npz_bytes(result),
                                "application/octet-stream")

        self.handler_cls = Handler
        self.httpd = None
        class DrainingHTTPServer(ThreadingHTTPServer):
            # non-daemon handler threads + block_on_close: server_close()
            # then WAITS for in-flight requests — the graceful-drain
            # contract of main()'s SIGTERM handler
            daemon_threads = False
            block_on_close = True

        self._server_cls = DrainingHTTPServer

    def bind(self, host: str, port: int):
        self.httpd = self._server_cls((host, port), self.handler_cls)
        return self.httpd

    def drain(self) -> None:
        """After `httpd.shutdown()` (no new requests): wait for the handler
        threads of the requests in flight, each answered, then stop the
        batching worker."""
        self.httpd.server_close()
        if self.executor is not None:
            self.executor.shutdown()

    def reload(self, checkpoint: str = None, bundle: str = None) -> dict:
        """Warm weight swap: rebuild the pipeline from `checkpoint` or
        `bundle` (both None = re-read the configured source: a checkpoint
        dir picks up its latest save, a bundle dir is re-loaded), run it
        once on a dummy request on the card while the old one serves, then
        atomically point the server and the coalescing executor at it.
        In-flight requests finish on the old weights; subsequent batches
        use the new ones. After the swap the old pipeline's last
        references are the groups in flight on it (the worker's snapshot
        in `_run_group`, an uncoalesced `run_image`): its weights are freed
        as soon as those end, so the card holds two models only for the
        swap."""
        if self.reload_fn is None:
            raise _ReloadUnsupported("reload unavailable on this daemon")
        with self._reload_lock:  # serialize concurrent reloads
            new_pipe = self.reload_fn(checkpoint=checkpoint, bundle=bundle)
            # Re-check the coalescing precondition BEFORE warmup/swap: a
            # batch-mode camcalib bundle (no per-frame CamCalib entry) can
            # pass build_pipeline but would break every subsequent
            # coalesced request (submit -> _camcalib_for -> None call).
            if (
                self.executor is not None
                and new_pipe.use_camcalib
                and getattr(new_pipe, "_cam_fwd", None) is None
            ):
                raise ValueError(
                    "reload rejected: this daemon coalesces camcalib "
                    "requests per frame, but the new bundle traces CamCalib "
                    "inside the whole-batch graph — re-export it with "
                    "`whmr-export --camcalib split`, or restart the daemon "
                    "with --no_coalesce"
                )
            _warmup_pipeline(new_pipe, coalesced=self.executor is not None)
            served = getattr(new_pipe, "_served", None)
            if served is not None and getattr(served, "meta", None):
                self.meta = dict(served.meta)
            else:
                # live-checkpoint pipelines carry no meta.json: rebuild the
                # same default main() constructs, else a bundle→checkpoint
                # reload keeps serving the RETIRED bundle's meta (dtypes,
                # batch capacity, platforms) from /meta
                self.meta = live_meta(new_pipe)
            old, self.pipeline = self.pipeline, new_pipe
            if self.executor is not None:
                # a re-exported bundle may carry a different batch capacity
                self.executor.pipeline = new_pipe
                self.executor.capacity = int(new_pipe.max_people)
                # Drop per-frame CamCalib rotations computed by the OLD
                # weights: content-hash keys would otherwise keep serving
                # stale calibrations for previously-seen frames forever.
                with self.executor._cam_lock:
                    self.executor._cam_cache.clear()
            # the old pipeline: its in-flight groups hold their own references
            del old
            self.reloads += 1
            return {
                "status": "reloaded",
                "source": checkpoint or bundle or "(configured source)",
                "reloads": self.reloads,
            }


class _ReloadUnsupported(RuntimeError):
    pass


def live_meta(pipeline) -> dict:
    """`/meta` of a live-checkpoint pipeline (it carries no meta.json): its
    crop size and, across cards, its grid's shape."""
    meta = {"source": "live checkpoint", "crop_hw": list(pipeline.cfg.crop_hw)}
    if pipeline.mesh is not None:
        meta["mesh"] = pipeline.mesh.shape
    return meta


def _warmup_pipeline(pipeline, coalesced: bool = False) -> None:
    """Run a pipeline's serving path once on a dummy single-detection image
    (used by --warmup at startup and by /reload before the swap): the
    kernels are built and the libraries set up before live traffic.

    coalesced=True warms the path the coalescing worker calls — the forward
    on a chunk with per-crop cam_rotmat and no frame, plus the per-frame
    _cam_fwd — through a throwaway BatchingExecutor on `pipeline` (same
    padded capacity, same cam_rotmat row layout as the live worker)."""
    import numpy as np

    from whmr_tpu_torch.inference.pipeline import Detection

    dummy = np.zeros((64, 64, 3), np.uint8)
    dets = [Detection(32.0, 32.0, 48.0)]
    if coalesced:
        tmp = BatchingExecutor(pipeline, max_wait_ms=0.0)
        try:
            tmp.submit(dummy, dets=dets)
        finally:
            tmp.shutdown()
    else:
        pipeline.run_image(dummy, dets=dets)


def build_server(argv=None) -> WHMRServer:
    """`whmr-serve`'s set-up without its loop: the pipeline, the executor
    and the server, bound to --host/--port (port 0 picks a free one).
    `main` runs it; a caller in-process runs `server.httpd.serve_forever()`
    on a thread and ends with `server.httpd.shutdown()` and `server.drain()`."""
    args = build_parser().parse_args(argv)
    if not args.bundle and not args.checkpoint:
        # the demo CLI's "random init if omitted" is a visual-debugging
        # affordance; a network daemon silently serving garbage is not
        raise SystemExit(
            "whmr-serve needs weights: pass --bundle (whmr-export output) "
            "or --checkpoint (a checkpoint dir of the port)"
        )

    from whmr_tpu_torch.inference.demo_cli import build_pipeline, detector_kind
    from whmr_tpu_torch.inference.detector import build_detector

    kind = detector_kind(args)

    def make_pipeline(checkpoint=None, bundle=None):
        import copy

        a = copy.copy(args)
        if checkpoint is not None:
            a.checkpoint, a.bundle = checkpoint, None
        elif bundle is not None:
            a.bundle, a.checkpoint = bundle, None
        p = build_pipeline(a)
        if kind == "iuv" and p.model is None:
            # detector_kind() rejects --bundle + --detector iuv at startup,
            # but a checkpoint-started daemon (kind defaults to 'iuv') can
            # /reload to a bundle: the frozen pipeline has no live model
            # for the dense-IUV pass, and without this check the reload
            # would succeed and every detector-path request 500 forever
            raise ValueError(
                "reload rejected: this daemon's detector is 'iuv' (the "
                "default for --checkpoint daemons), which needs the live "
                "model — reload from a checkpoint, or restart with "
                "--detector contour/full to serve bundles"
            )
        p.detector = build_detector(kind, None, pipeline=p)
        return p

    pipeline = make_pipeline()

    meta = dict(getattr(getattr(pipeline, "_served", None), "meta", None)
                or live_meta(pipeline))
    executor = None
    can_coalesce = (not pipeline.use_camcalib
                    or getattr(pipeline, "_cam_fwd", None) is not None)
    if can_coalesce and not args.no_coalesce:
        executor = BatchingExecutor(pipeline,
                                    max_wait_ms=args.coalesce_wait_ms)
    if args.warmup:
        _warmup_pipeline(pipeline, coalesced=executor is not None)
        print("[serve] warmup done", flush=True)
    server = WHMRServer(pipeline, meta, executor=executor,
                        reload_fn=make_pipeline)
    httpd = server.bind(args.host, args.port)
    print(f"[serve] WHMR listening on http://{args.host}:{httpd.server_address[1]} "
          f"(detector={kind}, max_people={args.max_people}, "
          f"frozen={pipeline.model is None}, "
          f"coalescing={executor is not None}, device={args.device}, "
          f"mesh={pipeline.mesh and pipeline.mesh.shape})", flush=True)
    return server


def main(argv=None):
    server = build_server(argv)
    httpd = server.httpd
    # SIGTERM (orchestrator shutdown) -> graceful drain: stop accepting,
    # finish in-flight requests (DrainingHTTPServer joins handler threads
    # in server_close), exit 0 — no client sees a dropped connection.
    import signal as _signal

    def _term(*_):
        print("[serve] SIGTERM: draining in-flight requests", flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    _signal.signal(_signal.SIGTERM, _term)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.drain()
        print("[serve] drained, exiting", flush=True)


if __name__ == "__main__":
    main()
