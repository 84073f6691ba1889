"""`whmr-serve` of whmr_tpu_torch at `tiny_config` on the CPU: the
BatchingExecutor (coalescing, the per-frame CamCalib cache, the carry,
cancelled orphans, empty requests, a worker that survives a failure)
against per-request calls and against whmr_tpu's executor, the HTTP
protocol on a live port-0 server (/healthz, /meta, /infer npz and json,
/stats, the 400s, /reload under load, the graceful drain) and
`build_server` from the command line. A server on a "split" bundle is
tested in `test_torch_export.py`, beside the bundle it serves.

Weights come from whmr_tpu's `model.init`, carried into the port by
`state_dict_from_flax`. Tolerances: a coalesced result equals the port's
per-request one within 1e-5 (rows are independent, but the batch changes
the CPU kernels' blocking) and whmr_tpu's within atol 1e-4 (rtol 1e-6 for
the O(1e3) focal length and translation), the forward's parity tolerance.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.inference import pipeline as jpipe
from whmr_tpu.inference import serve_cli as jserve
from whmr_tpu.utils.testing import tiny_config as jtiny
from whmr_tpu_torch.data.assets import synthetic_smpl_assets
from whmr_tpu_torch.inference import serve_cli
from whmr_tpu_torch.inference.export import OUTPUT_KEYS
from whmr_tpu_torch.inference.pipeline import DemoPipeline, Detection
from whmr_tpu_torch.inference.serve_cli import BatchingExecutor, WHMRServer
from whmr_tpu_torch.utils.testing import tiny_config

from torch_port_util import carried_whmr, release_memory, save_port_checkpoint  # noqa: F401 (autouse fixture)

CAM = {"cam_img_size": (128, 128)}
CAP = 2
TINY = ["pymaf.mlp_dim", "32,16,8,4", "deconv.num_filters", "32,32,32", "vit.embed_dim", "64",
        "vit.depth", "2", "vit.num_heads", "2", "vit.drop_path_rate", "0.0", "cam_img_size", "128,128"]


@pytest.fixture(scope="module")
def weights():
    return carried_whmr(jtiny().with_overrides(**CAM))


@pytest.fixture(scope="module")
def pipe(weights):
    return DemoPipeline(tiny_config().with_overrides(**CAM), weights[1], synthetic_smpl_assets(), max_people=CAP,
                        use_camcalib=True, device="cpu")


@pytest.fixture(scope="module")
def server(weights, pipe):
    """A live server on port 0 with coalescing and CamCalib on; /reload
    swaps to weights scaled by the factor named as the checkpoint."""
    cfg = tiny_config().with_overrides(**CAM)

    def reload_fn(checkpoint=None, bundle=None):
        if bundle is not None:
            raise ValueError("this test daemon reloads weights only")
        sd = {k: v * float(checkpoint) if v.is_floating_point() and "running_var" not in k else v
              for k, v in weights[1].items()} if checkpoint else weights[1]
        return DemoPipeline(cfg, sd, synthetic_smpl_assets(), max_people=CAP, use_camcalib=True, device="cpu")

    ex = BatchingExecutor(pipe, max_wait_ms=20.0)
    srv = WHMRServer(pipe, {"source": "live checkpoint"}, executor=ex, reload_fn=reload_fn)
    httpd = srv.bind("127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield srv, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        srv.drain()


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _npz(img, boxes=None):
    buf = io.BytesIO()
    arrays = {"image": img}
    if boxes is not None:
        arrays["bboxes"] = np.asarray(boxes, np.float32)
    np.savez(buf, **arrays)
    return buf.getvalue()


def _img(seed, hw=(200, 160)):
    return np.random.RandomState(seed).randint(0, 255, (*hw, 3), np.uint8)


ONE = [Detection(80.0, 100.0, 90.0)]
TWO = [Detection(60.0, 100.0, 90.0), Detection(110.0, 90.0, 70.0)]


def _submit_in_order(ex, jobs, base=0):
    """Start one submit thread a job, each enqueued before the next starts,
    behind the `base` requests already queued; returns the results list
    (filled as they finish) and the threads."""
    results, threads = [None] * len(jobs), []
    for k, (img, dets) in enumerate(jobs):
        def run(k=k, img=img, dets=dets):
            results[k] = ex.submit(img, dets=dets, timeout=120)

        threads.append(threading.Thread(target=run))
        threads[-1].start()
        deadline = time.time() + 30
        while ex.q.qsize() < base + k + 1 and time.time() < deadline:
            time.sleep(0.005)
    assert ex.q.qsize() == base + len(jobs)
    return results, threads


def _run(ex, group):
    ex._collect_group(group)
    ex._run_group(group)
    for r in group:
        r.event.set()
    return group


def _close(got, want, atol, rtol=0.0):
    assert got["n_people"] == want["n_people"]
    for k in OUTPUT_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol, rtol=rtol, err_msg=k)


def test_coalesced_matches_per_request_and_whmr_tpu(weights, pipe):
    """Two frames' crops share one device batch with per-crop cam_rotmat
    from one CamCalib call a frame: equal to per-request run_image (the
    frame in the forward) and to whmr_tpu's coalescing executor."""
    ex = BatchingExecutor(pipe, max_wait_ms=1.0, start=False)
    jobs = [(_img(5), ONE), (_img(6), ONE)]
    results, threads = _submit_in_order(ex, jobs)
    group = _run(ex, [ex.q.get(timeout=30)])
    assert len(group) == 2
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert ex.stats == {"requests": 2, "device_batches": 1, "coalesced_requests": 1, "crops": 2,
                        "camcalib_calls": 2, "camcalib_cache_hits": 0}
    jp = jpipe.DemoPipeline(jtiny().with_overrides(**CAM), weights[0], j_assets(), max_people=CAP, use_camcalib=True)
    jex = jserve.BatchingExecutor(jp, max_wait_ms=1.0)
    try:
        for (img, dets), got in zip(jobs, results):
            _close(got, pipe.run_image(img, dets=dets), atol=1e-5)
            jdets = [jpipe.Detection(d.cx, d.cy, d.size) for d in dets]
            _close(got, jex.submit(img, dets=jdets), atol=1e-4, rtol=1e-6)
    finally:
        jex.shutdown()


def test_cache_hits_repeated_frame(pipe):
    ex = BatchingExecutor(pipe, max_wait_ms=1.0)
    try:
        img = _img(7)
        a = ex.submit(img, dets=ONE)
        b = ex.submit(img, dets=ONE)
        assert ex.stats["camcalib_calls"] == 1 and ex.stats["camcalib_cache_hits"] == 1
        _close(a, b, atol=0.0)
    finally:
        ex.shutdown()


def test_carry_when_next_request_does_not_fit(pipe):
    ex = BatchingExecutor(pipe, max_wait_ms=1.0, start=False)
    results, threads = _submit_in_order(ex, [(_img(8), ONE), (_img(8), TWO)])
    group = _run(ex, [ex.q.get(timeout=30)])
    assert len(group) == 1 and ex._carry is not None  # 1 + 2 crops > capacity 2
    carry, ex._carry = ex._carry, None
    assert len(_run(ex, [carry])) == 1 and carry.n == 2
    for t in threads:
        t.join(timeout=60)
    assert [r["n_people"] for r in results] == [1, 2]
    assert ex.stats["device_batches"] == 2 and ex.stats["crops"] == 3


def test_cancelled_orphan_is_skipped(pipe):
    ex = BatchingExecutor(pipe, max_wait_ms=1.0, start=False)
    with pytest.raises(TimeoutError):
        ex.submit(_img(9), dets=ONE, timeout=0.01)  # no worker: times out
    # the timed-out orphan is still queued ahead of the live request
    results, threads = _submit_in_order(ex, [(_img(9), ONE)], base=1)
    first = ex.q.get(timeout=30)
    assert first.cancelled
    live = ex.q.get(timeout=30)
    assert _run(ex, [live]) == [live]
    threads[0].join(timeout=60)
    assert results[0]["n_people"] == 1 and ex.stats["requests"] == 1  # the orphan never ran


def test_zero_detection_request_and_worker_survives(pipe):
    ex = BatchingExecutor(pipe, max_wait_ms=1.0)
    try:
        out = ex.submit(np.zeros((100, 100, 3), np.uint8), dets=[])
        assert out["n_people"] == 0 and out["verts"].shape == (0, 6890, 3)
        assert out["detections"].shape == (0, 5)
        real = ex._run_group
        ex._run_group = lambda group: (_ for _ in ()).throw(RuntimeError("boom"))
        with pytest.raises(RuntimeError, match="boom"):
            ex.submit(_img(10), dets=ONE)
        ex._run_group = real
        assert ex._thread.is_alive()
        assert ex.submit(_img(10), dets=ONE)["n_people"] == 1
    finally:
        ex.shutdown()


def test_executor_rejects_batch_camcalib_bundle():
    class FrozenLike:
        use_camcalib, _cam_fwd, max_people = True, None, 2

    with pytest.raises(ValueError, match="camcalib split"):
        BatchingExecutor(FrozenLike(), start=False)


def test_http_protocol(server, pipe):
    srv, url = server
    h = _get(url + "/healthz")
    assert h["status"] == "ok" and h["frozen"] is False and h["coalescing"] is True
    assert h["executor_alive"] is True and h["max_people"] == CAP and h["camcalib"] is True
    assert _get(url + "/meta")["source"] == "live checkpoint"
    img = _img(11, (240, 200))
    boxes = [[100.0, 120.0, 120.0], [150.0, 100.0, 80.0, 0.7]]
    status, ctype, body = _post(url + "/infer", _npz(img, boxes[:1]))
    assert status == 200 and ctype == "application/octet-stream"
    out = dict(np.load(io.BytesIO(body)))
    _close({**out, "n_people": int(out["n_people"])},
           pipe.run_image(img, dets=[Detection(100.0, 120.0, 120.0)]), atol=1e-5)
    # image bytes: the server's detector (full image) finds one person
    ok, png = cv2.imencode(".png", img)
    out = np.load(io.BytesIO(_post(url + "/infer", png.tobytes())[2]))
    assert int(out["n_people"]) == 1 and out["detections"][0, 2] == 240
    # json, projected to chosen fields; a 4-column bbox carries a score
    status, ctype, body = _post(url + "/infer?format=json&fields=pred_cam_t", _npz(img, [boxes[1]]))
    js = json.loads(body)
    assert ctype == "application/json" and sorted(js) == ["detections", "n_people", "pred_cam_t"]
    assert js["n_people"] == 1 and js["detections"][0][3] == pytest.approx(0.7)
    stats = _get(url + "/stats")
    assert stats["requests"] >= 3 and stats["crops"] >= 3


@pytest.mark.parametrize("path, body, code", [
    ("/infer", b"not an image", 400),
    ("/infer", b"\x93NUMPY" + b"\x00" * 20, 400),
    ("/infer", b"PK\x03\x04broken", 400),
    ("/infer?fields=nope", None, 400),
    ("/nowhere", b"", 404),
    ("/reload", b"[1, 2]", 400),
    ("/reload", b"{bad json", 400),
    ("/reload", b'{"checkpoint": "a", "bundle": "b"}', 400),
    ("/reload", b'{"bundle": "b"}', 400),
])
def test_http_errors(server, path, body, code):
    _, url = server
    if body is None:
        body = _npz(_img(12), [[80.0, 100.0, 90.0]])
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url + path, body)
    assert e.value.code == code
    assert "error" in json.loads(e.value.read())


def test_http_rejects_bad_npz_arrays(server):
    _, url = server
    for arrays in ({"image": np.zeros((8, 8), np.uint8)}, {"image": np.zeros((8, 8, 3), np.float32)},
                   {"other": np.zeros(3)}):
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/infer", buf.getvalue())
        assert e.value.code == 400


def test_reload_under_load_swaps_weights(server):
    """/reload while clients post: no request fails, later results come
    from the new weights, the CamCalib cache is dropped."""
    srv, url = server
    img = _img(13)
    body = _npz(img, [[80.0, 100.0, 90.0]])
    before = np.load(io.BytesIO(_post(url + "/infer", body)[2]))["verts"]
    errors, done = [], []

    def client():
        for _ in range(3):
            try:
                done.append(_post(url + "/infer", body)[0])
            except Exception as e:  # noqa: BLE001 — recorded and asserted below
                errors.append(e)

    clients = [threading.Thread(target=client) for _ in range(3)]
    for c in clients:
        c.start()
    status, _, info = _post(url + "/reload", json.dumps({"checkpoint": "0.9"}).encode())
    for c in clients:
        c.join(timeout=120)
    assert status == 200 and json.loads(info)["reloads"] == 1
    assert not errors and done == [200] * 9
    after = np.load(io.BytesIO(_post(url + "/infer", body)[2]))["verts"]
    assert not np.allclose(before, after)
    assert srv.executor.pipeline is srv.pipeline and _get(url + "/healthz")["reloads"] == 1
    srv.reload("1.0")  # back to the fixture's weights for the other tests
    np.testing.assert_allclose(np.load(io.BytesIO(_post(url + "/infer", body)[2]))["verts"], before, atol=1e-6)


def test_graceful_drain_answers_inflight(pipe):
    srv = WHMRServer(pipe, {}, executor=None)
    httpd = srv.bind("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    release, orig = threading.Event(), pipe.run_image
    results = {}

    def slow(*a, **kw):
        release.wait(30)
        return orig(*a, **kw)

    pipe.run_image = slow
    try:
        client = threading.Thread(target=lambda: results.update(r=_post(url + "/infer", _npz(_img(14), [[80, 100, 90]]))))
        client.start()
        time.sleep(0.3)
        httpd.shutdown()
        release.set()
        srv.drain()  # joins the handler thread
        client.join(timeout=60)
        assert not client.is_alive() and results["r"][0] == 200
    finally:
        pipe.run_image = orig


def test_build_server_from_the_command_line(weights, tmp_path):
    save_port_checkpoint(weights[1], tmp_path / "ckpt")
    with pytest.raises(SystemExit, match="needs weights"):
        serve_cli.build_server(["--device", "cpu"])
    srv = serve_cli.build_server(["--checkpoint", str(tmp_path / "ckpt"), "--port", "0", "--device", "cpu",
                                  "--detector", "full", "--max_people", str(CAP), "--warmup", "--misc", *TINY])
    threading.Thread(target=srv.httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.httpd.server_address[1]}"
        out = np.load(io.BytesIO(_post(url + "/infer", _npz(_img(18), [[80.0, 100.0, 90.0]]))[2]))
        assert int(out["n_people"]) == 1 and np.isfinite(out["verts"]).all()
        assert _get(url + "/healthz")["coalescing"] is True
    finally:
        srv.httpd.shutdown()
        srv.drain()
    with pytest.raises(RuntimeError, match="--device cpu"), pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        serve_cli.build_server(["--checkpoint", str(tmp_path / "ckpt"), "--misc", *TINY])
