"""Serving across cards in the port (`DemoPipeline(mesh=)`,
`parallel/serving.py`, `--data_parallel` / `--tensor_parallel`) against
whmr_tpu's mesh pipeline, at `tiny_config` on the CPU. Mirrors
tests/test_serve.py's TestDataParallelServing: whmr_tpu serves on
`make_mesh(4)` and `make_mesh(4, model_parallel=2)` over the 8 XLA CPU
devices that tests/conftest.py forces; the port on grids of the CPU device
repeated, one replica a grid row and the ViT blocks split over the row.

Weights: whmr_tpu's `create_train_state`, as test_serve.py makes them,
carried into the port by `state_dict_from_flax`; one module fixture.
Tolerances, rtol and atol: data parallel 2e-5 (whmr_tpu's own test's);
tensor parallel and dp2 x tp2 5e-5, since the row-parallel sums add the
shards' partial products in another order.
"""

from argparse import Namespace

import numpy as np
import pytest
import torch

from whmr_tpu.utils.testing import make_example_inputs
from whmr_tpu.utils.testing import tiny_config as jtiny
from whmr_tpu_torch.config import ViTConfig
from whmr_tpu_torch.data.assets import synthetic_smpl_assets
from whmr_tpu_torch.inference import demo_cli, serve_cli, video_cli
from whmr_tpu_torch.inference.pipeline import DemoPipeline, Detection
from whmr_tpu_torch.inference.serve_cli import BatchingExecutor
from whmr_tpu_torch.models.vit import ViTBlock
from whmr_tpu_torch.parallel import (
    ServingGrid,
    TensorParallelBlock,
    make_serving_grid,
    split_rows,
    split_vit_blocks,
)
from whmr_tpu_torch.utils.convert import state_dict_from_flax
from whmr_tpu_torch.utils.testing import tiny_config

from torch_port_util import release_memory, save_port_checkpoint  # noqa: F401 (autouse fixture)

# A small CamCalib frame keeps the CPU ResNet-50 quick; both packages get it.
CAM = {"cam_img_size": (128, 128)}
KEYS = ("verts", "verts_world", "pred_cam_t", "focal_length")
DP_TOL, TP_TOL = 2e-5, 5e-5
DETS = [Detection(40.0, 48.0, 60.0), Detection(90.0, 50.0, 70.0), Detection(64.0, 48.0, 90.0)]
# The TINY list of test_torch_cli.py with the small frame, for the CLIs' --misc.
TINY = ["pymaf.mlp_dim", "32,16,8,4", "deconv.num_filters", "32,32,32", "vit.embed_dim", "64",
        "vit.depth", "2", "vit.num_heads", "2", "vit.drop_path_rate", "0.0", "cam_img_size", "128,128"]


def _image(seed, hw=(96, 128)):
    return np.random.RandomState(seed).randint(0, 255, (*hw, 3), np.uint8)


def _jdets(dets):
    from whmr_tpu.inference.pipeline import Detection as JDetection

    return [JDetection(d.cx, d.cy, d.size, d.score, d.track_id) for d in dets]


@pytest.fixture(scope="module")
def weights():
    """whmr_tpu's variables from create_train_state and the port's
    state_dict of the same weights."""
    import jax
    import jax.numpy as jnp

    from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
    from whmr_tpu.models.regressor import body_consts_from_assets
    from whmr_tpu.models.whmr import WHMR
    from whmr_tpu.training.train_step import create_train_state

    cfg = jtiny().with_overrides(**CAM)
    state = create_train_state(
        cfg, WHMR(cfg), body_consts_from_assets(j_assets()), jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in make_example_inputs(cfg, 2).items()},
    )
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    return variables, state_dict_from_flax(variables)


_PIPES = {}


def _port(weights, grid=None, max_people=4, camcalib=False):
    """The port's pipeline on `grid` ((data, model), or None), made once."""
    key = ("port", grid, max_people, camcalib)
    if key not in _PIPES:
        mesh = None if grid is None else make_serving_grid(*grid, device_type="cpu")
        _PIPES[key] = DemoPipeline(tiny_config().with_overrides(**CAM), weights[1], synthetic_smpl_assets(),
                                   max_people=max_people, use_camcalib=camcalib, mesh=mesh, device="cpu")
    return _PIPES[key]


def _whmr_tpu(weights, grid, max_people=4, camcalib=False):
    """whmr_tpu's pipeline on make_mesh(d * m, model_parallel=m), made once."""
    key = ("whmr_tpu", grid, max_people, camcalib)
    if key not in _PIPES:
        from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
        from whmr_tpu.inference.pipeline import DemoPipeline as JDemoPipeline
        from whmr_tpu.parallel import make_mesh

        d, m = grid
        _PIPES[key] = JDemoPipeline(jtiny().with_overrides(**CAM), weights[0], j_assets(), max_people=max_people,
                                    use_camcalib=camcalib, mesh=make_mesh(d * m, model_parallel=m))
    return _PIPES[key]


def _close(got, want, tol, keys=KEYS):
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("grid,max_people,tol", [((4, 1), 4, DP_TOL), ((1, 2), 2, TP_TOL), ((2, 2), 2, TP_TOL)],
                         ids=["dp4", "tp2", "dp2xtp2"])
def test_grid_matches_single_and_whmr_tpu(weights, grid, max_people, tol):
    """The port's grid against its single pipeline and whmr_tpu's mesh
    pipeline of the same shape, on the same crops."""
    img, dets = _image(7), DETS[:max_people]
    got = _port(weights, grid, max_people).run_image(img, dets=dets)
    single = _port(weights, None, max_people).run_image(img, dets=dets)
    want = _whmr_tpu(weights, grid, max_people).run_image(img, dets=_jdets(dets))
    assert got["n_people"] == single["n_people"] == want["n_people"] == len(dets)
    _close(got, single, tol)
    _close(got, want, tol)
    blocks = _port(weights, grid, max_people).model.feature_extractor.backbone.blocks
    assert all(isinstance(b, TensorParallelBlock if grid[1] > 1 else ViTBlock) for b in blocks)


def test_camcalib_frame_replicated(weights):
    """CamCalib under a grid: every replica calibrates its copy of the batch-1
    frame while the crops split; the rotations and meshes are the single
    pipeline's and whmr_tpu's."""
    img = _image(3)
    dets = [Detection(64.0, 48.0, 80.0), Detection(30.0, 40.0, 50.0)]
    got = _port(weights, (2, 1), camcalib=True).run_image(img, dets=dets)
    single = _port(weights, None, camcalib=True).run_image(img, dets=dets)
    want = _whmr_tpu(weights, (4, 1), camcalib=True).run_image(img, dets=_jdets(dets))
    assert got["n_people"] == 2 and np.isfinite(got["verts"]).all()
    keys = KEYS + ("cam_rotmat", "render_rotmat")
    _close(got, single, DP_TOL, keys)
    _close(got, want, DP_TOL, keys)


@pytest.mark.parametrize("grid,camcalib", [((4, 1), False), ((2, 2), True)], ids=["dp4", "dp2xtp2-camcalib"])
def test_executor_coalesces_across_grid(weights, grid, camcalib):
    """The serving BatchingExecutor splits its coalesced batch over the grid
    (with CamCalib: per-frame rotations from the lead replica)."""
    max_people = 4
    pipe = _port(weights, grid, max_people, camcalib)
    ex = BatchingExecutor(pipe, max_wait_ms=20.0)
    try:
        img = _image(11, (80, 80))
        dets = [Detection(40.0, 40.0, 60.0), Detection(20.0, 30.0, 30.0)]
        got = ex.submit(img, dets=dets, timeout=600)
    finally:
        ex.shutdown()
    want = _port(weights, None, max_people, camcalib).run_image(img, dets=dets)
    _close(got, want, TP_TOL if grid[1] > 1 else DP_TOL)
    assert ex.stats["device_batches"] == 1 and ex.stats["crops"] == 2


def test_grid_rejects_bundle_and_bad_divisor():
    cfg, assets = tiny_config(), synthetic_smpl_assets()
    mesh = make_serving_grid(4, device_type="cpu")
    with pytest.raises(ValueError, match="divisible"):
        DemoPipeline(cfg, None, assets, max_people=3, use_camcalib=False, mesh=mesh)
    with pytest.raises(ValueError, match="single device"):
        DemoPipeline(cfg, None, assets, max_people=4, use_camcalib=False, mesh=mesh, bundle="whatever")


def test_serving_mesh_resolution():
    assert demo_cli.serving_mesh(Namespace(device="cpu")) is None
    for dp, tp, want in ((2, 2, {"data": 2, "model": 2}), (0, 2, {"data": 1, "model": 2}),
                         (4, 0, {"data": 4, "model": 1})):
        m = demo_cli.serving_mesh(Namespace(data_parallel=dp, tensor_parallel=tp, device="cpu"))
        assert m.shape == want
        assert [d.type for row in m.devices for d in row] == ["cpu"] * (max(dp, 1) * max(tp, 1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "device_count", lambda: 2)
        with pytest.raises(SystemExit, match="needs 4 devices, but only 2"):
            demo_cli.serving_mesh(Namespace(data_parallel=2, tensor_parallel=2, device="cuda"))
        g = demo_cli.serving_mesh(Namespace(data_parallel=1, tensor_parallel=2, device="cuda"))
        assert [[str(d) for d in row] for row in g.devices] == [["cuda:0", "cuda:1"]]
        g = ServingGrid([["cuda:0"], ["cuda:0"]])
        assert g.shape == {"data": 2, "model": 1} and g.lead == torch.device("cuda:0")
    with pytest.raises(ValueError, match="equal, non-empty rows"):
        ServingGrid([["cpu", "cpu"], ["cpu"]])
    with pytest.raises(ValueError, match="data >= 1 and model >= 1"):
        make_serving_grid(0, 2, device_type="cpu")


def test_split_rows_blocks_in_order():
    batch = {"x": np.arange(8 * 3).reshape(8, 3), "scale": np.arange(8.0)}
    parts = split_rows(batch, 4)
    assert [p["scale"].tolist() for p in parts] == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    np.testing.assert_array_equal(np.concatenate([p["x"] for p in parts]), batch["x"])
    with pytest.raises(ValueError, match="do not split"):
        split_rows(batch, 3)


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_tensor_parallel_block_matches_block(impl):
    """One ViT block split over 2 and 4 (CPU) devices against the block: each
    shard holds whole heads (attention on H/m heads; K1's plain version with
    "pallas" on the CPU) and the row sums add the biases once."""
    cfg = ViTConfig(embed_dim=64, num_heads=4, attn_impl=impl)
    torch.manual_seed(0)
    block = ViTBlock(cfg.embed_dim, cfg.num_heads, 4.0, True, attn_impl=impl).eval()
    with torch.no_grad():
        for p in block.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    x = torch.randn(2, 12, 64)
    with torch.no_grad():
        want = block(x)
        for m in (2, 4):
            tp = TensorParallelBlock(block, ["cpu"] * m)
            assert [s.attn.qkv.weight.shape for s in tp.shards] == [(3 * 64 // m, 64)] * m
            np.testing.assert_allclose(tp(x).numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="4 heads do not split over tensor_parallel=3"):
        TensorParallelBlock(block, ["cpu"] * 3)
    holder = torch.nn.Module()
    holder.blocks = torch.nn.ModuleList([block])
    split_vit_blocks(holder, ["cpu", "cpu"])
    assert isinstance(holder.blocks[0], TensorParallelBlock)


def test_cli_paths_on_a_grid(weights, tmp_path):
    """whmr-serve (--data_parallel 2 --tensor_parallel 2; /reload rebuilds on
    the same grid), whmr-demo --data_parallel 2 and whmr-video
    --tensor_parallel 2, all with --device cpu, against the single
    pipeline's outputs."""
    import cv2

    ckpt = save_port_checkpoint(weights[1], tmp_path / "ckpt")
    img = _image(5, (120, 160))
    dets = [Detection(60.0, 60.0, 80.0), Detection(110.0, 60.0, 70.0)]
    single = _port(weights, None, 4, True).run_image(img, dets=dets)

    srv = serve_cli.build_server(["--checkpoint", ckpt, "--port", "0", "--max_people", "4", "--detector", "full",
                                  "--data_parallel", "2", "--tensor_parallel", "2", "--device", "cpu",
                                  "--misc", *TINY])
    try:
        assert srv.meta["mesh"] == {"data": 2, "model": 2} and srv.executor is not None
        _close(srv.executor.submit(img, dets=dets, timeout=600), single, TP_TOL)
        srv.reload()
        assert srv.pipeline.mesh.shape == {"data": 2, "model": 2} and srv.meta["mesh"] == srv.pipeline.mesh.shape
        _close(srv.executor.submit(img, dets=dets, timeout=600), single, TP_TOL)
    finally:
        srv.httpd.server_close()
        srv.drain()

    folder = tmp_path / "imgs"
    folder.mkdir()
    cv2.imwrite(str(folder / "a.png"), img[:, :, ::-1])
    boxes = tmp_path / "boxes.json"
    boxes.write_text('{"a.png": [[20, 20, 100, 100], [75, 25, 145, 95]]}')
    stats = demo_cli.main(["--image_folder", str(folder), "--output_folder", str(tmp_path / "out"),
                           "--checkpoint", ckpt, "--detector", "file", "--bbox_file", str(boxes),
                           "--max_people", "4", "--data_parallel", "2", "--no_render", "--device", "cpu",
                           "--misc", *TINY])
    assert stats["images"] == 1 and stats["people"] == 2

    clip = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (160, 120))
    for _ in range(3):
        writer.write(img[:, :, ::-1].copy())
    writer.release()
    stats = video_cli.main(["--video", clip, "--output_folder", str(tmp_path / "video"), "--checkpoint", ckpt,
                            "--detector", "full", "--max_people", "2", "--tensor_parallel", "2",
                            "--device", "cpu", "--misc", *TINY])
    assert stats["images"] == 3
