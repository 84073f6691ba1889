"""The demo slice of whmr_tpu_torch against whmr_tpu's, at `tiny_config` on
the CPU: the crop batch, `DemoPipeline.run_image` (with and without
CamCalib), the native overlay renderer, the detectors, `whmr-demo`, the
video path (`whmr-video`, the tracker, the OpenPose glue), the detector
harness and the vis helpers.

Weights come from whmr_tpu's `model.init`, carried into the port by
`state_dict_from_flax`. Tolerances: the forward's outputs within atol 1e-4
(rtol 1e-6 for the O(1e3) focal length and translation), as the forward's
own parity test; the host stages (crops, renderer, detectors, tracking)
bit for bit, since they run the same numpy, OpenCV and C++ code.
"""

import json
import os
import pickle

import cv2
import jax
import numpy as np
import pytest
import torch

from whmr_tpu.inference import detector as jdet
from whmr_tpu.inference import detector_eval as jdeval
from whmr_tpu.inference import pipeline as jpipe
from whmr_tpu.inference import renderer as jrend
from whmr_tpu.inference.video_cli import TrackingDetector as JTrackingDetector
from whmr_tpu.utils import pose_tracker as jpose
from whmr_tpu.utils import tracking as jtrack
from whmr_tpu.utils import vis as jvis
from whmr_tpu.utils.testing import tiny_config as jtiny
from whmr_tpu_torch.data.assets import synthetic_smpl_assets
from whmr_tpu_torch.inference import demo_cli, video_cli
from whmr_tpu_torch.inference import detector as tdet
from whmr_tpu_torch.inference import detector_eval as tdeval
from whmr_tpu_torch.inference import pipeline as tpipe
from whmr_tpu_torch.inference import renderer as trend
from whmr_tpu_torch.inference.export import OUTPUT_KEYS
from whmr_tpu_torch.inference.video_cli import TrackingDetector
from whmr_tpu_torch.parallel import make_serving_grid
from whmr_tpu_torch.utils import pose_tracker as tpose
from whmr_tpu_torch.utils import tracking as ttrack
from whmr_tpu_torch.utils import vis as tvis
from whmr_tpu_torch.utils.testing import tiny_config

from torch_port_util import carried_whmr, release_memory  # noqa: F401 (autouse fixture)

# A small CamCalib frame keeps the CPU ResNet-50 quick; both packages get it.
CAM = {"cam_img_size": (128, 128)}
MAX_PEOPLE = 2
# The TINY list of test_torch_cli.py, for the CLIs' --misc.
TINY = ["pymaf.mlp_dim", "32,16,8,4", "deconv.num_filters", "32,32,32", "vit.embed_dim", "64",
        "vit.depth", "2", "vit.num_heads", "2", "vit.drop_path_rate", "0.0"]


@pytest.fixture(scope="module")
def pipelines():
    """{use_camcalib: (whmr_tpu's DemoPipeline, the port's)} on one set of weights."""
    jcfg, tcfg = jtiny().with_overrides(**CAM), tiny_config().with_overrides(**CAM)
    variables, sd = carried_whmr(jcfg)
    from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets

    out = {}
    for cam in (False, True):
        out[cam] = (
            jpipe.DemoPipeline(jcfg, variables, j_assets(), max_people=MAX_PEOPLE, use_camcalib=cam),
            tpipe.DemoPipeline(tcfg, sd, synthetic_smpl_assets(), max_people=MAX_PEOPLE, use_camcalib=cam,
                               device="cpu"),
        )
    return out


def _image(seed=0, hw=(200, 240)):
    return np.random.RandomState(seed).randint(0, 255, (*hw, 3), np.uint8)


DETS = [tpipe.Detection(90.0, 100.0, 110.0, 0.9), tpipe.Detection(170.0, 90.0, 80.0)]


def _jdets(dets):
    return [jpipe.Detection(d.cx, d.cy, d.size, d.score, d.track_id) for d in dets]


@pytest.mark.parametrize("raw_uint8", [False, True])
def test_prepare_crop_batch_and_detections_bit_for_bit(raw_uint8):
    img = _image(1, (300, 400))
    cfg = tiny_config().with_overrides(**CAM)
    got = tpipe.prepare_crop_batch(cfg, img, DETS, 3, raw_uint8=raw_uint8)
    want = jpipe.prepare_crop_batch(jtiny().with_overrides(**CAM), img, _jdets(DETS), 3, raw_uint8=raw_uint8)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(tpipe.prepare_full_image(cfg, img, raw_uint8=raw_uint8),
                                  jpipe.prepare_full_image(jtiny().with_overrides(**CAM), img,
                                                           raw_uint8=raw_uint8))
    tracked = DETS + [tpipe.Detection(1.0, 2.0, 3.0, 0.5, 7)]
    np.testing.assert_array_equal(tpipe.detections_array(tracked), jpipe.detections_array(_jdets(tracked)))


@pytest.mark.parametrize("camcalib", [False, True])
def test_run_image_matches_whmr_tpu(pipelines, camcalib):
    jp, tp = pipelines[camcalib]
    img = _image(2)
    want = jp.run_image(img, dets=_jdets(DETS))
    got = tp.run_image(img, dets=list(DETS))
    assert got["n_people"] == want["n_people"] == 2
    np.testing.assert_array_equal(got["detections"], want["detections"])
    for k in OUTPUT_KEYS:
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-4, rtol=1e-6, err_msg=k)
    if camcalib:  # the pitch-flipped overlay rotation differs from the camera's
        assert not np.allclose(got["render_rotmat"], got["cam_rotmat"])


def test_dispatch_ahead_and_run_folder(pipelines, tmp_path):
    """run_folder enqueues the next image before fetching the last one and
    writes a pkl and an overlay panel for each image with people."""
    _, tp = pipelines[True]
    folder = tmp_path / "imgs"
    folder.mkdir()
    frames, _ = tdeval.composite_frames(3, people_per_frame=2, width=160, height=120, seed=3)
    for i, f in enumerate(frames):
        cv2.imwrite(str(folder / f"im{i}.png"), f[:, :, ::-1])
    tp.detector = tdet.ContourPersonDetector()
    stats = tp.run_folder(str(folder), str(tmp_path / "out"), render=True, pipeline_depth=2)
    assert stats["images"] == 3 and stats["people"] >= 3
    for i in range(3):
        overlay = cv2.imread(str(tmp_path / "out" / f"im{i}_overlay.png"))
        assert overlay.shape == (120, 160 + 2 * 120, 3)
        assert (overlay[:, :160] != cv2.imread(str(folder / f"im{i}.png"))).any()
    tp.detector = tpipe.FullImageDetector()


def test_pipeline_guards(pipelines):
    """mesh= serves on a grid (two replicas of the CPU device here, the
    outputs of one pipeline and of whmr_tpu's) and keeps whmr_tpu's
    refusals; a card that is absent raises."""
    jp, tp = pipelines[True]
    tcfg = tiny_config().with_overrides(**CAM)
    grid = make_serving_grid(2, device_type="cpu")
    dp = tpipe.DemoPipeline(tcfg, tp.model.state_dict(), synthetic_smpl_assets(), max_people=MAX_PEOPLE,
                            use_camcalib=True, mesh=grid, device="cpu")
    img = _image(2)
    got = dp.run_image(img, dets=list(DETS))
    want = tp.run_image(img, dets=list(DETS))
    for k in OUTPUT_KEYS:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=2e-5, err_msg=k)
    with pytest.raises(ValueError, match="divisible"):
        tpipe.DemoPipeline(tcfg, None, synthetic_smpl_assets(), max_people=3, mesh=grid)
    with pytest.raises(ValueError, match="single device"):
        tpipe.DemoPipeline(tcfg, None, synthetic_smpl_assets(), max_people=2, mesh=grid, bundle="b")
    with pytest.raises(RuntimeError, match="--device cpu"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.cuda, "is_available", lambda: False)
            tpipe.DemoPipeline(tcfg, None, synthetic_smpl_assets())


@pytest.fixture(scope="module")
def mesh():
    a = synthetic_smpl_assets()
    rng = np.random.RandomState(0)
    return (a.v_template + rng.randn(*a.v_template.shape) * 0.01).astype(np.float32), a.faces


@pytest.mark.parametrize("rot", [None, 20.0])
def test_renderer_bit_for_bit(mesh, rot):
    verts, faces = mesh
    rotmat = None
    if rot is not None:
        c, s = np.cos(np.deg2rad(rot)), np.sin(np.deg2rad(rot))
        rotmat = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    img = _image(4, (240, 320))
    args = (img, [verts, verts + 0.3], [np.array([0, 0, 5], np.float32)] * 2, faces, [500.0, 520.0])
    got = trend.render_overlay(*args, cam_rotmat=rotmat)
    np.testing.assert_array_equal(got, jrend.render_overlay(*args, cam_rotmat=rotmat))
    assert (got != img).sum() > 1000
    side = ([verts], [np.array([0, 0, 5], np.float32)], faces, 1000.0, (200, 200))
    for ground in (False, True):
        np.testing.assert_array_equal(trend.render_side_view(*side, rotmat=rotmat, ground=ground),
                                      jrend.render_side_view(*side, rotmat=rotmat, ground=ground))
    boxes = np.array([[160, 120, 100, 80], [30, 40, 50, 50]], np.float32)
    np.testing.assert_array_equal(trend.native_crop_resize(img, boxes, (64, 48)),
                                  jrend.native_crop_resize(img, boxes, (64, 48)))


def test_renderer_builds_from_the_port_source():
    """The library is built from csrc/native_rasterizer.cpp into build/,
    named by the hash of the source and flags; a failed build raises."""
    trend._load_native()
    path = trend.library_path()
    assert path.is_file() and path.parent == trend.BUILD_DIR
    assert trend.SOURCE.name == "native_rasterizer.cpp"


def _three_person_image():
    img = np.full((480, 640, 3), 30, np.uint8)
    for cx, h in ((120, 260), (320, 300), (520, 220)):
        w = int(h * 0.35)
        y0 = 240 - h // 2
        cv2.rectangle(img, (cx - w // 2, y0), (cx + w // 2, y0 + h), (200, 180, 160), -1)
        cv2.circle(img, (cx, y0 - 5), w // 3, (210, 190, 170), -1)
    return img


def _boxes(dets):
    return [(d.cx, d.cy, d.size, d.score) for d in dets]


@pytest.mark.parametrize("invert", [False, True])
def test_contour_detector_same_boxes(invert):
    img = _three_person_image()
    img = 255 - img if invert else img
    got = tdet.ContourPersonDetector()(img)
    assert len(got) == 3
    assert _boxes(got) == _boxes(jdet.ContourPersonDetector()(img))


def test_iuv_detector_same_boxes(pipelines):
    jp, tp = pipelines[False]
    jd = jdet.build_detector("iuv", pipeline=jp)
    td = tdet.build_detector("iuv", pipeline=tp)
    assert isinstance(td, tdet.IUVProposalDetector)
    for seed in (5, 6):
        img = _image(seed, (180, 240))
        got, want = td(img), jd(img)
        assert _boxes(got) == pytest.approx(_boxes(want), rel=1e-6)


def test_detector_factory_and_kind():
    assert isinstance(tdet.build_detector("full"), tpipe.FullImageDetector)
    assert isinstance(tdet.build_detector("contour"), tdet.ContourPersonDetector)
    with pytest.raises(ValueError, match="bbox_file"):
        tdet.build_detector("file")
    with pytest.raises(ValueError, match="unknown detector"):
        tdet.build_detector("yolo")
    parse = demo_cli.build_parser().parse_args
    assert demo_cli.detector_kind(parse(["--image_folder", "x"])) == "full"
    assert demo_cli.detector_kind(parse(["--image_folder", "x", "--checkpoint", "c"])) == "iuv"
    with pytest.raises(SystemExit):
        demo_cli.detector_kind(parse(["--image_folder", "x", "--bundle", "b", "--detector", "iuv"]))


def test_demo_cli_on_cpu(tmp_path):
    folder = tmp_path / "imgs"
    folder.mkdir()
    cv2.imwrite(str(folder / "a.png"), _three_person_image()[::2, ::2, ::-1])
    boxes = {"a.png": [[30, 40, 90, 200], [130, 30, 190, 210]]}
    (tmp_path / "boxes.json").write_text(json.dumps(boxes))
    stats = demo_cli.main(["--image_folder", str(folder), "--output_folder", str(tmp_path / "out"),
                           "--detector", "file", "--bbox_file", str(tmp_path / "boxes.json"),
                           "--max_people", "2", "--no_camcalib", "--device", "cpu", "--save_obj",
                           "--misc", *TINY])
    assert stats["images"] == 1 and stats["people"] == 2
    assert (tmp_path / "out" / "a_overlay.png").is_file() and (tmp_path / "out" / "a.obj").is_file()
    # --data_parallel 2 on the CPU: two replicas, each on one of the 2 crop
    # rows, give the single pipeline's results
    with open(tmp_path / "out" / "a.pkl", "rb") as f:
        single = pickle.load(f)
    stats = demo_cli.main(["--image_folder", str(folder), "--output_folder", str(tmp_path / "out_dp"),
                           "--detector", "file", "--bbox_file", str(tmp_path / "boxes.json"),
                           "--max_people", "2", "--no_camcalib", "--no_render", "--data_parallel", "2",
                           "--device", "cpu", "--misc", *TINY])
    assert stats["images"] == 1 and stats["people"] == 2
    with open(tmp_path / "out_dp" / "a.pkl", "rb") as f:
        parallel = pickle.load(f)
    for k in OUTPUT_KEYS:
        np.testing.assert_allclose(parallel[k], single[k], atol=2e-5, rtol=2e-5, err_msg=k)
    # on cards, a grid larger than the cards present is refused
    with pytest.MonkeyPatch.context() as mp, pytest.raises(SystemExit, match="needs 2 devices, but only 1"):
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        demo_cli.main(["--image_folder", str(folder), "--data_parallel", "2", "--misc", *TINY])


def _write_clip(path, n_frames=6, size=(64, 96)):
    h, w = size
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (w, h))
    rng = np.random.RandomState(0)
    for i in range(n_frames):
        frame = np.full((h, w, 3), 40, np.uint8)
        cv2.circle(frame, (20 + 6 * i, h // 2), 12, (220, 210, 200), -1)
        frame += rng.randint(0, 8, frame.shape, dtype=np.uint8)
        writer.write(frame)
    writer.release()
    return path


def test_video_cli_on_cpu(tmp_path):
    clip = _write_clip(str(tmp_path / "clip.mp4"))
    out = tmp_path / "out"
    stats = video_cli.main(["--video", clip, "--output_folder", str(out), "--detector", "contour",
                            "--max_people", "2", "--no_camcalib", "--device", "cpu", "--misc", *TINY])
    assert stats["images"] == 6
    pkls = sorted(f for f in os.listdir(out / "results") if f.endswith(".pkl"))
    assert len(pkls) == 6 and (out / "result.mp4").is_file()
    import pickle

    ids = [pickle.load(open(out / "results" / p, "rb"))["detections"][:, 4].tolist() for p in pkls]
    assert all(i == [0.0] for i in ids), ids  # one blob, one stable track


class _Jittery:
    def __init__(self, cls):
        self.cls, self.rng = cls, np.random.RandomState(1)

    def __call__(self, image, name=""):
        j = self.rng.uniform(-8, 8, 2)
        n = 1 + (self.rng.rand() < 0.5)
        return [self.cls(100 + j[0] + 60 * k, 80 + j[1], 60 + self.rng.uniform(-5, 5)) for k in range(n)]


def test_tracking_matches_whmr_tpu():
    """GreedyIoUTracker, OneEuroFilter (through TrackingDetector, with
    empty frames that age the tracks) and smooth_bbox_params on a seeded
    track, against whmr_tpu's, exactly."""
    img = np.zeros((160, 260, 3), np.uint8)
    port, ref = TrackingDetector(_Jittery(tpipe.Detection)), JTrackingDetector(_Jittery(jpipe.Detection))
    for i in range(30):
        if 10 <= i < 22:  # a gap longer than max_age
            port.base = ref.base = lambda image, name="": []
        elif i == 22:
            port.base, ref.base = _Jittery(tpipe.Detection), _Jittery(jpipe.Detection)
        got, want = port(img, f"{i:06d}.png"), ref(img, f"{i:06d}.png")
        assert [(d.cx, d.cy, d.size, d.track_id) for d in got] == [(d.cx, d.cy, d.size, d.track_id) for d in want]
    assert port.tracker._next_id == ref.tracker._next_id
    params = np.random.RandomState(2).randn(40, 3).cumsum(axis=0)
    np.testing.assert_array_equal(ttrack.smooth_bbox_params(params), jtrack.smooth_bbox_params(params))
    kps = [None if i % 7 == 3 else np.random.RandomState(i).rand(24, 3) * [100, 100, 3] for i in range(20)]
    for a, b in zip(ttrack.get_smooth_bbox_params(kps), jtrack.get_smooth_bbox_params(kps)):
        np.testing.assert_array_equal(a, b)


def _write_openpose(folder, n_frames=6):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n_frames):
        people = []
        for pid, cx in ((0, 30 + 5 * i), (3, 90)):
            if pid == 3 and not 2 <= i <= 4:
                continue
            pts = rng.uniform(-20, 20, (21, 2)) + (cx, 40)
            conf = rng.uniform(0.0, 1.0, (21, 1))
            people.append({"person_id": [pid], "pose_keypoints_2d": np.concatenate([pts, conf], 1).ravel().tolist()})
        with open(os.path.join(folder, f"frame_{i:012d}_keypoints.json"), "w") as f:
            json.dump({"people": people}, f)
    return folder


def test_pose_tracker_matches_whmr_tpu(tmp_path):
    folder = _write_openpose(str(tmp_path / "json"), n_frames=8)
    got, want = tpose.read_posetrack_keypoints(folder), jpose.read_posetrack_keypoints(folder)
    assert got.keys() == want.keys()
    for pid in want:
        for k in ("joints2d", "frames"):
            np.testing.assert_array_equal(got[pid][k], want[pid][k])
    t_det, j_det = tpose.PosetrackDetector(got), jpose.PosetrackDetector(want)
    img = np.zeros((80, 120, 3), np.uint8)
    for i in range(8):
        a, b = t_det(img, f"{i:06d}.png"), j_det(img, f"{i:06d}.png")
        assert [(d.cx, d.cy, d.size, d.track_id) for d in a] == [(d.cx, d.cy, d.size, d.track_id) for d in b]
    with pytest.raises(FileNotFoundError, match="openpose binary"):
        tpose.run_openpose("v.mp4", str(tmp_path / "o"), str(tmp_path))


def test_composite_frames_match_whmr_tpu(monkeypatch):
    """The posed vertices within 1e-5 m (XLA on the CPU fuses products into
    FMAs, the port rounds each), and the frames and boxes bit for bit when
    both composite the same vertices."""
    kw = dict(n_frames=3, people_per_frame=2, width=200, height=150, seed=4)
    rng = np.random.RandomState(0)
    pose = (rng.randn(4, 72) * 0.25).astype(np.float32)
    betas = (rng.randn(4, 10) * 0.5).astype(np.float32)
    import jax.numpy as jnp

    from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
    from whmr_tpu.models.smpl import smpl_forward, smpl_params_from_assets
    from whmr_tpu.ops.rotation import batch_rodrigues

    @jax.jit
    def fwd(c, pose, betas):  # whmr_tpu's composite_frames posing, as it jits it
        rm = batch_rodrigues(pose.reshape(-1, 3)).reshape(-1, 24, 3, 3)
        return smpl_forward(c, betas, rm).vertices

    def j_verts(pose, betas):
        return np.asarray(fwd(smpl_params_from_assets(j_assets()), jnp.asarray(pose), jnp.asarray(betas)))

    np.testing.assert_allclose(tdeval.posed_vertices(synthetic_smpl_assets(), pose, betas), j_verts(pose, betas),
                               atol=1e-5)
    want_frames, want_gt = jdeval.composite_frames(**kw)
    monkeypatch.setattr(tdeval, "posed_vertices", lambda assets, pose, betas: j_verts(pose, betas))
    frames, gt = tdeval.composite_frames(**kw)
    for f, w in zip(frames, want_frames):
        np.testing.assert_array_equal(f, w)
    assert [_boxes(g) for g in gt] == [_boxes(g) for g in want_gt]
    assert tdeval.score_detector(tdet.ContourPersonDetector(), frames, gt) == \
        jdeval.score_detector(jdet.ContourPersonDetector(), frames, _jgt(gt))


def _jgt(gt):
    return [_jdets(g) for g in gt]


def test_vis_helpers_bit_for_bit():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (64, 80, 3), np.uint8)
    kp = np.concatenate([rng.uniform(0, 64, (24, 2)), rng.uniform(0, 1, (24, 1))], 1).astype(np.float32)
    np.testing.assert_array_equal(tvis.draw_skeleton(img.copy(), kp), jvis.draw_skeleton(img.copy(), kp))
    np.testing.assert_array_equal(tvis.draw_horizon_line(img.copy(), 0.1, 0.05, 80.0),
                                  jvis.draw_horizon_line(img.copy(), 0.1, 0.05, 80.0))
    depth = rng.rand(32, 40).astype(np.float32)
    np.testing.assert_array_equal(tvis.colormap_depth(depth), jvis.colormap_depth(depth))
    grid = np.stack([img, img[::-1]])
    np.testing.assert_array_equal(tvis.make_image_grid(grid), jvis.make_image_grid(grid))
