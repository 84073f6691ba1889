"""The port's dataset tooling against whmr_tpu's: the COCO and TCMR
converters (data/coco.py, data/tcmr.py), the fits store (data/fits_dict.py)
and `whmr-data` (data/data_cli.py). They are numpy copies: the same inputs
give equal files, reports and exit codes."""

import io
import json

import cv2
import joblib
import numpy as np
import pytest

from whmr_tpu.data import coco as jcoco
from whmr_tpu.data import data_cli as jcli
from whmr_tpu.data import fits_dict as jfits
from whmr_tpu.data import tcmr as jtcmr
from whmr_tpu_torch.data import coco as tcoco
from whmr_tpu_torch.data import data_cli as tcli
from whmr_tpu_torch.data import fits_dict as tfits
from whmr_tpu_torch.data import tcmr as ttcmr

from torch_port_util import release_memory  # noqa: F401 (autouse fixture)


def _same_npz(a, b):
    a, b = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_coco_to_npz_matches(tmp_path):
    rng = np.random.RandomState(0)
    anns = []
    for i in range(6):
        vis = (rng.rand(17) > (0.1 if i != 3 else 0.9)) * 2.0  # person 3 has too few keypoints
        kps = np.stack([rng.uniform(50, 400, 17), rng.uniform(50, 300, 17), vis], -1)
        anns.append({"id": i + 1, "image_id": i % 3, "category_id": 1 if i != 5 else 2,
                     "bbox": rng.uniform(20, 200, 4).tolist(), "keypoints": kps.reshape(-1).tolist()})
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": [{"id": i, "file_name": f"{i}.jpg"} for i in range(3)], "annotations": anns,
                               "categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "dog"}]}))
    for min_kp in (6, 17):
        got = tcoco.coco_to_npz(str(ann), str(tmp_path / f"t{min_kp}.npz"), min_keypoints=min_kp)
        want = jcoco.coco_to_npz(str(ann), str(tmp_path / f"j{min_kp}.npz"), min_keypoints=min_kp)
        assert got.keys() == want.keys()
        _same_npz(tmp_path / f"t{min_kp}.npz", tmp_path / f"j{min_kp}.npz")


def _tcmr_db(tmp_path, n=5):
    rng = np.random.RandomState(1)
    j2d = rng.uniform(0, 400, (n, 49, 2)).astype(np.float32)
    j2d[:, 3] = 0.0
    db = {
        "img_name": np.array([f"seq/image_{i:05d}.jpg" for i in range(n)]),
        "bbox": np.concatenate([rng.uniform(100, 400, (n, 2)), rng.uniform(80, 260, (n, 2))], 1).astype(np.float32),
        "pose": (rng.randn(n, 72) * 0.2).astype(np.float32), "shape": (rng.randn(n, 10) * 0.2).astype(np.float32),
        "joints2D": j2d, "joints3D": (rng.randn(n, 49, 3) * 0.3).astype(np.float32),
        "vid_name": np.array(["seq_00"] * n), "frame_id": np.arange(n), "valid": (np.arange(n) != 2).astype(np.float32),
    }
    path = tmp_path / "db.pt"
    joblib.dump(db, path)
    return str(path)


def test_tcmr_to_npz_matches(tmp_path):
    db = _tcmr_db(tmp_path)
    ttcmr.tcmr_to_npz(db, str(tmp_path / "t.npz"))
    jtcmr.tcmr_to_npz(db, str(tmp_path / "j.npz"))
    _same_npz(tmp_path / "t.npz", tmp_path / "j.npz")
    # the path-list flavor probes the image sizes on disk
    (tmp_path / "frames").mkdir()
    for i in range(2):
        cv2.imwrite(str(tmp_path / "frames" / f"f_{i}.png"), np.zeros((360, 480 + 40 * i, 3), np.uint8))
    joblib.dump([f"/abs/frames/f_{i}.png" for i in range(2)], tmp_path / "list.pt")
    for mod, name in ((ttcmr, "tl.npz"), (jtcmr, "jl.npz")):
        mod.tcmr_to_npz(str(tmp_path / "list.pt"), str(tmp_path / name), img_dir=str(tmp_path / "frames"))
    _same_npz(tmp_path / "tl.npz", tmp_path / "jl.npz")
    with pytest.raises(FileNotFoundError, match="img_dir"):
        ttcmr.tcmr_to_npz(str(tmp_path / "list.pt"), str(tmp_path / "x.npz"))


def test_fits_dict_matches(tmp_path):
    rng = np.random.RandomState(2)
    np.savez(tmp_path / "a.npz", pose=rng.randn(6, 72).astype(np.float32), betas=rng.randn(6, 10).astype(np.float32),
             valid_fit=np.array([1, 0, 1, 1, 0, 1]))
    np.save(tmp_path / "b.npy", rng.randn(4, 82).astype(np.float32))
    names, sizes = ["a", "b", "c"], {"a": 6, "b": 4, "c": 3}
    ours, theirs = tfits.FitsDict(str(tmp_path), names, sizes), jfits.FitsDict(str(tmp_path), names, sizes)
    ds, idx = ["a", "b", "a", "c"], [0, 3, 4, 2]
    rot, flip = [10.0, 0.0, -25.0, 5.0], [True, False, True, False]
    for a, b in zip(ours.get(ds, idx, rot, flip), theirs.get(ds, idx, rot, flip)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.get_valid_state(ds, idx), theirs.get_valid_state(ds, idx))
    pose, betas = rng.randn(4, 72).astype(np.float32), rng.randn(4, 10).astype(np.float32)
    for fd in (ours, theirs):
        fd.update(ds, idx, rot, flip, pose, betas, [1, 0, 1, 1])
    for name in names:
        np.testing.assert_array_equal(ours.fits[name], theirs.fits[name])
        np.testing.assert_array_equal(ours.valid[name], theirs.valid[name])
    ours.save(str(tmp_path / "out"))
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "a_fits.npy"), theirs.fits["a"])


def _labels(path, n=6, **extra):
    rng = np.random.RandomState(3)
    fields = dict(
        imgname=np.array([f"im_{i}.png" for i in range(n)]),
        center=rng.uniform(100, 300, (n, 2)).astype(np.float32), scale=rng.uniform(0.8, 1.5, n).astype(np.float32),
        pose=(rng.randn(n, 72) * 0.2).astype(np.float32), shape=(rng.randn(n, 10) * 0.3).astype(np.float32),
        has_smpl=np.ones(n, np.float32),
        part=np.concatenate([rng.uniform(0, 400, (n, 24, 2)), np.ones((n, 24, 1))], -1).astype(np.float32),
        cam_rotmat=np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
    )
    fields.update(extra)
    np.savez(path, **fields)
    return str(path)


CHECK_CASES = {
    "valid": {},
    "bad_shape": {"center": np.zeros((6, 3), np.float32)},
    "non_finite": {"pose": np.full((6, 72), np.nan, np.float32)},
    "bad_values": {"scale": -np.ones(6, np.float32), "has_smpl": np.full(6, 0.5, np.float32),
                   "cam_rotmat": np.ones((6, 3, 3), np.float32)},
    "unknown_field": {"extra": np.zeros(6)},
    "missing_images": {},
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_npz_matches(tmp_path, case):
    npz = _labels(tmp_path / "labels.npz", **CHECK_CASES[case])
    img_dir = None
    if case == "missing_images":
        img_dir = tmp_path / "imgs"
        img_dir.mkdir()
        cv2.imwrite(str(img_dir / "im_0.png"), np.zeros((8, 8, 3), np.uint8))
        (img_dir / "im_1.png").write_bytes(b"not a png")
    outs = []
    for mod in (tcli, jcli):
        buf = io.StringIO()
        report = mod.check_npz(npz, img_dir=img_dir and str(img_dir), sample=0, train=True, out=buf)
        outs.append((report, buf.getvalue()))
    assert outs[0] == outs[1]
    assert bool(outs[0][0][0]) == (case not in ("valid", "unknown_field"))


@pytest.mark.parametrize("argv", [["check", "LABELS"], ["check", "BAD"], ["coco", "ANN", "OUT"]])
def test_data_cli_exit_codes_match(tmp_path, argv):
    paths = {"LABELS": _labels(tmp_path / "ok.npz"),
             "BAD": _labels(tmp_path / "bad.npz", scale=np.zeros(6, np.float32)),
             "ANN": str(tmp_path / "ann.json"), "OUT": str(tmp_path / "out.npz")}
    (tmp_path / "ann.json").write_text(json.dumps({"images": [], "annotations": [], "categories": []}))
    codes = []
    for mod in (tcli, jcli):
        try:
            mod.main([paths.get(a, a) for a in argv])
            codes.append(0)
        except SystemExit as e:
            codes.append(e.code)
    assert codes[0] == codes[1]
