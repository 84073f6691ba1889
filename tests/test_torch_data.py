"""The port's data path against whmr_tpu's, bit for bit on this host's cv2.

- `data/kp_formats.py`: the tables and conversions equal.
- `data/augment.py`: every function on seeded inputs, output for output.
- `data/npz_dataset.py`: NpzDataset items array by array in eval mode, in
  train mode with augmentation and occluders at the same seed, epoch and
  index, with `device_norm`, from the decoded-image cache, across a missing
  image and across a crop failure; MixtureDataset's draws; and one
  BatchLoader epoch over each package's dataset.
"""

import numpy as np
import pytest

from whmr_tpu.data import augment as JA
from whmr_tpu.data import kp_formats as jkp
from whmr_tpu.data import npz_dataset as jnd
from whmr_tpu.data.loader import BatchLoader as JBatchLoader
from whmr_tpu.utils.testing import tiny_config as j_tiny_config
from whmr_tpu_torch.data import augment as TA
from whmr_tpu_torch.data import kp_formats as tkp
from whmr_tpu_torch.data import npz_dataset as tnd
from whmr_tpu_torch.data.assets import synthetic_smpl_assets
from whmr_tpu_torch.data.loader import BatchLoader
from whmr_tpu_torch.models.regressor import body_consts_from_assets
from whmr_tpu_torch.utils.testing import tiny_config, write_npz_dataset

from torch_port_util import release_memory  # noqa: F401 (autouse fixture)


def assert_same(got, want, label=""):
    """Equal values, dtypes and shapes, through dicts, tuples and dataclasses."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), label
        for k in want:
            assert_same(got[k], want[k], f"{label}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{label}[{i}]")
    elif hasattr(want, "__dataclass_fields__"):
        assert_same(vars(got), vars(want), label)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (label, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=label)


def test_kp_formats_match():
    assert tkp.FORMATS == jkp.FORMATS
    rng = np.random.RandomState(0)
    for src in jkp.FORMATS:
        joints = rng.randn(3, len(jkp.FORMATS[src]), 3).astype(np.float32)
        for dst in ("spin", "coco", "common", "h36m", "smpl"):
            assert_same(tkp.convert_kps(joints, src, dst), jkp.convert_kps(joints, src, dst), f"{src}->{dst}")
            assert tkp.get_perm_idxs(src, dst) == jkp.get_perm_idxs(src, dst)
    with pytest.raises(KeyError):
        tkp.joint_names("nope")


def _image(rng, h=120, w=160):
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _aug_cases():
    center, scale, res = np.array([81.0, 57.5]), 0.55, (64, 48)
    return {
        "get_transform": lambda A, r: A.get_transform(center, scale, res, rot=17.0),
        "transform_point": lambda A, r: (A.transform_point([30.2, 40.7], center, scale, res, invert=1, rot=-12.0),
                                         A.transform_point([3.0, 4.0], center, scale, res)),
        "get_crop_shape": lambda A, r: (A.get_crop_shape(center, scale, res), A.get_crop_shape(center, scale, res, rot=25)),
        "crop_image": lambda A, r: (A.crop_image(_image(r), center, scale, res),
                                    A.crop_image(_image(r), center, scale, res, rot=-33.0),
                                    A.crop_image(r.randint(0, 7, (120, 160)).astype(np.float32), center, scale, res,
                                                 nearest=True)),
        "rot_aa": lambda A, r: (A.rot_aa(r.randn(3), 23.0), A.rot_aa(r.randn(3), 0)),
        "flip_kp": lambda A, r: [A.flip_kp(r.randn(k, 3), s) for k in (24, 49) for s in (False, True)],
        "flip_pose": lambda A, r: A.flip_pose(r.randn(72)),
        "AugmentParams.sample": lambda A, r: [A.AugmentParams.sample(r) for _ in range(6)]
        + [A.AugmentParams.sample(r, is_train=False)],
        "occlude_with_objects": lambda A, r: A.occlude_with_objects(_image(r), A.random_occluders(r, 4), r),
        "color_jitter": lambda A, r: [A.color_jitter(_image(r), r, p=1.0) for _ in range(3)]
        + [A.color_jitter(_image(r).astype(np.float32), r, p=1.0)],
        "apply_channel_noise": lambda A, r: A.apply_channel_noise(_image(r).astype(np.float32), r.uniform(0.6, 1.4, 3)),
        "normalize_image": lambda A, r: A.normalize_image(r.rand(16, 12, 3).astype(np.float32)),
        "finalize_crop": lambda A, r: A.finalize_crop(_image(r), r.uniform(0.6, 1.4, 3)),
        "j2d_processing": lambda A, r: [A.j2d_processing(r.uniform(0, 160, (49, 3)), center, scale, res, rot, flip)
                                        for rot in (0.0, 21.0) for flip in (0, 1)],
        "j3d_processing": lambda A, r: [A.j3d_processing(r.randn(24, 4), rot, flip) for rot in (0.0, -40.0)
                                        for flip in (0, 1)],
        "pose_processing": lambda A, r: [A.pose_processing(r.randn(72) * 0.3, rot, flip) for rot in (0.0, 15.0)
                                         for flip in (0, 1)],
        "uncrop_image": lambda A, r: A.uncrop_image(r.rand(64, 48, 3).astype(np.float32), center, scale, (120, 160)),
        "paste_over": lambda A, r: _paste(A, r),
    }


def _paste(A, r):
    dst = _image(r)
    A.paste_over(r.randint(0, 256, (30, 40, 4)).astype(np.uint8), dst, np.array([150, 10]))
    A.paste_over(r.randint(0, 256, (20, 20, 3)).astype(np.uint8), dst, np.array([40, 60]))
    return dst


@pytest.mark.parametrize("name", sorted(_aug_cases()))
def test_augment_matches_bit_for_bit(name):
    case = _aug_cases()[name]
    assert_same(case(TA, np.random.RandomState(11)), case(JA, np.random.RandomState(11)), name)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """8 images and labels in the reference schema, plus gender, det_score
    and a label file whose third image is missing."""
    root = tmp_path_factory.mktemp("torch_data")
    consts = body_consts_from_assets(synthetic_smpl_assets(0), device="cpu")
    paths = write_npz_dataset(root, consts, 8, seed=5)
    labels = dict(np.load(paths["npz"]))
    labels["gender"] = np.array(["m", "f"] * 4)
    labels["det_score"] = np.linspace(0.5, 1.0, 8).astype(np.float32)
    np.savez(paths["npz"], **labels)
    labels["imgname"] = labels["imgname"].copy()
    labels["imgname"][2] = "missing.png"
    paths["npz_missing"] = str(root / "missing.npz")
    np.savez(paths["npz_missing"], **labels)
    return paths


def _pair(paths, npz="npz", **kw):
    cfg_t, cfg_j = tiny_config(), j_tiny_config()
    return (tnd.NpzDataset(cfg_t, paths[npz], paths["img_dir"], **kw),
            jnd.NpzDataset(cfg_j, paths[npz], paths["img_dir"], **kw))


DATASET_CASES = {
    "eval": dict(is_train=False),
    "train_aug": dict(is_train=True, occluders=JA.random_occluders(np.random.RandomState(2), 6), seed=4),
    "train_no_aug": dict(is_train=True, use_augmentation=False),
    "device_norm": dict(is_train=True, device_norm=True, seed=1),
    "cache_images": dict(is_train=True, cache_images=True, seed=2),
    "missing_image": dict(is_train=True, npz="npz_missing"),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_npz_dataset_items_match(dataset_dir, case):
    kw = dict(DATASET_CASES[case])
    ours, theirs = _pair(dataset_dir, **kw)
    ours.set_epoch(3)
    theirs.set_epoch(3)
    for i in range(len(ours)):
        for _ in range(2 if case == "cache_images" else 1):
            assert_same(ours[i], theirs[i], f"{case} item {i}")
    if case == "device_norm":
        assert ours[0]["img"].dtype == np.uint8 and "pixel_noise" in ours[0]


def test_npz_dataset_crop_failure_retries_original_bbox(dataset_dir, monkeypatch):
    """An augmented crop that raises is retried once with the sample's own
    bbox, in both packages alike."""
    for module in (TA, JA):
        real = module.crop_image
        state = {"calls": 0}

        def flaky(*a, _real=real, _state=state, **k):
            _state["calls"] += 1
            if _state["calls"] == 1:
                raise ValueError("crop failed")
            return _real(*a, **k)

        monkeypatch.setattr(module, "crop_image", flaky)
    ours, theirs = _pair(dataset_dir, is_train=True, seed=9)
    assert_same(ours[5], theirs[5], "retried item")


def test_mixture_draws_match(dataset_dir):
    parts = [_pair(dataset_dir, is_train=True, seed=s) for s in (0, 1)]
    for (t, j), name in zip(parts, ("h36m", "3dpw")):
        t.name = j.name = name
    ours = tnd.MixtureDataset([p[0] for p in parts], length=12, seed=3)
    theirs = jnd.MixtureDataset([p[1] for p in parts], length=12, seed=3)
    assert tnd.MIXTURE_WEIGHTS == jnd.MIXTURE_WEIGHTS and tnd.MIXTURE_LENGTH == jnd.MIXTURE_LENGTH
    np.testing.assert_array_equal(ours.weights, theirs.weights)
    ours.set_epoch(2)
    theirs.set_epoch(2)
    for i in range(len(ours)):
        assert_same(ours[i], theirs[i], f"mixture draw {i}")


def test_batch_loader_epoch_matches(dataset_dir):
    ours, theirs = _pair(dataset_dir, is_train=True, seed=6, device_norm=True)
    lt = BatchLoader(ours, 3, shuffle=True, num_workers=3, seed=2, drop_last=False)
    lj = JBatchLoader(theirs, 3, shuffle=True, num_workers=3, seed=2, drop_last=False)
    lt.set_epoch(1)
    lj.set_epoch(1)
    got, want = list(lt), list(lj)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"batch {i}")
