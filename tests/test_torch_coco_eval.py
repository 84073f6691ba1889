"""The port's COCO keypoint OKS-AP protocol (inference/coco_eval.py)
against whmr_tpu's: OKS matrices, AP/AR over a seeded dataset with crowd,
ignored, unlabeled and missed persons and detections on images without
annotations, the json reader and the SPIN-49 to COCO-17 map. The two are
the same numpy code: results are equal."""

import json

import numpy as np

from whmr_tpu.inference import coco_eval as jce
from whmr_tpu_torch.inference import coco_eval as tce

from torch_port_util import release_memory  # noqa: F401 (autouse fixture)

K = 17


def _dataset(seed):
    rng = np.random.RandomState(seed)
    gts, dts = {}, {}
    for img in range(6):
        g = rng.randint(1, 4)
        kps = rng.uniform(100, 900, (g, K, 2))
        vis = (rng.rand(g, K, 1) > 0.2) * 2.0
        if img == 2:
            vis[0] = 0.0  # a person with no labeled keypoint
        lo, hi = kps.min(1), kps.max(1)
        gts[img] = {
            "kps": np.concatenate([kps, vis], -1), "areas": rng.uniform(0.5e4, 3e4, g),
            "bboxes": np.concatenate([lo, hi - lo], -1),
            "ignore": (np.arange(g) == 1) * float(img == 3), "crowd": (np.arange(g) == 1) * float(img == 4),
        }
        d = rng.randint(0, 4)
        src = kps[rng.randint(0, g, d)] if d else np.zeros((0, K, 2))
        dts[img] = {"kps": src + rng.randn(d, K, 2) * rng.uniform(2, 40), "scores": rng.rand(d)}
    dts[99] = {"kps": rng.uniform(100, 900, (2, K, 2)), "scores": rng.rand(2)}  # no gt image
    return gts, dts


def test_compute_oks_matches():
    gts, dts = _dataset(0)
    for img, gt in gts.items():
        args = (gt["kps"], gt["areas"], dts[img]["kps"], gt["bboxes"])
        np.testing.assert_array_equal(tce.compute_oks(*args), jce.compute_oks(*args))
    np.testing.assert_array_equal(tce.COCO_SIGMAS, jce.COCO_SIGMAS)


def test_evaluate_oks_ap_matches():
    for seed in range(4):
        gts, dts = _dataset(seed)
        got, want = tce.evaluate_oks_ap(gts, dts), jce.evaluate_oks_ap(gts, dts)
        assert got == want, seed
        assert 0.0 <= got["AP"] <= 1.0
    perfect = {i: {"kps": g["kps"][..., :2], "scores": np.ones(len(g["kps"]))} for i, g in _dataset(1)[0].items()}
    assert tce.evaluate_oks_ap(_dataset(1)[0], perfect) == jce.evaluate_oks_ap(_dataset(1)[0], perfect)


def test_load_coco_gt_and_joint_map_match(tmp_path):
    gts, _ = _dataset(5)
    images, anns = [], []
    for img, g in gts.items():
        images.append({"id": img, "file_name": f"dir/{img}.jpg", "width": 1000, "height": 1000})
        for j in range(len(g["kps"])):
            anns.append({"id": len(anns) + 1, "image_id": img, "category_id": 1, "iscrowd": int(g["crowd"][j]),
                         "keypoints": g["kps"][j].reshape(-1).tolist(), "area": float(g["areas"][j]),
                         "bbox": g["bboxes"][j].tolist()})
    anns.append({"id": 999, "image_id": 0, "category_id": 2, "keypoints": [], "bbox": [0, 0, 1, 1]})
    path = tmp_path / "person_keypoints.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": 1, "name": "person"}, {"id": 2, "name": "dog"}]}))
    got, want = tce.load_coco_gt(str(path), return_name_to_id=True), jce.load_coco_gt(str(path), return_name_to_id=True)
    assert got[1] == want[1]
    assert got[0].keys() == want[0].keys()
    for img in want[0]:
        for k in want[0][img]:
            np.testing.assert_array_equal(got[0][img][k], want[0][img][k])
    kp49 = np.random.RandomState(2).randn(3, 49, 2).astype(np.float32)
    for conf in (None, np.ones((3, 17), np.float32)):
        for a, b in zip(tce.spin49_to_coco17(kp49, conf), jce.spin49_to_coco17(kp49, conf)):
            np.testing.assert_array_equal(a, b)
