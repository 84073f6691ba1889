"""The port's LSP part-segmentation protocol (inference/part_segm.py)
against whmr_tpu's.

The part map renders through the port's `ops/rasterizer.py::rasterize`, as
whmr_tpu's renders through its XLA `rasterize`. XLA on the CPU contracts the
barycentric products and sums into FMAs and the port rounds each operation,
so a pixel centre within an ulp of an edge can fall on the other side: on a
posed body the maps agree on at least 99.9 % of the pixels, and bit for bit
on the seam case, whose vertices have exact fp32 arithmetic.
"""

import dataclasses

import numpy as np
import pytest
import torch

from whmr_tpu.data.assets import synthetic_smpl_assets as j_assets
from whmr_tpu.inference import part_segm as jps
from whmr_tpu_torch.data.assets import synthetic_smpl_assets
from whmr_tpu_torch.inference import part_segm as tps

from torch_port_util import release_memory  # noqa: F401 (autouse fixture)

# Share of pixels on which the two renders of a posed body must agree.
PIXEL_AGREEMENT = 0.999


def test_vertex_part_labels_match():
    np.testing.assert_array_equal(tps.vertex_part_labels(synthetic_smpl_assets()),
                                  jps.vertex_part_labels(j_assets()))


@pytest.mark.parametrize("res,batch", [((64, 64), 2), ((48, 40), 1)])
def test_render_part_map_matches(res, batch):
    assets = synthetic_smpl_assets()
    rng = np.random.RandomState(1)
    verts = (assets.v_template[None] + rng.randn(batch, *assets.v_template.shape) * 0.01).astype(np.float32)
    cam = np.array([[0.9, 0.02, -0.05], [1.2, -0.1, 0.1]][:batch], np.float32)
    got = tps.render_part_segmentation(assets, torch.from_numpy(verts), torch.from_numpy(cam), res).numpy()
    want = np.asarray(jps.render_part_segmentation(j_assets(), verts, cam, res))
    assert got.shape == want.shape == (batch, *res) and got.dtype == np.int32
    assert (got > 0).mean() > 0.03 and got.max() <= 6
    assert (got == want).mean() >= PIXEL_AGREEMENT


def test_seam_face_never_paints_third_label():
    """A face whose corners carry non-adjacent labels (torso 2, right leg 5)
    paints only those labels, bit for bit with whmr_tpu (the one-hot and
    argmax form; tests/test_part_segm.py's seam case)."""
    base = synthetic_smpl_assets()
    lbs = np.zeros_like(base.lbs_weights)
    lbs[0, 0] = 1.0
    lbs[1, 8] = 1.0
    lbs[2, 8] = 1.0
    vt = np.array(base.v_template)
    vt[0] = [-0.8, -0.8, 0.0]
    vt[1] = [0.8, -0.8, 0.0]
    vt[2] = [0.0, 0.9, 0.0]
    kw = dict(lbs_weights=lbs.astype(base.lbs_weights.dtype), v_template=vt.astype(base.v_template.dtype),
              faces=np.array([[0, 1, 2]], np.int32))
    ours, theirs = dataclasses.replace(base, **kw), dataclasses.replace(j_assets(), **kw)
    cam = np.array([[1.0, 0.0, 0.0]], np.float32)
    got = tps.render_part_segmentation(ours, torch.from_numpy(vt[None].astype(np.float32)), torch.from_numpy(cam),
                                       (64, 64)).numpy()
    want = np.asarray(jps.render_part_segmentation(theirs, vt[None].astype(np.float32), cam, (64, 64)))
    assert (got > 0).mean() > 0.1
    assert set(np.unique(got).tolist()) <= {0, 2, 5}
    np.testing.assert_array_equal(got, want)


def test_segmentation_metrics_match():
    rng = np.random.RandomState(4)
    gt = rng.randint(0, 7, (40, 40))
    cases = [gt, np.zeros_like(gt), rng.randint(0, 7, (40, 40)), np.where(rng.rand(40, 40) > 0.3, gt, 0)]
    for pred in cases:
        assert tps.segmentation_metrics(pred, gt) == jps.segmentation_metrics(pred, gt)
    assert tps.segmentation_metrics(gt, np.zeros_like(gt))["parts_accuracy"] == 0.0
