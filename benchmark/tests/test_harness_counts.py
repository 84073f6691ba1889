"""The counts of benchmark/counts held to hand counts at the cells' shapes,
and the benchmark's asset arrays to the port's synthetic assets."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import HERE


def sizes(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["model"]


def test_vit_block_flops_by_hand():
    from counts import flops

    for name, d, depth in (("whmr-vitb", 768, 12), ("whmr-vitl", 1024, 24)):
        parts = flops.forward_parts(sizes(name))
        n = 16 * 12  # 256x192 crops, 16x16 patches, padding 4
        # 24 D^2 a token a block (qkv 6, proj 2, MLP 16), 4 N D for the two attention products.
        per_token_block = 24 * d * d + 4 * n * d
        patch = 2 * 3 * 16 * 16 * d * n
        assert parts["vit"] == depth * n * per_token_block + patch
    assert 24 * 768 * 768 == 14_155_776  # 14.2 MFLOP a token a block of ViT-B's weights


def test_deconv_and_heads_by_hand():
    from counts import flops

    p = flops.forward_parts(sizes("whmr-vitb"))
    # ConvT k4 s2: Cin*Cout*16 MACs per input pixel: 768->256 at 16x12, 256->256 at 32x24 and 64x48.
    assert p["deconv"] == 2 * 16 * 256 * (768 * 192 + 256 * 768 + 256 * 3072)
    # IUV head: four 3x3 convs 256 -> 25, 25, 15, 25 at 128x96.
    assert p["iuv_head"] == 2 * 256 * 90 * 9 * 128 * 96
    assert flops.train_flops(sizes("whmr-vitb")) == 3 * flops.forward_flops(sizes("whmr-vitb"), train=True)


def test_attention_bound_by_hand():
    from counts import attention

    # ViT-L at B=192: 4 tensors of 192*16*192*64 bf16 against 4*B*H*N^2*D at 989 TFLOP/s.
    b, h, n, d = 192, 16, 192, 64
    t_bytes = 4 * b * h * n * d * 2 / 3.35e12
    t_ops = 4 * b * h * n * n * d / 989e12
    assert attention.attention_bound_s((b, h, n, d)) == pytest.approx(max(t_bytes, t_ops), rel=1e-12)


def test_raster_work_by_hand():
    from counts import raster

    # One triangle covering pixel centres (0.5..3.5) x (0.5..1.5) of a 4x4 window: its padded
    # bbox holds 4 x 2 centres; a degenerate face holds none.
    verts = torch.tensor([[[0.2, 0.2], [3.8, 0.2], [0.2, 1.8], [1.0, 1.0]]])
    faces = torch.tensor([[0, 1, 2], [3, 3, 3]])
    fbox = raster.face_bbox(verts, faces)
    pairs, live, n_bytes = raster.raster_work(fbox, (4, 4), (0.0, 0.0), 3)
    assert (pairs, live) == (8, 1)
    assert n_bytes == 4 * (1 * (12 + 9) + 16 * 4)
    assert raster.raster_bound_s(pairs, n_bytes) == pytest.approx(n_bytes / 3.35e12)


def test_assets_equal_the_ports_synthetic_assets():
    import assets
    from whmr_tpu_torch.data.assets import synthetic_smpl_assets

    ours, theirs = assets.synthetic_assets(), synthetic_smpl_assets(0)
    for k, v in ours.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(getattr(theirs, k)), err_msg=k)
