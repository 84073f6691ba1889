"""Shared fixtures: tiny configs and synthetic batches for tests/benchmarks.

A copy of `whmr_tpu/utils/testing.py`; the same seed gives the same arrays.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict

import numpy as np

from whmr_tpu_torch.config import DeconvConfig, ViTConfig, WHMRConfig


def tiny_config(backbone: str = "vitpose") -> WHMRConfig:
    """A dimension-consistent miniature WHMR config for fast CPU tests."""
    cfg = WHMRConfig()
    return replace(
        cfg,
        pymaf=replace(cfg.pymaf, backbone=backbone, mlp_dim=(32, 16, 8, 4)),
        deconv=DeconvConfig(num_filters=(32, 32, 32)),
        vit=ViTConfig(embed_dim=64, depth=2, num_heads=2, drop_path_rate=0.0),
    )


def make_example_inputs(
    cfg: WHMRConfig,
    batch: int,
    seed: int = 0,
    with_full_img: bool = False,
    dtype=np.float32,
) -> Dict[str, np.ndarray]:
    """Random inputs with realistic ranges for the WHMR forward signature."""
    rng = np.random.RandomState(seed)
    h, w = cfg.crop_hw
    img_h, img_w = 720.0, 1280.0
    bbox_height = rng.uniform(150, 500, size=(batch,)).astype(dtype)
    center = np.stack(
        [rng.uniform(200, 1080, batch), rng.uniform(150, 570, batch)], axis=-1
    ).astype(dtype)
    focal = np.sqrt(img_h**2 + img_w**2).astype(dtype)
    # bbox_info: [cx-img_cx, cy-img_cy, bbox_h, img_w, img_h] / pseudo-focal
    # (reference datasets/base_dataset.py:368-373, demo/tester.py:127-145).
    bbox_info = (
        np.stack(
            [
                center[:, 0] - img_w / 2,
                center[:, 1] - img_h / 2,
                bbox_height,
                np.full(batch, img_w),
                np.full(batch, img_h),
            ],
            axis=-1,
        )
        / focal
    ).astype(dtype)
    out = {
        "x": rng.randn(batch, h, w, 3).astype(dtype),
        "center": center,
        "scale": (bbox_height / 200.0).astype(dtype),
        "bbox_height": bbox_height,
        "orig_shape": np.tile(np.array([[img_h, img_w]], dtype), (batch, 1)),
        "bbox_info": bbox_info,
    }
    if with_full_img:
        ch, cw = cfg.cam_img_size
        out["full_x"] = rng.randn(batch, ch, cw, 3).astype(dtype)
    return out
