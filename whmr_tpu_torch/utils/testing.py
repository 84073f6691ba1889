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


def make_example_train_batch(
    cfg: WHMRConfig, batch: int, seed: int = 0, dtype=np.float32
) -> Dict[str, np.ndarray]:
    """Synthetic training batch with every GT field the loss consumes
    (field inventory per reference datasets/base_dataset.py:249-384)."""
    rng = np.random.RandomState(seed)
    inputs = make_example_inputs(cfg, batch, seed=seed, dtype=dtype)
    return {
        "img": inputs["x"],
        "center": inputs["center"],
        "scale": inputs["scale"],
        "bbox_height": inputs["bbox_height"],
        "bbox_width": inputs["bbox_height"] * 0.75,
        "orig_shape": inputs["orig_shape"],
        "bbox_info": inputs["bbox_info"],
        "keypoints": np.concatenate(
            [rng.uniform(-1, 1, (batch, 49, 2)), np.ones((batch, 49, 1))], -1
        ).astype(dtype),
        "keypoints_world": np.concatenate(
            [rng.uniform(-1, 1, (batch, 49, 2)), np.ones((batch, 49, 1))], -1
        ).astype(dtype),
        "pose": (rng.randn(batch, 72) * 0.2).astype(dtype),
        "betas": (rng.randn(batch, 10) * 0.5).astype(dtype),
        "pose_3d": np.concatenate(
            [rng.randn(batch, 24, 3) * 0.3, np.ones((batch, 24, 1))], -1
        ).astype(dtype),
        "has_smpl": np.ones(batch, dtype),
        "has_pose_3d": np.ones(batch, dtype),
        "focal": np.full(batch, 1469.0, dtype),
        # 431-vertex BERT-style visibility mask (base_dataset.py:345-355)
        "meta_mask": (rng.random_sample((batch, 431, 1)) > 0.15).astype(dtype),
    }


def make_keypoints_consistent(consts, batch_np: Dict[str, np.ndarray], seed: int = 7) -> Dict[str, np.ndarray]:
    """Replace a batch's random 2D keypoints with the GT joints projected
    through a plausible crop camera (scale 0.7-1.1, small shift), as real
    training data gives them. The train step's least-squares GT camera then
    frames a body-sized mesh; random keypoints make it degenerate, and the
    GT render then covers every tile or shrinks to a few pixels."""
    import torch

    from whmr_tpu_torch.config import FOCAL_LENGTH
    from whmr_tpu_torch.models.smpl import smpl_forward
    from whmr_tpu_torch.ops.rotation import batch_rodrigues

    dev = consts.smpl.v_template.device
    with torch.no_grad():
        pose = torch.from_numpy(batch_np["pose"]).to(dev)
        rotmats = batch_rodrigues(pose.reshape(-1, 3)).reshape(-1, 24, 3, 3)
        joints = smpl_forward(consts.smpl, torch.from_numpy(batch_np["betas"]).to(dev), rotmats).joints
    joints = joints.cpu().numpy().astype(np.float64)
    batch = joints.shape[0]
    rng = np.random.RandomState(seed)
    s = rng.uniform(0.7, 1.1, (batch, 1, 1))
    t = np.concatenate(
        [rng.uniform(-0.1, 0.1, (batch, 1, 2)), 2.0 * FOCAL_LENGTH / (256.0 * s)], axis=-1
    )
    pj = joints + t
    pix = FOCAL_LENGTH * pj[..., :2] / pj[..., 2:3] + 128.0
    out = dict(batch_np)
    out["keypoints"] = np.concatenate(
        [2.0 * pix / 256.0 - 1.0, np.ones((batch, joints.shape[1], 1))], -1
    ).astype(np.float32)
    return out


def make_ragged_raster_case(batch: int = 2, seed: int = 0):
    """A rasterizer input that exercises every edge of K2's tiling and tie
    rules: 150 random triangles (vertices beyond the frame too) over a 37x29
    window at origin (3, 2), so chunks of 64 leave 42 padding faces and
    neither side is a multiple of a tile. Faces 100-109 repeat faces 70-79
    (exact ties inside chunk 1) and faces 110-119 repeat faces 0-9 (exact
    ties across chunks 0 and 1). Returns numpy (verts_pix, verts_z, attrs,
    faces) and the keyword arguments (resolution, chunk, origin)."""
    rng = np.random.RandomState(seed)
    verts = rng.uniform(-4, 40, (batch, 60, 2)).astype(np.float32)
    z = rng.uniform(2, 8, (batch, 60)).astype(np.float32)
    attrs = rng.rand(batch, 60, 3).astype(np.float32)
    base = rng.randint(0, 60, (130, 3))
    faces = np.concatenate([base[:100], base[70:80], base[:10], base[100:]]).astype(np.int32)
    return (verts, z, attrs, faces), {"resolution": (37, 29), "chunk": 64, "origin": (3.0, 2.0)}


def write_npz_dataset(root, consts, n: int, seed: int = 0, img_wh=(480, 360), n_parts: int = 0,
                      n_coco: int = 0) -> Dict[str, str]:
    """A dataset on disk in the reference schema, made from `seed`: `n` PNG
    images of `img_wh` under root/images and root/labels.npz with imgname,
    center, scale, pose, shape, has_smpl, S, part, openpose (the keypoints are
    the GT SMPL joints through a plausible crop camera, as
    `make_keypoints_consistent` makes them, taken back to image pixels),
    cam_rotmat and global_pose. With `n_parts`, the first n_parts images get
    a GT part map under root/parts (labels 1..6 in a blob over the bbox);
    with `n_coco`, root/person_keypoints.json holds the first n_coco images
    and their COCO keypoint annotations. `consts` is the port's BodyConsts (any device). Returns
    the paths by name."""
    import json
    import os

    import cv2
    import torch

    from whmr_tpu_torch.config import FOCAL_LENGTH
    from whmr_tpu_torch.data.kp_formats import convert_kps
    from whmr_tpu_torch.models.smpl import smpl_forward
    from whmr_tpu_torch.ops.rotation import batch_rodrigues

    rng = np.random.RandomState(seed)
    w, h = img_wh
    paths = {"root": str(root), "img_dir": os.path.join(root, "images"), "npz": os.path.join(root, "labels.npz")}
    os.makedirs(paths["img_dir"], exist_ok=True)
    names = [f"img_{i:05d}.png" for i in range(n)]
    for name in names:
        # smooth colour fields with grain, so a PNG's decode costs what a
        # photo's does more than a noise image's
        low = rng.randint(0, 256, (h // 8, w // 8, 3)).astype(np.uint8)
        img = cv2.resize(low, (w, h), interpolation=cv2.INTER_LINEAR)
        img = np.clip(img.astype(np.int16) + rng.randint(-8, 9, img.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(paths["img_dir"], name), img)

    center = np.stack([rng.uniform(0.4 * w, 0.6 * w, n), rng.uniform(0.4 * h, 0.6 * h, n)], -1).astype(np.float32)
    scale = rng.uniform(0.6, 0.8, n).astype(np.float32) * h / 200.0
    pose = (rng.randn(n, 72) * 0.2).astype(np.float32)
    betas = (rng.randn(n, 10) * 0.5).astype(np.float32)
    dev = consts.smpl.v_template.device
    with torch.no_grad():
        rot = batch_rodrigues(torch.from_numpy(pose).to(dev).reshape(-1, 3)).reshape(-1, 24, 3, 3)
        joints = smpl_forward(consts.smpl, torch.from_numpy(betas).to(dev), rot).joints.cpu().numpy()
    joints = joints.astype(np.float64)
    s = rng.uniform(0.7, 1.1, (n, 1, 1))
    t = np.concatenate([rng.uniform(-0.1, 0.1, (n, 1, 2)), 2.0 * FOCAL_LENGTH / (256.0 * s)], axis=-1)
    pj = joints + t
    crop_px = FOCAL_LENGTH * pj[..., :2] / pj[..., 2:3] + 128.0
    # crop pixel -> image pixel: the inverse of augment.get_transform at 256
    img_px = center[:, None, :] + (crop_px / 256.0 - 0.5) * (200.0 * scale)[:, None, None]
    kp = np.concatenate([img_px, np.ones((n, 49, 1))], -1).astype(np.float32)
    cam_aa = rng.randn(n, 3) * 0.1
    cam_rotmat = np.stack([cv2.Rodrigues(a)[0] for a in cam_aa]).astype(np.float32)
    global_pose = pose.copy()
    for i in range(n):
        r = cam_rotmat[i].T.astype(np.float64) @ cv2.Rodrigues(pose[i, :3].astype(np.float64))[0]
        global_pose[i, :3] = cv2.Rodrigues(r)[0][:, 0]
    np.savez(
        paths["npz"], imgname=np.array(names), center=center, scale=scale, pose=pose, shape=betas,
        has_smpl=np.ones(n, np.float32),
        S=np.concatenate([joints[:, 25:], np.ones((n, 24, 1))], -1).astype(np.float32),
        part=kp[:, 25:], openpose=kp[:, :25], cam_rotmat=cam_rotmat, global_pose=global_pose,
    )

    if n_parts:
        paths["parts_dir"] = os.path.join(root, "parts")
        os.makedirs(paths["parts_dir"], exist_ok=True)
        for i in range(n_parts):
            part = np.zeros((h, w), np.uint8)
            half = int(100 * scale[i] * 0.6)
            x0, y0 = int(center[i, 0]) - half // 2, int(center[i, 1]) - half
            part[max(y0, 0):y0 + 2 * half, max(x0, 0):x0 + half] = rng.randint(1, 7, (2 * half, half))[
                max(-y0, 0):, max(-x0, 0):][: h - max(y0, 0), : w - max(x0, 0)]
            cv2.imwrite(os.path.join(paths["parts_dir"], names[i]), part)
    if n_coco:
        kp17 = convert_kps(kp[:n_coco].copy(), "spin", "coco")
        kp17[..., 2] *= 2.0  # COCO's "labeled and visible"
        lo, hi = kp17[..., :2].min(axis=1), kp17[..., :2].max(axis=1)
        anns = [{
            "id": i + 1, "image_id": i, "category_id": 1, "iscrowd": 0, "num_keypoints": 17,
            "keypoints": kp17[i].reshape(-1).tolist(),
            "bbox": [float(lo[i, 0]), float(lo[i, 1]), float(hi[i, 0] - lo[i, 0]), float(hi[i, 1] - lo[i, 1])],
            "area": float((hi[i, 0] - lo[i, 0]) * (hi[i, 1] - lo[i, 1])),
        } for i in range(n_coco)]
        paths["coco_gt"] = os.path.join(root, "person_keypoints.json")
        with open(paths["coco_gt"], "w") as f:
            json.dump({"images": [{"id": i, "file_name": name, "width": w, "height": h}
                                  for i, name in enumerate(names[:n_coco])],
                       "annotations": anns, "categories": [{"id": 1, "name": "person"}]}, f)
    return paths
