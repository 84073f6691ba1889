"""Visualization utilities: skeleton drawing, joint plots, horizon line.

A copy of `whmr_tpu/utils/vis.py` for the port: host code (numpy, cv2,
matplotlib); `vis_smpl_iuv` renders through the port's renderer and turns
the IUV maps into images with the port's `ops/iuv.py`. Equivalent of
reference `utils/vis.py` / `utils/vis_utils.py` / `utils/uv_vis.py`
essentials (skeleton drawing :52-210, horizon-line vis, IUV visualization).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import cv2
import numpy as np

# Skeleton edges over the SPIN 49-joint set's GT slice (25:49 -> J24) and
# over the 25 OpenPose joints.
J24_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (6, 7), (7, 8), (8, 9), (9, 10),
    (10, 11), (8, 12), (9, 12), (12, 13), (2, 14), (3, 14), (14, 16), (16, 15),
    (15, 12), (17, 18),
]
OPENPOSE_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (1, 8), (8, 9),
    (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (0, 15), (0, 16),
    (15, 17), (16, 18), (14, 19), (19, 20), (14, 21), (11, 22), (22, 23),
    (11, 24),
]


def draw_skeleton(
    image: np.ndarray,
    kp_2d: np.ndarray,
    edges: Optional[Sequence[Tuple[int, int]]] = None,
    vis_thresh: float = 0.3,
    radius: int = 3,
) -> np.ndarray:
    """Draw 2D keypoints + bones on an image (reference vis.py draw_skeleton).

    kp_2d: (J, 2) or (J, 3) pixel coordinates (+confidence).
    """
    out = image.copy()
    conf = kp_2d[:, 2] if kp_2d.shape[1] > 2 else np.ones(len(kp_2d))
    if edges is None:
        edges = OPENPOSE_EDGES if len(kp_2d) in (25, 49) else J24_EDGES
    for a, b in edges:
        if a < len(kp_2d) and b < len(kp_2d) and conf[a] > vis_thresh and conf[b] > vis_thresh:
            pa = tuple(np.round(kp_2d[a, :2]).astype(int))
            pb = tuple(np.round(kp_2d[b, :2]).astype(int))
            cv2.line(out, pa, pb, (0, 255, 128), 2)
    for j, (x, y) in enumerate(kp_2d[:, :2]):
        if conf[j] > vis_thresh:
            cv2.circle(out, (int(round(x)), int(round(y))), radius, (255, 64, 64), -1)
    return out


def draw_horizon_line(
    image: np.ndarray, pitch: float, roll: float, vfov: float
) -> np.ndarray:
    """Overlay the camera horizon implied by (pitch, roll, vfov) — the
    CamCalib visual check (reference vis_utils.py horizon drawing).

    The horizon's vertical offset at the image center is
    f * tan(pitch); the line is tilted by roll.
    """
    out = image.copy()
    h, w = image.shape[:2]
    f = (h / 2.0) / np.tan(vfov / 2.0)
    y_mid = h / 2.0 + f * np.tan(pitch)
    dx = w / 2.0
    dy = np.tan(roll) * dx
    p1 = (0, int(round(y_mid - dy)))
    p2 = (w - 1, int(round(y_mid + dy)))
    cv2.line(out, p1, p2, (0, 128, 255), 2)
    return out


def iuv_to_rgb(iuv_image: np.ndarray) -> np.ndarray:
    """IUV map (H, W, 3 in [0,1]) -> displayable uint8 (uv_vis.py style)."""
    return np.clip(iuv_image * 255.0, 0, 255).astype(np.uint8)


def colormap_depth(depth: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Inverse-depth map -> JET colormap visualization."""
    d = depth.astype(np.float32)
    if mask is None:
        mask = d > 0
    if mask.any():
        lo, hi = d[mask].min(), d[mask].max()
        norm = np.where(mask, (d - lo) / max(hi - lo, 1e-9), 0.0)
    else:
        norm = np.zeros_like(d)
    vis = cv2.applyColorMap((norm * 255).astype(np.uint8), cv2.COLORMAP_JET)
    vis[~mask] = 0
    return vis[:, :, ::-1]


# ---------------------------------------------------------------------------
# Batch joint-plot grids (reference utils/vis.py:378-541) and UV panels
# (reference utils/uv_vis.py:68-112)
# ---------------------------------------------------------------------------

def make_image_grid(
    images: np.ndarray,
    nrow: int = 8,
    padding: int = 1,
    pad_value: float = 1.0,
    normalize: bool = True,
) -> np.ndarray:
    """Tile a batch (B, H, W, 3) into one grid image (torchvision
    make_grid equivalent used by vis_batch_image_with_joints)."""
    b, h, w, c = images.shape
    xmaps = min(nrow, b)
    ymaps = -(-b // xmaps)
    imgs = images.astype(np.float32)
    if normalize:
        lo, hi = imgs.min(), imgs.max()
        imgs = (imgs - lo) / max(hi - lo, 1e-9)
    grid = np.full(
        (ymaps * (h + padding) + padding, xmaps * (w + padding) + padding, c),
        pad_value, np.float32,
    )
    for k in range(b):
        y, x = divmod(k, xmaps)
        gy = y * (h + padding) + padding
        gx = x * (w + padding) + padding
        grid[gy:gy + h, gx:gx + w] = imgs[k]
    return grid


def vis_batch_image_with_joints(
    batch_image: np.ndarray,
    batch_joints: np.ndarray,
    batch_joints_vis: np.ndarray,
    nrow: int = 8,
    padding: int = 1,
) -> np.ndarray:
    """Batch grid with numbered keypoints (reference vis.py:378-424).

    batch_image: (B, H, W, 3) float/uint8 (NHWC — not the reference's NCHW).
    batch_joints: (B, J, >=2) pixel coords; batch_joints_vis: (B, J, 1).
    Returns uint8 RGB grid; joints alternate red/green as in the reference.
    """
    grid = (make_image_grid(batch_image, nrow, padding) * 255).clip(0, 255)
    ndarr = np.ascontiguousarray(grid.astype(np.uint8))
    b, h, w = batch_image.shape[:3]
    xmaps = min(nrow, b)
    for k in range(b):
        y, x = divmod(k, xmaps)
        flip = 1
        for count, (joint, jv) in enumerate(
            zip(batch_joints[k], batch_joints_vis[k])
        ):
            jx = int(x * (w + padding) + padding + joint[0])
            jy = int(y * (h + padding) + padding + joint[1])
            flip *= -1
            if jv[0]:
                color = [255, 0, 0] if flip > 0 else [0, 255, 0]
                cv2.circle(ndarr, (jx, jy), 1, color, 1)
                cv2.putText(ndarr, str(count), (jx, jy),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.75, (255, 0, 0), 1)
    return ndarr


_JOINT_COLORS = ["#00B0F0", "#00B050", "#DC6464", "#207070", "#BC4484"]


def _fig_to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    return buf.copy()


def _group_of(idx: int, joint_group) -> int:
    if joint_group is None:
        return 1
    for i, g in enumerate(joint_group):
        if idx in g:
            return i
    return 0


def set_axes_equal(ax) -> None:
    """Equal aspect for 3D axes (reference vis.py:581-606 workaround for
    matplotlib's missing 3D 'equal')."""
    limits = np.array([ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()])
    centers = limits.mean(axis=1)
    radius = 0.5 * (limits[:, 1] - limits[:, 0]).max()
    ax.set_xlim3d([centers[0] - radius, centers[0] + radius])
    ax.set_ylim3d([centers[1] - radius, centers[1] + radius])
    ax.set_zlim3d([centers[2] - radius, centers[2] + radius])


def vis_img_2Djoint(
    batch_img: Optional[np.ndarray],
    joints: np.ndarray,
    pairs=None,
    joint_group=None,
    max_show: int = 2,
) -> np.ndarray:
    """2D joint scatter grid (reference vis.py:485-541): optional image row
    on top, joint scatter (grouped colors) + dotted bones below.
    Returns the rendered figure as an RGB uint8 array."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    n = min(joints.shape[0], max_show)
    joints = joints[:n]
    rows = 2 if batch_img is not None else 1
    fig = plt.figure(figsize=(3 * n, 3 * rows))
    for i in range(n):
        if batch_img is not None:
            ax_img = fig.add_subplot(rows, n, i + 1)
            ax_img.imshow(np.clip(batch_img[i], 0, 1))
            ax_img.set_axis_off()
            ax = fig.add_subplot(rows, n, n + i + 1)
        else:
            ax = fig.add_subplot(rows, n, i + 1)
        kp = joints[i]
        if joint_group is None:
            ax.scatter(kp[:, 0], kp[:, 1], s=300, c=_JOINT_COLORS[0], marker=".")
        else:
            for j, g in enumerate(joint_group):
                ax.scatter(kp[g, 0], kp[g, 1], s=100,
                           c=_JOINT_COLORS[j % len(_JOINT_COLORS)], marker="o")
        if pairs is not None:
            for p in pairs:
                ax.plot(kp[list(p), 0], kp[list(p), 1],
                        c=_JOINT_COLORS[_group_of(p[1], joint_group) % len(_JOINT_COLORS)],
                        linestyle=":", linewidth=3)
        ax.set_axis_off()
        ax.set_aspect("equal")
        ax.invert_yaxis()  # image convention: y grows downward
    out = _fig_to_rgb(fig)
    plt.close(fig)
    return out


def vis_img_3Djoint(
    batch_img: Optional[np.ndarray],
    joints: np.ndarray,
    pairs=None,
    joint_group=None,
    max_show: int = 2,
) -> np.ndarray:
    """3D joint scatter grid (reference vis.py:427-482): scatter in
    (z, x, y) axes order as the reference plots, grouped colors, bones,
    equal axes. Returns an RGB uint8 array."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    n = min(joints.shape[0], max_show)
    joints = joints[:n]
    rows = 2 if batch_img is not None else 1
    fig = plt.figure(figsize=(3 * n, 3 * rows))
    for i in range(n):
        if batch_img is not None:
            ax_img = fig.add_subplot(rows, n, i + 1)
            ax_img.imshow(np.clip(batch_img[i], 0, 1))
            ax_img.set_axis_off()
            ax = fig.add_subplot(rows, n, n + i + 1, projection="3d")
        else:
            ax = fig.add_subplot(rows, n, i + 1, projection="3d")
        kp = joints[i]
        if joint_group is None:
            ax.scatter(kp[:, 2], kp[:, 0], kp[:, 1], s=10, marker=".")
            ax.scatter(kp[0, 2], kp[0, 0], kp[0, 1], s=10, c="g", marker=".")
        else:
            for j, g in enumerate(joint_group):
                ax.scatter(kp[g, 2], kp[g, 0], kp[g, 1], s=30,
                           c=_JOINT_COLORS[j % len(_JOINT_COLORS)], marker="s")
        if pairs is not None:
            for p in pairs:
                ax.plot(kp[list(p), 2], kp[list(p), 0], kp[list(p), 1],
                        c=_JOINT_COLORS[_group_of(p[1], joint_group) % len(_JOINT_COLORS)],
                        linewidth=2)
        set_axes_equal(ax)
        ax.set_xticks([]), ax.set_yticks([]), ax.set_zticks([])
    out = _fig_to_rgb(fig)
    plt.close(fig)
    return out


def vis_smpl_iuv(
    image: np.ndarray,
    cam_t: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    pred_uv,
    vert_errors: np.ndarray,
    image_names: Sequence[str],
    save_path: str,
    focal_length: float = 5000.0,
) -> list:
    """Per-sample [image | mesh overlay | predicted IUV] panels
    (reference uv_vis.py:68-112, pyrender/OpenDR replaced by the native
    scanline renderer). Saves one png per sample named
    '{10*PVE:06d}_{image_name}.png' like the reference; returns the paths.

    Args:
      image: (B, H, W, 3) uint8 RGB crops.
      cam_t: (B, 3) full-image camera translations.
      verts: (B, 6890, 3) camera-frame vertices.
      pred_uv: (u_map, v_map, index_map[, ann_map]) one-hot stacks
        (B, h, w, C) or None.
      vert_errors: (B,) per-sample vertex errors (mm).
    """
    import os

    import numpy as _np

    import torch

    from whmr_tpu_torch.inference.renderer import render_overlay

    os.makedirs(save_path, exist_ok=True)
    iuv_imgs = None
    if pred_uv is not None:
        from whmr_tpu_torch.ops.iuv import iuv_map2img

        iuv_imgs = iuv_map2img(*[torch.as_tensor(_np.asarray(m)) for m in pred_uv]).numpy()

    out_paths = []
    b, h, w = image.shape[:3]
    for i in range(b):
        name = os.path.splitext(os.path.basename(str(image_names[i])))[0]
        draw_name = "{:06d}_{}".format(int(10 * float(vert_errors[i])), name)
        overlay = render_overlay(
            image[i], [verts[i]], [cam_t[i]], faces, [focal_length]
        )
        panels = [image[i], overlay]
        if iuv_imgs is not None:
            iuv_rgb = iuv_to_rgb(iuv_imgs[i])
            panels.append(cv2.resize(iuv_rgb, (w, h),
                                     interpolation=cv2.INTER_NEAREST))
        panel = np.concatenate(panels, axis=1)
        path = os.path.join(save_path, draw_name + ".png")
        cv2.imwrite(path, panel[:, :, ::-1])
        out_paths.append(path)
    return out_paths
