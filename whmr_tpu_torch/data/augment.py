"""Host-side data augmentation: crop/flip/rotate/noise/occlusion.

A copy of `whmr_tpu/data/augment.py` (the port imports nothing of whmr_tpu):
the same numpy and cv2 calls, so on one host both give the same bits.

Numpy/cv2 equivalents of the reference augmentation stack
(`utils/imutils.py` crop math :12-133, flips :148-180;
`datasets/base_dataset.py` augm_params :152-182, rgb/j2d/j3d/pose
processing :184-247). One deliberate improvement: crop+rotation is a single
cv2.warpAffine with the composed affine matrix instead of the reference's
pad -> skimage.rotate -> un-pad -> PIL-resize chain — same geometry, one
resampling pass.

These run on the host (CPU) inside loader workers; the device-side pipeline
receives ready (H, W, 3) float crops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import cv2
import numpy as np

from whmr_tpu_torch.config import IMG_NORM_MEAN, IMG_NORM_STD

# Flip permutations (reference core/constants.py:106-118).
SMPL_JOINTS_FLIP_PERM = [0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16, 19, 18, 21, 20, 23, 22]
SMPL_POSE_FLIP_PERM = []
for _i in SMPL_JOINTS_FLIP_PERM:
    SMPL_POSE_FLIP_PERM.extend([3 * _i, 3 * _i + 1, 3 * _i + 2])
J24_FLIP_PERM = [5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 15, 16, 17, 18, 19, 21, 20, 23, 22]
J49_FLIP_PERM = [0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15, 18, 17, 22, 23, 24, 19, 20, 21] + [
    25 + i for i in J24_FLIP_PERM
]
SMPL_J49_FLIP_PERM = [0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15, 18, 17, 22, 23, 24, 19, 20, 21] + [
    25 + i for i in SMPL_JOINTS_FLIP_PERM
]


def get_transform(center, scale, res, rot=0) -> np.ndarray:
    """Crop-box affine matrix (reference imutils.py:12-36). res = (W, H)."""
    h = 200 * scale
    t = np.zeros((3, 3))
    t[0, 0] = float(res[0]) / h
    t[1, 1] = float(res[1]) / h
    t[0, 2] = res[0] * (-float(center[0]) / h + 0.5)
    t[1, 2] = res[1] * (-float(center[1]) / h + 0.5)
    t[2, 2] = 1
    if rot != 0:
        rot = -rot
        rot_mat = np.zeros((3, 3))
        rot_rad = rot * np.pi / 180
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        rot_mat[2, 2] = 1
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[0] / 2
        t_mat[1, 2] = -res[1] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def transform_point(pt, center, scale, res, invert=0, rot=0) -> np.ndarray:
    """Transform one pixel location (reference imutils.py:38-45)."""
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = np.array([pt[0] - 1, pt[1] - 1, 1.0])
    new_pt = t @ new_pt
    return (new_pt[:2].astype(int) + 1).astype(np.int64)


def get_crop_shape(center, scale, res, rot=0):
    """Crop corners (ul, br) in original-image pixels (imutils.py:92-105)."""
    ul = np.array(transform_point([1, 1], center, scale, res, invert=1)) - 1
    br = np.array(transform_point([res[0] + 1, res[1] + 1], center, scale, res, invert=1)) - 1
    pad = int(np.linalg.norm(br - ul) / 2 - float(br[1] - ul[1]) / 2)
    if rot != 0:
        ul -= pad
        br += pad
    return ul, br


def crop_image(img: np.ndarray, center, scale, res, rot=0, nearest=False) -> np.ndarray:
    """Affine crop to res=(W, H) with optional in-plane rotation.

    Geometry matches reference imutils.crop (:54-90); implemented as one
    warpAffine of the composed transform. `nearest=True` for label images
    (part-segmentation maps) where interpolation must not blend classes.
    """
    t = get_transform(center, scale, res, rot=rot)
    # The reference's pixel convention: output pixel (x, y) samples input at
    # inv(t) @ (x, y). warpAffine expects the forward map matrix.
    m = t[:2, :]
    return cv2.warpAffine(
        img, m, (int(res[0]), int(res[1])),
        flags=cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=0,
    )


def rot_aa(aa: np.ndarray, rot: float) -> np.ndarray:
    """Rotate global-orient axis-angle by the crop rotation (imutils.py:135-146)."""
    if rot == 0:
        return aa
    r = np.array(
        [
            [np.cos(np.deg2rad(-rot)), -np.sin(np.deg2rad(-rot)), 0],
            [np.sin(np.deg2rad(-rot)), np.cos(np.deg2rad(-rot)), 0],
            [0, 0, 1],
        ]
    )
    per_rdg, _ = cv2.Rodrigues(aa)
    resrot, _ = cv2.Rodrigues(r @ per_rdg)
    return resrot.T[0]


def flip_kp(kp: np.ndarray, is_smpl: bool = False) -> np.ndarray:
    """Flip keypoints (imutils.py:156-170)."""
    if len(kp) == 24:
        perm = SMPL_JOINTS_FLIP_PERM if is_smpl else J24_FLIP_PERM
    elif len(kp) == 49:
        perm = SMPL_J49_FLIP_PERM if is_smpl else J49_FLIP_PERM
    else:
        raise ValueError(f"unsupported keypoint count {len(kp)}")
    kp = kp[perm].copy()
    kp[:, 0] = -kp[:, 0]
    return kp


def flip_pose(pose: np.ndarray) -> np.ndarray:
    """Flip 72-d SMPL pose (imutils.py:172-182)."""
    pose = pose[SMPL_POSE_FLIP_PERM].copy()
    pose[1::3] = -pose[1::3]
    pose[2::3] = -pose[2::3]
    return pose


@dataclass
class AugmentParams:
    flip: int = 0
    pn: np.ndarray = None  # (3,) channel noise
    rot: float = 0.0
    sc: float = 1.0

    @staticmethod
    def sample(
        rng: np.random.RandomState,
        noise_factor: float = 0.4,
        rot_factor: float = 30.0,
        scale_factor: float = 0.25,
        is_train: bool = True,
    ) -> "AugmentParams":
        """Reference augm_params (base_dataset.py:152-182)."""
        if not is_train:
            return AugmentParams(0, np.ones(3), 0.0, 1.0)
        flip = 1 if rng.uniform() <= 0.5 else 0
        pn = rng.uniform(1 - noise_factor, 1 + noise_factor, 3)
        rot = 0.0
        if rng.uniform() > 0.6:
            rot = min(2 * rot_factor, max(-2 * rot_factor, rng.randn() * rot_factor))
        sc = min(1 + scale_factor, max(1 - scale_factor, rng.randn() * scale_factor + 1))
        return AugmentParams(flip, pn, rot, sc)


def occlude_with_objects(
    img: np.ndarray, occluders: Sequence[np.ndarray], rng: np.random.RandomState
) -> np.ndarray:
    """Synthetic occlusion paste (pare's occlude_with_pascal_objects
    equivalent, used at base_dataset.py:192-194): paste 1-8 RGBA cutouts at
    random positions/scales."""
    result = img.copy()
    width_height = np.array([img.shape[1], img.shape[0]])
    count = rng.randint(1, 8)
    for _ in range(count):
        occ = occluders[rng.randint(len(occluders))]
        scale_factor = rng.uniform(0.2, 1.0) * 0.5 * width_height.min() / max(occ.shape[:2])
        occ_s = cv2.resize(
            occ, None, fx=scale_factor, fy=scale_factor, interpolation=cv2.INTER_AREA
        )
        if occ_s.ndim == 2:
            occ_s = occ_s[..., None]
        center = rng.uniform(0, width_height, 2).astype(int)
        paste_over(occ_s, result, center)
    return result


def paste_over(im_src: np.ndarray, im_dst: np.ndarray, center) -> None:
    """Alpha-paste im_src (RGBA or RGB) over im_dst in place at center."""
    wh_src = np.array([im_src.shape[1], im_src.shape[0]])
    wh_dst = np.array([im_dst.shape[1], im_dst.shape[0]])
    raw_start = center - wh_src // 2
    raw_end = raw_start + wh_src
    start = np.clip(raw_start, 0, wh_dst)
    end = np.clip(raw_end, 0, wh_dst)
    region_dst = im_dst[start[1]:end[1], start[0]:end[0]]
    if region_dst.size == 0:
        return
    s0 = start - raw_start
    e0 = s0 + (end - start)
    region_src = im_src[s0[1]:e0[1], s0[0]:e0[0]]
    if region_src.shape[2] == 4:
        alpha = region_src[..., 3:4].astype(np.float32) / 255.0
        im_dst[start[1]:end[1], start[0]:end[0]] = (
            alpha * region_src[..., :3] + (1 - alpha) * region_dst
        ).astype(im_dst.dtype)
    else:
        im_dst[start[1]:end[1], start[0]:end[0]] = region_src[..., :3]


def random_occluders(rng: np.random.RandomState, n: int = 16) -> list:
    """Deterministic synthetic occluder set (textured RGBA blobs) used when
    the PASCAL VOC cutouts are unavailable."""
    occluders = []
    for _ in range(n):
        h, w = rng.randint(24, 96, 2)
        rgba = np.zeros((h, w, 4), np.uint8)
        rgba[..., :3] = rng.randint(0, 255, (h, w, 3))
        yy, xx = np.mgrid[0:h, 0:w]
        mask = ((yy / h - 0.5) ** 2 + (xx / w - 0.5) ** 2) < 0.25
        rgba[..., 3] = mask * 255
        occluders.append(rgba)
    return occluders


def _shift_hue(img_f32: np.ndarray, hue_factor: float) -> np.ndarray:
    """Cyclic hue shift by hue_factor*180 degrees (HSV H channel)."""
    x = np.clip(img_f32, 0, 255).astype(np.uint8)
    hsv = cv2.cvtColor(x, cv2.COLOR_RGB2HSV)
    # cv2 uint8 hue lives in [0, 180)
    h = (hsv[..., 0].astype(np.int32) + int(round(hue_factor * 180.0))) % 180
    hsv[..., 0] = h.astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)


def color_jitter(
    img: np.ndarray, rng: np.random.RandomState, p: float = 0.2
) -> np.ndarray:
    """Color jitter matching the reference recipe (base_dataset.py:198:
    albumentations ColorJitter(brightness=(0.2,0.4), contrast=(0.3,0.5),
    p=0.2)) INCLUDING its defaulted arguments: saturation=0.2 and hue=0.2
    stay at their torchvision-convention defaults, so saturation factors
    in [0.8, 1.2] and hue shifts in [-0.2, 0.2] are jittered too, and the
    four transforms apply in random order. `img` is RGB (uint8 or float
    in [0, 255]).

    Transform semantics (torchvision/albumentations definitions):
      brightness: img * b
      contrast:   img * c + mean(grayscale(img)) * (1 - c)
      saturation: img * s + grayscale(img) * (1 - s)   (per pixel)
      hue:        HSV hue channel shifted by h * 180 degrees, wrapped
    """
    if rng.uniform() > p:
        return img
    b = rng.uniform(0.2, 0.4)
    c = rng.uniform(0.3, 0.5)
    s = rng.uniform(0.8, 1.2)
    h = rng.uniform(-0.2, 0.2)

    def gray(x):
        # ITU-R 601 luma, the torchvision rgb_to_grayscale weighting
        return x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114

    ops = [
        lambda x: x * b,
        lambda x: x * c + float(gray(np.clip(x, 0, 255)).mean()) * (1.0 - c),
        lambda x: x * s + gray(x)[..., None] * (1.0 - s),
        lambda x: _shift_hue(x, h),
    ]
    out = img.astype(np.float32)
    for i in rng.permutation(4):
        out = ops[int(i)](out)
    return np.clip(out, 0, 255).astype(img.dtype)


def apply_channel_noise(img: np.ndarray, pn: np.ndarray) -> np.ndarray:
    """Channel-wise multiplicative noise (base_dataset.py:202-205)."""
    return np.clip(img * pn[None, None, :], 0, 255)


def normalize_image(img01: np.ndarray) -> np.ndarray:
    """(H, W, 3) [0,1] float -> normalized by ImageNet stats (NHWC)."""
    mean = np.asarray(IMG_NORM_MEAN, np.float32)
    std = np.asarray(IMG_NORM_STD, np.float32)
    return (img01 - mean) / std


def finalize_crop(crop: np.ndarray, pn: np.ndarray) -> np.ndarray:
    """Fused channel-noise + [0,1] + ImageNet normalization.

    Same op order as apply_channel_noise(crop, pn)/255 -> normalize_image
    (*pn, clip, /255, -mean, /std) but computed in f32 throughout with
    in-place passes and no astype copies; the unfused chain accidentally
    upcast to f64 via the f64 noise factors, so results differ by <=1 ulp
    of f32. This chain is a large share of the host's per-item cost."""
    mean = np.asarray(IMG_NORM_MEAN, np.float32)
    std = np.asarray(IMG_NORM_STD, np.float32)
    out = crop * pn[None, None, :].astype(np.float32)
    np.clip(out, 0, 255, out=out)
    out /= 255.0
    out -= mean
    out /= std
    return out


def j2d_processing(kp, center, scale, res, rot, flip, is_smpl=False):
    """GT 2D keypoints -> crop frame, normalized [-1,1] (base_dataset.py:211-223)."""
    kp = kp.copy()
    t = get_transform(center, scale, res, rot=rot)
    # Vectorized version of reference transform() incl. its int truncation:
    # input (x+1)-1 = x, output int(.)+1 per coordinate (imutils.py:38-45
    # called with kp+1 at base_dataset.py:214).
    hom = np.concatenate([kp[:, :2], np.ones((kp.shape[0], 1))], axis=1)
    proj = hom @ t.T
    kp[:, :2] = proj[:, :2].astype(int) + 1
    kp[:, :-1] = 2.0 * kp[:, :-1] / np.asarray(res) - 1.0
    if flip:
        kp = flip_kp(kp, is_smpl)
    return kp.astype(np.float32)


def j3d_processing(s, rot, flip, is_smpl=False):
    """GT 3D keypoints: in-plane rotation + flip (base_dataset.py:225-239)."""
    s = s.copy()
    rot_mat = np.eye(3)
    if rot != 0:
        rot_rad = -rot * np.pi / 180
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
    s[:, :-1] = np.einsum("ij,kj->ki", rot_mat, s[:, :-1])
    if flip:
        s = flip_kp(s, is_smpl)
    return s.astype(np.float32)


def pose_processing(pose, rot, flip):
    """72-d SMPL pose: rotate global orient + flip (base_dataset.py:241-249)."""
    pose = pose.copy()
    pose[:3] = rot_aa(pose[:3], rot)
    if flip:
        pose = flip_pose(pose)
    return pose.astype(np.float32)


def uncrop_image(img: np.ndarray, center, scale, orig_shape) -> np.ndarray:
    """Invert the crop/resize back to the original frame (imutils.py:107-133):
    used for mask/part-segmentation evaluation."""
    res = (img.shape[1], img.shape[0])
    ul = np.array(transform_point([1, 1], center, scale, res, invert=1)) - 1
    br = np.array(transform_point([res[0] + 1, res[1] + 1], center, scale, res, invert=1)) - 1
    crop_shape = (int(br[0] - ul[0]), int(br[1] - ul[1]))
    new_img = np.zeros(tuple(orig_shape[:2]) + img.shape[2:], dtype=img.dtype)
    resized = cv2.resize(img, crop_shape, interpolation=cv2.INTER_LINEAR)
    new_x = max(0, -ul[0]), min(br[0], orig_shape[1]) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], orig_shape[0]) - ul[1]
    old_x = max(0, ul[0]), min(orig_shape[1], br[0])
    old_y = max(0, ul[1]), min(orig_shape[0], br[1])
    new_img[old_y[0]:old_y[1], old_x[0]:old_x[1]] = resized[new_y[0]:new_y[1], new_x[0]:new_x[1]]
    return new_img
