"""npz-label training/eval datasets (reference-format) + mixture sampling.

A copy of `whmr_tpu/data/npz_dataset.py` (the port imports nothing of
whmr_tpu): samples are numpy dicts, equal array by array to whmr_tpu's, for
the port's `data/loader.py::BatchLoader`.

Reads the same label schema as the reference (`datasets/base_dataset.py:31-158`:
imgname/center/scale/pose/shape/S/part/openpose/gender/has_smpl) and emits
the same per-sample dict (`__getitem__`, base_dataset.py:249-384), with the
vitpose 256->192 width slice applied at batch level.

The weighted multi-dataset mixture replicates `datasets/mixed_dataset.py:
13-123` (11 datasets, fixed ratios, virtual epoch length) as a generic
weighted sampler.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import cv2
import numpy as np

logger = logging.getLogger(__name__)


def _derived_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    """Deterministic per-(seed, epoch, index) generator.

    The reference mutates one shared `np.random` stream from DataLoader
    workers, so its augmentation draws are neither reproducible nor
    well-defined under threading; deriving an independent stream per sample
    is both (and is what the loader's worker THREADS require — RandomState
    is not thread-safe to share).
    """
    mix = np.uint32(
        (seed * 1_000_003 + epoch * 8_191 + index * 2_654_435_761) % (2**31 - 1)
    )
    return np.random.RandomState(mix)

from whmr_tpu_torch.config import WHMRConfig
from whmr_tpu_torch.data import augment as A

# Reference mixture (mixed_dataset.py:21-64): dataset name -> weight.
MIXTURE_WEIGHTS = {
    "h36m": 0.07,
    "mpii-vitpose": 0.05,
    "coco-prune": 0.05,
    "coco-vitpose-prune": 0.05,
    "mpi-inf-3dhp": 0.02,
    "ava": 0.18,
    "aic": 0.18,
    "insta": 0.19,
    "agora_1280x720": 0.07,
    "3dpw": 0.07,
    "humman": 0.07,
}
MIXTURE_LENGTH = 165_000  # virtual epoch length (mixed_dataset.py:66)


class NpzDataset:
    """One npz-label dataset; returns numpy sample dicts."""

    def __init__(
        self,
        cfg: WHMRConfig,
        npz_path: str,
        img_dir: str,
        name: str = "dataset",
        is_train: bool = True,
        use_augmentation: bool = True,
        occluders: Optional[Sequence[np.ndarray]] = None,
        noise_factor: float = 0.4,
        rot_factor: float = 30.0,
        scale_factor: float = 0.25,
        seed: int = 0,
        cache_images: bool = False,
        device_norm: bool = False,
    ):
        self.cfg = cfg
        self.name = name
        self.img_dir = img_dir
        self.is_train = is_train
        self.use_augmentation = use_augmentation and is_train
        self.occluders = occluders
        self.noise_factor = noise_factor
        self.rot_factor = rot_factor
        self.scale_factor = scale_factor
        self.seed = seed
        self.epoch = 0
        # device_norm: ship the crop as uint8 + the (3,) channel-noise
        # factors and let the train graph normalize
        # (train_step.device_normalize) — 4x less host->device traffic.
        # Train-only schema: the
        # eval/demo entry points expect host-normalized f32.
        self.device_norm = device_norm and is_train
        # Decoded-RGB memo for small datasets (e.g. overfit regressions):
        # on a host with few cores the PNG decode dominates the feed path.
        # Keyed by index; benign races under threads (worst case
        # re-decode), per-process under fork workers.
        self._img_cache: Optional[dict] = {} if cache_images else None

        data = np.load(npz_path, allow_pickle=True)
        self.imgname = data["imgname"]
        self.center = data["center"].astype(np.float32)
        self.scale = data["scale"].astype(np.float32)
        n = len(self.imgname)

        if "pose" in data and "shape" in data:
            self.pose = data["pose"].astype(np.float32)
            self.betas = data["shape"].astype(np.float32)
            self.has_smpl = data["has_smpl"].astype(np.float32) if "has_smpl" in data else np.ones(n, np.float32)
        else:
            self.pose = np.zeros((n, 72), np.float32)
            self.betas = np.zeros((n, 10), np.float32)
            self.has_smpl = np.zeros(n, np.float32)

        if "S" in data:
            self.pose_3d = data["S"].astype(np.float32)
            self.has_pose_3d = 1
        else:
            self.pose_3d = np.zeros((n, 24, 4), np.float32)
            self.has_pose_3d = 0

        part = data["part"] if "part" in data else np.zeros((n, 24, 3))
        openpose = data["openpose"] if "openpose" in data else np.zeros((n, 25, 3))
        self.keypoints = np.concatenate([openpose, part], axis=1).astype(np.float32)

        if "gender" in data:
            self.gender = np.array(
                [0 if str(g) == "m" else 1 for g in data["gender"]], np.int32
            )
        else:
            self.gender = -np.ones(n, np.int32)

        # Eval-protocol extras (reference eval-dataset variants,
        # datasets/__init__.py:1-6): per-sample GT camera rotation and
        # world-frame pose (evaluate/eval.py:157-179) and detector scores
        # (evaluate/base_dataset.py:119,333 for AGORA crops).
        self.cam_rotmat = data["cam_rotmat"].astype(np.float32) if "cam_rotmat" in data else None
        self.global_pose = data["global_pose"].astype(np.float32) if "global_pose" in data else None
        self.det_score = data["det_score"].astype(np.float32) if "det_score" in data else None

    def __len__(self):
        return len(self.imgname)

    def set_epoch(self, epoch: int):
        """Advance the per-sample rng streams (fresh draws each epoch)."""
        self.epoch = int(epoch)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        # TRAINING: an unreadable image is warned about and a neighboring
        # sample substituted so one corrupt file cannot kill the epoch (the
        # reference only logs and then crashes, base_dataset.py:270-277 —
        # strictly worse). EVAL: substitution would silently score a
        # neighbor twice and skew benchmark metrics, so fail loudly instead.
        return self.get_with_rng(index, None)

    def get_with_rng(
        self, index: int, rng: Optional[np.random.RandomState]
    ) -> Dict[str, np.ndarray]:
        """Fetch a sample, drawing augmentation from `rng` (None = derive
        the per-(seed, epoch, index) stream). MixtureDataset passes its
        own per-DRAW stream here: with replacement sampling, the same
        underlying sample can be drawn at several mixture indices per
        epoch, and deriving from the INNER index alone would hand every
        such draw bit-identical augmentation (and, with equal seeds, even
        share streams across member datasets)."""
        if not self.is_train:
            return self._load_item(index, rng)
        last_err: Optional[Exception] = None
        for attempt in range(8):
            i = (index + attempt) % len(self)
            try:
                return self._load_item(i, rng)
            except FileNotFoundError as e:
                logger.warning("fail while loading %s; trying next sample", e)
                last_err = e
        raise last_err  # 8 consecutive unreadable files: give up loudly

    def _load_item(
        self, index: int, rng: Optional[np.random.RandomState] = None
    ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        res = cfg.img_res  # (W, H)
        scale = float(self.scale[index])
        center = self.center[index].copy()
        scale_orig, center_orig = scale, center.copy()
        if rng is None:
            rng = _derived_rng(self.seed, self.epoch, index)

        if self.use_augmentation:
            p = A.AugmentParams.sample(
                rng, self.noise_factor, self.rot_factor, self.scale_factor
            )
        else:
            p = A.AugmentParams(0, np.ones(3), 0.0, 1.0)
        scale = p.sc * scale

        cache = self._img_cache
        if cache is not None and index in cache:
            img = cache[index]
        else:
            img_path = os.path.join(self.img_dir, str(self.imgname[index]))
            img = cv2.imread(img_path)
            if img is None:
                raise FileNotFoundError(img_path)
            # Stay in uint8 through crop/flip/occlude/jitter — the REFERENCE
            # quantizes the crop to uint8 too (imutils.crop:87 resizes via
            # PIL.Image.fromarray(new_img.astype(np.uint8))), and skipping
            # the full-image f32 conversion removes the largest astype copy
            # in the loader hot path.
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            if cache is not None:
                cache[index] = img
        orig_shape = np.array(img.shape[:2], np.float32)

        # rgb processing (base_dataset.py:184-208); a failed augmented crop
        # retries with the original bbox (base_dataset.py:281-287).
        try:
            crop = A.crop_image(img, center, scale, res, rot=p.rot)
        except Exception:  # noqa: BLE001 — reference catches bare `except`
            center, scale = center_orig, scale_orig
            crop = A.crop_image(img, center, scale, res, rot=p.rot)
        if p.flip:
            crop = np.fliplr(crop)
        # Both stochastic appearance augs ride the use_augmentation toggle
        # so `use_augmentation=False` yields fully deterministic samples
        # (the overfit-regression protocol, VERDICT r3 item 1).
        if self.occluders is not None and self.use_augmentation:
            crop = A.occlude_with_objects(crop, self.occluders, rng)
        if self.use_augmentation:
            crop = A.color_jitter(crop, rng)
        # Slice to the vitpose width BEFORE the per-pixel finalization:
        # elementwise noise/normalization commutes with slicing (exact),
        # and 25% of the pixels are dropped anyway (:291-292). color_jitter
        # must stay pre-slice — its contrast term uses the full-crop mean.
        if cfg.pymaf.backbone == "vitpose":
            crop = crop[:, 32:-32]  # 256x256 -> 256x192 (:291-292)
        if self.device_norm:
            img_out = np.ascontiguousarray(crop)  # uint8; noise+norm on device
        else:
            img_out = np.asarray(A.finalize_crop(crop, p.pn), np.float32)

        pose = (
            A.pose_processing(self.pose[index], p.rot, p.flip)
            if self.has_smpl[index]
            else np.zeros(72, np.float32)
        )
        keypoints = A.j2d_processing(
            self.keypoints[index], center, scale, res, p.rot, p.flip
        )
        if self.has_pose_3d:
            pose_3d = A.j3d_processing(self.pose_3d[index], p.rot, p.flip)
        else:
            pose_3d = np.zeros((24, 4), np.float32)

        # World keypoints: crop-normalized -> full-image normalized
        # (base_dataset.py:326-342).
        ul, br = A.get_crop_shape(center, scale, res, p.rot)
        bbox_res = np.array([br[0] - ul[0], br[1] - ul[1]], np.float32)
        kp_orig = keypoints.copy()
        kp_orig[:, :2] = 0.5 * bbox_res * (kp_orig[:, :2] + 1.0) + ul
        img_wh = orig_shape[[1, 0]]
        kp_world = kp_orig.copy()
        kp_world[:, :2] = 2.0 * kp_orig[:, :2] / img_wh - 1.0

        new_center = (ul + br) / 2.0
        focal = np.sqrt(np.sum(orig_shape**2)).astype(np.float32)
        img_center = img_wh / 2.0
        bbox_info = np.array(
            [
                new_center[0] - img_center[0],
                new_center[1] - img_center[1],
                bbox_res[1],
                img_wh[0],
                img_wh[1],
            ],
            np.float32,
        ) / focal

        # 431-vertex BERT-style visibility mask (base_dataset.py:345-355).
        mvm_mask = np.ones((431, 1), np.float32)
        if self.is_train:
            pb = rng.random_sample()
            masked = int(pb * 0.3 * 431)
            idx = rng.choice(431, replace=False, size=masked)
            mvm_mask[idx] = 0.0

        extras = {}
        if self.device_norm:
            extras["pixel_noise"] = p.pn.astype(np.float32)
        if self.cam_rotmat is not None:
            extras["cam_rotmat"] = self.cam_rotmat[index]
        if self.global_pose is not None:
            extras["global_pose"] = self.global_pose[index]
        if self.det_score is not None:
            extras["det_score"] = self.det_score[index]

        return {
            **extras,
            "img": img_out,
            "pose": pose,
            "betas": self.betas[index].astype(np.float32),
            "keypoints": keypoints,
            "keypoints_world": kp_world.astype(np.float32),
            "pose_3d": pose_3d,
            "meta_mask": mvm_mask,
            "has_smpl": np.float32(self.has_smpl[index]),
            "has_pose_3d": np.float32(self.has_pose_3d),
            "scale": np.float32(scale),
            "center": new_center.astype(np.float32),
            "orig_shape": orig_shape,
            "is_flipped": np.float32(p.flip),
            "rot_angle": np.float32(p.rot),
            "gender": self.gender[index],
            "sample_index": np.int32(index),
            "bbox_height": np.float32(bbox_res[1]),
            "bbox_width": np.float32(bbox_res[0]),
            "focal": focal,
            "bbox_info": bbox_info,
        }


class MixtureDataset:
    """Weighted multi-dataset sampler (reference mixed_dataset.py:13-123)."""

    def __init__(
        self,
        datasets: Sequence[NpzDataset],
        weights: Optional[Sequence[float]] = None,
        length: int = MIXTURE_LENGTH,
        seed: int = 0,
    ):
        self.datasets = list(datasets)
        w = np.asarray(
            weights
            if weights is not None
            else [MIXTURE_WEIGHTS.get(d.name, 1.0) for d in self.datasets],
            np.float64,
        )
        self.weights = w / w.sum()
        self.length = length
        self.seed = seed
        self.epoch = 0
        # Cumulative partition bounds, as in mixed_dataset.py:66-89.
        self.partition = np.cumsum(self.weights)

    def __len__(self):
        return self.length

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        # index -> dataset via the ratio partition (mixed_dataset.py:116-120)
        frac = float(index) / self.length
        d_idx = int(np.searchsorted(self.partition, frac, side="right"))
        d_idx = min(d_idx, len(self.datasets) - 1)
        ds = self.datasets[d_idx]
        rng = _derived_rng(self.seed, self.epoch, index)
        inner = rng.randint(len(ds))
        # Continue THIS stream for the augmentation draws: it is unique per
        # (seed, epoch, MIXTURE index), so repeated with-replacement draws
        # of the same inner sample get fresh augmentation (the reference's
        # shared np.random stream gives every draw fresh randomness too;
        # deriving inside the member dataset from the inner index would not)
        return ds.get_with_rng(inner, rng)
