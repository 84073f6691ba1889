"""Per-sample best-fit SMPL pseudo-ground-truth store (SPIN heritage).

A copy of `whmr_tpu/data/fits_dict.py` (the port imports nothing of
whmr_tpu).

Equivalent of reference `core/fits_dict.py:16-121` (instantiation is
commented out in the shipped trainer, trainer.py:156 — kept as part of the
capability surface): a per-dataset table of fitted (pose 72, betas 10)
pseudo-GT, read with flip/rotation equivariance matching the augmentation
applied to the sample, writable when the network produces a better fit.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

from whmr_tpu_torch.data.augment import SMPL_POSE_FLIP_PERM, rot_aa


class FitsDict:
    def __init__(self, fits_dir: str, dataset_names: Sequence[str], dataset_sizes: Dict[str, int]):
        """Load per-dataset fits; missing files start as invalid zeros."""
        self.fits: Dict[str, np.ndarray] = {}
        self.valid: Dict[str, np.ndarray] = {}
        for name in dataset_names:
            npz_path = os.path.join(fits_dir, f"{name}.npz")
            npy_path = os.path.join(fits_dir, f"{name}.npy")
            n = dataset_sizes[name]
            if os.path.exists(npz_path):
                data = np.load(npz_path)
                self.fits[name] = np.concatenate(
                    [data["pose"], data["betas"]], axis=1
                ).astype(np.float32)
                self.valid[name] = data["valid_fit"].astype(np.uint8)
            elif os.path.exists(npy_path):
                self.fits[name] = np.load(npy_path).astype(np.float32)
                self.valid[name] = np.ones(n, np.uint8)
            else:
                self.fits[name] = np.zeros((n, 82), np.float32)
                self.valid[name] = np.zeros(n, np.uint8)

    def get(
        self,
        dataset_name: Sequence[str],
        indices: Sequence[int],
        rot: Sequence[float],
        is_flipped: Sequence[bool],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Read fits with the sample's augmentation applied (fits_dict.py:53-66)."""
        n = len(indices)
        pose = np.zeros((n, 72), np.float32)
        betas = np.zeros((n, 10), np.float32)
        for k, (ds, i) in enumerate(zip(dataset_name, indices)):
            params = self.fits[ds][int(i)]
            p = params[:72].copy()
            p[:3] = rot_aa(p[:3], float(rot[k]))
            if is_flipped[k]:
                p = p[SMPL_POSE_FLIP_PERM]
                p[1::3] = -p[1::3]
                p[2::3] = -p[2::3]
            pose[k] = p
            betas[k] = params[72:]
        return pose, betas

    def get_valid_state(self, dataset_name, indices) -> np.ndarray:
        return np.array(
            [self.valid[ds][int(i)] for ds, i in zip(dataset_name, indices)], np.uint8
        )

    def update(self, dataset_name, indices, rot, is_flipped, pose, betas, valid):
        """Write back improved fits, undoing the augmentation
        (inverse of get: un-flip then un-rotate; fits_dict.py:75-100)."""
        for k, (ds, i) in enumerate(zip(dataset_name, indices)):
            if not valid[k]:
                continue
            p = np.asarray(pose[k], np.float32).copy()
            if is_flipped[k]:
                p = p[SMPL_POSE_FLIP_PERM]
                p[1::3] = -p[1::3]
                p[2::3] = -p[2::3]
            p[:3] = rot_aa(p[:3], -float(rot[k]))
            self.fits[ds][int(i), :72] = p
            self.fits[ds][int(i), 72:] = betas[k]
            self.valid[ds][int(i)] = 1

    def save(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        for name, arr in self.fits.items():
            np.save(os.path.join(out_dir, f"{name}_fits.npy"), arr)
