"""Video/tracking utilities: smooth bbox trajectories, one-Euro filtering.

A copy of `whmr_tpu/utils/tracking.py` for the port. Equivalent of reference `utils/smooth_bbox.py:9-121` (keypoint-derived bbox
params, interpolation over missing frames, median + gaussian smoothing) and
the one-Euro smoothing used by the dormant video path. Host-side numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter1d
from scipy.signal import medfilt


def kp_to_bbox_param(kp: Optional[np.ndarray], vis_thresh: float) -> Optional[np.ndarray]:
    """2D keypoints (K, 3) -> [cx, cy, scale] sizing the person to ~150 px
    (reference smooth_bbox.py:37-59)."""
    if kp is None:
        return None
    vis = kp[:, 2] > vis_thresh
    if not np.any(vis):
        return None
    min_pt = np.min(kp[vis, :2], axis=0)
    max_pt = np.max(kp[vis, :2], axis=0)
    person_height = np.linalg.norm(max_pt - min_pt)
    if person_height < 0.5:
        return None
    center = (min_pt + max_pt) / 2.0
    return np.append(center, 150.0 / person_height)


def get_all_bbox_params(
    kps: List[Optional[np.ndarray]], vis_thresh: float = 2.0
) -> Tuple[np.ndarray, int, int]:
    """Bbox params per frame with linear interpolation over gaps."""
    start, end = -1, -1
    params = []
    prev: Optional[np.ndarray] = None
    gap = 0
    for i, kp in enumerate(kps):
        p = kp_to_bbox_param(kp, vis_thresh)
        if p is None:
            if start >= 0:
                gap += 1
            continue
        if start < 0:
            start = i
        if gap > 0 and prev is not None:
            interp = np.linspace(0, 1, gap + 2)[1:-1, None]
            params.extend(list(prev[None] * (1 - interp) + p[None] * interp))
            gap = 0
        params.append(p)
        prev = p
        end = i
    if not params:
        return np.zeros((0, 3)), 0, 0
    return np.stack(params), start, end + 1


def smooth_bbox_params(
    bbox_params: np.ndarray, kernel_size: int = 11, sigma: float = 3.0
) -> np.ndarray:
    """Median + gaussian filtering along time (smooth_bbox.py:95-110)."""
    if bbox_params.shape[0] == 0:
        return bbox_params
    smoothed = np.array(
        [medfilt(bbox_params[:, i], kernel_size) for i in range(3)]
    ).T
    return np.array(
        [gaussian_filter1d(smoothed[:, i], sigma) for i in range(3)]
    ).T


def get_smooth_bbox_params(
    kps: List[Optional[np.ndarray]],
    vis_thresh: float = 2.0,
    kernel_size: int = 11,
    sigma: float = 3.0,
) -> Tuple[np.ndarray, int, int]:
    """Full pipeline (smooth_bbox.py:9-33)."""
    params, start, end = get_all_bbox_params(kps, vis_thresh)
    smoothed = smooth_bbox_params(params, kernel_size, sigma)
    smoothed = np.vstack([np.zeros((start, 3)), smoothed]) if start > 0 else smoothed
    return smoothed, start, end


class OneEuroFilter:
    """One-Euro low-pass filter for per-frame signals (video smoothing)."""

    def __init__(self, min_cutoff: float = 1.0, beta: float = 0.0, d_cutoff: float = 1.0, freq: float = 30.0):
        self.min_cutoff = min_cutoff
        self.beta = beta
        self.d_cutoff = d_cutoff
        self.freq = freq
        self._x_prev: Optional[np.ndarray] = None
        self._dx_prev: Optional[np.ndarray] = None

    @staticmethod
    def _alpha(cutoff, freq):
        tau = 1.0 / (2 * np.pi * cutoff)
        te = 1.0 / freq
        return 1.0 / (1.0 + tau / te)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if self._x_prev is None:
            self._x_prev = x
            self._dx_prev = np.zeros_like(x)
            return x
        dx = (x - self._x_prev) * self.freq
        a_d = self._alpha(self.d_cutoff, self.freq)
        dx_hat = a_d * dx + (1 - a_d) * self._dx_prev
        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = self._alpha(cutoff, self.freq)
        x_hat = a * x + (1 - a) * self._x_prev
        self._x_prev = x_hat
        self._dx_prev = dx_hat
        return x_hat


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> float:
    x1 = max(a[0], b[0]); y1 = max(a[1], b[1])
    x2 = min(a[2], b[2]); y2 = min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / max(area_a + area_b - inter, 1e-9)


class GreedyIoUTracker:
    """Frame-to-frame person association by greedy IoU matching.

    Equivalent of the reference's tracker glue (`utils/pose_tracker.py`:
    25-102 shells out to an external OpenPose/STAF tracker and regroups
    results by person id); here detection boxes are associated in-process.
    Returns stable integer track ids per frame.
    """

    def __init__(self, iou_thresh: float = 0.3, max_age: int = 10):
        self.iou_thresh = iou_thresh
        self.max_age = max_age
        self._tracks = {}  # id -> (bbox, age)
        self._next_id = 0

    def update(self, boxes_xyxy: np.ndarray) -> List[int]:
        """boxes (N, 4) -> list of track ids (new ids for unmatched)."""
        ids = [-1] * len(boxes_xyxy)
        used = set()
        # age existing tracks
        for tid in list(self._tracks):
            bbox, age = self._tracks[tid]
            if age >= self.max_age:
                del self._tracks[tid]
            else:
                self._tracks[tid] = (bbox, age + 1)
        # greedy best-first matching
        pairs = []
        for i, box in enumerate(boxes_xyxy):
            for tid, (tb, _) in self._tracks.items():
                iou = iou_xyxy(np.asarray(box, float), tb)
                if iou >= self.iou_thresh:
                    pairs.append((iou, i, tid))
        for iou, i, tid in sorted(pairs, reverse=True):
            if ids[i] == -1 and tid not in used:
                ids[i] = tid
                used.add(tid)
                self._tracks[tid] = (np.asarray(boxes_xyxy[i], float), 0)
        for i, box in enumerate(boxes_xyxy):
            if ids[i] == -1:
                tid = self._next_id
                self._next_id += 1
                ids[i] = tid
                self._tracks[tid] = (np.asarray(box, float), 0)
        return ids
