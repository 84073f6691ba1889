"""The body-model arrays the benchmark hands to the port and to the reference.

The real SMPL model is not in the repository, so every configuration runs
on synthetic assets with SMPL's exact shapes (6890 vertices, 13,776 faces,
24 joints, 10 betas, 207 pose-blend rows, 1723 and 431 downsampled
vertices, 67 markers, the 49-joint map). This is a frozen copy of the
port's `data/assets.py::synthetic_smpl_assets(0)`: the same arrays, made
here so that both sides read one set of inputs that neither of them made.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

N_VERTS, N_BETAS, N_SUB_VERTS, N_TEMP_VERTS, N_MARKERS = 6890, 10, 1723, 431, 67

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21], np.int32
)
# smplh vertex ids of the 21 surface keypoints after the 24 kinematic joints.
VERTEX_JOINT_IDS = np.array(
    [332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624, 6787,
     2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905, 6016, 6133], np.int32
)
# The 49-joint output set as indices into [24 kinematic | 21 vertex | 9 regressed].
JOINT_MAP = np.array(
    [24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
     8, 5, 45, 46, 4, 7, 21, 19, 17, 16, 18, 20, 47, 48, 49, 50, 51, 52, 53, 24, 26, 25, 28, 27],
    np.int32,
)

_JOINT_POS = np.array(
    [[0.00, -0.20, 0.00], [0.07, -0.30, 0.00], [-0.07, -0.30, 0.00], [0.00, -0.05, 0.00],
     [0.09, -0.65, 0.00], [-0.09, -0.65, 0.00], [0.00, 0.05, 0.00], [0.10, -1.00, 0.00],
     [-0.10, -1.00, 0.00], [0.00, 0.15, 0.00], [0.11, -1.08, 0.08], [-0.11, -1.08, 0.08],
     [0.00, 0.35, 0.00], [0.08, 0.28, 0.00], [-0.08, 0.28, 0.00], [0.00, 0.50, 0.02],
     [0.18, 0.30, 0.00], [-0.18, 0.30, 0.00], [0.22, 0.05, 0.00], [-0.22, 0.05, 0.00],
     [0.24, -0.18, 0.00], [-0.24, -0.18, 0.00], [0.25, -0.25, 0.00], [-0.25, -0.25, 0.00]],
    np.float32,
)


def _uv_sphere(n_rows: int, n_cols: int) -> Tuple[np.ndarray, np.ndarray]:
    theta = np.linspace(0, np.pi, n_rows + 2)[1:-1]
    phi = np.linspace(0, 2 * np.pi, n_cols, endpoint=False)
    verts = [[np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)] for t in theta for p in phi]
    verts += [[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]]
    verts = np.asarray(verts, np.float32)
    npole, spole = len(verts) - 2, len(verts) - 1
    faces = [[npole, c, (c + 1) % n_cols] for c in range(n_cols)]
    for r in range(n_rows - 1):
        for c in range(n_cols):
            a, b = r * n_cols + c, r * n_cols + (c + 1) % n_cols
            cc, dd = (r + 1) * n_cols + c, (r + 1) * n_cols + (c + 1) % n_cols
            faces += [[a, b, cc], [b, dd, cc]]
    last = (n_rows - 1) * n_cols
    faces += [[spole, last + (c + 1) % n_cols, last + c] for c in range(n_cols)]
    return verts, np.asarray(faces, np.int32)


def _pool_matrix(n_out: int, n_in: int) -> np.ndarray:
    m = np.zeros((n_out, n_in), np.float32)
    idx = np.linspace(0, n_in, n_out + 1).astype(int)
    for i in range(n_out):
        lo, hi = idx[i], max(idx[i] + 1, idx[i + 1])
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


@functools.lru_cache(maxsize=1)
def synthetic_assets() -> Dict[str, np.ndarray]:
    """The arrays by the port's `SMPLAssets` field names (seed 0)."""
    rng = np.random.RandomState(0)
    sphere_v, faces = _uv_sphere(82, 84)
    v_template = sphere_v * np.array([0.25, 1.0, 0.15], np.float32)
    v_template[:, 1] -= 0.15
    d2 = ((v_template[None] - _JOINT_POS[:, None]) ** 2).sum(-1)
    jr = np.exp(-d2 / 0.01)
    j_regressor = (jr / jr.sum(axis=1, keepdims=True)).astype(np.float32)
    w = np.exp(-d2.T / 0.05)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    def smooth_field(out_dim, scale):
        freq = rng.randn(8, 3).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, size=(8,)).astype(np.float32)
        basis = np.sin(v_template @ freq.T * 3.0 + phase)
        coef = rng.randn(8, 3 * out_dim).astype(np.float32) * scale
        return (basis @ coef).reshape(N_VERTS, 3, out_dim)

    shapedirs = smooth_field(N_BETAS, 0.01).astype(np.float32)
    posedirs = smooth_field(207, 0.001).reshape(N_VERTS * 3, 207).T.astype(np.float32)
    extra_pos = _JOINT_POS[[1, 2, 12, 15, 0, 9, 6, 15, 15]] + rng.randn(9, 3).astype(np.float32) * 0.01
    jre = np.exp(-((v_template[None] - extra_pos[:, None]) ** 2).sum(-1) / 0.01)
    j_regressor_extra = (jre / jre.sum(axis=1, keepdims=True)).astype(np.float32)
    j_regressor_h36m = j_regressor[[0, 2, 5, 8, 1, 4, 7, 3, 12, 15, 15, 16, 18, 20, 17, 19, 21]]
    dmap0 = _pool_matrix(N_SUB_VERTS, N_VERTS)
    dmap1 = _pool_matrix(N_TEMP_VERTS, N_SUB_VERTS)
    ssm = rng.choice(N_VERTS, size=N_MARKERS, replace=False).astype(np.int32)
    return {
        "v_template": v_template, "shapedirs": shapedirs, "posedirs": posedirs,
        "j_regressor": j_regressor, "parents": SMPL_PARENTS, "lbs_weights": lbs_weights,
        "faces": faces, "j_regressor_extra": j_regressor_extra, "joint_map": JOINT_MAP,
        "vertex_joint_ids": VERTEX_JOINT_IDS, "j_regressor_h36m": j_regressor_h36m.astype(np.float32),
        "dmap0": dmap0, "dmap1": dmap1, "ssm": ssm,
        "mean_pose_rot6d": np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), (24, 1)),
        "mean_shape": np.zeros(10, np.float32), "mean_cam": np.array([0.9, 0.0, 0.0], np.float32),
    }
