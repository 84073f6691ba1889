"""Body-model asset loading: real SMPL files when present, synthetic otherwise.

A copy of `whmr_tpu/data/assets.py` (the port imports nothing of whmr_tpu);
`synthetic_smpl_assets(seed)` gives arrays bit-identical to whmr_tpu's.

The reference depends on a Google-Drive data bundle (reference README.md:53-55):
SMPL_NEUTRAL.pkl (+male/female), smpl_mean_params.npz, mesh_downsampling.npz,
smpl_ssm.npy (67 markers), J_regressor_h36m.npy, J_regressor_extra.npy. None of
those ship with the repo, so this module provides two paths:

1. `load_smpl_assets(data_dir)` — parse the real files (chumpy-free pkl
   decode) into one flat `SMPLAssets` array bundle.
2. `synthetic_smpl_assets(seed)` — a deterministic, anatomically-plausible
   synthetic model with the exact SMPL shapes (6890 verts / 24 joints /
   10 betas / 207 pose-blend dims, smplh extra-keypoint vertex ids, 49-joint
   pare map). Used for tests, benchmarks, and dry runs; swaps 1:1 for the
   real assets.

All matrices are dense float32, as in whmr_tpu.
"""

from __future__ import annotations

import functools
import os
import pickle
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Public SMPL family constants (model topology, not learned data)
# ---------------------------------------------------------------------------

N_VERTS = 6890
N_JOINTS = 24
N_BETAS = 10
N_SUB_VERTS = 1723
N_TEMP_VERTS = 431
N_MARKERS = 67

# Kinematic tree of the 24 SMPL joints (parent of joint i; root = -1).
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)

# smplh vertex ids for the 21 extra surface keypoints appended after the 24
# kinematic joints (smplx.vertex_ids['smplh'] + VertexJointSelector order,
# used by reference whmr.py:60,73-75).
VERTEX_JOINT_IDS = np.array(
    [
        332,   # nose
        6260,  # right eye
        2800,  # left eye
        4071,  # right ear
        583,   # left ear
        3216,  # left big toe
        3226,  # left small toe
        3387,  # left heel
        6617,  # right big toe
        6624,  # right small toe
        6787,  # right heel
        2746,  # left thumb tip
        2319,  # left index tip
        2445,  # left middle tip
        2556,  # left ring tip
        2673,  # left pinky tip
        6191,  # right thumb tip
        5782,  # right index tip
        5905,  # right middle tip
        6016,  # right ring tip
        6133,  # right pinky tip
    ],
    dtype=np.int32,
)

# 49-joint output map (reference core/constants.py:16-92): indices into the
# 54-joint concat [24 kinematic + 21 vertex keypoints + 9 extra-regressor].
JOINT_NAMES_49 = [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle", "OP REye",
    "OP LEye", "OP REar", "OP LEar", "OP LBigToe", "OP LSmallToe", "OP LHeel",
    "OP RBigToe", "OP RSmallToe", "OP RHeel",
    "Right Ankle", "Right Knee", "Right Hip", "Left Hip", "Left Knee",
    "Left Ankle", "Right Wrist", "Right Elbow", "Right Shoulder",
    "Left Shoulder", "Left Elbow", "Left Wrist", "Neck (LSP)",
    "Top of Head (LSP)", "Pelvis (MPII)", "Thorax (MPII)", "Spine (H36M)",
    "Jaw (H36M)", "Head (H36M)", "Nose", "Left Eye", "Right Eye", "Left Ear",
    "Right Ear",
]

JOINT_MAP_49 = {
    "OP Nose": 24, "OP Neck": 12, "OP RShoulder": 17, "OP RElbow": 19,
    "OP RWrist": 21, "OP LShoulder": 16, "OP LElbow": 18, "OP LWrist": 20,
    "OP MidHip": 0, "OP RHip": 2, "OP RKnee": 5, "OP RAnkle": 8, "OP LHip": 1,
    "OP LKnee": 4, "OP LAnkle": 7, "OP REye": 25, "OP LEye": 26, "OP REar": 27,
    "OP LEar": 28, "OP LBigToe": 29, "OP LSmallToe": 30, "OP LHeel": 31,
    "OP RBigToe": 32, "OP RSmallToe": 33, "OP RHeel": 34, "Right Ankle": 8,
    "Right Knee": 5, "Right Hip": 45, "Left Hip": 46, "Left Knee": 4,
    "Left Ankle": 7, "Right Wrist": 21, "Right Elbow": 19,
    "Right Shoulder": 17, "Left Shoulder": 16, "Left Elbow": 18,
    "Left Wrist": 20, "Neck (LSP)": 47, "Top of Head (LSP)": 48,
    "Pelvis (MPII)": 49, "Thorax (MPII)": 50, "Spine (H36M)": 51,
    "Jaw (H36M)": 52, "Head (H36M)": 53, "Nose": 24, "Left Eye": 26,
    "Right Eye": 25, "Left Ear": 28, "Right Ear": 27,
}

JOINT_MAP_ARRAY = np.array([JOINT_MAP_49[n] for n in JOINT_NAMES_49], dtype=np.int32)

# H36M 17 -> LSP 14 selector (reference core/constants.py:96-97).
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]


@dataclass(frozen=True)
class SMPLAssets:
    """Flat array bundle with everything the model graph consumes."""

    v_template: np.ndarray        # (6890, 3)
    shapedirs: np.ndarray         # (6890, 3, 10)
    posedirs: np.ndarray          # (207, 6890*3)
    j_regressor: np.ndarray       # (24, 6890)
    parents: np.ndarray           # (24,)
    lbs_weights: np.ndarray       # (6890, 24)
    faces: np.ndarray             # (F, 3) int32
    j_regressor_extra: np.ndarray  # (9, 6890)
    joint_map: np.ndarray         # (49,)
    vertex_joint_ids: np.ndarray  # (21,)
    j_regressor_h36m: np.ndarray  # (17, 6890)
    dmap0: np.ndarray             # (1723, 6890)
    dmap1: np.ndarray             # (431, 1723)
    ssm: np.ndarray               # (67,) marker vertex indices
    mean_pose_rot6d: np.ndarray   # (24, 6)
    mean_shape: np.ndarray        # (10,)
    mean_cam: np.ndarray          # (3,)
    gender: str = "neutral"


def _chumpy_free_unpickle(path: str) -> dict:
    """Load an SMPL pkl without the legacy chumpy dependency.

    SMPL_NEUTRAL.pkl stores some arrays as chumpy `ch.Ch` objects; the
    reference pulls in the whole chumpy package to read them
    (models/smpl_webuser/serialization.py). We instead intercept the chumpy
    class lookups and strip to the underlying ndarray.
    """

    class _ChShim:
        def __setstate__(self, state):
            self.__dict__.update(state)

        @property
        def r(self):
            return np.asarray(self.__dict__.get("x"))

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("chumpy"):
                return _ChShim
            return super().find_class(module, name)

    with open(path, "rb") as f:
        data = _Unpickler(f, encoding="latin1").load()

    def to_np(v):
        if isinstance(v, _ChShim):
            return v.r
        if hasattr(v, "todense"):
            return np.asarray(v.todense())
        return v

    return {k: to_np(v) for k, v in data.items()}


def load_smpl_assets(data_dir: str, gender: str = "neutral") -> SMPLAssets:
    """Load the real asset bundle laid out like the reference `data/` dir.

    Expects: smpl/SMPL_{GENDER}.pkl, smpl_mean_params.npz,
    mesh_downsampling.npz, smpl/smpl_ssm.npy, J_regressor_h36m.npy,
    J_regressor_extra.npy (paths per reference core/path_config.py and
    whmr.py:72-100).
    """
    pkl = _chumpy_free_unpickle(
        os.path.join(data_dir, "smpl", f"SMPL_{gender.upper()}.pkl")
    )
    shapedirs = np.asarray(pkl["shapedirs"], np.float32)[..., :N_BETAS]
    posedirs = np.asarray(pkl["posedirs"], np.float32)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # (207, 6890*3)

    mean = np.load(os.path.join(data_dir, "smpl_mean_params.npz"))
    mesh = np.load(
        os.path.join(data_dir, "mesh_downsampling.npz"), allow_pickle=True, encoding="latin1"
    )
    import scipy.sparse

    d = [scipy.sparse.coo_matrix(m).todense() for m in mesh["D"]]
    dmap0 = np.asarray(d[0], np.float32)  # (1723, 6890)
    dmap1 = np.asarray(d[1], np.float32)  # (431, 1723)

    return SMPLAssets(
        v_template=np.asarray(pkl["v_template"], np.float32),
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=np.asarray(pkl["J_regressor"], np.float32),
        parents=SMPL_PARENTS,
        lbs_weights=np.asarray(pkl["weights"], np.float32),
        faces=np.asarray(pkl["f"], np.int32),
        j_regressor_extra=np.load(
            os.path.join(data_dir, "J_regressor_extra.npy")
        ).astype(np.float32),
        joint_map=JOINT_MAP_ARRAY,
        vertex_joint_ids=VERTEX_JOINT_IDS,
        j_regressor_h36m=np.load(
            os.path.join(data_dir, "J_regressor_h36m.npy")
        ).astype(np.float32),
        dmap0=dmap0,
        dmap1=dmap1,
        ssm=np.load(os.path.join(data_dir, "smpl", "smpl_ssm.npy")).astype(np.int32).reshape(-1),
        mean_pose_rot6d=np.asarray(mean["pose"], np.float32).reshape(24, 6),
        mean_shape=np.asarray(mean["shape"], np.float32).reshape(10),
        mean_cam=np.asarray(mean["cam"], np.float32).reshape(3),
        gender=gender,
    )


def _uv_sphere(n_rows: int, n_cols: int) -> Tuple[np.ndarray, np.ndarray]:
    """UV-sphere mesh with n_rows*n_cols + 2 vertices and valid triangles."""
    verts = []
    theta = np.linspace(0, np.pi, n_rows + 2)[1:-1]
    phi = np.linspace(0, 2 * np.pi, n_cols, endpoint=False)
    for t in theta:
        for p in phi:
            verts.append([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)])
    verts.append([0.0, 1.0, 0.0])   # north pole
    verts.append([0.0, -1.0, 0.0])  # south pole
    verts = np.asarray(verts, np.float32)

    faces = []
    npole, spole = len(verts) - 2, len(verts) - 1
    for c in range(n_cols):
        faces.append([npole, c, (c + 1) % n_cols])
    for r in range(n_rows - 1):
        for c in range(n_cols):
            a = r * n_cols + c
            b = r * n_cols + (c + 1) % n_cols
            cc = (r + 1) * n_cols + c
            dd = (r + 1) * n_cols + (c + 1) % n_cols
            faces.append([a, b, cc])
            faces.append([b, dd, cc])
    last = (n_rows - 1) * n_cols
    for c in range(n_cols):
        faces.append([spole, last + (c + 1) % n_cols, last + c])
    return verts, np.asarray(faces, np.int32)


@functools.lru_cache(maxsize=2)
def synthetic_smpl_assets(seed: int = 0) -> SMPLAssets:
    """Deterministic synthetic SMPL-shaped assets for tests/benchmarks.

    Geometry: a body-proportioned ellipsoid (UV sphere, 82x84 grid + poles =
    6890 verts) so the mesh has valid connectivity for rasterization. Joints
    are placed at plausible body landmarks inside the surface; the LBS
    weights fall off smoothly with distance to each joint, rows normalized.
    Blend shapes are smooth low-amplitude fields. Every array has the exact
    dtype/shape of the real model.
    """
    rng = np.random.RandomState(seed)
    sphere_v, faces = _uv_sphere(82, 84)
    assert sphere_v.shape[0] == N_VERTS

    # Stretch into a rough standing-body ellipsoid: y in [-1.2, 0.9] m-ish.
    v_template = sphere_v * np.array([0.25, 1.0, 0.15], np.float32)
    v_template[:, 1] -= 0.15

    # Joint rest positions: plausible skeleton inside the ellipsoid.
    joint_pos = np.array(
        [
            [0.00, -0.20, 0.00],   # 0 pelvis
            [0.07, -0.30, 0.00],   # 1 L hip
            [-0.07, -0.30, 0.00],  # 2 R hip
            [0.00, -0.05, 0.00],   # 3 spine1
            [0.09, -0.65, 0.00],   # 4 L knee
            [-0.09, -0.65, 0.00],  # 5 R knee
            [0.00, 0.05, 0.00],    # 6 spine2
            [0.10, -1.00, 0.00],   # 7 L ankle
            [-0.10, -1.00, 0.00],  # 8 R ankle
            [0.00, 0.15, 0.00],    # 9 spine3
            [0.11, -1.08, 0.08],   # 10 L foot
            [-0.11, -1.08, 0.08],  # 11 R foot
            [0.00, 0.35, 0.00],    # 12 neck
            [0.08, 0.28, 0.00],    # 13 L collar
            [-0.08, 0.28, 0.00],   # 14 R collar
            [0.00, 0.50, 0.02],    # 15 head
            [0.18, 0.30, 0.00],    # 16 L shoulder
            [-0.18, 0.30, 0.00],   # 17 R shoulder
            [0.22, 0.05, 0.00],    # 18 L elbow
            [-0.22, 0.05, 0.00],   # 19 R elbow
            [0.24, -0.18, 0.00],   # 20 L wrist
            [-0.24, -0.18, 0.00],  # 21 R wrist
            [0.25, -0.25, 0.00],   # 22 L hand
            [-0.25, -0.25, 0.00],  # 23 R hand
        ],
        np.float32,
    )

    # J_regressor: soft-assign each joint to its nearest template vertices.
    d2 = ((v_template[None] - joint_pos[:, None]) ** 2).sum(-1)  # (24, 6890)
    jr = np.exp(-d2 / 0.01)
    j_regressor = (jr / jr.sum(axis=1, keepdims=True)).astype(np.float32)
    # Exactness: the regressor should reproduce joint_pos closely enough for
    # tests; store the soft version (real SMPL's is also a soft regressor).

    # LBS weights: smooth distance falloff, row-normalized.
    w = np.exp(-d2.T / 0.05)  # (6890, 24)
    lbs_weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    # Smooth random blend shapes (low-frequency via random Fourier features).
    def smooth_field(out_dim, scale):
        freq = rng.randn(8, 3).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, size=(8,)).astype(np.float32)
        basis = np.sin(v_template @ freq.T * 3.0 + phase)  # (6890, 8)
        coef = rng.randn(8, 3 * out_dim).astype(np.float32) * scale
        return (basis @ coef).reshape(N_VERTS, 3, out_dim)

    shapedirs = smooth_field(N_BETAS, 0.01)
    posedirs_v = smooth_field(207, 0.001)  # (6890, 3, 207)
    posedirs = posedirs_v.reshape(N_VERTS * 3, 207).T.astype(np.float32)

    # Extra regressor (9 joints: hips x2, neck, head-top, pelvis, thorax,
    # spine, jaw, head) as soft vertex selections.
    extra_pos = joint_pos[[1, 2, 12, 15, 0, 9, 6, 15, 15]] + rng.randn(9, 3).astype(np.float32) * 0.01
    d2e = ((v_template[None] - extra_pos[:, None]) ** 2).sum(-1)
    jre = np.exp(-d2e / 0.01)
    j_regressor_extra = (jre / jre.sum(axis=1, keepdims=True)).astype(np.float32)

    # H36M 17-joint regressor: reuse kinematic joints + head approximations.
    h36m_pick = [0, 2, 5, 8, 1, 4, 7, 3, 12, 15, 15, 16, 18, 20, 17, 19, 21]
    j_regressor_h36m = j_regressor[h36m_pick].astype(np.float32)

    # Mesh downsampling: average pooling of vertex neighborhoods
    # (1723 <- 6890, 431 <- 1723), deterministic strided grouping.
    def pool_matrix(n_out, n_in):
        m = np.zeros((n_out, n_in), np.float32)
        idx = np.linspace(0, n_in, n_out + 1).astype(int)
        for i in range(n_out):
            lo, hi = idx[i], max(idx[i] + 1, idx[i + 1])
            m[i, lo:hi] = 1.0 / (hi - lo)
        return m

    dmap0 = pool_matrix(N_SUB_VERTS, N_VERTS)
    dmap1 = pool_matrix(N_TEMP_VERTS, N_SUB_VERTS)

    ssm = rng.choice(N_VERTS, size=N_MARKERS, replace=False).astype(np.int32)

    # Mean params: identity rotations in rot6d, zero shape, s~0.9 camera
    # (same layout as data/smpl_mean_params.npz consumed at whmr.py:62-67).
    # NOTE the rot6d layout is INTERLEAVED per reference geometry.py:243-257
    # (x.view(-1, 3, 2): a1 = elements 0,2,4; a2 = 1,3,5), so the identity is
    # [1,0,0,1,0,0] — caught by the full-graph torch-oracle parity test.
    ident6d = np.tile(np.array([1, 0, 0, 1, 0, 0], np.float32), (24, 1))
    return SMPLAssets(
        v_template=v_template,
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs,
        j_regressor=j_regressor,
        parents=SMPL_PARENTS,
        lbs_weights=lbs_weights,
        faces=faces,
        j_regressor_extra=j_regressor_extra,
        joint_map=JOINT_MAP_ARRAY,
        vertex_joint_ids=VERTEX_JOINT_IDS,
        j_regressor_h36m=j_regressor_h36m,
        dmap0=dmap0,
        dmap1=dmap1,
        ssm=ssm,
        mean_pose_rot6d=ident6d,
        mean_shape=np.zeros(10, np.float32),
        mean_cam=np.array([0.9, 0.0, 0.0], np.float32),
        gender="neutral",
    )


def get_assets(data_dir: Optional[str] = None, gender: str = "neutral") -> SMPLAssets:
    """Real assets when a data dir (or $WHMR_DATA_DIR) holds them, else synthetic."""
    data_dir = data_dir or os.environ.get("WHMR_DATA_DIR", "")
    if data_dir and os.path.exists(
        os.path.join(data_dir, "smpl", f"SMPL_{gender.upper()}.pkl")
    ):
        return load_smpl_assets(data_dir, gender)
    return synthetic_smpl_assets()
