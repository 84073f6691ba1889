"""Cross-format keypoint conversion registry.

A copy of `whmr_tpu/data/kp_formats.py` (the port imports nothing of
whmr_tpu); the tables are equal, name by name.

Equivalent of reference `datasets/data_utils/kp_utils.py` (convert_kps :28,
per-format name getters :46-725), reorganized as one registry of skeleton
conventions -> joint-name lists. Conversion matches joints BY NAME, so the
names follow the same conventions the ecosystem uses (COCO / MPII / H36M /
SMPL / SPIN-49 orderings are public standards).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

_SPIN_OPENPOSE = [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle", "OP REye",
    "OP LEye", "OP REar", "OP LEar", "OP LBigToe", "OP LSmallToe", "OP LHeel",
    "OP RBigToe", "OP RSmallToe", "OP RHeel",
]

FORMATS: Dict[str, List[str]] = {
    # SPIN/W-HMR 49-joint superset (core/constants.py:16-68)
    "spin": _SPIN_OPENPOSE + [
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
        "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
        "headtop", "hip", "thorax", "Spine (H36M)", "Jaw (H36M)",
        "Head (H36M)", "nose", "leye", "reye", "lear", "rear",
    ],
    # 14-joint common LSP-style skeleton
    "common": [
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
        "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
        "headtop",
    ],
    "coco": [
        "nose", "leye", "reye", "lear", "rear", "lshoulder", "rshoulder",
        "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip", "lknee",
        "rknee", "lankle", "rankle",
    ],
    "mpii": [
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "hip", "thorax",
        "neck", "headtop", "rwrist", "relbow", "rshoulder", "lshoulder",
        "lelbow", "lwrist",
    ],
    "h36m": [
        "hip", "lhip", "lknee", "lankle", "rhip", "rknee", "rankle",
        "Spine (H36M)", "neck", "Head (H36M)", "headtop", "lshoulder",
        "lelbow", "lwrist", "rshoulder", "relbow", "rwrist",
    ],
    "smpl": [
        "hips", "leftUpLeg", "rightUpLeg", "spine", "leftLeg", "rightLeg",
        "spine1", "leftFoot", "rightFoot", "spine2", "leftToeBase",
        "rightToeBase", "neck", "leftShoulder", "rightShoulder", "head",
        "leftArm", "rightArm", "leftForeArm", "rightForeArm", "leftHand",
        "rightHand", "leftHandIndex1", "rightHandIndex1",
    ],
    "3dpw": [
        "nose", "thorax", "rshoulder", "relbow", "rwrist", "lshoulder",
        "lelbow", "lwrist", "hip", "rhip", "rknee", "rankle", "lhip", "lknee",
        "lankle",
    ],
    "posetrack": [
        "nose", "neck", "headtop", "lear", "rear", "lshoulder", "rshoulder",
        "lelbow", "relbow", "lwrist", "rwrist", "lhip", "rhip", "lknee",
        "rknee", "lankle", "rankle",
    ],
    "pennaction": [
        "headtop", "lshoulder", "rshoulder", "lelbow", "relbow", "lwrist",
        "rwrist", "lhip", "rhip", "lknee", "rknee", "lankle", "rankle",
    ],
    "aich": [
        "rshoulder", "relbow", "rwrist", "lshoulder", "lelbow", "lwrist",
        "rhip", "rknee", "rankle", "lhip", "lknee", "lankle", "headtop",
        "neck",
    ],
    "mpii3d": [
        "spine3", "spine4", "spine2", "Spine (H36M)", "hip", "neck",
        "Head (H36M)", "headtop", "lshoulder", "lelbow", "lwrist", "lhand",
        "rshoulder", "relbow", "rwrist", "rhand", "lhip", "lknee", "lankle",
        "lfoot", "ltoe", "rhip", "rknee", "rankle", "rfoot", "rtoe",
    ],
    "mpii3d_test": [
        "headtop", "neck", "rshoulder", "relbow", "rwrist", "lshoulder",
        "lelbow", "lwrist", "rhip", "rknee", "rankle", "lhip", "lknee",
        "lankle", "hip", "Spine (H36M)", "Head (H36M)",
    ],
    "smplcoco": [
        "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "rwrist",
        "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
        "headtop", "hip", "thorax", "Spine (H36M)", "Jaw (H36M)",
        "Head (H36M)", "nose", "leye", "reye", "lear", "rear",
    ],
    "staf": [
        "nose", "neck", "rshoulder", "relbow", "rwrist", "lshoulder",
        "lelbow", "lwrist", "hip", "rhip", "rknee", "rankle", "lhip", "lknee",
        "lankle", "reye", "leye", "rear", "lear", "neck_top",
    ],
    "insta": [
        "rheel", "rknee", "rhip", "lhip", "lknee", "lheel", "rwrist",
        "relbow", "rshoulder", "lshoulder", "lelbow", "lwrist", "neck",
        "headtop", "nose", "leye", "reye", "lear", "rear", "lbigtoe",
        "rbigtoe", "lsmalltoe", "rsmalltoe", "lankle", "rankle",
    ],
}


def joint_names(fmt: str) -> List[str]:
    if fmt not in FORMATS:
        raise KeyError(f"unknown keypoint format '{fmt}'; known: {sorted(FORMATS)}")
    return FORMATS[fmt]


def convert_kps(joints: np.ndarray, src: str, dst: str) -> np.ndarray:
    """(B, J_src, 3) -> (B, J_dst, 3); unmatched joints become zeros
    (reference kp_utils.py:28-39 semantics)."""
    src_names = joint_names(src)
    dst_names = joint_names(dst)
    out = np.zeros((joints.shape[0], len(dst_names), 3), joints.dtype)
    for idx, name in enumerate(dst_names):
        if name in src_names:
            out[:, idx] = joints[:, src_names.index(name)]
    return out


def get_perm_idxs(src: str, dst: str) -> List[int]:
    """Indices into src for the joints present in dst (kp_utils.py:41-45)."""
    src_names = joint_names(src)
    return [src_names.index(n) for n in joint_names(dst) if n in src_names]
