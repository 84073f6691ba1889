"""External OpenPose/STAF pose-tracker glue.

A copy of `whmr_tpu/utils/pose_tracker.py` for the port. Capability counterpart of reference `utils/pose_tracker.py:25-102`: launch
the STAF fork of OpenPose in tracking mode over a video, parse its
`--write_json` output folder into per-person tracklets, and (net-new here)
turn those tracklets into the per-frame `Detection` stream the demo/video
pipeline consumes — so an external tracker can replace the in-process
detector + GreedyIoUTracker when a STAF checkout is available.

The binary itself is user-supplied (the reference assumes a built STAF
checkout too); everything below the subprocess line is pure host-side
parsing and works on any OpenPose-format json folder, external binary or
not. Tests exercise the parsing/conversion on synthetic json.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Dict, List, Optional

import numpy as np

# STAF's tracking model; each person entry carries `person_id` and
# `pose_keypoints_2d` as a flat [x, y, conf] * K list (K = 21 for BODY_21A,
# but the parser accepts any K).
_OPENPOSE_BIN = os.path.join("build", "examples", "openpose", "openpose.bin")


def run_openpose(
    video_file: str,
    output_folder: str,
    staf_folder: str,
    vis: bool = False,
) -> None:
    """Run the STAF openpose binary in tracking mode, writing per-frame json.

    Same invocation protocol as reference pose_tracker.py:25-53 (BODY_21A,
    --tracking 1, --write_json); raises FileNotFoundError when the checkout
    has no built binary instead of silently producing nothing.
    """
    binary = os.path.join(staf_folder, _OPENPOSE_BIN)
    if not os.path.exists(binary):
        raise FileNotFoundError(
            f"no openpose binary at {binary} — build the STAF checkout "
            "('staf' branch) first"
        )
    cmd = [
        _OPENPOSE_BIN,
        "--model_pose", "BODY_21A",
        "--tracking", "1",
        "--render_pose", "1" if vis else "0",
        "--video", os.path.abspath(video_file),
        "--write_json", os.path.abspath(output_folder),
        "--display", "2" if vis else "0",
    ]
    subprocess.run(cmd, cwd=staf_folder, check=True)


def read_posetrack_keypoints(output_folder: str) -> Dict[int, dict]:
    """Parse an OpenPose `--write_json` folder into per-person tracklets.

    Returns {person_id: {"joints2d": (T, K, 3) float array, "frames": (T,)
    int source-frame indices}} (reference pose_tracker.py:56-81). Frame
    index = position of the json file in sorted order, matching how
    OpenPose emits one file per frame.
    """
    people: Dict[int, dict] = {}
    names = sorted(f for f in os.listdir(output_folder) if f.endswith(".json"))
    for idx, result_file in enumerate(names):
        with open(os.path.join(output_folder, result_file)) as f:
            data = json.load(f)
        for person in data.get("people", []):
            pid = person["person_id"]
            pid = int(pid[0] if isinstance(pid, list) else pid)
            joints = np.asarray(
                person["pose_keypoints_2d"], np.float32
            ).reshape(-1, 3)
            entry = people.setdefault(pid, {"joints2d": [], "frames": []})
            entry["joints2d"].append(joints)
            entry["frames"].append(idx)
    for entry in people.values():
        entry["joints2d"] = np.stack(entry["joints2d"])
        entry["frames"] = np.asarray(entry["frames"], np.int64)
    return people


def run_posetracker(
    video_file: str,
    staf_folder: str,
    output_root: Optional[str] = None,
    display: bool = False,
) -> Dict[int, dict]:
    """End-to-end: run the tracker, parse, clean up (pose_tracker.py:84-102).
    The json goes to a fresh directory under `output_root` (the process's
    temporary directory when None)."""
    import tempfile

    stem = os.path.splitext(os.path.basename(video_file))[0]
    out = tempfile.mkdtemp(prefix=f"{stem}_posetrack", dir=output_root)
    run_openpose(video_file, out, staf_folder=staf_folder, vis=display)
    people = read_posetrack_keypoints(out)
    shutil.rmtree(out)
    return people


def tracklets_to_detections(
    people: Dict[int, dict],
    vis_thresh: float = 0.3,
    margin: float = 1.2,
    min_size: float = 16.0,
    smooth: bool = True,
) -> Dict[int, list]:
    """Tracklets -> per-source-frame Detection lists for the demo pipeline.

    For each person: visible-keypoint bbox per frame -> (cx, cy, size)
    params, median+gaussian smoothed along the track (the same smoothing the
    reference applies to keypoint-derived bboxes, smooth_bbox.py:95-110).
    OpenPose confidences are in [0, 1], hence the 0.3 default (the
    reference's vis_thresh=2.0 is for its 0-3 annotation-quality scale).

    Returns {source_frame_index: [Detection, ...]} with track_id set to the
    tracker's person_id; frames where a person has <2 visible joints are
    skipped for that person.
    """
    from whmr_tpu_torch.inference.pipeline import Detection
    from whmr_tpu_torch.utils.tracking import smooth_bbox_params

    per_frame: Dict[int, list] = {}
    for pid, entry in people.items():
        frames = entry["frames"]
        params = np.full((len(frames), 3), np.nan, np.float32)
        for t, joints in enumerate(entry["joints2d"]):
            vis = joints[:, 2] > vis_thresh
            if vis.sum() < 2:
                continue
            lo = joints[vis, :2].min(axis=0)
            hi = joints[vis, :2].max(axis=0)
            size = max(float((hi - lo).max()) * margin, min_size)
            cx, cy = (lo + hi) / 2.0
            params[t] = (cx, cy, size)
        valid = ~np.isnan(params[:, 0])
        if not valid.any():
            continue
        if smooth and valid.sum() >= 5:  # shorter tracks than the kernel stay raw
            sm = params.copy()
            sm[valid] = smooth_bbox_params(params[valid], kernel_size=5)
            params = sm
        for t in np.flatnonzero(valid):
            cx, cy, size = params[t]
            per_frame.setdefault(int(frames[t]), []).append(
                Detection(float(cx), float(cy), float(size), 1.0, int(pid))
            )
    return per_frame


class PosetrackDetector:
    """Serve precomputed external-tracker detections to the pipeline.

    Plugs into DemoPipeline / whmr-video in place of an image detector:
    frame files are named `{source_frame_index:06d}.png` (video.py:30), so
    lookup keys on int(stem). Frames the tracker produced nothing for
    return [].
    """

    def __init__(self, people: Dict[int, dict], **to_det_kwargs):
        self.per_frame = tracklets_to_detections(people, **to_det_kwargs)

    @classmethod
    def from_json_folder(cls, folder: str, **kw) -> "PosetrackDetector":
        return cls(read_posetrack_keypoints(folder), **kw)

    def __call__(self, image: np.ndarray, name: str = "") -> List:
        stem = os.path.splitext(os.path.basename(name))[0]
        try:
            idx = int(stem)
        except ValueError:
            return []
        h, w = image.shape[:2]
        dets = []
        for d in self.per_frame.get(idx, []):
            # keep anyone whose box still intersects the frame (crops are
            # zero-padded for the out-of-frame part); drop only detections
            # entirely outside — e.g. smoothing overshoot past an edge exit
            half = d.size / 2.0
            if d.cx + half > 0 and d.cx - half < w and \
                    d.cy + half > 0 and d.cy - half < h:
                dets.append(d)
        return dets
