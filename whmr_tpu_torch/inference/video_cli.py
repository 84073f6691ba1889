"""`whmr-video` of the port: video in -> tracked per-frame meshes -> video out.

Counterpart of `whmr_tpu/inference/video_cli.py`; run it as
`python -m whmr_tpu_torch.inference.video_cli --video clip.mp4 [--device cpu]`
(the card unless `--device cpu`; no fall back). Completes the reference's dormant video path as a first-class flow: the
reference ships video<->frames ffmpeg glue (`utils/demo_utils.py:29-201`),
bbox smoothing (`utils/smooth_bbox.py`) and external-tracker regrouping
(`utils/pose_tracker.py:25-102`) but no driver that ties them together.
Here: frames are extracted (cv2), any demo detector backend runs per frame,
detections are associated across frames (greedy IoU) and their bbox params
smoothed per track (one-Euro), the folder demo pipeline renders overlays,
and the overlay frames are re-encoded to a video.
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np


class TrackingDetector:
    """Wrap a per-image detector with cross-frame association + smoothing.

    Frames must be processed in order (run_folder walks sorted names, and
    video frames are written with zero-padded indices). Each track id gets
    a one-Euro filter over (cx, cy, size); the reference's equivalents are
    smooth_bbox.get_smooth_bbox_params and the pose_tracker regrouping.
    """

    def __init__(self, base, min_cutoff: float = 0.6, beta: float = 0.1,
                 freq: float = 30.0):
        from whmr_tpu_torch.utils.tracking import GreedyIoUTracker

        self.base = base
        self.tracker = GreedyIoUTracker()
        self.filters = {}
        self.min_cutoff = min_cutoff
        self.beta = beta
        # Effective processed-frame rate: the one-Euro derivative term
        # scales with this, so decimated streams must pass fps/every_n.
        self.freq = freq

    def __call__(self, image: np.ndarray, name: str = "") -> List:
        from whmr_tpu_torch.utils.tracking import OneEuroFilter

        try:
            dets = self.base(image, name)
        except TypeError:
            dets = self.base(image)
        if not dets:
            # Still tick the tracker: tracks only age out inside update(),
            # so skipping it during detection gaps would keep stale ids
            # (and their one-Euro filter state, _x_prev minutes old) alive
            # forever — the next person near an old bbox would inherit a
            # dead track's identity and be smoothed toward its position.
            self.tracker.update(np.zeros((0, 4), np.float32))
            live = set(self.tracker._tracks)
            for tid in list(self.filters):
                if tid not in live:
                    del self.filters[tid]
            return dets
        boxes = np.array(
            [
                [d.cx - d.size / 2, d.cy - d.size / 2,
                 d.cx + d.size / 2, d.cy + d.size / 2]
                for d in dets
            ],
            np.float32,
        )
        ids = self.tracker.update(boxes)
        for det, tid in zip(dets, ids):
            f = self.filters.setdefault(
                tid, OneEuroFilter(
                    min_cutoff=self.min_cutoff, beta=self.beta, freq=self.freq
                )
            )
            cx, cy, size = f(np.array([det.cx, det.cy, det.size], np.float32))
            det.cx, det.cy, det.size = float(cx), float(cy), float(size)
            det.track_id = tid
        # Drop filter state for tracks the tracker has retired (ids are
        # never reused, so without pruning a long stream leaks one filter
        # per transient detection).
        live = set(self.tracker._tracks)
        for tid in list(self.filters):
            if tid not in live:
                del self.filters[tid]
        return dets


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WHMR video demo (PyTorch port)")
    p.add_argument("--video", required=True)
    p.add_argument("--output_folder", default="output_video")
    p.add_argument("--checkpoint", default=None, help="checkpoint dir of the port")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--detector", default=None,
                   choices=["full", "file", "iuv", "contour"],
                   help="default: iuv with --checkpoint, full otherwise")
    p.add_argument("--bbox_file", default=None)
    p.add_argument("--max_people", type=int, default=8)
    p.add_argument("--data_parallel", type=int, default=0, metavar="N",
                   help="split each crop batch over N model replicas, one a device row")
    p.add_argument("--tensor_parallel", type=int, default=0, metavar="M",
                   help="split ViT block weights over the M devices of each row")
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                   help="live-model compute dtype")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, or cpu); no fall back")
    p.add_argument("--every_n", type=int, default=1, help="process every Nth frame")
    p.add_argument("--fps", type=float, default=None,
                   help="SOURCE video fps (default: read from the file, "
                        "falling back to 30); the output encodes at "
                        "fps/every_n so the result plays in real time")
    p.add_argument("--no_camcalib", action="store_true")
    p.add_argument("--no_track", action="store_true",
                   help="disable cross-frame tracking/smoothing")
    p.add_argument("--openpose_json", default=None, metavar="DIR",
                   help="folder of OpenPose/STAF --write_json output for "
                        "this video: use the external tracker's person ids "
                        "and keypoint-derived boxes instead of the "
                        "in-process detector (utils/pose_tracker.py)")
    p.add_argument("--staf_dir", default=None, metavar="DIR",
                   help="built STAF checkout: run its openpose binary in "
                        "tracking mode on --video first, then proceed as "
                        "with --openpose_json")
    p.add_argument("--bundle", default=None,
                   help="whmr-export bundle dir (frozen program; see "
                        "whmr-demo --bundle)")
    p.add_argument("--cfg_file", default=None,
                   help="reference-style YAML config (e.g. configs/vit-l.yaml)")
    p.add_argument("--misc", nargs="*", default=[])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import shutil

    from whmr_tpu_torch.inference.demo_cli import build_pipeline, detector_kind
    from whmr_tpu_torch.inference.detector import build_detector
    from whmr_tpu_torch.inference.video import images_to_video, video_to_images

    import cv2

    pipeline = build_pipeline(args)
    external_track = args.openpose_json or args.staf_dir
    if external_track:
        from whmr_tpu_torch.utils.pose_tracker import (
            PosetrackDetector,
            run_posetracker,
        )

        if args.openpose_json:
            base = PosetrackDetector.from_json_folder(args.openpose_json)
        else:
            base = PosetrackDetector(
                run_posetracker(args.video, args.staf_dir)
            )
    else:
        base = build_detector(
            detector_kind(args), args.bbox_file, pipeline=pipeline
        )
    src_fps = args.fps
    if src_fps is None:
        cap = cv2.VideoCapture(args.video)
        src_fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        cap.release()
        if not (src_fps and src_fps > 0):
            src_fps = 30.0
    eff_fps = src_fps / args.every_n
    # External-tracker detections already carry person ids and per-track
    # smoothing — don't re-associate them through the in-process tracker.
    pipeline.detector = (
        base
        if args.no_track or external_track
        else TrackingDetector(base, freq=eff_fps)
    )

    os.makedirs(args.output_folder, exist_ok=True)
    # Fresh per-run frame/result dirs: reusing an output folder must not mix
    # stale frames or overlays from a previous clip into this run's video.
    frame_dir = os.path.join(args.output_folder, "frames")
    result_dir = os.path.join(args.output_folder, "results")
    for d in (frame_dir, result_dir):
        if os.path.isdir(d):
            shutil.rmtree(d)
    frames = video_to_images(args.video, frame_dir, every_n=args.every_n)
    print(f"extracted {len(frames)} frames -> {frame_dir}")
    stats = pipeline.run_folder(frame_dir, result_dir, render=True)

    # Assemble the result video from THIS run's frames, in frame order;
    # frames with no detections (no overlay written) fall back to the raw
    # frame padded to the 3-view panel shape (frame + two h x h side views)
    # so the timeline has no silent gaps and every frame has equal size.
    panel_paths = []
    for fp in frames:
        stem = os.path.splitext(os.path.basename(fp))[0]
        overlay = os.path.join(result_dir, f"{stem}_overlay.png")
        if os.path.exists(overlay):
            panel_paths.append(overlay)
            continue
        frame = cv2.imread(fp)
        h = frame.shape[0]
        panel = np.concatenate(
            [frame, np.zeros((h, 2 * h, 3), frame.dtype)], axis=1
        )
        gap = os.path.join(result_dir, f"{stem}_gap.png")
        cv2.imwrite(gap, panel)
        panel_paths.append(gap)
    out_path = os.path.join(args.output_folder, "result.mp4")
    if panel_paths:
        images_to_video(panel_paths, out_path, fps=eff_fps)
        dest = out_path
    else:
        dest = result_dir
    print(
        f"W-HMR video: {stats['images']} frames, {stats['people']} people, "
        f"{stats['fps']:.2f} fps -> {dest}"
    )
    return stats


if __name__ == "__main__":
    main()
