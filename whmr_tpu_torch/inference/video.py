"""Video <-> frames helpers for the demo pipeline.

A copy of `whmr_tpu/inference/video.py` for the port. Equivalent of reference `utils/demo_utils.py` video_to_images /
images_to_video (which shell out to ffmpeg); implemented with cv2 so the
demo works without an ffmpeg binary. Combined with utils/tracking.py this
covers the reference's dormant video path.
"""

from __future__ import annotations

import os
from typing import List

import cv2


def video_to_images(video_path: str, out_dir: str, every_n: int = 1) -> List[str]:
    """Extract frames as PNGs; returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    paths = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % every_n == 0:
            p = os.path.join(out_dir, f"{i:06d}.png")
            cv2.imwrite(p, frame)
            paths.append(p)
        i += 1
    cap.release()
    return paths


def images_to_video(
    image_paths: List[str], out_path: str, fps: float = 30.0
) -> str:
    """Assemble frames into an mp4."""
    if not image_paths:
        raise ValueError("no frames")
    first = cv2.imread(image_paths[0])
    h, w = first.shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(out_path, fourcc, fps, (w, h))
    for p in image_paths:
        frame = cv2.imread(p)
        if frame.shape[:2] != (h, w):
            frame = cv2.resize(frame, (w, h))
        writer.write(frame)
    writer.release()
    return out_path
