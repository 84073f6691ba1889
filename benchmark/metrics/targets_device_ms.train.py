"""Median over the traced window's steps (the CUDA-only pass,
benchmark/spans.py) of the device ms of the `train.targets` span: GT SMPL,
mesh downsampling, camera fit and the GT render (K2), from its first work to
its last (CUDA events)."""

import spans


def read(ctx):
    return spans.median_ms("train.step", "train.targets", "device")
