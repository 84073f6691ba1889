"""Median over the traced window's steps (the CUDA-only pass,
benchmark/spans.py) of the device ms of the `train.optimizer` span: the
gradient norm, clip, Adam and EMA (CUDA events)."""

import spans


def read(ctx):
    return spans.median_ms("train.step", "train.optimizer", "device")
