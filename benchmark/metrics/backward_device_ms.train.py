"""Median over the traced window's steps (the CUDA-only pass,
benchmark/spans.py) of the device ms of the `train.backward` span:
autograd's backward (CUDA events)."""

import spans


def read(ctx):
    return spans.median_ms("train.step", "train.backward", "device")
