"""Median over the traced window's steps (the CUDA-only pass,
benchmark/spans.py) of the host ms of the `train.step` span: the whole
step's enqueue, back-pressure from the launch queue included."""

import spans


def read(ctx):
    return spans.median_ms("train.step", "train.step", "host")
