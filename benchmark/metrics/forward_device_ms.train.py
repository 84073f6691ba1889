"""Median over the traced window's steps (the CUDA-only pass,
benchmark/spans.py) of the device ms of the `train.forward` span: the train-
mode forward and the loss (CUDA events)."""

import spans


def read(ctx):
    return spans.median_ms("train.step", "train.forward", "device")
