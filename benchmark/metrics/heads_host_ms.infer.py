"""Median over the traced window's forwards (the CUDA-only pass,
benchmark/spans.py) of the host ms of the `whmr.heads` spans, both intervals
summed: the mean-parameter init, deconv pyramid and Tz head, then the IUV
and depth heads."""

import spans


def read(ctx):
    return spans.median_ms("whmr.forward", "whmr.heads", "host")
