"""Median over the traced window's forwards (the CUDA-only pass,
benchmark/spans.py) of the device ms of the `whmr.heads` spans, both
intervals summed (CUDA events, idle time inside them included)."""

import spans


def read(ctx):
    return spans.median_ms("whmr.forward", "whmr.heads", "device")
