"""Median over the traced window's forwards (the CUDA-only pass,
benchmark/spans.py) of the device ms of the `whmr.maf` span (CUDA events,
idle time inside it included)."""

import spans


def read(ctx):
    return spans.median_ms("whmr.forward", "whmr.maf", "device")
