"""Median over the traced window's forwards (the CUDA-only pass,
benchmark/spans.py) of the device ms of the `whmr.backbone` span: the
stream's time from the ViT's first work to its last (CUDA events), idle time
inside it included."""

import spans


def read(ctx):
    return spans.median_ms("whmr.forward", "whmr.backbone", "device")
