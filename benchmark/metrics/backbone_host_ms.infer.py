"""Median over the traced window's forwards (the CUDA-only pass,
benchmark/spans.py) of the host ms of the `whmr.backbone` span: the ViT's
enqueue, back-pressure from the launch queue included."""

import spans


def read(ctx):
    return spans.median_ms("whmr.forward", "whmr.backbone", "host")
