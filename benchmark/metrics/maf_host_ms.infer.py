"""Median over the traced window's forwards (the CUDA-only pass,
benchmark/spans.py) of the host ms of the `whmr.maf` span: the MAF loop with
its regressors and SMPL forwards, the Graphormer stage, global orientation
and the world SMPL."""

import spans


def read(ctx):
    return spans.median_ms("whmr.forward", "whmr.maf", "host")
