"""K1's least time at a launch shape (a copy of chip_smoke.py's
`attention_bound_ms`): q, k and v read once and the output written once,
against 4*B*H*N*N*D operations (the two products) at the peak of the
dtype."""

from __future__ import annotations

from counts import peaks

ELEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def attention_bound_s(shape, dtype: str = "bfloat16") -> float:
    b, h, n, d = shape
    t_bytes = 4 * b * h * n * d * ELEM_BYTES[dtype] / peaks.HBM_BYTES_PER_S
    ops = 4 * b * h * n * n * d
    t_ops = ops / (peaks.BF16_FLOPS if dtype != "float32" else peaks.FP32_FLOPS)
    return max(t_bytes, t_ops)
