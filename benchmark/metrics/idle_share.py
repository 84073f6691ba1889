"""The device's idle share of the traced window, in %: one minus the union of
its kernel, memcpy and memset intervals (overlaps counted once) over the
window's wall time, both from the trace's CUDA-only pass (trace.py). Serves
`idle_share.infer` and `idle_share.train`."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
