"""`torch.cuda.max_memory_allocated()` over the window, after
`reset_peak_memory_stats()`, in GiB."""


def read(ctx):
    peak = ctx.get("peak_bytes")
    return peak / 2**30 if peak else None
