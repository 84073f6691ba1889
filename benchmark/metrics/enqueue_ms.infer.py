"""Host milliseconds of one `WHMR.forward` call, from call to return (the
forward has no synchronise inside it), averaged over the window's batches.
A forward that the host cannot enqueue faster than the card runs it sets
the pace of `infer_crops_per_s`."""


def read(ctx):
    spans = ctx.get("spans", {}).get("enqueue_s")
    return sum(spans) / len(spans) * 1e3 if spans else None
