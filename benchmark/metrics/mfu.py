"""Model FLOPs of the window's work (counts/flops.py: a forward per crop in
inference, three forwards per crop in a training step) over the window's
wall time times the card's bf16 dense peak, in %. Serves `mfu.infer` and
`mfu.train`."""

from counts import peaks


def read(ctx):
    w = ctx.get("window")
    if not w or not w.get("crops"):
        return None
    return 100.0 * w["crops"] * ctx["flops_per_crop"] / (w["seconds"] * peaks.BF16_FLOPS)
