"""K1's least time at its launch shape (counts/attention.py) over its mean
device time per launch in the traced window, in %. K1's kernels are the
`attention*_kernel` instantiations of the port's csrc/attention.cu."""

import re

K1 = re.compile(r"attention(_batch)?(_f32)?(_wg)?(_mma)?_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    hits = [v for k, v in tr["kernels"].items() if K1.search(k)]
    launches = sum(v[0] for v in hits)
    if not launches:
        return None
    return 100.0 * ctx["k1_bound_s"] / (sum(v[1] for v in hits) / launches)
