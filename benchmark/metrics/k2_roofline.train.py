"""K2's least time for the traced steps' GT renders (counts/raster.py, on
the GT meshes and cameras the benchmark derives from its own batches) over
K2's device time per call (its face pass and resolve step), in %."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or "k2_bound_s" not in ctx:
        return None
    faces = [v for k, v in tr["kernels"].items() if "raster_faces" in k]
    calls = sum(v[0] for v in faces)
    if not calls:
        return None
    t = sum(v[1] for k, v in tr["kernels"].items() if "raster_faces" in k or "raster_resolve" in k)
    return 100.0 * ctx["k2_bound_s"] / (t / calls)
