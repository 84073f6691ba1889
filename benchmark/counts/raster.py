"""K2's least time for a render (a copy of the arithmetic of the port's
`ops/rasterizer_kernel.py::raster_work` and chip_smoke.py's
`rasterizer_bound_ms`): the (pixel, face) pairs whose pixel centre lies in
the face's bbox widened by 1/16 pixel (only these can be covered) get the
coverage-and-depth test, 20 fp32 operations each; the tables of the faces
that can shade a pixel (12 + 3C floats) are read once, and the depth and
the C attributes of every pixel written once."""

from __future__ import annotations

import torch

from counts import peaks

BBOX_PAD = 0.0625
OPS_PER_PAIR = 3 * 4 + 3 + 5 + 2


def face_bbox(verts_pix: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(B, 4, F) [xmin, xmax, ymin, ymax], widened; degenerate faces empty."""
    tri = verts_pix[:, faces]
    p0, p1, p2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
    area = (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1]) - (p1[..., 1] - p0[..., 1]) * (p2[..., 0] - p0[..., 0])
    live = area.abs() > 1e-9
    big = 1e9
    fx, fy = tri[..., 0], tri[..., 1]
    return torch.stack([torch.where(live, fx.amin(-1), big) - BBOX_PAD, torch.where(live, fx.amax(-1), -big) + BBOX_PAD,
                        torch.where(live, fy.amin(-1), big) - BBOX_PAD, torch.where(live, fy.amax(-1), -big) + BBOX_PAD], 1)


def raster_work(fbox: torch.Tensor, resolution, origin, n_attr: int):
    """(pairs, live faces, bytes) of one render."""
    h, w = resolution
    b = fbox.shape[0]
    xs = torch.arange(w, dtype=torch.float32, device=fbox.device) + 0.5 + float(origin[0])
    ys = torch.arange(h, dtype=torch.float32, device=fbox.device) + 0.5 + float(origin[1])

    def centres_in(axis, lo, hi):
        return (torch.searchsorted(axis, hi.contiguous(), right=True) - torch.searchsorted(axis, lo.contiguous())).clamp(min=0)

    per_face = centres_in(xs, fbox[:, 0], fbox[:, 1]) * centres_in(ys, fbox[:, 2], fbox[:, 3])
    pairs = int(per_face.sum().item())
    live = int((per_face > 0).sum().item())
    return pairs, live, 4 * (live * (12 + 3 * n_attr) + b * h * w * (1 + n_attr))


def raster_bound_s(pairs: int, n_bytes: int) -> float:
    return max(n_bytes / peaks.HBM_BYTES_PER_S, pairs * OPS_PER_PAIR / peaks.FP32_FLOPS)
