"""K2: the GT IUV z-buffer rasterizer, a hand-written CUDA kernel for Hopper.

Replaces `rasterize_pallas` of whmr_tpu/ops/rasterizer_pallas.py:255 (body
`_kernel` :152, pallas_call :316), which renders the GT IUV maps once every
train step. The kernel is `csrc/rasterizer.cu`; its header states its bound
on an H100 and what the design does about it.

What stays plain torch here, as it stays XLA outside the `pallas_call` in
whmr_tpu: the KD sort of the topology (`spatial_sort_faces`, numpy, once at
load), the per-face tables of edge coefficients, depths and attributes
(`_face_tables`, `kernel_inputs`), the padded per-face and per-chunk
bounding boxes, and the choice of pixel tile (`_pick_tile_hw`). K2 works
face by face, so the tiling shapes no work on the card; it is checked, and
kept for `rasterize_pallas`'s signature.
`raster_work` counts what a render needs (the kernel's bound) and
`tile_hits` what the TPU kernel's chunk cull keeps.

`rasterize_kernel(...)` has `rasterize_pallas`'s signature and result. For
CUDA tensors it launches the kernel (counted in the tracer's `k2.launches`)
or raises; for CPU tensors it runs `rasterize_kernel_reference`, the plain
version, which the CPU tests hold against `rasterize_pallas(interpret=True)`
and chip_smoke.py holds the kernel against on the card.

Per pixel centre and face chunk, both compute: barycentrics
b_j = (px*a_j + py*b_j) + c_j, inside when all b_j >= 0, depth
z = (b0*tz0 + b1*tz1) + b2*tz2, the chunk minimum cz over inside faces, the
winners (inside and z == cz) weighted 1/cnt, and their interpolated
attributes; across chunks a strictly nearer chunk wins (`cz < best_z`), so
an exact tie across chunks keeps the earlier chunk. Each product and sum is
rounded on its own (no FMA), so mask and zbuf agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from whmr_tpu_torch.ops import cuda_build
from whmr_tpu_torch.ops.rasterizer import _BIG, RasterOut, _face_chunks, pixel_centers
from whmr_tpu_torch.utils import profiling

# Faces per chunk of the KD sort, of the TPU kernel's cull and of the tie
# rule across chunks.
DEFAULT_CHUNK = 1024
# Face and chunk bboxes are widened by this many pixels so that the fp32
# rounding of the barycentric evaluation can never make a face cover a pixel
# centre outside them (rasterizer_pallas.py:290-296).
_BBOX_PAD = 0.0625
# The attribute channels the kernel takes, the pixels of a tile, and the
# pixels of a window (csrc/rasterizer.cu's kMaxWindow: a warp's 32 faces
# have at most 32 * H * W pairs, which the kernel counts in int32).
_MAX_ATTR = 8
_MAX_TILE = 256
_MAX_WINDOW = (2**31 - 1) // 32
# Images the plain version renders at once: each costs about ten
# (H*W, chunk) fp32 temporaries.
_REFERENCE_BYTES = 2 << 30

_lib = None


def spatial_sort_faces(faces: np.ndarray, v_template: np.ndarray, chunk: int = DEFAULT_CHUNK) -> np.ndarray:
    """Reorder faces by chunk-aligned KD bisection of template centroids
    (rasterizer_pallas.py:63-95), so that every `chunk` consecutive faces are
    one compact patch of the surface and their bbox culls most tiles.

    Splits the face set at the widest centroid axis into two halves that
    are multiples of `chunk`, recursively; the render is face-order
    invariant up to exact z-ties."""
    cent = v_template[faces].mean(axis=1)
    out = []

    def rec(idx):
        if idx.size <= chunk:
            out.append(idx)
            return
        c = cent[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        n_chunks = -(-idx.size // chunk)
        left = (n_chunks // 2) * chunk
        part = np.argpartition(c[:, ax], left)
        rec(idx[part[:left]])
        rec(idx[part[left:]])

    rec(np.arange(faces.shape[0]))
    return np.ascontiguousarray(faces[np.concatenate(out)])


def _face_tables(verts_pix, verts_z, attrs, faces):
    """Per-face tables in struct-of-arrays layout (rasterizer_pallas.py:98-149).

    Returns (coef_a, coef_b, coef_c, tz) each (B, 3, F) with the barycentric
    index j leading, ta (B, 3C, F) with row j*C + c, and the per-face bbox
    extrema (B, F). Degenerate (padding) faces get coef_c = -1, so that every
    b_j = -1 fails the coverage test, and an empty (inverted) bbox.
    """
    tri = verts_pix[:, faces]  # (B, F, 3, 2)
    tz = verts_z[:, faces]     # (B, F, 3)
    ta = attrs[:, faces]       # (B, F, 3, C)
    p0, p1, p2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
    area = (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1]) - (
        p1[..., 1] - p0[..., 1]
    ) * (p2[..., 0] - p0[..., 0])
    inv_area = torch.where(area.abs() > 1e-9, 1.0 / area, 0.0)
    degenerate = area.abs() <= 1e-9

    def edge_coef(pa, pb):
        return (pa[..., 1] - pb[..., 1], pb[..., 0] - pa[..., 0],
                pa[..., 0] * pb[..., 1] - pa[..., 1] * pb[..., 0])

    coefs = [edge_coef(p1, p2), edge_coef(p2, p0), edge_coef(p0, p1)]
    coef_a = torch.stack([e[0] for e in coefs], dim=1) * inv_area[:, None]
    coef_b = torch.stack([e[1] for e in coefs], dim=1) * inv_area[:, None]
    coef_c = torch.stack([e[2] for e in coefs], dim=1) * inv_area[:, None]
    coef_c = torch.where(degenerate[:, None, :], -1.0, coef_c)
    b, f, _, c = ta.shape
    ta_rows = ta.permute(0, 2, 3, 1).reshape(b, 3 * c, f)
    fx, fy = tri[..., 0], tri[..., 1]
    fx_lo = torch.where(degenerate, _BIG, fx.amin(dim=-1))
    fx_hi = torch.where(degenerate, -_BIG, fx.amax(dim=-1))
    fy_lo = torch.where(degenerate, _BIG, fy.amin(dim=-1))
    fy_hi = torch.where(degenerate, -_BIG, fy.amax(dim=-1))
    return coef_a, coef_b, coef_c, tz.transpose(1, 2), ta_rows, fx_lo, fx_hi, fy_lo, fy_hi


def kernel_inputs(verts_pix, verts_z, attrs, faces, chunk: int = DEFAULT_CHUNK):
    """K2's inputs, for faces padded to whole chunks: the five face tables
    (contiguous fp32) and the (B, 4, F) face bboxes [xmin, xmax, ymin, ymax],
    widened by `_BBOX_PAD` (padding faces: an inverted bbox)."""
    faces_pad = _face_chunks(np.asarray(faces), chunk).reshape(-1, 3)
    # non_blocking: a copy from pageable memory that does not wait for the card.
    idx = torch.from_numpy(faces_pad.astype(np.int64)).to(attrs.device, non_blocking=True)
    *tables, fx_lo, fx_hi, fy_lo, fy_hi = _face_tables(verts_pix.float(), verts_z.float(), attrs.float(), idx)
    face_bbox = torch.stack([fx_lo - _BBOX_PAD, fx_hi + _BBOX_PAD, fy_lo - _BBOX_PAD, fy_hi + _BBOX_PAD], dim=1)
    return tuple(t.contiguous() for t in tables), face_bbox.contiguous()


def _pick_tile_hw(h: int, w: int, tile_p: int) -> Tuple[int, int]:
    """Largest 2D block (tile_h, tile_w), tile_h * tile_w == tile_p, that
    tiles (h, w) evenly and is as square as possible
    (rasterizer_pallas.py:238-252)."""
    best = None
    tw = 1
    while tw <= min(w, tile_p):
        th = tile_p // tw
        if tw * th == tile_p and w % tw == 0 and th <= h and h % th == 0:
            score = abs(th - tw)
            if best is None or score < best[0]:
                best = (score, th, tw)
        tw *= 2
    if best is None:
        raise ValueError(f"no 2D tiling of ({h}, {w}) with tile_p={tile_p}")
    return best[1], best[2]


def raster_tables(verts_pix, verts_z, attrs, faces, chunk: int = DEFAULT_CHUNK):
    """The TPU kernel's inputs (rasterizer_pallas.py:283-305): `kernel_inputs`'
    face tables, the (B, 4, K) chunk bboxes [xmin, xmax, ymin, ymax] padded
    by `_BBOX_PAD`, and the (B, 4, F) face bboxes."""
    tables, face_bbox = kernel_inputs(verts_pix, verts_z, attrs, faces, chunk)
    # Rounding is monotonic, so the chunk's min of padded face bounds is the
    # padded min of its faces' bounds, bit for bit.
    per_chunk = face_bbox.reshape(face_bbox.shape[0], 4, -1, chunk)
    bbox = torch.stack(
        [per_chunk[:, 0].amin(-1), per_chunk[:, 1].amax(-1), per_chunk[:, 2].amin(-1), per_chunk[:, 3].amax(-1)],
        dim=1,
    )
    return tables, bbox.contiguous(), face_bbox


def tile_hits(bbox: torch.Tensor, resolution, tile_hw, origin) -> torch.Tensor:
    """(B, tiles, K) bool: which of the (B, 4, K) padded chunk bboxes meet
    which tile's rectangle of pixel centres, the TPU kernel's chunk cull
    (rasterizer_pallas.py:165-168, 221-226). Tiles are row-major over the
    (ceil(H/th), ceil(W/tw)) grid."""
    (h, w), (th, tw) = resolution, tile_hw
    nby, nbx = -(-h // th), -(-w // tw)
    bx = torch.arange(nbx, dtype=torch.float32, device=bbox.device).repeat(nby)
    by = torch.arange(nby, dtype=torch.float32, device=bbox.device).repeat_interleave(nbx)
    x0 = bx * tw + 0.5 + float(origin[0])
    y0 = by * th + 0.5 + float(origin[1])
    x1, y1 = x0 + (tw - 1), y0 + (th - 1)
    xmin, xmax, ymin, ymax = (bbox[:, i, None, :] for i in range(4))
    return (
        (xmax >= x0[None, :, None]) & (xmin <= x1[None, :, None])
        & (ymax >= y0[None, :, None]) & (ymin <= y1[None, :, None])
    )


def raster_work(face_bbox: torch.Tensor, resolution, origin, n_attr: int) -> Tuple[int, int, int]:
    """What a render of these inputs needs, whatever the kernel's design:
    the (pixel, face) pairs whose pixel centre lies in the face's padded
    bbox (only these can be covered), the faces whose padded bbox holds a
    pixel centre of the window (only their tables need reading), and the
    bytes: those faces' 12 + 3C table floats read once, zbuf and attrs
    written once. Returns (pairs, live_faces, n_bytes) as ints."""
    h, w = resolution
    b = face_bbox.shape[0]
    dev = face_bbox.device
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5 + float(origin[0])
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5 + float(origin[1])

    def centres_in(axis, lo, hi):  # pixel centres c with lo <= c <= hi, per face
        return (torch.searchsorted(axis, hi.contiguous(), right=True)
                - torch.searchsorted(axis, lo.contiguous())).clamp(min=0)

    per_face = centres_in(xs, face_bbox[:, 0], face_bbox[:, 1]) * centres_in(ys, face_bbox[:, 2], face_bbox[:, 3])
    pairs = int(per_face.sum().item())
    live = int((per_face > 0).sum().item())
    return pairs, live, 4 * (live * (12 + 3 * n_attr) + b * h * w * (1 + n_attr))


def rasterize_kernel_reference(
    verts_pix: torch.Tensor,
    verts_z: torch.Tensor,
    attrs: torch.Tensor,
    faces: np.ndarray,
    resolution: Tuple[int, int] = (128, 128),
    chunk: int = DEFAULT_CHUNK,
    origin: Tuple[float, float] = (0.0, 0.0),
) -> RasterOut:
    """Plain K2: the arithmetic and tie rules of `_kernel` step for step,
    chunk by chunk, on every chunk (the padded cull is exact, so K2 held
    against this also checks K2's cull). A few images at a time bound the
    (images, H*W, chunk) temporaries."""
    h, w = resolution
    b, _, c = attrs.shape
    (ca, cb, cc, tz, ta), _ = kernel_inputs(verts_pix, verts_z, attrs, faces, chunk)
    xs, ys = pixel_centers(h, w, origin, attrs.device)
    px, py = xs[None, :, None], ys[None, :, None]
    n_pix = h * w
    step = max(1, _REFERENCE_BYTES // (12 * 4 * n_pix * chunk))
    zbufs, outs = [], []
    for i0 in range(0, b, step):
        sl_b = slice(i0, min(b, i0 + step))
        nb = sl_b.stop - sl_b.start
        best_z = torch.full((nb, n_pix, 1), _BIG, dtype=torch.float32, device=attrs.device)
        best_attr = torch.zeros((nb, n_pix, c), dtype=torch.float32, device=attrs.device)
        for f0 in range(0, ca.shape[-1], chunk):
            sl = slice(f0, f0 + chunk)

            def row(t, r):
                return t[sl_b, r:r + 1, sl]  # (nb, 1, chunk)

            b0, b1, b2 = ((px * row(ca, j) + py * row(cb, j)) + row(cc, j) for j in range(3))
            inside = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
            z = (b0 * row(tz, 0) + b1 * row(tz, 1)) + b2 * row(tz, 2)
            z_masked = torch.where(inside, z, _BIG)
            cz = z_masked.amin(dim=-1, keepdim=True)
            win = ((z_masked == cz) & inside).float()
            win = win / win.sum(dim=-1, keepdim=True).clamp(min=1.0)
            wb = (win * b0, win * b1, win * b2)
            cols = []
            for ci in range(c):
                acc = None
                for j in range(3):
                    term = (wb[j] * row(ta, j * c + ci)).sum(dim=-1, keepdim=True)
                    acc = term if acc is None else acc + term
                cols.append(acc)
            take = cz < best_z
            best_z = torch.where(take, cz, best_z)
            best_attr = torch.where(take, torch.cat(cols, dim=-1), best_attr)
        zbufs.append(best_z)
        outs.append(best_attr)
    zbuf = torch.cat(zbufs).reshape(b, h, w)
    mask = zbuf < _BIG * 0.5
    return RasterOut(attrs=torch.cat(outs).reshape(b, h, w, c) * mask[..., None], zbuf=zbuf, mask=mask)


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("rasterizer")
        lib.whmr_raster_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.whmr_raster_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(tables, face_bbox, resolution, chunk, origin) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on the face tables and bboxes of `kernel_inputs`. Returns
    (zbuf, attrs)."""
    ca, cb, cc, tz, ta = tables
    h, w = resolution
    b, _, n_faces = ca.shape
    c = ta.shape[1] // 3
    if not 1 <= c <= _MAX_ATTR:
        raise ValueError(f"rasterize_kernel takes 1 to {_MAX_ATTR} attribute channels, got {c}")
    if not 1 <= b <= 65535:
        raise ValueError(f"rasterize_kernel takes 1 to 65535 images, got {b}")
    if not 1 <= h * w <= _MAX_WINDOW:
        raise ValueError(f"rasterize_kernel takes windows of 1 to {_MAX_WINDOW} pixels, got {h}x{w}")
    lib = _kernel_lib()
    dev = ca.device
    keys = torch.empty((2, b, h, w), dtype=torch.int64, device=dev)
    zbuf = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    attrs = torch.empty((b, h, w, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.whmr_raster_fwd(
            face_bbox.data_ptr(), ca.data_ptr(), cb.data_ptr(), cc.data_ptr(), tz.data_ptr(), ta.data_ptr(),
            keys.data_ptr(), zbuf.data_ptr(), attrs.data_ptr(),
            b, h, w, n_faces, chunk, c, float(origin[0]), float(origin[1]), stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterizer kernel launch failed: cudaError {err}")
    profiling.count("k2.launches")
    return zbuf, attrs


def rasterize_kernel(
    verts_pix: torch.Tensor,
    verts_z: torch.Tensor,
    attrs: torch.Tensor,
    faces: np.ndarray,
    resolution: Tuple[int, int] = (128, 128),
    chunk: int = DEFAULT_CHUNK,
    tile_p: int = 128,
    tile_hw: Optional[Tuple[int, int]] = None,
    origin: Tuple[float, float] = (0.0, 0.0),
) -> RasterOut:
    """`rasterize_pallas` on the card: (B, V, 2) pixel vertices, (B, V)
    depths, (B, V, C) attributes and (F, 3) numpy faces -> RasterOut at
    `resolution` (H, W), rendering the window at `origin`.

    The pixel tiling is `rasterize_pallas`'s: (tile_h, tile_w) blocks, by
    default the most square even tiling of tile_p pixels (ValueError if
    there is none); with `tile_hw` given, H and W need not be multiples of
    it. The result does not depend on it. CUDA tensors launch K2, CPU
    tensors run the plain version; nothing falls back from one to the other.
    """
    dev = attrs.device
    if not (verts_pix.device == verts_z.device == dev):
        raise ValueError(f"rasterize_kernel: inputs on different devices: {verts_pix.device}, {verts_z.device}, {dev}")
    if dev.type == "cpu":
        return rasterize_kernel_reference(verts_pix, verts_z, attrs, faces, resolution, chunk, origin)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_kernel runs on cuda or cpu tensors, got {dev}")
    th, tw = tuple(tile_hw) if tile_hw is not None else _pick_tile_hw(*resolution, tile_p)
    if not 1 <= th * tw <= _MAX_TILE:
        raise ValueError(f"rasterize_kernel takes tiles of 1 to {_MAX_TILE} pixels, got {th}x{tw}")
    tables, face_bbox = kernel_inputs(verts_pix, verts_z, attrs, faces, chunk)
    zbuf, out = _launch(tables, face_bbox, resolution, chunk, origin)
    return RasterOut(attrs=out, zbuf=zbuf, mask=zbuf < _BIG * 0.5)
