"""Batched z-buffer triangle rasterizer in plain PyTorch (pytorch3d's place).

Counterpart of `whmr_tpu/ops/rasterizer.py`: the CPU path of the GT IUV
render (whmr_tpu/training/gt_renderer.py:279-282). Barycentrics are linear
in the pixel coordinates, so all pixels against one face chunk are one
(P, 3) x (3, 3 chunk) product; the depth test is a running minimum over the
chunks, so memory is P x chunk, not P x F. Inside a chunk the FIRST face at
the minimum depth wins (argmin), and across chunks a strictly nearer chunk
wins. Each chunk is tested only against the pixels of its faces' bbox
(over the batch, one pixel of margin): no pixel outside it can be covered,
so the result is the same as over the whole window, at a fraction of the
work. On the card the render goes through K2 (ops/rasterizer_kernel.py),
whose tie rule differs: it averages exact ties inside a chunk.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

_BIG = 1e9


class RasterOut(NamedTuple):
    attrs: torch.Tensor  # (B, H, W, C) interpolated attributes (0 on background)
    zbuf: torch.Tensor   # (B, H, W) depth of the nearest face (1e9 on background)
    mask: torch.Tensor   # (B, H, W) foreground


def _face_chunks(faces: np.ndarray, chunk: int) -> np.ndarray:
    """Pad faces to a multiple of `chunk` with degenerate (all-0) triangles;
    returns (K, chunk, 3)."""
    f = faces.shape[0]
    pad = (-f) % chunk
    if pad:
        faces = np.concatenate([faces, np.zeros((pad, 3), faces.dtype)], axis=0)
    return faces.reshape(-1, chunk, 3)


def pixel_centers(h: int, w: int, origin: Tuple[float, float], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 x and y of the (h, w) window's pixel centres, row-major (P,):
    (column + 0.5) + origin_x, (row + 0.5) + origin_y."""
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5 + float(origin[0])
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5 + float(origin[1])
    return xs.repeat(h), ys.repeat_interleave(w)


def rasterize(
    verts_pix: torch.Tensor,
    verts_z: torch.Tensor,
    attrs: torch.Tensor,
    faces: np.ndarray,
    resolution: Tuple[int, int] = (128, 128),
    chunk: int = 1024,
    origin: Tuple[float, float] = (0.0, 0.0),
) -> RasterOut:
    """Rasterize batched meshes with a per-pixel depth test.

    verts_pix: (B, V, 2) pixel coordinates (x right, y down); verts_z: (B, V)
    depth (smaller is nearer); attrs: (B, V, C); faces: (F, 3) numpy; output
    (H, W) = `resolution`. A window at `origin` (x0, y0) equals the enclosing
    frame's render sliced [y0:y0+H, x0:x0+W] bit for bit.
    """
    h, w = resolution
    b, _, c = attrs.shape
    dev = attrs.device
    # Bound the live barycentric temporary (B x P x chunk x 3 fp32, 256 MB).
    max_chunk = max(64, ((1 << 28) // 4) // max(b * h * w * 3, 1))
    chunk = min(chunk, max_chunk)
    fchunks = torch.from_numpy(_face_chunks(np.asarray(faces), chunk).astype(np.int64)).to(dev)
    xs, ys = pixel_centers(h, w, origin, dev)
    px_all = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (P, 3)
    rows = torch.arange(b, device=dev)[:, None]
    windows = _chunk_windows(verts_pix, fchunks, resolution, origin)

    best_z_all = torch.full((b, h * w), _BIG, dtype=torch.float32, device=dev)
    best_attr_all = torch.zeros((b, h * w, c), dtype=torch.float32, device=dev)
    for fchunk, (r0, r1, c0, c1) in zip(fchunks, windows):
        if r0 > r1 or c0 > c1:
            continue  # the chunk's faces lie outside the window
        pix = (torch.arange(r0, r1 + 1, device=dev)[:, None] * w + torch.arange(c0, c1 + 1, device=dev)).reshape(-1)
        px = px_all[pix]
        best_z, best_attr = best_z_all[:, pix], best_attr_all[:, pix]
        tri = verts_pix[:, fchunk]  # (B, chunk, 3, 2)
        tz = verts_z[:, fchunk]     # (B, chunk, 3)
        ta = attrs[:, fchunk]       # (B, chunk, 3, C)
        p0, p1, p2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
        area = (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1]) - (
            p1[..., 1] - p0[..., 1]
        ) * (p2[..., 0] - p0[..., 0])
        valid = area.abs() > 1e-9
        inv_area = torch.where(valid, 1.0 / area, 0.0)

        # Barycentric w0 is the edge function of (p1, p2) over the area, in
        # a*x + b*y + c form.
        def edge_coef(pa, pb):
            return torch.stack(
                [pa[..., 1] - pb[..., 1], pb[..., 0] - pa[..., 0],
                 pa[..., 0] * pb[..., 1] - pa[..., 1] * pb[..., 0]],
                dim=-1,
            )

        coefs = torch.stack([edge_coef(p1, p2), edge_coef(p2, p0), edge_coef(p0, p1)], dim=2)
        coefs = coefs * inv_area[..., None, None]  # (B, chunk, 3 bary, 3 abc)
        bary = torch.einsum("pk,bcjk->bpcj", px, coefs)  # (B, P, chunk, 3)
        inside = (bary >= 0.0).all(dim=-1) & valid[:, None, :]
        z_px = torch.einsum("bpcj,bcj->bpc", bary, tz)
        z_masked = torch.where(inside, z_px, _BIG)

        chunk_best = z_masked.argmin(dim=2)  # first minimum, (B, P)
        chunk_z = z_masked.gather(2, chunk_best[..., None])[..., 0]
        take = chunk_z < best_z
        win_bary = bary.gather(2, chunk_best[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]
        win_attr = torch.einsum("bpj,bpjc->bpc", win_bary, ta[rows, chunk_best])
        best_z_all[:, pix] = torch.where(take, chunk_z, best_z)
        best_attr_all[:, pix] = torch.where(take[..., None], win_attr, best_attr)

    zbuf = best_z_all.reshape(b, h, w)
    mask = zbuf < _BIG * 0.5
    return RasterOut(attrs=best_attr_all.reshape(b, h, w, c) * mask[..., None], zbuf=zbuf, mask=mask)


def _chunk_windows(verts_pix, fchunks, resolution, origin):
    """For each face chunk, the inclusive (row0, row1, col0, col1) of the
    window's pixels whose centre can lie in one of its faces in any mesh of
    the batch: the faces' bbox, one pixel of margin, clipped to the window
    (empty when row0 > row1 or col0 > col1). A chunk whose bbox is not finite
    gets the whole window. One read-back for all chunks."""
    h, w = resolution
    pts = verts_pix[:, fchunks]  # (B, K, chunk, 3, 2)
    lo = pts.amin(dim=(0, 2, 3)) - torch.tensor(origin, device=pts.device) - 0.5  # (K, 2) as x, y
    hi = pts.amax(dim=(0, 2, 3)) - torch.tensor(origin, device=pts.device) - 0.5
    windows = []
    for (x0, y0), (x1, y1) in zip(lo.tolist(), hi.tolist()):
        if not all(np.isfinite((x0, y0, x1, y1))):
            windows.append((0, h - 1, 0, w - 1))
            continue
        windows.append((max(int(np.floor(y0)) - 1, 0), min(int(np.ceil(y1)) + 1, h - 1),
                        max(int(np.floor(x0)) - 1, 0), min(int(np.ceil(x1)) + 1, w - 1)))
    return windows


def rdiv(numerator: float, t: torch.Tensor) -> torch.Tensor:
    """numerator / t, rounded once as JAX rounds it. `float / tensor` in
    torch multiplies by the reciprocal, which rounds twice; a 0-dim CPU
    numerator is passed to the kernel as a scalar, with no copy to the card."""
    return torch.tensor(numerator, dtype=t.dtype) / t


def project_weak_perspective_to_pixels(
    verts: torch.Tensor,
    camera: torch.Tensor,
    resolution: Tuple[int, int],
    focal_length: float = 1000.0,
    crop_res: float = 256.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop-frame projection to pixels with the GT weak camera [s, tx, ty],
    s = 2f/(res tz) (trainer.py:445-449). Returns ((B, V, 2) pixels, (B, V) z)."""
    h, w = resolution
    s, tx, ty = camera[:, 0:1], camera[:, 1:2], camera[:, 2:3]
    tz = rdiv(2 * focal_length, crop_res * s)
    x = verts[..., 0] + tx
    y = verts[..., 1] + ty
    z = verts[..., 2] + tz
    xn = x / z * focal_length / (crop_res / 2)
    yn = y / z * focal_length / (crop_res / 2)
    px = (xn + 1.0) * 0.5 * w
    py = (yn + 1.0) * 0.5 * h
    return torch.stack([px, py], dim=-1), z
