"""GT IUV / inverse-depth rendering for the auxiliary supervision.

Counterpart of `whmr_tpu/training/gt_renderer.py`, which replaces the
reference's pytorch3d `IUV_Renderer` / `Depth_Renderer` (utils/renderer.py:
289-533, run every train step at trainer.py:442-464) with a z-buffer render
inside the step. On the card the render is K2, the hand-written CUDA kernel
of ops/rasterizer_kernel.py; on the CPU it is ops/rasterizer.py, as
whmr_tpu takes its Pallas kernel on an accelerator and its XLA scan on the
CPU.

Per-vertex IUV attributes come from the DensePose UV data when given
(`UV_Processed.mat`, densepose_methods.py:14-28); otherwise a deterministic
synthetic chart is derived from the LBS weights (part = strongest joint, UV
from a planar projection of the template). Every chart has PART-PURE faces:
barycentric interpolation of the part channel across a face whose corners
carry different parts would paint unrelated part labels along each seam,
so seam vertices are duplicated per part, as DensePose's own chart does
(renderer.py:302-328).
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from whmr_tpu_torch.data.assets import SMPLAssets
from whmr_tpu_torch.ops.rasterizer import project_weak_perspective_to_pixels, rasterize, rdiv
from whmr_tpu_torch.ops.rasterizer_kernel import rasterize_kernel, spatial_sort_faces


class RenderConsts(NamedTuple):
    vertex_iuv: torch.Tensor  # (Vr, 3) part/24, U, V per RENDER vertex, on the device
    faces: np.ndarray         # (F, 3) int32 over render vertices, KD-sorted, part-pure
    vertex_map: torch.Tensor  # (Vr,) int64 render vertex -> source vertex, on the device
    source_verts: int         # vertex count of the source mesh (6890 full, 1723 sub)


def _duplicate_part_seams(
    vert_part: np.ndarray, uv: np.ndarray, faces: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mint one render vertex per used (source vertex, part) pair so every
    face carries one part: each face takes its majority corner part.
    Returns (vertex_map, vert_iuv, faces) over render vertices."""
    fp = vert_part[faces]
    face_part = np.where(fp[:, 1] == fp[:, 2], fp[:, 1], fp[:, 0])
    pairs = np.stack([faces.reshape(-1), np.repeat(face_part, 3)], axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    vertex_map = uniq[:, 0].astype(np.int64)
    vert_iuv = np.concatenate(
        [uniq[:, 1:2].astype(np.float32) / 24.0, uv[vertex_map]], axis=1
    ).astype(np.float32)
    return vertex_map, vert_iuv, inv.reshape(-1, 3).astype(np.int64)


def _densepose_chart(densepose_mat: str):
    """(vertex_map, vert_iuv, faces) of a DensePose `UV_Processed.mat`: its
    per-sample vertices (seams pre-duplicated per part) are the render mesh
    (renderer.py:302-328)."""
    import scipy.io

    dp = scipy.io.loadmat(densepose_mat)
    all_vertices = dp["All_vertices"].reshape(-1).astype(np.int64) - 1
    face_part = dp["All_FaceIndices"].reshape(-1)
    faces_dp = dp["All_Faces"].astype(np.int64) - 1
    # Part of a dp vertex = part of the FIRST face holding it (reference
    # dp_vert_pid, renderer.py:316-322): reversed assignment, first write wins.
    vert_pid = np.zeros(all_vertices.shape[0], np.float32)
    vert_pid[faces_dp.reshape(-1)[::-1]] = np.repeat(face_part, 3)[::-1]
    # Part purity is a property of the data here: a face whose corners'
    # assigned part differs from its own would blend seam labels.
    pure = vert_pid[faces_dp] == face_part[:, None]
    if not pure.all():
        bad = int((~pure).any(axis=1).sum())
        raise ValueError(
            f"densepose_mat {densepose_mat!r} is not part-pure: {bad} faces span "
            "multiple charts (corrupt or non-DensePose data)"
        )
    vert_iuv = np.stack(
        [vert_pid / 24.0, dp["All_U_norm"].reshape(-1), dp["All_V_norm"].reshape(-1)], axis=-1
    ).astype(np.float32)
    return all_vertices, vert_iuv, faces_dp


def _collapse_to_sub_mesh(assets: SMPLAssets, vertex_map, vert_iuv, faces_np, template):
    """The render mesh over the 1723 dmap0-pooled vertices (mesh="sub").

    A full vertex belongs to its nearest pooled template point (the real
    dmap0 is a binary selection matrix, so an argmax over it would send every
    unselected vertex to sub-vertex 0). Render vertices are minted again per
    (sub vertex, part), so faces stay part-pure, with U/V of the first
    member. Faces that collapse are dropped, and faces are deduplicated per
    sorted SUB-vertex triple: two faces of different parts on one sub
    triangle would tie exactly, and K2 averages exact ties into seam labels.
    """
    from scipy.spatial import cKDTree

    dmap0 = np.asarray(assets.dmap0)
    pooled = (dmap0 @ template) / np.maximum(dmap0.sum(axis=1, keepdims=True), 1e-6)
    owner = cKDTree(pooled).query(template)[1].astype(np.int64)
    part_r = np.round(vert_iuv[:, 0] * 24.0).astype(np.int64)
    pairs = np.stack([owner[vertex_map], part_r], axis=1)
    uniq, first, inv = np.unique(pairs, axis=0, return_index=True, return_inverse=True)
    new_map = uniq[:, 0].astype(np.int64)
    vert_iuv = np.concatenate(
        [uniq[:, 1:2].astype(np.float32) / 24.0, vert_iuv[first, 1:]], axis=1
    ).astype(np.float32)
    mapped = inv[faces_np]
    msub = new_map[mapped]
    keep = (msub[:, 0] != msub[:, 1]) & (msub[:, 1] != msub[:, 2]) & (msub[:, 0] != msub[:, 2])
    mk, msk = mapped[keep], np.sort(msub[keep], axis=1)
    _, first = np.unique(msk, axis=0, return_index=True)
    return new_map, vert_iuv, mk[np.sort(first)], pooled


def build_render_consts(
    assets: SMPLAssets,
    densepose_mat: Optional[str] = None,
    mesh: str = "full",
    device=None,
) -> RenderConsts:
    """The render chart and topology (whmr_tpu gt_renderer.py:70-219):
    DensePose's when `densepose_mat` is given, the synthetic one otherwise;
    over the full 6890-vertex mesh or (mesh="sub") the 1723-vertex pooled
    one. The faces are KD-sorted once so that each face chunk of the render
    is a compact patch and the chunk cull bites."""
    if mesh not in ("full", "sub"):
        raise ValueError(f"mesh must be 'full' or 'sub', got {mesh!r}")
    if densepose_mat and not os.path.exists(densepose_mat):
        # A requested real chart never degrades to the synthetic one: their
        # part/U/V semantics differ as supervision targets.
        raise FileNotFoundError(f"densepose_mat {densepose_mat!r} does not exist")
    if densepose_mat:
        vertex_map, vert_iuv, faces_np = _densepose_chart(densepose_mat)
    else:
        part = assets.lbs_weights.argmax(axis=1) + 1  # 1..24 (0 = background)
        vt = assets.v_template
        lo, hi = vt.min(axis=0), vt.max(axis=0)
        uv = ((vt - lo) / np.maximum(hi - lo, 1e-6))[:, :2].astype(np.float32)
        vertex_map, vert_iuv, faces_np = _duplicate_part_seams(
            part.astype(np.int64), uv, np.asarray(assets.faces, np.int64)
        )
    template = np.asarray(assets.v_template)
    source_verts = template.shape[0]
    if mesh == "sub":
        vertex_map, vert_iuv, faces_np, template = _collapse_to_sub_mesh(
            assets, vertex_map, vert_iuv, faces_np, template
        )
        source_verts = template.shape[0]
    faces_sorted = spatial_sort_faces(faces_np.astype(np.int32), template[vertex_map])
    return RenderConsts(
        vertex_iuv=torch.as_tensor(vert_iuv, device=device),
        faces=faces_sorted,
        vertex_map=torch.as_tensor(vertex_map.astype(np.int64), device=device),
        source_verts=int(source_verts),
    )


def raster_inputs(
    consts: RenderConsts,
    gt_vertices: torch.Tensor,
    gt_camera: torch.Tensor,
    heatmap_size: Tuple[int, int] = (128, 128),
    vitpose_slice: bool = True,
):
    """The rasterizer's arguments for a batch: (verts_pix, verts_z, attrs,
    resolution, origin). With `vitpose_slice` only the supervised 128x96
    window (columns 16:-16) is rasterized, bit for bit what rendering the
    whole map and slicing gives."""
    if gt_vertices.shape[1] != consts.source_verts:
        raise ValueError(
            f"gt_vertices has {gt_vertices.shape[1]} vertices but render consts source "
            f"{consts.source_verts} (full vs sub mesh mismatch between build_render_consts "
            "and the caller)"
        )
    render_verts = gt_vertices.index_select(1, consts.vertex_map)
    vp, vz = project_weak_perspective_to_pixels(render_verts, gt_camera, heatmap_size)
    resolution, origin = heatmap_size, (0.0, 0.0)
    if vitpose_slice:
        margin = heatmap_size[1] // 8  # 16 at 128
        resolution = (heatmap_size[0], heatmap_size[1] - 2 * margin)
        origin = (float(margin), 0.0)
    attrs = consts.vertex_iuv[None].expand(gt_vertices.shape[0], -1, -1)
    return vp, vz, attrs, resolution, origin


def render_gt_maps(
    consts: RenderConsts,
    gt_vertices: torch.Tensor,
    gt_camera: torch.Tensor,
    heatmap_size: Tuple[int, int] = (128, 128),
    vitpose_slice: bool = True,
    with_depth: bool = False,
    valid: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """GT IUV image (and inverse depth) of a batch (trainer.py:442-464):
    rendered at `heatmap_size` with the GT weak camera, invalid samples
    zeroed. `gt_vertices` is the SOURCE mesh; `vertex_map` gathers the
    render vertices (the reference's verts[:, vert_mapping])."""
    vp, vz, attrs, resolution, origin = raster_inputs(
        consts, gt_vertices, gt_camera, heatmap_size, vitpose_slice
    )
    dev = gt_vertices.device.type
    if dev == "cuda":
        out = rasterize_kernel(vp, vz, attrs, consts.faces, resolution=resolution, origin=origin)
    elif dev == "cpu":
        out = rasterize(vp, vz, attrs, consts.faces, resolution=resolution, origin=origin)
    else:
        raise ValueError(f"render_gt_maps runs on cuda or cpu tensors, got {gt_vertices.device}")
    iuv = out.attrs
    if valid is not None:
        iuv = iuv * valid[:, None, None, None]
    results = {"iuv_image_gt": iuv}
    if with_depth:
        # Inverse depth, 0 on the background; surfaces at or behind the
        # camera (z <= 1e-3) are culled as pytorch3d's znear would.
        near = out.mask & (out.zbuf > 1e-3)
        inv_depth = torch.where(near, 1.0 / out.zbuf.clamp(min=1e-3), 0.0)
        if valid is not None:
            inv_depth = inv_depth * valid[:, None, None]
        results["depth_image_gt"] = inv_depth[..., None]
    return results


def gt_camera_from_cam_t(
    cam_t: torch.Tensor,
    focal_length: float = 1000.0,
    crop_res: float = 256.0,
    tz_range: Tuple[float, float] = (1.0, 100.0),
    txy_max: float = 20.0,
) -> torch.Tensor:
    """Full-perspective translation -> weak GT camera [2f/(res tz), tx, ty]
    (trainer.py:445-449), clamped to the physical range.

    The least-squares translation degenerates on bad keypoints (NaN, inf,
    negative or tiny tz); a degenerate camera projects the mesh over every
    tile and defeats the cull, or poisons the maps. Every such tz (NaN, inf,
    anything below the near bound) maps to the FAR bound, so invalid
    samples render small, never everywhere.
    """
    lo, hi = tz_range
    tz = torch.nan_to_num(cam_t[:, 2], nan=hi, posinf=hi, neginf=hi)
    tz = torch.where(tz < lo, hi, tz.clamp(max=hi))
    txy = torch.nan_to_num(cam_t[:, :2], nan=0.0, posinf=txy_max, neginf=-txy_max)
    txy = txy.clamp(-txy_max, txy_max)
    s = rdiv(2.0 * focal_length / crop_res, tz)
    return torch.stack([s, txy[:, 0], txy[:, 1]], dim=-1)
