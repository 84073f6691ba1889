"""Demo overlay rendering through the port's native C++ rasterizer.

Counterpart of `whmr_tpu/inference/renderer.py` (reference
`utils/renderer_cam.py`, render_image_group :144-225, render_overlay_image
:41-141): per-person camera-frame mesh overlay plus rotated side views of
the local and world meshes, and .obj export. pyrender/EGL is replaced by a
host C++ scanline rasterizer (`csrc/native_rasterizer.cpp`, the port's own
copy of whmr_tpu's `native/rasterizer.cpp`): no GL context, no GPU.

At first use the source is compiled with `-O3 -fPIC -shared -fopenmp` into
the git-ignored `build/whmr_tpu_torch/`, under a name that carries the hash
of the source and the flags, as `ops/cuda_build.py` names the CUDA kernels,
by the `g++` on the PATH. When it fails, the load raises with its error:
nothing falls back to a prebuilt library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from whmr_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC

SOURCE = CSRC / "native_rasterizer.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-fopenmp")
_LIB = None
_lock = threading.Lock()

# Mesh color matching the reference overlay look (renderer_cam.py uses
# light blue-ish body color).
DEFAULT_COLOR = (0.65, 0.74, 0.86, 0.9)


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libwhmr_native-{digest}.so"


def _build(so_path) -> None:
    """Compile the source with g++ and install the library atomically."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native rasterizer build needs g++ on the PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native rasterizer build failed: {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so_path)  # atomic: a concurrent loader never sees half a file


def _load_native():
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        so_path = library_path()
        if not so_path.exists():
            _build(so_path)
        lib = ctypes.CDLL(str(so_path))
        lib.whmr_render_overlay.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.whmr_clear_zbuf.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.whmr_crop_resize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ]
        for fn in (lib.whmr_render_overlay, lib.whmr_clear_zbuf, lib.whmr_crop_resize):
            fn.restype = None
        _LIB = lib
        return lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _rotmat_right_factor(rotmat: np.ndarray) -> np.ndarray:
    """Camera-pose rotation R (reference renderer_cam.py:108-110) expressed
    as a right-multiply factor in THIS renderer's frame.

    The reference mounts R on the pyrender camera (world y-up, -z forward)
    after flipping the mesh 180 deg about x (:76-78); our native rasterizer
    works directly in the CV frame (y-down, +z forward). Mapping the pyrender
    view transform into the CV frame conjugates by F = diag(1,-1,-1):
    v_cv = (F R^T F) v, i.e. row-vectors right-multiply by F R F.
    """
    f = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    return f @ np.asarray(rotmat, np.float32) @ f


def render_overlay(
    image: np.ndarray,
    verts_list: Sequence[np.ndarray],
    cam_t_list: Sequence[np.ndarray],
    faces: np.ndarray,
    focal_length: Sequence[float],
    color: Tuple[float, float, float, float] = DEFAULT_COLOR,
    cam_rotmat: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Overlay camera-frame meshes for all people on one image.

    Args:
      image: (H, W, 3) uint8 RGB.
      verts_list: per-person (6890, 3) camera-frame vertices.
      cam_t_list: per-person (3,) full-image camera translation.
      faces: (F, 3) int32.
      focal_length: per-person focal length in pixels.
      cam_rotmat: optional (3, 3) camera rotation applied to the mesh.
    """
    lib = _load_native()
    h, w = image.shape[:2]
    out = np.ascontiguousarray(image, np.uint8).copy()
    zbuf = np.empty(h * w, np.float32)
    lib.whmr_clear_zbuf(_fp(zbuf), h * w)
    faces_c = np.ascontiguousarray(faces, np.int32)
    col = np.asarray(color, np.float32)
    rot_factor = None if cam_rotmat is None else _rotmat_right_factor(cam_rotmat)
    for verts, cam_t, f in zip(verts_list, cam_t_list, np.broadcast_to(np.asarray(focal_length, np.float32), (len(verts_list),))):
        v = np.asarray(verts, np.float32)
        if rot_factor is not None:
            v = v @ rot_factor
        v = np.ascontiguousarray(v + np.asarray(cam_t, np.float32)[None])
        lib.whmr_render_overlay(
            _fp(v), v.shape[0], _i32p(faces_c), faces_c.shape[0],
            float(f), w / 2.0, h / 2.0, _fp(col), _u8p(out), _fp(zbuf), h, w,
        )
    return out


def _checkerboard_plane(
    y0: float, x_center: float, z_center: float,
    plane_width: float = 4.0, num_boxes: int = 9,
):
    """Two-tone checkerboard quads in the x-z plane at height y0
    (reference pare get_checkerboard_plane, used at renderer_cam.py:96-105).

    Returns [(verts, faces, color), ...] for the dark and light squares.
    """
    step = plane_width / num_boxes
    meshes = {0: ([], []), 1: ([], [])}
    for i in range(num_boxes):
        for j in range(num_boxes):
            x0 = x_center - plane_width / 2 + i * step
            z0 = z_center - plane_width / 2 + j * step
            verts, faces = meshes[(i + j) % 2]
            base = len(verts)
            verts += [
                (x0, y0, z0), (x0 + step, y0, z0),
                (x0 + step, y0, z0 + step), (x0, y0, z0 + step),
            ]
            faces += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    out = []
    for tone, rgb in ((0, (0.35, 0.35, 0.35)), (1, (0.85, 0.85, 0.85))):
        verts, faces = meshes[tone]
        out.append(
            (
                np.asarray(verts, np.float32),
                np.asarray(faces, np.int32),
                np.asarray((*rgb, 1.0), np.float32),
            )
        )
    return out


def render_side_view(
    verts_list: Sequence[np.ndarray],
    cam_t_list: Sequence[np.ndarray],
    faces: np.ndarray,
    focal_length: float,
    resolution: Tuple[int, int],
    angle_deg: float = 270.0,
    color: Tuple[float, float, float, float] = DEFAULT_COLOR,
    rotmat: Optional[np.ndarray] = None,
    ground: bool = False,
) -> np.ndarray:
    """Rotated free-view render on a white background
    (reference render_image_group's two 270-degree side views,
    renderer_cam.py:176-215).

    rotmat: optional (3, 3) camera rotation (render_rotmat) — the reference
    mounts it on the pyrender camera pose for every view (:108-110); here
    its inverse is applied to the mesh, which is equivalent.
    ground: add the checkerboard ground plane the reference draws under the
    side views (renderer_cam.py:96-105).
    """
    h, w = resolution
    canvas = np.full((h, w, 3), 255, np.uint8)
    a = np.deg2rad(angle_deg)
    rot_y = np.array(
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
        np.float32,
    )
    all_v = [np.asarray(v, np.float32) + np.asarray(t, np.float32)[None] for v, t in zip(verts_list, cam_t_list)]
    if not all_v:
        return canvas
    if rotmat is not None:
        r = _rotmat_right_factor(rotmat)
        all_v = [v @ r for v in all_v]
    center = np.concatenate(all_v).mean(axis=0)
    lib = _load_native()
    zbuf = np.empty(h * w, np.float32)
    lib.whmr_clear_zbuf(_fp(zbuf), h * w)
    faces_c = np.ascontiguousarray(faces, np.int32)
    col = np.asarray(color, np.float32)
    z_cam = max(center[2], 3.0)
    offset = np.array([0, 0, z_cam], np.float32)
    transformed = [
        np.ascontiguousarray((v - center) @ rot_y.T + offset) for v in all_v
    ]
    if ground:
        # floor level = max y over all meshes (+y is image-down)
        y0 = float(max(v[:, 1].max() for v in transformed))
        for gv, gf, gcol in _checkerboard_plane(y0, 0.0, z_cam):
            gv = np.ascontiguousarray(gv)
            gf = np.ascontiguousarray(gf)
            lib.whmr_render_overlay(
                _fp(gv), gv.shape[0], _i32p(gf), gf.shape[0],
                float(focal_length), w / 2.0, h / 2.0, _fp(gcol),
                _u8p(canvas), _fp(zbuf), h, w,
            )
    for vr in transformed:
        lib.whmr_render_overlay(
            _fp(vr), vr.shape[0], _i32p(faces_c), faces_c.shape[0],
            float(focal_length), w / 2.0, h / 2.0, _fp(col), _u8p(canvas), _fp(zbuf), h, w,
        )
    return canvas


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Wavefront OBJ export (reference demo --save_obj path)."""
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in np.asarray(faces) + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def native_crop_resize(
    image: np.ndarray, boxes: np.ndarray, out_hw: Tuple[int, int]
) -> np.ndarray:
    """Batched bbox crop+resize via the native library.

    boxes: (N, 4) [cx, cy, box_h, box_w]; returns (N, out_h, out_w, 3) u8.
    """
    lib = _load_native()
    img = np.ascontiguousarray(image, np.uint8)
    boxes_c = np.ascontiguousarray(boxes, np.float32)
    n = boxes_c.shape[0]
    oh, ow = out_hw
    out = np.empty((n, oh, ow, 3), np.uint8)
    lib.whmr_crop_resize(
        _u8p(img), img.shape[0], img.shape[1], _fp(boxes_c), n, _u8p(out), oh, ow
    )
    return out
