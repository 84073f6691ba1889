"""Serving export: freeze the WHMR forward into a `torch.export` program.

Counterpart of `whmr_tpu/inference/export.py`, with `torch.export` in place
of `jax.export`. A bundle pins the exact traced graph: no model code is
needed to serve it, only torch, numpy and this module (and the import of
`whmr_tpu_torch.ops.attention`, which registers K1's operators before a
program that holds them is loaded: `whmr::attention_qkv`, which the
pallas ViT block calls, and `whmr::attention`, the (B, H, N, D) entry,
which older bundles hold).

Layout of a bundle directory:
    forward.pt2    the serving graph, written by `torch.export.save`
    camcalib.pt2   the per-frame CamCalib graph ("split" bundles only)
    meta.json      input signature, dtypes, output keys, versions

Where whmr_tpu keeps the weights in `weights.npz` and passes them to its
graph as arguments, a torch.export program holds them itself (its
parameters and buffers, the SMPL constants among them), so the bundle has
no weights file. A program is traced on one device (`meta["device"]`):
`load_exported` moves it when asked for another.

The three CamCalib modes are whmr_tpu's: none; "batch", where one full frame
rides the main graph (a batch-global input, so crops of different frames
cannot share a batch); and "split", where a second graph runs CamCalib per
frame and the main graph takes a per-crop `cam_rotmat`. The batch is fixed,
or symbolic through `torch.export.Dim` (at least 2 in "batch" mode, where
the frame's rotation is broadcast over the batch).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from whmr_tpu_torch.config import IMG_NORM_MEAN, IMG_NORM_STD, WHMRConfig
from whmr_tpu_torch.models.regressor import BodyConsts
from whmr_tpu_torch.models.smpl import SMPLParams

EXPORT_GRAPH = "forward.pt2"
EXPORT_CAM_GRAPH = "camcalib.pt2"
EXPORT_META = "meta.json"
# What a whmr_tpu bundle holds instead (jax.export's StableHLO).
JAX_EXPORT_GRAPH = "forward.jaxexport"
FORMAT = "torch.export"

# The demo/serving output surface (pipeline.DemoPipeline's forward).
OUTPUT_KEYS = (
    "verts", "verts_world", "pred_cam_t", "focal_length", "cam_rotmat",
    "render_rotmat", "shape", "global_pose", "local_pose",
)

# The eval-variant output surface: what the metric protocol consumes
# (world verts for MPJPE/PA/PVE, final-stage pose/shape/cam for the
# --result_file dump; reference eval.py:155-228, 312-319).
EVAL_OUTPUT_KEYS = ("verts_world", "verts", "pose", "shape", "camera")


def _cam_mode(camcalib) -> Optional[str]:
    """False/None -> None, True/"batch" -> "batch", "split" -> "split"."""
    if camcalib in (False, None):
        return None
    if camcalib is True:
        return "batch"
    if camcalib in ("batch", "split"):
        return camcalib
    raise ValueError(f"camcalib must be False, 'batch', or 'split', got {camcalib!r}")


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host array (numpy or CPU tensor) on `device`. To a card it goes
    through pinned memory with a non-blocking copy, so the host does not
    wait for the stream (the caching host allocator keeps the pinned block
    until the copy has run)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fetch(out) -> Dict[str, np.ndarray]:
    """Device outputs -> host numpy in one batch: every tensor is copied
    into pinned memory with a non-blocking copy, then the host waits once a
    device (the counterpart of whmr_tpu's one `jax.device_get`). Floating
    outputs come back as float32 (numpy has no bf16). A list of such dicts
    (the replicas of a serving grid, each on its block of rows) comes back
    as one dict, the blocks' rows concatenated in order."""
    blocks = out if isinstance(out, (list, tuple)) else [out]
    host, devices = [], set()
    for block in blocks:
        h = {}
        for k, v in block.items():
            if v.is_floating_point() and v.dtype != torch.float32:
                v = v.float()
            if v.device.type == "cuda":
                devices.add(v.device)
                dst = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                dst.copy_(v, non_blocking=True)
                h[k] = dst
            else:
                h[k] = v.detach()
        host.append(h)
    for device in devices:
        torch.cuda.current_stream(device).synchronize()
    if len(host) == 1:
        return {k: v.numpy() for k, v in host[0].items()}
    return {k: np.concatenate([h[k].numpy() for h in host]) for k in host[0]}


class _Consts(nn.Module):
    """BodyConsts as registered buffers, so that an exported program holds
    them (a graph input, where whmr_tpu passes them as arguments)."""

    def __init__(self, consts: BodyConsts):
        super().__init__()
        for name, v in consts.smpl._asdict().items():
            self.register_buffer(f"smpl_{name}", v)
        for name, v in consts._asdict().items():
            if name != "smpl" and v is not None:
                self.register_buffer(name, v)

    def forward(self) -> BodyConsts:
        smpl = SMPLParams(**{n: getattr(self, f"smpl_{n}") for n in SMPLParams._fields})
        return BodyConsts(smpl, **{n: getattr(self, n, None) for n in BodyConsts._fields if n != "smpl"})


class Normalize(nn.Module):
    """uint8 images (NHWC) -> fp32, normalised with the ImageNet statistics."""

    def __init__(self):
        super().__init__()
        self.register_buffer("mean", torch.tensor(IMG_NORM_MEAN, dtype=torch.float32))
        self.register_buffer("std", torch.tensor(IMG_NORM_STD, dtype=torch.float32))

    def forward(self, u8: torch.Tensor) -> torch.Tensor:
        # uint8 in, normalised on the device: a quarter of fp32's bytes cross
        # to the card
        return (u8.float() / 255.0 - self.mean) / self.std


def _without_camcalib(model):
    """A shallow copy of `model` sharing every submodule but the CamCalib
    network: a program that never runs CamCalib then holds no copy of its
    weights (its forward raises if it tried)."""
    view = copy.copy(model)
    view._modules = {k: v for k, v in model._modules.items() if k != "cam_model"}
    return view


def vis_outputs(out) -> Dict[str, torch.Tensor]:
    """The demo output dict (OUTPUT_KEYS) of a WHMR forward."""
    vis = out["vis"]
    return {
        "verts": vis["local_smpl_vertices"],
        "verts_world": vis["smpl_vertices"],
        "pred_cam_t": vis["pred_cam_t"],
        "focal_length": vis["focal_length"],
        "cam_rotmat": vis["cam_rotmat"],
        "render_rotmat": vis["render_rotmat"],
        "shape": vis["shape"],
        "global_pose": vis["global_pose"],
        "local_pose": vis["local_pose"],
    }


class ServingModule(nn.Module):
    """The serving graph (whmr_tpu's `make_serving_fn`): uint8 crops in,
    normalised on the device, the OUTPUT_KEYS dict out. The last input is
    the (1, Hc, Wc, 3) uint8 frame in "batch" CamCalib mode, the per-crop
    (B, 3, 3) `cam_rotmat` in "split" mode, and absent without CamCalib."""

    def __init__(self, model, consts: BodyConsts, camcalib=None):
        super().__init__()
        self.mode = _cam_mode(camcalib)
        self.model = model if self.mode == "batch" else _without_camcalib(model)
        self.consts = _Consts(consts)
        self.normalize = Normalize()

    def forward(self, x_u8, center, scale, bbox_height, orig_shape, bbox_info,
                extra: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        full_x = self.normalize(extra) if self.mode == "batch" else None
        cam_rotmat = extra if self.mode == "split" else None
        out = self.model(
            self.consts(), self.normalize(x_u8), center, scale, bbox_height, orig_shape,
            bbox_info, train=False, full_x=full_x, cam_rotmat=cam_rotmat,
        )
        return vis_outputs(out)


class EvalServingModule(nn.Module):
    """The eval-variant graph (whmr_tpu's `make_eval_serving_fn`): the
    metric protocol's forward. The GT camera rotation is an input (no
    CamCalib branch), the crops arrive normalised in fp32 (the eval loader's
    output), and the outputs are EVAL_OUTPUT_KEYS. `whmr-eval --bundle`
    scores the exact program that is deployed."""

    def __init__(self, model, consts: BodyConsts):
        super().__init__()
        self.model = _without_camcalib(model)
        self.consts = _Consts(consts)

    def forward(self, img, center, scale, bbox_height, orig_shape, bbox_info,
                cam_rotmat) -> Dict[str, torch.Tensor]:
        preds = self.model(
            self.consts(), img, center, scale, bbox_height, orig_shape, bbox_info,
            train=False, cam_rotmat=cam_rotmat,
        )
        last = preds["smpl_out"][-1]
        return {
            "verts_world": preds["global_output"]["global_verts"],
            "verts": last["verts"],
            "pose": last["pose"],
            "shape": last["pred_shape"],
            "camera": last["pred_cam"],
        }


class CamCalibModule(nn.Module):
    """The standalone CamCalib graph of "split" bundles (whmr_tpu's
    `make_camcalib_fn`): one uint8 full frame -> {"cam_rotmat",
    "render_rotmat"}, both (1, 3, 3). It holds the CamCalib network only."""

    def __init__(self, model):
        super().__init__()
        self.cam_model = model.cam_model
        self.normalize = Normalize()

    def forward(self, full_u8) -> Dict[str, torch.Tensor]:
        from whmr_tpu_torch.models.whmr import camcalib

        cam_rotmat, render_rotmat = camcalib(self.cam_model, self.normalize(full_u8))
        return {"cam_rotmat": cam_rotmat, "render_rotmat": render_rotmat}


# The example batch a polymorphic export is traced at. Not 0 or 1 (torch
# specialises those) and unequal to the graph's fixed sizes (2, 3, 5, ...),
# which a trace could confuse with the batch.
_TRACE_BATCH = 7


def _model_device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def batch_args(cfg: WHMRConfig, batch: int, camcalib, device, seed: int = 0):
    """Example serving inputs in prepare_crop_batch's layout, on `device`."""
    from whmr_tpu_torch.utils.testing import make_example_inputs

    mode = _cam_mode(camcalib)
    rng = np.random.RandomState(seed)
    inp = make_example_inputs(cfg, batch, seed=seed)
    h, w = cfg.crop_hw
    args = [rng.randint(0, 255, (batch, h, w, 3), np.uint8)]
    args += [inp[k] for k in ("center", "scale", "bbox_height", "orig_shape", "bbox_info")]
    if mode == "batch":
        ch, cw = cfg.cam_img_size
        args.append(rng.randint(0, 255, (1, ch, cw, 3), np.uint8))
    elif mode == "split":
        args.append(np.broadcast_to(np.eye(3, dtype=np.float32), (batch, 3, 3)))
    return tuple(to_device(a, torch.device(device)) for a in args)


def eval_args(cfg: WHMRConfig, batch: int, device, seed: int = 0):
    """Example eval-variant inputs: normalised fp32 crops and a GT rotation."""
    from whmr_tpu_torch.utils.testing import make_example_inputs

    inp = make_example_inputs(cfg, batch, seed=seed)
    args = [inp[k] for k in ("x", "center", "scale", "bbox_height", "orig_shape", "bbox_info")]
    args.append(np.broadcast_to(np.eye(3, dtype=np.float32), (batch, 3, 3)))
    return tuple(to_device(a, torch.device(device)) for a in args)


def _export(module: nn.Module, args, batch_size: Optional[int], min_batch: int = 0):
    """torch.export of `module` at `args`; with no `batch_size`, dim 0 of
    every argument traced at _TRACE_BATCH (all but a "batch"-mode frame) is
    one symbolic batch."""
    dynamic = None
    if not batch_size:
        b = torch.export.Dim("B", min=min_batch) if min_batch else torch.export.Dim("B")
        dynamic = tuple({0: b} if a.shape[0] == _TRACE_BATCH else None for a in args)
    # the wrapper's own buffers (normalisation, constants) join the model's device
    module = module.to(args[0].device).eval()
    with torch.no_grad():
        return torch.export.export(module, args, dynamic_shapes=dynamic, strict=False)


def export_serving(cfg: WHMRConfig, model, consts: BodyConsts, batch_size: Optional[int],
                   camcalib=False, variant: str = "demo"):
    """Trace the serving forward of `model` (on its device, in its compute
    dtype) into an ExportedProgram.

    variant: "demo" (uint8 crops and the optional CamCalib input -> the vis
    dict) or "eval" (normalised fp32 crops and the GT cam_rotmat -> the
    metric-protocol dict). batch_size None or 0 -> a batch-polymorphic
    program."""
    if variant not in ("demo", "eval"):
        raise ValueError(f"unknown export variant {variant!r}")
    if variant == "eval" and camcalib:
        raise ValueError(
            "camcalib is a demo-graph branch; the eval protocol feeds the "
            "GT cam_rotmat instead (eval.py:157-163)"
        )
    device = _model_device(model)
    batch = batch_size or _TRACE_BATCH
    if variant == "eval":
        return _export(EvalServingModule(model, consts), eval_args(cfg, batch, device), batch_size)
    mode = _cam_mode(camcalib)
    args = batch_args(cfg, batch, mode, device)
    # "batch" mode broadcasts one frame's rotation over the batch, which a
    # trace decides for B >= 2 only (models/whmr.py's `batch_size > 1`)
    return _export(ServingModule(model, consts, mode), args, batch_size, 2 if mode == "batch" else 0)


def export_camcalib(cfg: WHMRConfig, model):
    """Trace the standalone CamCalib graph ("split" bundles)."""
    device = _model_device(model)
    ch, cw = cfg.cam_img_size
    frame = np.random.RandomState(0).randint(0, 255, (1, ch, cw, 3), np.uint8)
    return _export(CamCalibModule(model), (to_device(frame, device),), 1)


def save_exported(out_dir: str, program, cfg: WHMRConfig, batch_size: Optional[int], camcalib,
                  variant: str = "demo", cam_program=None, dtype=torch.float32) -> None:
    """Write a bundle: the program(s) and meta.json, with whmr_tpu's keys."""
    mode = _cam_mode(camcalib)
    if (mode == "split") != (cam_program is not None):
        raise ValueError(
            "camcalib='split' bundles carry a second exported graph: pass "
            "cam_program=export_camcalib(...) iff camcalib == 'split'"
        )
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, EXPORT_GRAPH))
    if cam_program is not None:
        torch.export.save(cam_program, os.path.join(out_dir, EXPORT_CAM_GRAPH))
    devices = {str(v.device.type) for v in program.state_dict.values()}
    meta = {
        "format": FORMAT,
        "format_version": 1,
        "torch_version": torch.__version__,
        "device": devices.pop() if len(devices) == 1 else "cpu",
        "batch_size": batch_size or 0,  # 0 = batch-polymorphic
        "camcalib": mode is not None,
        "camcalib_mode": mode or "",
        "variant": variant,
        "crop_hw": list(cfg.crop_hw),
        "cam_img_size": list(cfg.cam_img_size),
        "dtype": str(dtype).replace("torch.", ""),
        "weights": "held by the program (torch.export.save)",
        "output_keys": list(EVAL_OUTPUT_KEYS if variant == "eval" else OUTPUT_KEYS),
        "img_norm_mean": list(IMG_NORM_MEAN),
        "img_norm_std": list(IMG_NORM_STD),
    }
    with open(os.path.join(out_dir, EXPORT_META), "w") as f:
        json.dump(meta, f, indent=1)


def _load_program(path: str, device: torch.device):
    program = torch.export.load(path)
    have = {v.device for v in program.state_dict.values()}
    if have != {device}:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return program.module()


def bundle_meta(path: str) -> dict:
    """A bundle's meta.json, read without loading its programs, so that a
    consumer checks it before the load (which takes seconds). Raises on a
    directory that holds no bundle of this port, naming what it found."""
    if os.path.isfile(os.path.join(path, JAX_EXPORT_GRAPH)):
        raise ValueError(
            f"{path} is a whmr_tpu bundle (jax.export StableHLO, {JAX_EXPORT_GRAPH} and "
            f"weights.npz); this port loads torch.export bundles ({EXPORT_GRAPH}): "
            "re-export the checkpoint with the port's whmr-export"
        )
    meta_path = os.path.join(path, EXPORT_META)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"no {EXPORT_META} in {path}: not a whmr-export bundle")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path} holds a {meta.get('format')!r} bundle, not {FORMAT!r}")
    return meta


class ExportedWHMR:
    """Serving-side loader: needs torch and numpy, no model code.

    >>> served = ExportedWHMR("export_dir/")
    >>> out = served(x_u8, center, scale, bbox_height, orig_shape, bbox_info)
    >>> out["verts"].shape   # (B, 6890, 3), on the bundle's device

    Inputs may be numpy arrays or tensors; outputs are tensors on `device`
    (the device the bundle was exported on when None), returned before the
    card finishes (`fetch` brings them to the host).
    """

    def __init__(self, path: str, device=None):
        self.meta = bundle_meta(path)
        # registers K1's ops, whmr::attention_qkv and whmr::attention, which
        # pallas-attention programs hold
        import whmr_tpu_torch.ops.attention  # noqa: F401

        self.device = torch.device(device or self.meta["device"])
        self.batch_size = self.meta["batch_size"] or None  # None = any
        self.camcalib = self.meta["camcalib"]
        self.camcalib_mode = self.meta["camcalib_mode"]
        self.variant = self.meta["variant"]
        self._call = _load_program(os.path.join(path, EXPORT_GRAPH), self.device)
        self._cam_call = None
        if self.camcalib_mode == "split":
            self._cam_call = _load_program(os.path.join(path, EXPORT_CAM_GRAPH), self.device)

    def _args(self, *arrays):
        return [to_device(a, self.device) for a in arrays]

    @torch.inference_mode()
    def __call__(self, x_u8, center, scale, bbox_height, orig_shape, bbox_info,
                 full_u8=None, cam_rotmat=None) -> Dict[str, torch.Tensor]:
        if self.variant != "demo":
            raise ValueError(
                f"this is a {self.variant!r}-variant bundle; use call_eval "
                "(or whmr-eval --bundle), not the demo serving call"
            )
        args = self._args(x_u8, center, scale, bbox_height, orig_shape, bbox_info)
        if self.camcalib_mode == "batch":
            if full_u8 is None:
                raise ValueError(
                    "this artifact was exported with camcalib='batch'; pass "
                    "full_u8 (1, H, W, 3) uint8"
                )
            args.append(to_device(full_u8, self.device))
        elif self.camcalib_mode == "split":
            render = None
            if cam_rotmat is None:
                if full_u8 is None:
                    raise ValueError(
                        "this artifact was exported with camcalib='split'; "
                        "pass per-crop cam_rotmat (B, 3, 3) — or full_u8, "
                        "from which camcalib_fn derives it"
                    )
                d = self.camcalib_fn(full_u8)
                b = args[0].shape[0]
                cam_rotmat = d["cam_rotmat"].expand(b, 3, 3).contiguous()
                render = d["render_rotmat"].expand(b, 3, 3).contiguous()
            args.append(to_device(cam_rotmat, self.device))
            out = dict(self._call(*args))
            if render is not None:
                # the main graph echoes cam_rotmat as render_rotmat; give the
                # caller the pitch-flipped overlay rotation. With a
                # caller-supplied cam_rotmat the echo stands (the caller
                # holds the camcalib_fn outputs and can substitute).
                out["render_rotmat"] = render
            return out
        return dict(self._call(*args))

    @torch.inference_mode()
    def camcalib_fn(self, full_u8) -> Dict[str, torch.Tensor]:
        """Split-bundle CamCalib graph: (1, H, W, 3) uint8 full frame ->
        {'cam_rotmat', 'render_rotmat'}, each (1, 3, 3). Run once per unique
        frame; its cam_rotmat rides every crop row of that frame through
        __call__ (the coalesced-serving protocol)."""
        if self._cam_call is None:
            raise ValueError(
                "no camcalib graph in this bundle: only camcalib='split' "
                "exports carry one (whmr-export --camcalib split)"
            )
        return dict(self._cam_call(to_device(full_u8, self.device)))

    @torch.inference_mode()
    def call_eval(self, img, center, scale, bbox_height, orig_shape, bbox_info,
                  cam_rotmat) -> Dict[str, torch.Tensor]:
        """Eval-variant forward (EVAL_OUTPUT_KEYS). `img` is the loader's
        normalised fp32 crop batch; `cam_rotmat` the GT camera rotation."""
        if self.variant != "eval":
            raise ValueError(
                f"this is a {self.variant!r}-variant bundle; eval bundles "
                "are produced by whmr-export --eval"
            )
        return dict(self._call(*self._args(img, center, scale, bbox_height, orig_shape, bbox_info,
                                           cam_rotmat)))


def load_exported(path: str, device=None) -> ExportedWHMR:
    return ExportedWHMR(path, device=device)
