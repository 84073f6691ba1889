"""Demo inference pipeline: images -> detections -> crops -> WHMR -> outputs.

Counterpart of `whmr_tpu/inference/pipeline.py` (reference
`demo/whmr_demo.py` + `demo/tester.py`, SPECTester :40-222): detect people,
build the per-person crop batch and bbox_info, run the model, dump per-image
pkl results, and render overlays.

- The model runs at a fixed batch of `max_people` rows (padding rows are
  masked), as in whmr_tpu, so every image launches the same kernels.
- Detection is a pluggable host stage: full-image, bbox-file, and the
  detectors of `inference/detector.py`.
- Crops travel to the card as uint8 through pinned memory with non-blocking
  copies and are normalised there. `dispatch_image` returns once the forward
  is enqueued, before the card finishes, so the next image's host work
  (detection, crops, rendering) overlaps the forward; `collect` brings every
  output back in one batch of copies and waits once.
- Overlay rendering runs on the host (`inference/renderer.py`, the port's
  C++ scanline rasterizer).

- Across cards (`mesh=`, a `parallel.ServingGrid` of d x m devices): one
  replica of the live model a grid row, the crop batch split into d equal
  row blocks, one to each replica, and with m > 1 each replica's ViT blocks
  split over its row's devices (`parallel/serving.py`). The CamCalib frame
  goes to every replica.

The pipeline runs on the card unless `device="cpu"` is given, and raises
when there is no card; it never falls back.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np
import torch

from whmr_tpu_torch.config import WHMRConfig
from whmr_tpu_torch.data.assets import SMPLAssets
from whmr_tpu_torch.inference.eval_cli import resolve_device
from whmr_tpu_torch.inference.export import (
    Normalize,
    bundle_meta,
    fetch,
    load_exported,
    to_device,
    vis_outputs,
)


@dataclass
class Detection:
    """One person bbox: center (cx, cy) and square size (h=w), score.

    track_id is assigned by the video path's TrackingDetector (-1 = none).
    """

    cx: float
    cy: float
    size: float
    score: float = 1.0
    track_id: int = -1


class FullImageDetector:
    """Single-person fallback: the whole image is the person bbox."""

    def __call__(self, image: np.ndarray) -> List[Detection]:
        h, w = image.shape[:2]
        return [Detection(w / 2.0, h / 2.0, max(h, w) * 1.0, 1.0)]


class BboxFileDetector:
    """Read per-image bboxes from a json: {filename: [[x1,y1,x2,y2], ...]}.

    Covers the reference's precomputed-detection workflows (AGORA val
    crops carry detector boxes in the labels, evaluate/base_dataset.py:119).
    """

    def __init__(self, path: str):
        with open(path) as f:
            self.boxes = json.load(f)

    def __call__(self, image: np.ndarray, name: str = "") -> List[Detection]:
        dets = []
        for x1, y1, x2, y2 in self.boxes.get(name, []):
            cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
            size = max(x2 - x1, y2 - y1) * 1.1  # context margin as MPT does
            dets.append(Detection(cx, cy, size, 1.0))
        return dets


def prepare_crop_batch(
    cfg: WHMRConfig,
    image: np.ndarray,
    detections: Sequence[Detection],
    max_people: int,
    raw_uint8: bool = False,
) -> Dict[str, np.ndarray]:
    """Person crops + camera context, padded to max_people.

    Mirrors tester.py:100-149: 256x256 crop per detection (center/scale with
    scale = size/200), vitpose width slice, bbox_info 5-vector over the
    pseudo-focal sqrt(h^2+w^2).
    """
    from whmr_tpu_torch.data.augment import crop_image, normalize_image

    h, w = image.shape[:2]
    res = cfg.img_res
    n = min(len(detections), max_people)
    crop_h, crop_w = cfg.crop_hw

    imgs = np.zeros((max_people, crop_h, crop_w, 3), np.uint8 if raw_uint8 else np.float32)
    centers = np.zeros((max_people, 2), np.float32)
    scales = np.zeros((max_people,), np.float32) + 1.0
    bbox_heights = np.zeros((max_people,), np.float32) + 1.0
    valid = np.zeros((max_people,), np.float32)

    focal = np.sqrt(h * h + w * w)
    bbox_infos = np.zeros((max_people, 5), np.float32)

    # Crop straight from the source frame: a uint8 warpAffine for the uint8
    # feed (as the training loader crops), one fp32 conversion outside the
    # loop otherwise.
    crop_src = image
    if not (raw_uint8 and image.dtype == np.uint8):
        crop_src = image.astype(np.float32)
    for i, det in enumerate(detections[:n]):
        center = np.array([det.cx, det.cy], np.float32)
        scale = det.size / 200.0
        crop = crop_image(crop_src, center, scale, res)
        if cfg.pymaf.backbone == "vitpose":
            crop = crop[:, 32:-32]
        if raw_uint8:
            # normalised on the device (a quarter of the bytes to copy)
            imgs[i] = crop if crop.dtype == np.uint8 else np.clip(crop, 0, 255).astype(np.uint8)
        else:
            imgs[i] = normalize_image(crop / 255.0)
        centers[i] = center
        scales[i] = scale
        bbox_heights[i] = det.size
        valid[i] = 1.0
        bbox_infos[i] = np.array([det.cx - w / 2.0, det.cy - h / 2.0, det.size, w, h], np.float32) / focal

    return {
        "x": imgs,
        "center": centers,
        "scale": scales,
        "bbox_height": bbox_heights,
        "orig_shape": np.tile(np.array([[h, w]], np.float32), (max_people, 1)),
        "bbox_info": bbox_infos,
        "valid": valid,
    }


def prepare_full_image(cfg: WHMRConfig, image: np.ndarray, raw_uint8: bool = False) -> np.ndarray:
    """CamCalib input: resize so the long side is cam_img_size, pad square
    (reference tester.py:100-104 resizes to 600)."""
    th, tw = cfg.cam_img_size
    h, w = image.shape[:2]
    s = min(th / h, tw / w)
    resized = cv2.resize(image, (int(w * s), int(h * s)))
    if raw_uint8:
        canvas = np.zeros((th, tw, 3), np.uint8)
        canvas[: resized.shape[0], : resized.shape[1]] = resized
        return canvas
    from whmr_tpu_torch.data.augment import normalize_image

    canvas = np.zeros((th, tw, 3), np.float32)
    canvas[: resized.shape[0], : resized.shape[1]] = resized
    return normalize_image(canvas / 255.0).astype(np.float32)


def call_detector(detector, image: np.ndarray, name: str = ""):
    """Invoke a pluggable detector: `(image, name)` if it takes one, else
    `(image)` — one calling convention for every consumer (DemoPipeline,
    whmr-serve)."""
    try:
        return detector(image, name)
    except TypeError:
        return detector(image)


def detections_array(dets: Sequence[Detection]) -> np.ndarray:
    """The response-schema detections matrix. Columns: cx, cy, size,
    score, track_id (-1 when untracked) — one definition shared by
    DemoPipeline.collect and the serving batcher."""
    return np.array(
        [[d.cx, d.cy, d.size, d.score, d.track_id] for d in dets], np.float32,
    ).reshape(len(dets), 5)


class DemoPipeline:
    """Folder-mode demo runner (reference tester.run_on_image_folder)."""

    def __init__(
        self,
        cfg: WHMRConfig,
        variables,
        assets: SMPLAssets,
        max_people: int = 8,
        detector=None,
        use_camcalib: bool = True,
        dtype=None,
        bundle: str = None,
        mesh=None,
        device=None,
    ):
        """variables: the port's WHMR state_dict (the checkpoint's weights);
        None with `bundle`, whose program holds its weights.

        bundle: path to a whmr-export directory — the demo then runs the
        frozen program (ExportedWHMR) instead of building the live model.

        dtype: the live model's compute dtype (fp32 when None).

        device: the card when None, or "cpu"; no fall back. With a mesh,
        the grid's devices.

        mesh: a `parallel.ServingGrid` ((data, model) devices,
        `parallel.make_serving_grid`): the crop batch is split over "data"
        (rows are independent, so d replicas serve d times the rows of one
        at the same outputs) and, when "model" is larger than 1, each
        replica's ViT blocks over its row's devices (the Megatron rules of
        `parallel/mesh.py`: the latency lever for ViT-L/H). The CamCalib
        frame (batch 1) is replicated. Needs `max_people % data == 0` and
        the live model."""
        self.cfg = cfg
        self.assets = assets
        self.max_people = max_people
        self.detector = detector or FullImageDetector()
        self.use_camcalib = use_camcalib
        self.mesh = mesh
        if mesh is not None:
            if bundle is not None:
                raise ValueError(
                    "data-parallel serving needs the live model: an exported "
                    "bundle is traced for a single device (torch.export fixes "
                    "the device its program runs on)"
                )
            data_axis = mesh.shape["data"]
            if max_people % data_axis != 0:
                raise ValueError(
                    f"max_people={max_people} must be divisible by the "
                    f"mesh data axis ({data_axis}) to shard the crop batch"
                )
            if mesh.lead.type == "cuda":
                resolve_device("cuda")
            self.device = mesh.lead
        else:
            self.device = resolve_device(device or "cuda")
        if bundle is not None:
            self._init_from_bundle(bundle)
            return

        from whmr_tpu_torch.models.regressor import body_consts_from_assets
        from whmr_tpu_torch.models.whmr import WHMR
        from whmr_tpu_torch.parallel.serving import ServingGrid, replicate

        model = WHMR(cfg, dtype=dtype or torch.float32)
        model.load_state_dict(variables, strict=True)
        grid = mesh if mesh is not None else ServingGrid([[self.device]])
        # (model, body constants, normaliser) of each replica, on its row's
        # lead device; the normaliser's statistics on the card once (a
        # per-call copy from pageable memory could make the host wait on
        # the stream)
        self._replicas = [
            (rep, body_consts_from_assets(assets, device=row[0]), Normalize().to(row[0]))
            for rep, row in zip(replicate(model, grid), grid.devices)
        ]
        del model
        # the lead replica: CamCalib's per-frame entry and the IUV detector
        self.model, self.consts, self._norm = self._replicas[0]
        self._served = None

    @torch.inference_mode()
    def _fwd(self, batch: Dict[str, np.ndarray], full_u8: Optional[np.ndarray]):
        """The forward on a host crop batch (uint8 crops; a per-crop
        `cam_rotmat` in the coalesced-serving path) and an optional uint8
        CamCalib frame -> one OUTPUT_KEYS dict on the device a replica, each
        on its block of rows (`export.fetch` joins them), returned before the
        card finishes. The frame ships once to each replica; its rotation
        broadcasts over the crops."""
        from whmr_tpu_torch.parallel.serving import split_rows

        batch = {k: v for k, v in batch.items() if k != "valid"}
        return [self._replica_fwd(rep, part, full_u8)
                for rep, part in zip(self._replicas, split_rows(batch, len(self._replicas)))]

    @staticmethod
    def _replica_fwd(replica, batch, full_u8) -> Dict[str, torch.Tensor]:
        model, consts, norm = replica
        device = norm.mean.device
        dev = {k: to_device(v, device) for k, v in batch.items()}
        full_x = None if full_u8 is None else norm(to_device(full_u8, device))
        out = model(
            consts, norm(dev["x"]), dev["center"], dev["scale"], dev["bbox_height"],
            dev["orig_shape"], dev["bbox_info"], train=False, full_x=full_x,
            cam_rotmat=dev.get("cam_rotmat"),
        )
        return vis_outputs(out)

    @torch.inference_mode()
    def _cam_fwd(self, full_u8: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """CamCalib alone on a (1, H, W, 3) uint8 frame -> (cam_rotmat,
        render_rotmat) on the device: one call per unique frame in the
        coalesced-serving path (serve_cli.BatchingExecutor), on the lead
        replica with a mesh."""
        return self.model.camcalib(self._norm(to_device(full_u8, self.device)))

    def _init_from_bundle(self, bundle: str) -> None:
        """Serve from a whmr-export bundle: the frozen program takes the same
        uint8 crop batch + optional frame and returns the same output dict
        as the live `_fwd` (export.OUTPUT_KEYS), so dispatch_image/collect
        need no changes."""
        # the checks read meta.json only: they come before the programs' load
        meta = bundle_meta(bundle)
        if meta["variant"] != "demo":
            raise ValueError(
                f"{bundle} is a {meta['variant']!r}-variant bundle (metric "
                "protocol graph); the demo needs a demo-variant export "
                "(whmr-export without --eval)"
            )
        if meta["camcalib"] != self.use_camcalib:
            raise ValueError(
                f"bundle was exported with camcalib={meta['camcalib']} but "
                f"the pipeline wants use_camcalib={self.use_camcalib}; "
                "re-export or pass the matching flag"
            )
        if meta["batch_size"] and meta["batch_size"] != self.max_people:
            raise ValueError(
                f"bundle has fixed batch {meta['batch_size']} but "
                f"max_people={self.max_people}; re-export with "
                f"--batch_size {self.max_people} (or 0 for polymorphic)"
            )
        if not meta["batch_size"] and meta["camcalib_mode"] == "batch" and self.max_people < 2:
            # polymorphic batch-camcalib exports constrain the symbolic batch
            # to B >= 2 (export._export) so the broadcast stays symbolic
            raise ValueError(f"camcalib-polymorphic bundles need max_people >= 2 (got {self.max_people})")
        for key, want in (
            ("crop_hw", tuple(self.cfg.crop_hw)),
            ("cam_img_size", tuple(self.cfg.cam_img_size)),
        ):
            have = tuple(meta.get(key, want))
            if have != want:
                raise ValueError(
                    f"bundle was exported with {key}={list(have)} but the "
                    f"pipeline config has {list(want)}; pass the --cfg_file "
                    "the bundle was exported with"
                )
        served = load_exported(bundle, device=self.device)
        self.model = None
        self.consts = None
        self._served = served  # exposed for servers (whmr-serve /meta)

        def fwd(batch, full_u8):
            # ExportedWHMR.__call__ owns the split protocol (per-frame
            # camcalib_fn, (B, 3, 3) broadcast, render_rotmat substitution):
            # a per-crop cam_rotmat in the batch (coalesced serving) passes
            # through; with full_u8 (one shared frame) it calibrates there
            return served(
                batch["x"], batch["center"], batch["scale"], batch["bbox_height"],
                batch["orig_shape"], batch["bbox_info"], full_u8=full_u8,
                cam_rotmat=batch.get("cam_rotmat") if served.camcalib_mode == "split" else None,
            )

        self._fwd = fwd
        if served.camcalib_mode == "split":
            def cam_fwd(full_u8):
                d = served.camcalib_fn(full_u8)
                return d["cam_rotmat"], d["render_rotmat"]

            self._cam_fwd = cam_fwd
        else:
            # "batch"-mode bundles trace CamCalib inside the whole-batch
            # graph (the frame is batch-global): no standalone entry, so
            # CamCalib coalescing needs a "split" bundle or the live model
            self._cam_fwd = None

    def dispatch_image(self, image: np.ndarray, name: str = "", dets=None):
        """Async half of run_image: detect + crop on the host, enqueue the
        forward without waiting for it. Returns an opaque pending handle.

        dets: explicit Detection list, bypassing self.detector for this
        image (a serving request that carries its own bboxes)."""
        if dets is None:
            dets = call_detector(self.detector, image, name)
        batch = prepare_crop_batch(self.cfg, image, dets, self.max_people, raw_uint8=True)
        full_u8 = None
        if self.use_camcalib:
            full_u8 = prepare_full_image(self.cfg, image, raw_uint8=True)[None]
        out = self._fwd(batch, full_u8)
        return out, batch, dets

    def collect(self, pending) -> Dict[str, np.ndarray]:
        """Blocking half: bring a dispatch_image handle to host arrays, in
        one batch of copies and one wait."""
        out, batch, dets = pending
        n = int(batch["valid"].sum())
        result = {k: v[:n] for k, v in fetch(out).items()}
        result["n_people"] = n
        # the track_id column lets a consumer regroup person slots across
        # frames (see detections_array for the schema)
        result["detections"] = detections_array(dets[:n])
        return result

    def run_image(self, image: np.ndarray, name: str = "", dets=None) -> Dict[str, np.ndarray]:
        return self.collect(self.dispatch_image(image, name, dets=dets))

    def run_folder(
        self,
        image_folder: str,
        output_folder: str,
        render: bool = True,
        save_obj_files: bool = False,
        pipeline_depth: int = 1,
    ) -> Dict[str, float]:
        os.makedirs(output_folder, exist_ok=True)
        names = sorted(
            f for f in os.listdir(image_folder) if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        t0 = time.time()
        n_people = 0
        # Software pipeline: the next `pipeline_depth` images' detector,
        # crops and forward are enqueued before image i's results are
        # fetched, so the card overlaps the host's rendering and pkl/png IO
        # instead of waiting for it. Each slot in flight holds one
        # max_people crop batch on the card.
        queue: List[Tuple[str, np.ndarray, object]] = []

        def drain():
            nonlocal n_people
            fname, img, pending = queue.pop(0)
            result = self.collect(pending)
            n_people += result["n_people"]
            self._emit(output_folder, fname, img, result, render, save_obj_files)

        for fname in names:
            raw = cv2.imread(os.path.join(image_folder, fname))
            if raw is None:
                print(f"[demo] WARNING: unreadable image skipped: {fname}")
                continue
            img = np.ascontiguousarray(raw[:, :, ::-1])
            queue.append((fname, img, self.dispatch_image(img, fname)))
            if len(queue) > max(1, pipeline_depth):
                drain()
        while queue:
            drain()
        dt = time.time() - t0
        fps = len(names) / dt if dt > 0 else 0.0
        return {"images": len(names), "people": n_people, "fps": fps}

    def _emit(
        self,
        output_folder: str,
        fname: str,
        img: np.ndarray,
        result: Dict[str, np.ndarray],
        render: bool,
        save_obj_files: bool,
    ) -> None:
        from whmr_tpu_torch.inference.renderer import render_overlay, render_side_view, save_obj

        n = result["n_people"]
        stem = os.path.splitext(fname)[0]
        with open(os.path.join(output_folder, f"{stem}.pkl"), "wb") as f:
            pickle.dump(result, f)
        if render and n > 0:
            # render_rotmat rides every view, matching the reference's
            # camera pose (renderer_cam.py:108-110, render_image_group
            # :173-215); side views add the checkerboard ground plane.
            render_rotmat = result["render_rotmat"][0]
            overlay = render_overlay(
                img,
                [result["verts"][i] for i in range(n)],
                [result["pred_cam_t"][i] for i in range(n)],
                self.assets.faces,
                result["focal_length"][:n],
                cam_rotmat=render_rotmat,
            )
            side_local = render_side_view(
                [result["verts"][i] for i in range(n)],
                [result["pred_cam_t"][i] for i in range(n)],
                self.assets.faces, 1000.0, (img.shape[0], img.shape[0]),
                rotmat=render_rotmat, ground=True,
            )
            side_world = render_side_view(
                [result["verts_world"][i] for i in range(n)],
                [result["pred_cam_t"][i] for i in range(n)],
                self.assets.faces, 1000.0, (img.shape[0], img.shape[0]),
                rotmat=render_rotmat, ground=True,
            )
            panel = np.concatenate([overlay, side_local, side_world], axis=1)
            cv2.imwrite(os.path.join(output_folder, f"{stem}_overlay.png"), panel[:, :, ::-1])
        if save_obj_files and n > 0:
            save_obj(os.path.join(output_folder, f"{stem}.obj"), result["verts_world"][0], self.assets.faces)
