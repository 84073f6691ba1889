"""In-repo multi-person detectors for the demo pipeline.

Counterpart of `whmr_tpu/inference/detector.py`; the IUV detector runs the
port's `WHMR.iuv_logits` on the pipeline's device. The reference demo's first stage is an external MPT YOLOv3 detector
(`/root/reference/demo/tester.py:25,68-79` — a separate GPU model shipped as
a pip package with downloaded weights). This environment ships no pretrained
detector (no torchvision, no OpenCV HOG/cascades), so the framework provides
two self-contained backends with the same role and interface, letting
`whmr-demo` run on raw images without a bbox file:

- `IUVProposalDetector`: W-HMR's own dense-IUV auxiliary head run over the
  full frame. The dp_head's part-index maps segment person foreground
  (DensePose semantics), whose connected components become person boxes —
  a detector that reuses the checkpoint the user already loads and needs
  no extra weights.
- `ContourPersonDetector`: foreground-blob detection (Otsu threshold +
  connected components with person-ish aspect/area gates). For synthetic,
  studio, or high-contrast footage, and for deterministic tests.

Any callable `(image[, name]) -> List[Detection]` plugs into DemoPipeline;
these join FullImageDetector / BboxFileDetector (pipeline.py:44-69).
"""

from __future__ import annotations

from typing import List

import cv2
import numpy as np

from whmr_tpu_torch.inference.pipeline import Detection

# MPT pads detections with a context margin before cropping
# (multi-person-tracker's bbox scale); mirrored by both detectors.
BOX_MARGIN = 1.1


def _merge_overlapping(dets: List[Detection], iou_thresh: float = 0.55) -> List[Detection]:
    """Greedy square-box NMS keeping the highest-scored of overlapping pairs."""
    dets = sorted(dets, key=lambda d: -d.score)
    kept: List[Detection] = []
    for d in dets:
        ok = True
        for k in kept:
            half_d, half_k = d.size / 2, k.size / 2
            x_ov = max(0.0, min(d.cx + half_d, k.cx + half_k) - max(d.cx - half_d, k.cx - half_k))
            y_ov = max(0.0, min(d.cy + half_d, k.cy + half_k) - max(d.cy - half_d, k.cy - half_k))
            inter = x_ov * y_ov
            union = d.size**2 + k.size**2 - inter
            if union > 0 and inter / union > iou_thresh:
                ok = False
                break
        if ok:
            kept.append(d)
    return kept


def _components_to_detections(
    mask: np.ndarray,
    scale_x: float,
    scale_y: float,
    min_area_frac: float,
    max_area_frac: float,
    aspect_range,
    max_people: int,
) -> List[Detection]:
    """Connected components of a binary mask -> person Detections in the
    original frame (mask coords x scale)."""
    n, _, stats, centroids = cv2.connectedComponentsWithStats(mask.astype(np.uint8))
    area_img = float(mask.shape[0] * mask.shape[1])
    dets: List[Detection] = []
    for i in range(1, n):  # 0 = background
        x, y, bw, bh, area = stats[i]
        if not (min_area_frac <= area / area_img <= max_area_frac):
            continue
        # Aspect in FRAME space: the mask is anisotropically resized (e.g.
        # a 1280x720 frame into a 256x192 mask), so mask-space bh/bw is
        # inflated by scale_x/scale_y (~2.4x for 16:9 into 4:3) and a tall
        # standing person would wrongly fail the gate.
        aspect = (bh * scale_y) / max(bw * scale_x, 1e-6)
        if not (aspect_range[0] <= aspect <= aspect_range[1]):
            continue
        dets.append(
            Detection(
                cx=float(centroids[i][0]) * scale_x,
                cy=float(centroids[i][1]) * scale_y,
                size=float(max(bw * scale_x, bh * scale_y)) * BOX_MARGIN,
                score=float(area / area_img),
            )
        )
    dets = _merge_overlapping(dets)
    dets.sort(key=lambda d: -d.score)
    return dets[:max_people]


class IUVProposalDetector:
    """Person proposals from W-HMR's own dense-IUV head on the full frame.

    One forward: full image -> backbone -> deconv pyramid -> dp_head ->
    part-index foreground mask on the model's device; components -> boxes
    on the host. Requires a trained/converted checkpoint (the same one the
    demo loads anyway) and a config with `pymaf.aux_supv_on` so dp_head
    exists. The model is shared with the pipeline, whose forward may run on
    another thread at the same time: both run in eval mode under
    `torch.inference_mode`.
    """

    def __init__(
        self,
        cfg,
        model,
        min_area_frac: float = 0.004,
        max_area_frac: float = 0.9,
        aspect_range=(0.5, 8.0),
        max_people: int = 16,
    ):
        from whmr_tpu_torch.inference.export import Normalize

        self.cfg = cfg
        self.model = model.eval()
        self.min_area_frac = min_area_frac
        self.max_area_frac = max_area_frac
        self.aspect_range = aspect_range
        self.max_people = max_people
        self._device = next(model.parameters()).device
        self._norm = Normalize().to(self._device)

    def _fg(self, img_u8: np.ndarray) -> np.ndarray:
        import torch

        from whmr_tpu_torch.inference.export import to_device

        with torch.inference_mode():
            x = self._norm(to_device(img_u8, self._device))
            logits = self.model.iuv_logits(x[None])[0]
            # DensePose ann-index channel 0 = background
            return (logits.argmax(dim=-1) > 0).cpu().numpy()

    def __call__(self, image: np.ndarray, name: str = "") -> List[Detection]:
        h, w = image.shape[:2]
        ch, cw = self.cfg.crop_hw
        resized = cv2.resize(image.astype(np.uint8), (cw, ch))
        mask = self._fg(resized)
        mask = cv2.morphologyEx(
            mask.astype(np.uint8) * 255, cv2.MORPH_CLOSE, np.ones((5, 5), np.uint8)
        )
        mh, mw = mask.shape
        return _components_to_detections(
            mask > 0, w / mw, h / mh,
            self.min_area_frac, self.max_area_frac,
            self.aspect_range, self.max_people,
        )


class ContourPersonDetector:
    """Foreground-blob detector: gradient-energy blobs -> components.

    Assumes subjects are locally detailed against smoother backgrounds
    (synthetic renders, studio shots, chroma-key footage). Foreground =
    pixels whose Sobel magnitude exceeds the image's `grad_percentile`
    (bodies carry silhouette + shading edges; smooth backgrounds don't),
    dilated so limbs merge into one blob per person; boxes are shrunk
    back by the dilation margin. Components are gated by area fraction
    and a loose person aspect ratio.

    Measured on composited GT frames (scripts/bench_detector.py /
    tests/test_detector_quality.py, smooth random-gradient backgrounds):
    recall 1.00, precision 1.00, mean IoU 0.89 (1 person) / 0.91 (2
    person) — the previous grayscale-Otsu formulation scored recall
    0.17/0.08 there (Otsu shatters non-uniform backgrounds).
    """

    def __init__(
        self,
        min_area_frac: float = 0.003,
        max_area_frac: float = 0.7,
        aspect_range=(0.5, 6.0),  # height / width
        max_people: int = 16,
        grad_percentile: float = 95.0,
        min_grad: float = 30.0,
        dilate_radius: int = 5,
    ):
        self.min_area_frac = min_area_frac
        self.max_area_frac = max_area_frac
        self.aspect_range = aspect_range
        self.max_people = max_people
        self.grad_percentile = grad_percentile
        self.min_grad = min_grad
        self.dilate_radius = dilate_radius

    def __call__(self, image: np.ndarray, name: str = "") -> List[Detection]:
        gray = cv2.cvtColor(image.astype(np.uint8), cv2.COLOR_RGB2GRAY)
        gx = cv2.Sobel(gray, cv2.CV_32F, 1, 0)
        gy = cv2.Sobel(gray, cv2.CV_32F, 0, 1)
        mag = np.sqrt(gx * gx + gy * gy)
        thr = max(float(np.percentile(mag, self.grad_percentile)),
                  self.min_grad)
        mask = (mag > thr).astype(np.uint8) * 255
        r = self.dilate_radius
        k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * r + 1, 2 * r + 1))
        mask = cv2.dilate(mask, k, iterations=2)
        mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, k, iterations=2)
        dets = _components_to_detections(
            mask > 0, 1.0, 1.0,
            self.min_area_frac, self.max_area_frac,
            self.aspect_range, self.max_people,
        )
        # undo the dilation growth (2 iterations of radius r per side)
        shrink = 4.0 * r
        return [
            Detection(d.cx, d.cy, max(d.size - shrink, 4.0), d.score)
            for d in dets
        ]


def build_detector(kind: str, bbox_file: str = None, pipeline=None):
    """Factory shared by the demo CLI (`--detector`). `pipeline` (a
    DemoPipeline) is required for the model-based 'iuv' backend."""
    from whmr_tpu_torch.inference.pipeline import BboxFileDetector, FullImageDetector

    if kind == "full":
        return FullImageDetector()
    if kind == "file":
        if not bbox_file:
            raise ValueError("--detector file requires --bbox_file")
        return BboxFileDetector(bbox_file)
    if kind == "iuv":
        if pipeline is None:
            raise ValueError("--detector iuv needs the built pipeline")
        if pipeline.model is None:
            # frozen bundles have no live model for the dense-IUV pass;
            # failing here (construction) beats an AttributeError on the
            # first detector-path request
            raise ValueError(
                "detector 'iuv' needs a live model: this pipeline runs a "
                "frozen bundle — use contour, full, or file"
            )
        if not pipeline.cfg.pymaf.aux_supv_on:
            raise ValueError("--detector iuv requires pymaf.aux_supv_on")
        return IUVProposalDetector(pipeline.cfg, pipeline.model)
    if kind == "contour":
        return ContourPersonDetector()
    raise ValueError(f"unknown detector '{kind}'")
