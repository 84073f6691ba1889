"""The batch preparation of `whmr-eval` (whmr_tpu/inference/eval_cli.py).

Only `device_eval_batch` is ported: the trainer's validation uses it. The
CLI itself (`build_parser`, `main`, the COCO AP and LSP parts protocols,
bundle evaluation) waits for the data slice, with the npz dataset it reads.
"""

from __future__ import annotations

import torch

from whmr_tpu_torch.data.loader import host_tensor

_EVAL_MODEL_KEYS = ("img", "center", "scale", "bbox_height", "orig_shape",
                    "bbox_info")


def device_eval_batch(host_batch, extra_keys=(), warn_identity=False, device=None):
    """Shared device-batch prep for every eval protocol: model inputs +
    requested label keys on `device` (the card when None), with the
    cam_rotmat fallback in ONE place (the metric protocols warn on the
    identity substitution; the 2D protocols never use a GT camera, so they
    don't). Returns (batch, n)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to evaluate on the CPU")
        device = "cuda"
    keys = _EVAL_MODEL_KEYS + tuple(extra_keys)
    b = {k: host_tensor(v).to(device) for k, v in host_batch.items() if k in keys}
    n = b["img"].shape[0]
    if "cam_rotmat" in host_batch:
        b["cam_rotmat"] = host_tensor(host_batch["cam_rotmat"]).to(device)
    else:
        if warn_identity:
            print("[eval] WARNING: identity cam_rotmat substituted")
        b["cam_rotmat"] = torch.eye(3, device=device).expand(n, 3, 3)
    return b, n
