"""Checkpoint save/resume with latest / by-step / best policies.

Counterpart of `whmr_tpu/utils/checkpoint.py` (reference `utils/saver.py`
CheckpointSaver :8-117) in torch's format: each step is a directory
`<save_dir>/<step>/` holding one `payload.pt` written by `torch.save` from
host tensors, and the best-metric copy is `<save_dir>/best/`. The payload
mirrors the reference's {model, optimizer, epoch, batch_idx,
total_step_count} as {params, batch_stats, opt_state, step, epoch,
batch_idx}: nested dicts whose leaves are tensors and Python scalars.

Writes are atomic: the payload goes to a temporary directory beside the
target, which `os.replace` then moves into place, so a kill mid-write leaves
the last good step. A directory that is overwritten (`best/`) is first moved
aside to `.old-<name>`; a kill between the two moves leaves the last good
copy there, and `restore_best` reads it. `save(block=False)` snapshots the payload to host
memory before it returns and writes it on a background thread: the caller
may update the saved tensors in place (the port's Adam does) as soon as
`save` returns.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

_PAYLOAD = "payload.pt"


def _tree_mismatch(template, got, path: str = "") -> Optional[str]:
    """First structural difference between two weight trees (nested dicts
    of arrays), as a human-readable path, or None if they match in keys
    and leaf shapes. dtype is deliberately not compared (checkpoints may
    legitimately hold a different storage dtype than the live model)."""
    t_is_map, g_is_map = hasattr(template, "items"), hasattr(got, "items")
    if t_is_map != g_is_map:
        return (f"{path or '/'}: {type(template).__name__} in model vs "
                f"{type(got).__name__} in checkpoint")
    if t_is_map:
        tk, gk = set(template.keys()), set(got.keys())
        if tk != gk:
            return (f"{path or '/'}: missing {sorted(tk - gk)}, "
                    f"unexpected {sorted(gk - tk)}")
        for k in sorted(tk):
            bad = _tree_mismatch(template[k], got[k], f"{path}/{k}")
            if bad is not None:
                return bad
        return None
    ts, gs = tuple(np.shape(template)), tuple(np.shape(got))
    if ts != gs:
        return f"{path}: checkpoint shape {gs} vs model {ts}"
    return None


def _to_host(tree):
    """A copy of `tree` in host memory: every tensor is copied (a CPU tensor
    too, so a later in-place update of the original cannot reach it), numpy
    arrays become tensors, other leaves stay as they are. The device-to-host
    copies block, so the snapshot is whole when this returns."""
    if hasattr(tree, "items"):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    return tree


def _like(got, template):
    """`got` with each tensor leaf cast to its template leaf's dtype and
    device (the template's structure has been checked)."""
    if hasattr(template, "items"):
        return {k: _like(got[k], template[k]) for k in template}
    if isinstance(template, torch.Tensor) and isinstance(got, torch.Tensor):
        return got.to(device=template.device, dtype=template.dtype)
    return got


def _old(path: str) -> str:
    """Where `_write` moves an existing `path` while it replaces it."""
    return os.path.join(os.path.dirname(path), f".old-{os.path.basename(path)}")


def _write(path: str, payload: Dict[str, Any]) -> None:
    """Atomic: a temporary directory beside `path`, then os.replace."""
    parent = os.path.dirname(path)
    tmp = os.path.join(parent, f".tmp-{os.path.basename(path)}-{os.getpid()}-{threading.get_ident()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, _PAYLOAD))
    old = _old(path)
    if os.path.exists(path):
        # A directory cannot replace a non-empty one: move the old one aside
        # first, so `path` is missing for a moment but never half written,
        # and the last good copy is in `old` until the new one is in place.
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _read(path: str, template: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The payload under `path`; with a template, checked against it and
    cast to its leaves' dtypes and devices."""
    # weights_only: the payload holds tensors, dicts and scalars only.
    payload = torch.load(os.path.join(path, _PAYLOAD), map_location="cpu", weights_only=True)
    if template is None:
        return payload
    bad = _tree_mismatch(template, payload)
    if bad is not None:
        raise ValueError(f"checkpoint {path} does not match the template: {bad}")
    return _like(payload, template)


def missing_checkpoint_message(path: str) -> str:
    """What a load says when `path` holds no checkpoint of this port."""
    return (
        f"no checkpoint of this port (<step>/payload.pt) under {path}. An orbax directory "
        "written by whmr_tpu cannot be read without orbax: export its variables to a torch "
        ".pt with whmr_tpu_torch.utils.convert.state_dict_from_flax"
    )


class CheckpointManager:
    def __init__(self, save_dir: str, max_to_keep: int = 5):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best_metric: Optional[float] = None
        self._best_dir = os.path.join(self.save_dir, "best")
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _steps(self):
        return sorted(
            int(name) for name in os.listdir(self.save_dir)
            if name.isdigit() and os.path.isfile(os.path.join(self.save_dir, name, _PAYLOAD))
        )

    def save(self, step: int, payload: Dict[str, Any], metric: Optional[float] = None,
             lower_is_better: bool = True, block: bool = True):
        """Save a step checkpoint; track/copy best by `metric`.

        The payload is copied to host memory before this returns; with
        block=False the disk write then continues on a background thread.
        Any in-flight save is always drained first, so saves never
        interleave.

        Saving a step that is already the latest on disk is a NO-OP for the
        step artifact: it happens legitimately when an epoch-boundary save
        lands on the same step as a periodic save, or when a resumed run's
        first boundary save lands on the restored step. The best-metric copy
        below still runs, so boundary metrics keep feeding best-checkpoint
        tracking."""
        self.wait_until_finished()
        write_step = self.latest_step() != step
        write_best = False
        if metric is not None:
            write_best = (
                self._best_metric is None
                or (metric < self._best_metric if lower_is_better else metric > self._best_metric)
            )
            if write_best:
                self._best_metric = float(metric)
        if not (write_step or write_best):
            return
        host = _to_host(payload)

        def write():
            if write_step:
                _write(os.path.join(self.save_dir, str(int(step))), host)
                for old in self._steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.save_dir, str(old)))
            if write_best:
                _write(self._best_dir, host)

        if block:
            write()
            return

        def run():
            try:
                write()
            except Exception as e:  # noqa: BLE001 — re-raised by wait_until_finished
                self._error = e

        self._thread = threading.Thread(target=run, name="checkpoint-write", daemon=False)
        self._thread.start()

    def wait_until_finished(self) -> None:
        """Drain the in-flight async write; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write to {self.save_dir} failed") from err

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, template: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
        """Restore by step (default latest). With a template tree the
        structure and leaf shapes are checked against it, and each tensor
        comes back with its template leaf's dtype and device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        self.wait_until_finished()
        return _read(os.path.join(self.save_dir, str(int(step))), template)

    def restore_weights(self, template: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Restore just model weights {params, batch_stats}, accepting
        either checkpoint flavor: a full training payload (params,
        batch_stats, opt_state, step, epoch, batch_idx — the trainer's main
        dir) or a weights-only payload (params, batch_stats — the EMA dir
        `checkpoints_ema`). The weight subtrees are checked against the
        template's, so a wrong-model checkpoint fails here with a clear
        diagnosis."""
        payload = self.restore()
        if payload is None:
            return None
        out = {}
        for part in ("params", "batch_stats"):
            bad = _tree_mismatch(template[part], payload.get(part, {}), part)
            if bad is not None:
                raise ValueError(
                    f"checkpoint in {self.save_dir} does not match the requested model: {bad}"
                )
            out[part] = _like(payload[part], template[part])
        return out

    def restore_best(self, template: Optional[Dict[str, Any]] = None):
        """The best/ copy; if a kill fell between `_write`'s two moves, the
        copy it had moved aside."""
        self.wait_until_finished()
        for path in (self._best_dir, _old(self._best_dir)):
            if os.path.isfile(os.path.join(path, _PAYLOAD)):
                return _read(path, template)
        return None
