"""The training loop: epochs, validation, checkpointing, metric logging.

Counterpart of `whmr_tpu/training/trainer.py` (reference `core/trainer.py`
Trainer / `core/base_trainer.py` BaseTrainer) around the port's train step:

- epoch loop with per-epoch loader reshuffle (trainer.py:322-378), batches
  fed to the card ahead of the compute by `data.loader.device_prefetch`
- periodic validation -> MPJPE/PA-MPJPE/PVE -> best-checkpoint
  (trainer.py:638-665, 753-907)
- resume from the latest checkpoint incl. step counters, mid-epoch position
  and the LR schedule's step (base_trainer.py:35-48)
- metric stream as JSON-lines (one record per log interval with all loss
  terms, reference trainer.py:624-634)
- a SIGTERM preemption save at the next batch boundary

The loop decides its log and save cadence from host counters, so the only
host syncs are the metric read-back at log steps and the checkpoint
snapshots. The sharded trainer (`mesh`, `model_parallel`, `fsdp`) and the
HMR baseline (`regressor="hmr"`) are not ported yet and raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from whmr_tpu_torch.config import WHMRConfig
from whmr_tpu_torch.data.assets import get_assets
from whmr_tpu_torch.data.loader import device_prefetch, host_tensor
from whmr_tpu_torch.models.whmr import build_model
from whmr_tpu_torch.training.gt_renderer import build_render_consts
from whmr_tpu_torch.training.train_step import AdamState, create_train_state, train_step, train_step_accum
from whmr_tpu_torch.utils import profiling
from whmr_tpu_torch.utils.checkpoint import CheckpointManager, missing_checkpoint_message
from whmr_tpu_torch.utils.convert import is_known_buffer, merge_trees

_TORCH_CKPT_SUFFIXES = (".pt", ".pth", ".tar", ".ckpt")


class MetricWriter:
    """JSON-lines metric log (one object per record)."""

    def __init__(self, log_dir: str, name: str = "metrics"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")

    def write(self, step: int, payload: Dict[str, Any]):
        rec = {"step": int(step), "time": time.time()}
        for k, v in payload.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class Trainer:
    def __init__(
        self,
        cfg: WHMRConfig,
        log_dir: str,
        data_dir: Optional[str] = None,
        mesh=None,
        model_parallel: int = 1,
        aux_rendering: bool = True,
        dtype=torch.float32,
        seed: int = 0,
        steps_per_epoch: int = 1,
        fsdp: bool = False,
        regressor: str = "pymaf_net",
        device=None,
    ):
        if mesh is not None or model_parallel != 1 or fsdp:
            raise NotImplementedError("the sharded trainer (mesh, model_parallel, fsdp) is not ported yet (slice 5)")
        if regressor != "pymaf_net":
            raise NotImplementedError(f"regressor={regressor!r} is not ported yet (slice 6)")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.cfg = cfg
        self.log_dir = log_dir
        self.regressor = regressor
        assets = get_assets(data_dir)
        self.model, self.consts = build_model(cfg, dtype=dtype, device=self.device, seed=seed, assets=assets)
        # Real DensePose chart when present (reference
        # densepose_methods.py:17 reads data/UV_data/UV_Processed.mat):
        # annotated uvia_gt samples and rendered GT maps must share one
        # chart, so auto-discover it next to the SMPL assets rather than
        # silently training the IUV head on the synthetic fallback chart.
        dp_mat = None
        root = data_dir or os.environ.get("WHMR_DATA_DIR", "")
        if root:
            cand = os.path.join(root, "UV_data", "UV_Processed.mat")
            if os.path.exists(cand):
                dp_mat = cand
                print(f"[trainer] DensePose chart: {cand}", flush=True)
        self.render_consts = (
            build_render_consts(assets, densepose_mat=dp_mat, mesh=cfg.pymaf.gt_render_mesh, device=self.device)
            if aux_rendering and (cfg.pymaf.aux_supv_on or cfg.pymaf.depth_supv_on)
            else None
        )
        self.state = create_train_state(cfg, self.model, steps_per_epoch=steps_per_epoch)
        self.accum = max(int(cfg.train.grad_accum), 1)
        if self.accum > 1 and cfg.train.batch_size % self.accum:
            raise ValueError(
                f"train.grad_accum={self.accum} must divide "
                f"train.batch_size={cfg.train.batch_size}"
            )
        self.ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints"))
        # EMA weights go to a sibling dir with a weights-only payload —
        # restore_weights accepts both flavors.
        self.ckpt_ema = (
            CheckpointManager(os.path.join(log_dir, "checkpoints_ema"))
            if self.state.ema_params is not None else None
        )
        self.metrics = MetricWriter(log_dir)
        # Run-config dump (reference utils/train_utils.py:54-65 writes
        # args.json + cfg.yaml into the run dir).
        with open(os.path.join(log_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
        self.epoch = 0
        # Mid-epoch resume position (reference base_trainer.py:45-48,
        # trainer.py:346: `checkpoint_batch_idx` skips already-seen batches).
        self.batch_idx = 0
        # Host-side optimizer-step counter for log/save cadence. Counts
        # steps taken by THIS process across epochs — the per-epoch batch
        # index would never hit a log_every/save_every larger than the
        # epoch length, and nothing here waits for the card to decide.
        self.steps_seen = 0
        # The step RNG (drop path, dropout): one generator on the device,
        # not checkpointed (whmr_tpu does not checkpoint its key either).
        self.rng = torch.Generator(device=self.device).manual_seed(seed + 1)
        # Preemption flag: set by install_preemption_handler's SIGTERM
        # handler; train_epoch checkpoints and exits at the next batch
        # boundary.
        self._preempted = False
        # torch.profiler window, set by enable_profiling: train_epoch opens
        # the trace after `skip` warm-up steps and closes it `steps` later.
        self._profile = None
        # Host-clock spans of the loop ("step": a step's enqueue, "log": the
        # metric read-back, "save": a checkpoint call), recorded when a
        # profiling.Timer is set here; off by default.
        self.timer: Optional[profiling.Timer] = None

    def _span(self, name: str):
        return self.timer.span(name) if self.timer is not None else contextlib.nullcontext()

    def enable_profiling(self, log_dir: str, steps: int = 3, skip: int = 2):
        """Capture a Chrome trace of `steps` training steps, starting after
        `skip` steps (so warm-up and cold caches stay out of the window).
        One capture per process."""
        self._profile = {"dir": log_dir, "steps": steps, "skip": skip,
                         "active": False, "done": False, "prof": None}

    def install_preemption_handler(self, signals=None) -> None:
        """SIGTERM (the cluster-preemption signal) → save a mid-epoch
        checkpoint at the next batch boundary, then exit 0. The handler
        only sets a flag: the save runs in the training loop, so the
        in-flight step finishes and the checkpoint is consistent. `resume`
        then continues at the exact batch where preemption hit."""
        import signal as _signal

        for sig in signals or (_signal.SIGTERM,):
            _signal.signal(sig, lambda *_: setattr(self, "_preempted", True))

    # -- checkpoint lifecycle (reference base_trainer.py:35-48) --------------
    def _payload(self, batch_idx: int) -> Dict[str, Any]:
        """The checkpoint tree of the live state (tensors, not copies)."""
        names = list(self.state.params)
        opt = self.state.opt_state
        return {
            "params": self.state.params,
            "batch_stats": self.state.batch_stats,
            "opt_state": {"count": opt.count, "mu": dict(zip(names, opt.mu)), "nu": dict(zip(names, opt.nu))},
            "step": self.state.step,
            "epoch": self.epoch,
            "batch_idx": int(batch_idx),
        }

    def _weights(self, params) -> Dict[str, Any]:
        return {"params": params, "batch_stats": self.state.batch_stats}

    @torch.no_grad()
    def resume(self) -> bool:
        """Load the latest checkpoint into the live state: parameters,
        BatchNorm statistics, Adam moments and count (so the LR schedule's
        step), step, epoch, mid-epoch batch and the EMA weights. Returns
        False when there is none."""
        payload = self.ckpt.restore(template=self._payload(0))
        if payload is None:
            return False
        for k, p in self.state.params.items():
            p.copy_(payload["params"][k])
        for k, b in self.state.batch_stats.items():
            b.copy_(payload["batch_stats"][k])
        opt = payload["opt_state"]
        names = list(self.state.params)
        self.state.opt_state = AdamState(
            count=int(opt["count"]), mu=[opt["mu"][k] for k in names], nu=[opt["nu"][k] for k in names],
        )
        self.state.step = int(payload["step"])
        if self.ckpt_ema is not None:
            ema = self.ckpt_ema.restore(template=self._weights(self.state.ema_params))
            # older run without an EMA dir: restart the average from the
            # restored params
            src = ema["params"] if ema is not None else payload["params"]
            for k, e in self.state.ema_params.items():
                e.copy_(src[k])
        self.epoch = int(payload["epoch"])
        self.batch_idx = int(payload.get("batch_idx", 0))
        return True

    @torch.no_grad()
    def load_pretrained(self, path: str, strict: bool = False) -> int:
        """Initialize weights from a pretrained checkpoint before training.

        `path` is a torch .pt/.pth (a reference WHMR checkpoint, or a bare
        ViT backbone such as `vitpose-b-multi-coco.pth`, whose `backbone.*`
        keys map under `feature_extractor.`) or a checkpoint directory of
        this port. The port keeps the reference's key names, so the
        state_dict maps directly, once the reference's constant buffers
        (`is_known_buffer`) are dropped. Only matching-shape leaves present
        in the checkpoint are overwritten; optimizer state, step and epoch
        stay fresh. With `strict`, a key of another shape or one that is
        neither this model's nor a known buffer raises. Returns the number
        of parameter leaves loaded.
        """
        if path.endswith(_TORCH_CKPT_SUFFIXES):
            # A reference checkpoint may pickle its options next to the
            # weights, so this is not a weights_only load: load only files
            # you trust, as with torch.load itself.
            ckpt = torch.load(path, map_location="cpu", weights_only=False)
            sd = ckpt
            for key in ("model", "state_dict"):
                if isinstance(ckpt, dict) and key in ckpt and isinstance(ckpt[key], dict):
                    sd = ckpt[key]
                    break
            model_keys = self.model.state_dict().keys()
            # The reference's constant buffers (SMPL, Dmaps, init_*,
            # points_grid, ...) are not this model's to load: drop them, as
            # whmr_tpu's convert_whmr_checkpoint skips them.
            sd = {k.replace("module.", ""): v for k, v in sd.items()}
            sd = {k: v for k, v in sd.items() if not is_known_buffer(k)}
            sd = {
                ("feature_extractor." + k if k not in model_keys and "feature_extractor." + k in model_keys
                 else k): v
                for k, v in sd.items()
            }
        else:
            if not os.path.isdir(path):
                raise FileNotFoundError(f"no checkpoint at {path}")
            payload = CheckpointManager(path).restore()
            if payload is None:
                raise FileNotFoundError(missing_checkpoint_message(path))
            sd = {**payload["params"], **payload.get("batch_stats", {})}

        live = self.model.state_dict()
        host_params = {k: v.detach().cpu() for k, v in live.items() if k in self.state.params}
        host_rest = {k: v.detach().cpu() for k, v in live.items() if k not in self.state.params}
        params, rep_p = merge_trees(host_params, {k: v for k, v in sd.items() if k in host_params})
        rest, rep_s = merge_trees(host_rest, {k: v for k, v in sd.items() if k not in host_params})
        problems = rep_p["mismatched"] + rep_s["mismatched"] + rep_p["extra"] + rep_s["extra"]
        if problems:
            msg = f"pretrained load: {len(problems)} unmatched/mismatched keys"
            if strict:
                raise ValueError(msg + ": " + "; ".join(problems[:10]))
            print(f"[trainer] WARNING {msg} (first: {problems[:5]})")
        # Copies into the live tensors, which the train state holds.
        self.model.load_state_dict({**params, **rest}, strict=True)
        print(
            f"[trainer] loaded pretrained {path}: {rep_p['matched']} param "
            f"leaves (+{rep_s['matched']} buffers)"
        )
        return rep_p["matched"]

    def save(self, metric: Optional[float] = None, batch_idx: int = 0, block: bool = True):
        """block=False makes the disk write asynchronous. The snapshot to
        host memory is still synchronous, so the next step may update the
        parameters and moments in place safely; used by mid-epoch periodic
        saves."""
        with self._span("save"):
            self.ckpt.save(self.state.step, self._payload(batch_idx), metric=metric, block=block)
            if self.ckpt_ema is not None:
                # weights-only flavor
                self.ckpt_ema.save(self.state.step, self._weights(self.state.ema_params), block=block)

    # -- train loop ----------------------------------------------------------
    def _step(self, batch):
        fn = train_step_accum if self.accum > 1 else train_step
        return fn(self.cfg, self.model, self.state, self.consts, batch, self.rng, self.render_consts)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stop_profile(self):
        prof = self._profile
        self._sync()
        path = profiling.stop_trace(prof["prof"], prof["dir"])
        prof.update(active=False, done=True, prof=None)
        print(f"[trainer] profile trace written to {path}", flush=True)

    def train_epoch(
        self,
        loader: Iterable[Dict[str, np.ndarray]],
        log_every: int = 100,
        max_steps: Optional[int] = None,
        start_batch: int = 0,
        save_every: Optional[int] = None,
    ) -> Dict[str, float]:
        last = {}
        # Mid-epoch resume: fast-forward past already-trained batches
        # (reference trainer.py:346 skip via checkpoint_batch_idx). Prefer
        # the loader's index-level skip (no decode/augment work for skipped
        # samples); islice over a generic iterable still pays full pipeline
        # cost per skipped sample.
        if start_batch and hasattr(loader, "set_start_batch"):
            loader.set_start_batch(start_batch)
            it = iter(loader)
        else:
            it = iter(loader)
            if start_batch:
                it = itertools.islice(it, start_batch, None)
        if self.accum > 1:
            # (B, ...) -> (K, B/K, ...) on the host, for train_step_accum
            k = self.accum
            it = ({key: np.asarray(v).reshape(k, -1, *np.shape(v)[1:]) for key, v in b.items()} for b in it)
        # Keep 2 batches in flight on the device: host batch assembly
        # overlaps device compute (replaces DataLoader prefetch_factor,
        # trainer.py:143).
        for i, batch in enumerate(device_prefetch(it, size=2, device=self.device), start=start_batch):
            if max_steps is not None and i >= max_steps:
                break
            prof = self._profile
            if prof and not prof["done"]:
                rel = i - start_batch
                if not prof["active"] and rel == prof["skip"]:
                    # drain in-flight steps so the window holds only the
                    # traced steps
                    self._sync()
                    prof.update(prof=profiling.start_trace(), active=True)
                elif prof["active"] and rel == prof["skip"] + prof["steps"]:
                    self._stop_profile()
            with self._span("step"):
                self.state, metrics = self._step(batch)
            self.batch_idx = i + 1
            self.steps_seen += 1
            if (log_every and self.steps_seen % log_every == 0) or (
                max_steps is not None and i == max_steps - 1
            ):
                # one read-back of all the metrics
                with self._span("log"):
                    values = torch.stack([v.float() for v in metrics.values()]).tolist()
                last = dict(zip(metrics.keys(), values))
                self.metrics.write(self.state.step, last)
            saved_this_step = False
            if save_every and self.steps_seen % save_every == 0:
                # async disk write: training resumes after the host snapshot
                self.save(batch_idx=i + 1, block=False)
                saved_this_step = True
            if self._preempted:
                if saved_this_step:
                    # the periodic save above already wrote this exact
                    # step: just drain its async write before exiting
                    self.ckpt.wait_until_finished()
                    if self.ckpt_ema is not None:
                        self.ckpt_ema.wait_until_finished()
                else:
                    self.save(batch_idx=i + 1, block=True)
                print(
                    f"[trainer] preempted: checkpoint saved at step "
                    f"{self.state.step} (epoch {self.epoch}, batch "
                    f"{i + 1}); resume to continue", flush=True,
                )
                raise SystemExit(0)
        if self._profile and self._profile["active"]:
            # epoch ended inside the trace window: close it cleanly
            self._stop_profile()
        return last

    def make_validate_fn(self, val_loader_factory, gendered_smpl=None):
        """Validation hook for fit(): runs the eval pipeline over a loader
        (reference trainer.validate, trainer.py:753-849). The model runs in
        eval mode for it and returns to train mode after."""
        from whmr_tpu_torch.inference.eval_cli import device_eval_batch
        from whmr_tpu_torch.inference.evaluate import run_evaluation

        def validate(state):
            def batches():
                # Same prep as whmr-eval (ONE definition): in particular
                # 'global_pose' must ride along — run_evaluation rotates
                # predictions into the world frame via cam_rotmat, and a
                # dropped global_pose would silently score them against the
                # crop-local 'pose', inflating MPJPE/PVE and mis-ranking
                # best checkpoints.
                for hb in val_loader_factory():
                    b, n = device_eval_batch(
                        hb,
                        extra_keys=("pose", "betas", "gender", "global_pose"),
                        device=self.device,
                    )
                    b["valid"] = host_tensor(hb.get("has_smpl", np.ones(n, np.float32))).to(self.device)
                    yield b

            return run_evaluation(
                self.cfg, self.model, self.consts, batches(),
                log_every=0, gendered_smpl=gendered_smpl, regressor=self.regressor,
            )

        return validate

    def fit(
        self,
        loader_factory,
        num_epochs: Optional[int] = None,
        validate_fn=None,
        steps_per_epoch: Optional[int] = None,
        log_every: int = 100,
        save_every: Optional[int] = None,
        save_epochs: int = 1,
    ):
        """Full fit loop (reference trainer.py:638-665).

        loader_factory(epoch) -> iterable of host batches.
        validate_fn(state) -> dict with 'pa_mpjpe' for best-ckpt tracking.
        save_every: also checkpoint mid-epoch every N batches (with the
          batch_idx payload enabling mid-epoch resume).
        save_epochs: checkpoint every K epoch boundaries (always the
          final one). The reference saves per epoch, but its epochs are
          165k samples (mixed_dataset.py:64); with small datasets the
          per-epoch write would dominate wall-clock.
        """
        num_epochs = num_epochs or self.cfg.train.num_epochs
        resume_batch = self.batch_idx  # only the resumed (first) epoch skips
        for epoch in range(self.epoch, num_epochs):
            self.epoch = epoch
            loader = loader_factory(epoch)
            start_batch, resume_batch = resume_batch, 0
            self.train_epoch(
                loader, log_every=log_every, max_steps=steps_per_epoch,
                start_batch=start_batch, save_every=save_every,
            )
            self.batch_idx = 0
            metric = None
            if validate_fn is not None:
                val = validate_fn(self.state)
                self.metrics.write(self.state.step, {f"val_{k}": v for k, v in val.items()})
                metric = val.get("pa_mpjpe")
            # Epoch-boundary checkpoints record the NEXT epoch (reference
            # saver call sites trainer.py:362,662 save epoch+1 with batch 0)
            # so a resume continues at E+1 instead of retraining epoch E.
            self.epoch = epoch + 1
            if (epoch + 1) % max(save_epochs, 1) == 0 or epoch + 1 == num_epochs:
                self.save(metric=metric)
        return self.state
