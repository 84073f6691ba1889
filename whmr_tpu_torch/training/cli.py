"""`whmr-train` of the port (reference train.py + core/train_options.py surface).

Counterpart of `whmr_tpu/training/cli.py`, with the same parser and checks,
over the port's Trainer, NpzDataset and BatchLoader. Run it as

    python -m whmr_tpu_torch.training.cli --train_npz labels.npz --img_dir images/ [--device cpu]

It trains on the card unless `--device cpu` is given, and raises when there
is no card; it never falls back. Beside whmr_tpu's parser: `--device`;
`--bf16` computes in torch.bfloat16; `--profile DIR` writes a torch.profiler
trace of a few steps and, beside it, `spans_<pid>.json`: the tracer's
summary of the window (utils/profiling.py). `--regressor hmr` trains the HMR baseline (no GT render, no
`--grad_accum`).

Parallel training runs one process a card under torchrun, which the CLI
detects by its environment and joins (`parallel.init_distributed`):

    torchrun --nproc_per_node 8 -m whmr_tpu_torch.training.cli --train_npz ... [--model_parallel 2] [--fsdp]

Every rank is on the data axis unless `--model_parallel M` splits the ViT
blocks over M adjacent ranks; `--fsdp` shards the parameters and Adam's
moments over the data axis. `--batch_size` is the global batch. Each data
rank loads from its disjoint slice of the epoch (`num_hosts`/`host_index`
from the data rank, as whmr_tpu's cli.py:169-176) and trains on its rows
of those batches (`training/trainer.py`); rank 0 writes the logs and
checkpoints.
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train the WHMR model of the port (reference train.py:41-69 surface)"
    )
    p.add_argument("--cfg_file", default=None, help="reference-style YAML config")
    p.add_argument("--regressor", default="pymaf_net",
                   choices=("pymaf_net", "hmr"),
                   help="model to train: the full WHMR (pymaf_net) or the "
                        "plain SPIN-style HMR baseline (reference "
                        "core/train_options.py:19-20, trainer.py:406-440)")
    p.add_argument("--log_dir", default="runs")
    p.add_argument("--name", default=None, help="run name (default: timestamp)")
    p.add_argument("--data_dir", default=None, help="asset dir (SMPL files etc.)")
    p.add_argument("--train_npz", default=None, action="append",
                   help="label npz path(s); repeat for a mixture")
    p.add_argument("--img_dir", default=None, action="append",
                   help="image root(s), aligned with --train_npz")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--log_every", type=int, default=100,
                   help="write a metrics.jsonl record every N steps")
    p.add_argument("--save_every", type=int, default=None,
                   help="also checkpoint every N batches (mid-epoch resume)")
    p.add_argument("--save_epochs", type=int, default=1,
                   help="checkpoint every K epoch boundaries (plus the "
                        "final one); >1 keeps small-dataset runs from "
                        "being dominated by checkpoint writes")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--pretrained", default=None,
                   help="init weights from a torch .pt/.pth (full WHMR or "
                        "bare vitpose backbone) or a checkpoint dir of the port; "
                        "optimizer/epoch start fresh (reference "
                        "base_trainer.load_pretrained + pose_vit.py:21)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel ranks a ViT block (under torchrun)")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3-style parameter and optimizer-state sharding over the data axis (under torchrun)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--ema_decay", type=float, default=None, metavar="D",
                   help="maintain an exponential moving average of the "
                        "weights (saved to <run>/checkpoints_ema; serve "
                        "or evaluate it by pointing --checkpoint there)")
    p.add_argument("--grad_accum", type=int, default=None, metavar="K",
                   help="accumulate gradients over K sequential "
                        "microbatches per optimizer step (batch_size %% K "
                        "== 0); ~K x less activation memory at the same "
                        "effective batch")
    p.add_argument("--host_norm", action="store_true",
                   help="normalize crops on the host (f32 feed) instead "
                        "of the default uint8 feed + in-graph "
                        "normalization (bit-identical math, 4x less "
                        "host->device traffic — train_step.device_normalize)")
    p.add_argument("--no_aug", action="store_true",
                   help="disable train-time augmentation (deterministic "
                        "samples; the overfit-regression protocol)")
    p.add_argument("--cache_images", action="store_true",
                   help="memoize decoded images in RAM (small datasets "
                        "only; removes the per-step PNG decode, the feed "
                        "bottleneck on low-core hosts)")
    p.add_argument("--loader_procs", type=int, default=0,
                   help="fork-based loader worker processes (0 = GIL-bound "
                        "threads)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler (Chrome trace) of a few "
                        "training steps into DIR (view with ui.perfetto.dev), "
                        "and the spans' summary of the window (spans_<pid>.json)")
    p.add_argument("--profile_steps", type=int, default=3,
                   help="steps inside the --profile trace window")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu); no fall back")
    p.add_argument("--misc", nargs="*", default=[],
                   help="dotted config overrides: key value [key value ...]")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch
    import torch.distributed as dist

    from whmr_tpu_torch.config import WHMRConfig, load_yaml
    from whmr_tpu_torch.data.loader import BatchLoader
    from whmr_tpu_torch.data.npz_dataset import MixtureDataset, NpzDataset
    from whmr_tpu_torch.inference.eval_cli import resolve_device
    from whmr_tpu_torch.parallel.mesh import init_distributed
    from whmr_tpu_torch.training.trainer import Trainer

    cfg = load_yaml(args.cfg_file) if args.cfg_file else WHMRConfig()
    if len(args.misc) % 2:
        # an odd list means a forgotten value (or key): pairing would
        # silently shift every following override onto the wrong key
        raise SystemExit(
            f"--misc needs key value pairs; got an odd number of tokens "
            f"({len(args.misc)}): {' '.join(args.misc)}"
        )
    overrides = dict(zip(args.misc[::2], args.misc[1::2]))
    if args.batch_size:
        overrides["train.batch_size"] = args.batch_size
    if args.grad_accum:
        overrides["train.grad_accum"] = args.grad_accum
    if args.ema_decay is not None:
        overrides["train.ema_decay"] = args.ema_decay
    if overrides:
        cfg = cfg.with_overrides(**overrides)

    name = args.name or time.strftime("%Y%m%d_%H%M%S")
    log_dir = os.path.join(args.log_dir, name)

    if not args.train_npz:
        raise SystemExit("--train_npz is required (reference-format label npz)")
    img_dirs = args.img_dir or [os.path.dirname(p) for p in args.train_npz]
    if len(img_dirs) == 1 and len(args.train_npz) > 1:
        # one shared image root for several label files is a common layout
        img_dirs = img_dirs * len(args.train_npz)
    if len(img_dirs) != len(args.train_npz):
        # zip would silently DROP the unmatched label files from the mixture
        raise SystemExit(
            f"--img_dir count ({len(img_dirs)}) must match --train_npz "
            f"count ({len(args.train_npz)}) — or pass exactly one shared "
            "image root"
        )
    datasets = [
        NpzDataset(cfg, npz, img_dir, name=os.path.basename(npz),
                   is_train=True, use_augmentation=not args.no_aug,
                   cache_images=args.cache_images,
                   device_norm=not args.host_norm)
        for npz, img_dir in zip(args.train_npz, img_dirs)
    ]
    dataset = datasets[0] if len(datasets) == 1 else MixtureDataset(datasets)
    steps_per_epoch = args.steps_per_epoch or max(
        1, len(dataset) // cfg.train.batch_size
    )

    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        # under torchrun: one process a rank
        init_distributed(backend="gloo" if device.type == "cpu" else None)
    trainer = Trainer(
        cfg,
        log_dir,
        data_dir=args.data_dir,
        model_parallel=args.model_parallel,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        steps_per_epoch=steps_per_epoch,
        fsdp=args.fsdp,
        regressor=args.regressor,
        device=device,
        local_batches=True,
    )
    resumed = args.resume and trainer.resume()
    if resumed:
        print(
            f"resumed from step {trainer.state.step} "
            f"(epoch {trainer.epoch}, batch {trainer.batch_idx})"
        )
    if args.pretrained and not resumed:
        # Pretrained init only applies to fresh runs; a resumed run's
        # weights come from its own checkpoint.
        trainer.load_pretrained(args.pretrained)

    def loader_factory(epoch):
        # Per-data-rank disjoint slices (DistributedSampler equivalent),
        # each rank loading its B / D rows a step: without the slices every
        # rank would feed the same samples.
        loader = BatchLoader(
            dataset, cfg.train.batch_size // trainer.data_ranks,
            num_hosts=trainer.data_ranks, host_index=trainer.data_index,
            num_procs=args.loader_procs,
        )
        loader.set_epoch(epoch)
        return loader

    if args.profile:
        trainer.enable_profiling(args.profile, steps=args.profile_steps)
    # SIGTERM (cluster preemption) -> consistent mid-epoch checkpoint at
    # the next batch boundary, exit 0; continue with --resume.
    trainer.install_preemption_handler()
    trainer.fit(
        loader_factory,
        num_epochs=args.num_epochs,
        steps_per_epoch=args.steps_per_epoch,
        log_every=args.log_every,
        save_every=args.save_every,
        save_epochs=args.save_epochs,
    )
    print(f"done at step {trainer.state.step}; logs in {log_dir}")
    return trainer


if __name__ == "__main__":
    main()
