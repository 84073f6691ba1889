"""`whmr-demo` of the port (reference demo/whmr_demo.py:93-172 surface).

Counterpart of `whmr_tpu/inference/demo_cli.py`, with the same parser and
guards. Run it as

    python -m whmr_tpu_torch.inference.demo_cli --image_folder imgs/ \\
        --output_folder out/ [--checkpoint run/checkpoints] [--device cpu]

It runs on the card unless `--device cpu` is given, and raises when there
is no card. Checkpoints are the port's (`CheckpointManager`, the full
training payload or the weights-only one); without one the weights are the
seeded random init. `--data_parallel N` and `--tensor_parallel M` serve
from one process over a grid of N x M devices (`parallel/serving.py`):
`cuda:0 .. cuda:N*M-1`, or with `--device cpu` the CPU N x M times.
"""

from __future__ import annotations

import argparse

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WHMR folder-mode demo (PyTorch port)")
    p.add_argument("--image_folder", required=True)
    p.add_argument("--output_folder", default="output")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir of the port (random init if omitted)")
    p.add_argument("--data_dir", default=None, help="asset dir")
    p.add_argument(
        "--detector", default=None, choices=["full", "file", "iuv", "contour"],
        help="person detector: iuv (model's dense-IUV head — needs trained "
             "weights), contour (foreground blobs), full (whole image), "
             "file (--bbox_file json). Default: iuv when --checkpoint is "
             "given, full otherwise (an untrained IUV head detects nothing).",
    )
    p.add_argument("--bbox_file", default=None, help="json bboxes for --detector file")
    p.add_argument("--max_people", type=int, default=8)
    p.add_argument("--data_parallel", type=int, default=0, metavar="N",
                   help="split each crop batch over N model replicas, one a device row")
    p.add_argument("--tensor_parallel", type=int, default=0, metavar="M",
                   help="split ViT block weights over the M devices of each row")
    p.add_argument("--no_render", action="store_true")
    p.add_argument("--save_obj", action="store_true")
    p.add_argument("--no_camcalib", action="store_true")
    p.add_argument("--bundle", default=None,
                   help="whmr-export bundle dir: run the frozen program "
                        "instead of building the model (no --checkpoint "
                        "needed; bundle batch must equal --max_people or be "
                        "polymorphic)")
    p.add_argument("--cfg_file", default=None,
                   help="reference-style YAML config (e.g. configs/vit-l.yaml)")
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                   help="live-model compute dtype; fp32 matches the torch "
                        "reference demo. Bundles fix their dtype at export")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, or cpu); no fall back")
    p.add_argument("--misc", nargs="*", default=[],
                   help="dotted config overrides: key value [key value ...]")
    return p


def serving_mesh(args):
    """Resolve --data_parallel/--tensor_parallel into a (data, model)
    `ServingGrid`, or None for the plain single-device path. dp x tp devices
    in all: batch rows spread over "data", ViT block weights over "model".
    On cards they are `cuda:0 ..` and must be present; `--device cpu`
    repeats the CPU."""
    from whmr_tpu_torch.parallel.serving import make_serving_grid

    dp = getattr(args, "data_parallel", 0) or 0
    tp = getattr(args, "tensor_parallel", 0) or 0
    if not dp and not tp:
        return None
    device_type = torch.device(getattr(args, "device", "cuda")).type
    need = max(dp, 1) * max(tp, 1)
    if device_type != "cpu":
        have = torch.cuda.device_count()
        if need > have:
            raise SystemExit(
                f"--data_parallel {dp} x --tensor_parallel {tp} needs {need} "
                f"devices, but only {have} are present"
            )
    return make_serving_grid(max(dp, 1), max(tp, 1), device_type=device_type)


def live_weights(args, cfg):
    """The port's WHMR state_dict: the seeded random init, or the weights of
    `args.checkpoint`."""
    from whmr_tpu_torch.inference.eval_cli import restore_checkpoint
    from whmr_tpu_torch.models.whmr import build_model

    model, _ = build_model(cfg, dtype=torch.float32, device="cpu", seed=0)
    if args.checkpoint:
        restore_checkpoint(model, args.checkpoint)
    return model.state_dict()


def build_pipeline(args):
    """Model + DemoPipeline construction shared by whmr-demo, whmr-video and
    whmr-serve. `args` needs: misc, data_dir, checkpoint, max_people,
    no_camcalib, device."""
    from whmr_tpu_torch.config import config_from_args
    from whmr_tpu_torch.data.assets import get_assets
    from whmr_tpu_torch.inference.eval_cli import resolve_device
    from whmr_tpu_torch.inference.pipeline import DemoPipeline

    cfg = config_from_args(args)
    assets = get_assets(args.data_dir)
    device = resolve_device(getattr(args, "device", "cuda"))
    if getattr(args, "bundle", None):
        if args.checkpoint:
            raise SystemExit(
                "--bundle already carries its weights; drop --checkpoint "
                "(or drop --bundle to run the live model)"
            )
        if getattr(args, "data_parallel", 0) or getattr(args, "tensor_parallel", 0):
            raise SystemExit(
                "--data_parallel/--tensor_parallel need the live model "
                "(--checkpoint): an exported bundle is traced for a "
                "single device"
            )
        if getattr(args, "dtype", "fp32") != "fp32":
            raise SystemExit(
                "--dtype applies to the live model; a bundle's compute "
                "dtype was fixed at export time"
            )
        return DemoPipeline(
            cfg, None, assets,
            max_people=args.max_people,
            use_camcalib=not args.no_camcalib,
            bundle=args.bundle,
            device=device,
        )
    mesh = serving_mesh(args)
    return DemoPipeline(
        cfg, live_weights(args, cfg), assets,
        max_people=args.max_people,
        use_camcalib=not args.no_camcalib,
        dtype=torch.bfloat16 if getattr(args, "dtype", "fp32") == "bf16" else None,
        mesh=mesh,
        device=device,
    )


def detector_kind(args) -> str:
    """Resolve the detector choice (shared by whmr-demo and whmr-video).

    The IUV-proposal detector runs the live model's dense-IUV head as a
    separate pass, which a frozen bundle cannot serve — so bundle mode
    defaults to `full` and rejects an explicit `--detector iuv`."""
    bundle = getattr(args, "bundle", None)
    kind = args.detector or ("iuv" if (args.checkpoint and not bundle) else "full")
    if bundle and kind == "iuv":
        raise SystemExit(
            "--detector iuv needs the live model (a separate dense-IUV "
            "fg-mask pass); with --bundle use contour, full, or file"
        )
    return kind


def main(argv=None):
    args = build_parser().parse_args(argv)

    from whmr_tpu_torch.inference.detector import build_detector

    kind = detector_kind(args)
    pipeline = build_pipeline(args)
    pipeline.detector = build_detector(kind, args.bbox_file, pipeline=pipeline)
    stats = pipeline.run_folder(
        args.image_folder, args.output_folder,
        render=not args.no_render, save_obj_files=args.save_obj,
    )
    print(
        f"W-HMR demo: {stats['images']} images, {stats['people']} people, "
        f"{stats['fps']:.2f} img/s -> results in {args.output_folder}"
    )
    return stats


if __name__ == "__main__":
    main()
