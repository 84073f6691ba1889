"""`whmr-export` of the port: checkpoint -> serving bundle (torch.export).

Counterpart of `whmr_tpu/inference/export_cli.py` (the reference deploys by
loading its torch codebase, demo/tester.py:55-66). Run it as

    python -m whmr_tpu_torch.inference.export_cli --checkpoint run/checkpoints \\
        --output bundle/ [--camcalib split] [--eval] [--bf16] [--device cpu]

The bundle (`forward.pt2`, `camcalib.pt2` in split mode, `meta.json`) is
restored by `whmr_tpu_torch.inference.export.load_exported`. A program is
traced on one device: `--device` (the card by default; no fall back) takes
the place of whmr_tpu's `--platforms`. `--check` reloads the bundle and runs
one batch through it on that device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a WHMR checkpoint of the port to a serving bundle")
    p.add_argument("--checkpoint", required=True, help="checkpoint dir of the port")
    p.add_argument("--output", required=True, help="bundle output directory")
    p.add_argument("--batch_size", type=int, default=48,
                   help="fixed serving batch; 0 exports a batch-polymorphic "
                        "program (any batch size)")
    p.add_argument("--camcalib", nargs="?", const="batch", default=None,
                   choices=("batch", "split"),
                   help="include the CamCalib branch (demo graph, "
                        "tester.py:100-104). 'batch' (the bare-flag "
                        "default) traces the full frame into the main "
                        "graph — one frame per batch, no cross-frame "
                        "coalescing; 'split' exports a second per-frame "
                        "CamCalib graph and the main graph takes per-crop "
                        "cam_rotmat, so whmr-serve coalesces crops from "
                        "different frames (one calibration per unique "
                        "frame, content-hash cached)")
    p.add_argument("--eval", action="store_true", dest="eval_variant",
                   help="export the EVAL graph instead of the demo one: "
                        "GT cam_rotmat input, normalized fp32 crops, "
                        "metric-protocol outputs — consumed by "
                        "whmr-eval --bundle (reference protocol "
                        "eval.py:155-228)")
    p.add_argument("--device", default="cuda",
                   help="device the program is traced on and checked on "
                        "(cuda, or cpu); no fall back")
    p.add_argument("--bf16", action="store_true",
                   help="trace with bfloat16 compute (parameters stay fp32)")
    p.add_argument("--check", action="store_true",
                   help="reload the bundle and run one batch through it")
    p.add_argument("--data_dir", default=None, help="asset dir")
    p.add_argument("--cfg_file", default=None,
                   help="reference-style YAML config — required to match the "
                        "checkpoint's geometry when it was trained with one "
                        "(e.g. configs/vit-l.yaml)")
    p.add_argument("--misc", nargs="*", default=[],
                   help="dotted config overrides: key value [key value ...]")
    return p


def bundle_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def main(argv=None):
    args = build_parser().parse_args(argv)

    from whmr_tpu_torch.config import config_from_args
    from whmr_tpu_torch.inference.eval_cli import load_model_state
    from whmr_tpu_torch.inference.export import (
        batch_args,
        eval_args,
        export_camcalib,
        export_serving,
        fetch,
        load_exported,
        save_exported,
    )
    from whmr_tpu_torch.models.whmr import WHMR

    if args.eval_variant and args.camcalib:
        raise SystemExit(
            "--eval and --camcalib are mutually exclusive: the eval "
            "protocol feeds the GT cam_rotmat (eval.py:157-163), not the "
            "CamCalib branch"
        )
    cfg = config_from_args(args)
    model, consts, _assets = load_model_state(args, cfg)
    dtype = torch.float32
    if args.bf16:
        # the bundle fixes its compute dtype: trace a bf16 twin with the same weights
        dtype = torch.bfloat16
        twin = WHMR(cfg, dtype=dtype)
        twin.load_state_dict(model.state_dict())
        model = twin.to(consts.smpl.v_template.device).eval()
    model.requires_grad_(False)

    variant = "eval" if args.eval_variant else "demo"
    program = export_serving(cfg, model, consts, args.batch_size, camcalib=args.camcalib, variant=variant)
    cam_program = export_camcalib(cfg, model) if args.camcalib == "split" else None
    save_exported(args.output, program, cfg, args.batch_size, args.camcalib, variant=variant,
                  cam_program=cam_program, dtype=dtype)
    print(f"[export] bundle written to {args.output} "
          f"({bundle_bytes(args.output) / 1e6:.1f} MB, device={args.device}, "
          f"batch={args.batch_size}, camcalib={args.camcalib}, "
          f"variant={variant}, dtype={dtype})")

    if args.check:
        served = load_exported(args.output, device=args.device)
        b = args.batch_size or 4
        if args.eval_variant:
            out = served.call_eval(*eval_args(cfg, b, args.device))
        else:
            a = batch_args(cfg, b, args.camcalib, args.device)
            # both modes accept the frame: 'batch' feeds it to the main
            # graph, 'split' routes it through camcalib_fn
            full_u8 = None
            if args.camcalib:
                ch, cw = cfg.cam_img_size
                full_u8 = np.random.RandomState(0).randint(0, 255, (1, ch, cw, 3), np.uint8)
            out = served(*a[:6], full_u8=full_u8)
        host = fetch(out)
        finite = all(bool(np.isfinite(v).all()) for v in host.values())
        print("[export] check: " + ", ".join(f"{k}{tuple(v.shape)}" for k, v in sorted(host.items())))
        print(f"[export] check outputs finite: {finite}")
        if not finite:
            raise SystemExit("exported graph produced non-finite outputs")
    return args.output


if __name__ == "__main__":
    main()
