"""`whmr-convert` of the port: a reference torch checkpoint -> a checkpoint
directory of the port.

Counterpart of `whmr_tpu/utils/convert_cli.py`. Run it as

    python -m whmr_tpu_torch.utils.convert_cli --torch_ckpt w-hmr-p-vitpose_checkpoint.pt \\
        --out converted/ [--strict] [--misc key value ...] [--device cpu]

The port keeps the reference's key names, so no layout changes: the
checkpoint's state_dict (under `--state_dict_key`, default "model"; "none"
for a bare state_dict; `module.` prefixes stripped) loses the reference's
constant buffers (`convert.is_known_buffer`: SMPL, Dmaps, init_*,
points_grid, BatchNorm step counters, CamCalib's ImageNet head), and the
rest is merged by shape over a freshly built model of the `--misc`
config (`convert.merge_trees`), so leaves the checkpoint lacks keep their
init. It prints whmr_tpu's report: the keys it does not recognise, the
matched parameters (+ BatchNorm statistics), the mismatched shapes and the
unmatched keys; `--strict` fails on any of them (torch's strict=True,
reference tester.py:65).

The output is a weights-only checkpoint at step 0 (`{params, batch_stats}`,
what `CheckpointManager.restore_weights` reads): `whmr-eval --checkpoint`,
`whmr-train --pretrained` and the serving CLIs take it. whmr_tpu also
writes a fresh optimizer state there; a run that starts from it gets a
fresh one from `whmr-train` anyway.

The template model is built on `--device` (the card unless `--device cpu`),
as every entry point of the port.
"""

from __future__ import annotations

import argparse

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert a reference .pt checkpoint into a checkpoint of the port")
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--out", required=True, help="checkpoint dir of the port")
    p.add_argument("--state_dict_key", default="model", help="key inside the .pt (or 'none')")
    p.add_argument("--data_dir", default=None, help="asset dir")
    p.add_argument("--strict", action="store_true",
                   help="fail on any mismatched/unmatched/unrecognized key "
                        "(torch's strict=True, tester.py:65)")
    p.add_argument("--cfg_file", default=None, help="reference-style YAML config")
    p.add_argument("--misc", nargs="*", default=[],
                   help="dotted config overrides: key value [key value ...]")
    p.add_argument("--device", default="cuda",
                   help="torch device of the template model (cuda, or cpu); no fall back")
    return p


def convert(state_dict, model: torch.nn.Module):
    """Merge a reference state_dict over `model`'s weights by shape ->
    ({"params", "batch_stats"} host tensors, report). The report has
    whmr_tpu's fields: "unrecognized" (keys neither the model's nor known
    constants), "params" and "batch_stats" (`merge_trees` reports: matched,
    mismatched, extra)."""
    from whmr_tpu_torch.utils.convert import is_known_buffer, merge_trees

    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    sd = {k: torch.as_tensor(v) for k, v in sd.items() if not is_known_buffer(k)}
    host = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    params = {k: host[k] for k, _ in model.named_parameters()}
    stats = {k: v for k, v in host.items() if k.endswith(("running_mean", "running_var"))}
    unrecognized = sorted(k for k in sd if k not in params and k not in stats)
    merged_p, rep_p = merge_trees(params, {k: v for k, v in sd.items() if k in params})
    merged_s, rep_s = merge_trees(stats, {k: v for k, v in sd.items() if k in stats})
    weights = {
        "params": {k: v.float() for k, v in merged_p.items()},
        "batch_stats": {k: v.float() for k, v in merged_s.items()},
    }
    return weights, {"unrecognized": unrecognized, "params": rep_p, "batch_stats": rep_s}


def main(argv=None):
    args = build_parser().parse_args(argv)

    from whmr_tpu_torch.config import config_from_args
    from whmr_tpu_torch.data.assets import get_assets
    from whmr_tpu_torch.inference.eval_cli import resolve_device
    from whmr_tpu_torch.models.whmr import build_model
    from whmr_tpu_torch.utils.checkpoint import CheckpointManager

    # A reference checkpoint may pickle its options next to the weights, so
    # this is not a weights_only load: convert only files you trust.
    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    sd = ckpt if args.state_dict_key == "none" else ckpt.get(args.state_dict_key, ckpt)
    cfg = config_from_args(args)
    model, _ = build_model(cfg, dtype=torch.float32, device=resolve_device(args.device), seed=0,
                           assets=get_assets(args.data_dir))
    weights, report = convert(sd, model)
    rep_p, rep_s = report["params"], report["batch_stats"]
    if report["unrecognized"]:
        print(f"unrecognized ckpt keys ({len(report['unrecognized'])}):")
        for k in report["unrecognized"][:20]:
            print("  ", k)
    print(
        f"matched params: {rep_p['matched']} (+{rep_s['matched']} batch stats); "
        f"mismatched: {len(rep_p['mismatched'])}; unmatched ckpt keys: {len(rep_p['extra'])}"
    )
    for m in (rep_p["mismatched"] + rep_s["mismatched"])[:20]:
        print("  MISMATCH", m)
    problems = (
        len(rep_p["mismatched"]) + len(rep_s["mismatched"])
        + len(rep_p["extra"]) + len(rep_s["extra"]) + len(report["unrecognized"])
    )
    if args.strict and problems:
        raise SystemExit(f"--strict: {problems} conversion problems (see above)")
    CheckpointManager(args.out).save(0, weights)
    print(f"wrote a checkpoint of the port to {args.out}")
    return report


if __name__ == "__main__":
    main()
