"""`whmr-eval` of the port (reference evaluate/eval.py:44-62, 364-385 surface).

Counterpart of `whmr_tpu/inference/eval_cli.py`, with the same parser and
guards. Run it as

    python -m whmr_tpu_torch.inference.eval_cli --checkpoint run/checkpoints \\
        --dataset_npz labels.npz --img_dir images/ [--device cpu]

It runs on the card unless `--device cpu` is given, and raises when there
is no card; it never falls back. The model is fp32, as in whmr_tpu;
`--misc vit.attn_impl pallas` runs the ViT's attention through the port's
CUDA kernel (in fp32 its tensor-core variant, 3xTF32).

Protocol variants carried over from the reference:
- `--dataset mpi-inf-3dhp` switches the joint mapper to J17
  (eval.py:150-151); every other pose dataset evaluates J14.
- `--gendered` builds male/female SMPL GT for 3DPW-style protocols
  (core/trainer.py:784-798); requires SMPL_MALE/FEMALE.pkl in --data_dir.
- `--result_file out.npz` dumps per-sample predictions (eval.py:312-319).
- `--eval_parts` runs the LSP mask/part-segmentation protocol
  (eval.py:145-148) against GT part maps on disk, scored with
  inference/part_segm.py instead of the neural_renderer CUDA path.
- `--coco_ap` scores the full-image keypoints by COCO OKS-AP
  (inference/coco_eval.py).
- labels without `cam_rotmat` abort unless `--allow_identity_cam`: the
  reference eval REQUIRES the GT camera rotation (eval.py:157-163), and a
  silent identity fallback produces quietly-wrong world-frame metrics.
- `--bundle dir/` (instead of `--checkpoint`) scores an eval-variant
  export (`whmr-export --eval`): the metric protocol runs the exact
  deployed program, padded to its fixed batch when it has one.
- `--data_parallel N` scores the metric protocol on N ranks, one process
  each, under torchrun (N must equal its world size):

      torchrun --nproc_per_node N -m whmr_tpu_torch.inference.eval_cli \\
          --data_parallel N --checkpoint ... --dataset_npz ... --img_dir ...

  Every rank reads the same batches and scores its rows of each
  (`run_evaluation(mesh=)`); the metrics equal the one-process run's, and
  rank 0 prints them and writes `--result_file`. `--eval_parts`,
  `--coco_ap` and `--bundle` refuse it, as in whmr_tpu.

- `--regressor hmr` scores an HMR-baseline checkpoint (`whmr-train
  --regressor hmr`) on its camera-frame mesh (eval.py:174-176), the metric
  protocol only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from whmr_tpu_torch.data.loader import host_tensor

# Datasets whose reference protocol uses the 17-joint mapper (eval.py:150-151).
J17_DATASETS = ("mpi-inf-3dhp",)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a WHMR checkpoint of the port")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir of the port (<step>/payload.pt), full or weights-only")
    p.add_argument("--bundle", default=None,
                   help="eval-variant export bundle (whmr-export --eval): "
                        "score the frozen program instead of --checkpoint")
    p.add_argument("--dataset_npz", required=True, help="eval label npz")
    p.add_argument("--img_dir", required=True)
    p.add_argument("--dataset", default="custom",
                   help="protocol name (3dpw, h36m-p2, mpi-inf-3dhp, lsp, ...)")
    p.add_argument("--regressor", default="pymaf_net",
                   choices=("pymaf_net", "hmr"),
                   help="model family (reference eval.py:52); hmr is not ported yet (slice 6)")
    p.add_argument("--data_dir", default=None, help="asset dir")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--log_freq", type=int, default=10)
    p.add_argument("--result_file", default=None,
                   help="npz path for per-sample prediction dump")
    p.add_argument("--gendered", action="store_true",
                   help="use gendered SMPL GT (3DPW protocol)")
    p.add_argument("--allow_identity_cam", action="store_true",
                   help="proceed with identity cam_rotmat when labels lack it")
    p.add_argument("--eval_parts", action="store_true",
                   help="LSP mask/part-segmentation protocol")
    p.add_argument("--coco_ap", action="store_true",
                   help="COCO keypoint OKS-AP protocol (reference "
                        "datasets/coco_keypoint_dataset.py via pycocotools)")
    p.add_argument("--coco_gt", default=None,
                   help="COCO person_keypoints annotation json for --coco_ap")
    p.add_argument("--parts_dir", default=None,
                   help="directory of GT part maps (one png per sample)")
    p.add_argument("--parts_template", default="{stem}.png",
                   help="GT part-map filename from the image stem")
    p.add_argument("--data_parallel", type=int, default=0, metavar="N",
                   help="score the metric protocol on N ranks: run under torchrun with N processes")
    p.add_argument("--loader_procs", type=int, default=0,
                   help="fork-based loader worker processes (0 = threads); "
                        "same knob as whmr-train")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cuda, or cpu); no fall back")
    p.add_argument("--cfg_file", default=None,
                   help="reference-style YAML config (e.g. configs/vit-l.yaml "
                        "for checkpoints trained at that scale)")
    p.add_argument("--misc", nargs="*", default=[],
                   help="dotted config overrides: key value [key value ...]")
    return p


def resolve_device(name: str) -> torch.device:
    """The CLIs' `--device`: a CUDA device needs a card; nothing falls back
    to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return device


_EVAL_MODEL_KEYS = ("img", "center", "scale", "bbox_height", "orig_shape",
                    "bbox_info")


def data_parallel_mesh(n: int, device: torch.device):
    """The mesh of `--data_parallel N`: the N ranks of a torchrun launch
    (or of a process group already joined) on the data axis."""
    from whmr_tpu_torch.parallel.mesh import init_distributed, make_mesh

    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(f"--data_parallel {n} runs one process a rank: launch whmr-eval under "
                             f"torchrun --nproc_per_node {n}")
        init_distributed(backend="gloo" if device.type == "cpu" else None)
    world = dist.get_world_size()
    if n != world:
        raise SystemExit(f"--data_parallel {n} but the process group has {world} ranks: they must be equal")
    return make_mesh(n, device_type=device.type)


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


def _forward(model, consts, batch):
    return model(
        consts, batch["img"], batch["center"], batch["scale"], batch["bbox_height"],
        batch["orig_shape"], batch["bbox_info"], train=False, cam_rotmat=batch.get("cam_rotmat"),
    )


def load_model_state(args, cfg):
    """Build the fp32 model on `args.device` and load a checkpoint dir of the
    port into it -> (model, consts, assets). Takes the full training payload
    and the weights-only one (`checkpoints_ema`) alike. The port's model holds
    its own weights: where whmr_tpu returns `variables`, the model carries
    them."""
    from whmr_tpu_torch.data.assets import get_assets
    from whmr_tpu_torch.models.whmr import build_hmr, build_model

    device = resolve_device(getattr(args, "device", "cuda"))
    assets = get_assets(args.data_dir)
    if getattr(args, "regressor", "pymaf_net") == "hmr":
        model, consts = build_hmr(dtype=torch.float32, device=device, seed=0, assets=assets)
    else:
        model, consts = build_model(cfg, dtype=torch.float32, device=device, seed=0, assets=assets)
    restore_checkpoint(model, args.checkpoint)
    return model.eval(), consts, assets


def restore_checkpoint(model, checkpoint: str) -> None:
    """Load the weights of a checkpoint dir of the port (the full training
    payload or the weights-only one) into `model`, in place; SystemExit
    when the dir holds none."""
    from whmr_tpu_torch.utils.checkpoint import CheckpointManager, missing_checkpoint_message

    template = {
        "params": dict(model.named_parameters()),
        "batch_stats": {k: v for k, v in model.named_buffers() if k.endswith(("running_mean", "running_var"))},
    }
    weights = CheckpointManager(checkpoint).restore_weights(template) if os.path.isdir(checkpoint) else None
    if weights is None:
        raise SystemExit(missing_checkpoint_message(checkpoint))
    with torch.no_grad():
        for part in ("params", "batch_stats"):
            for k, t in template[part].items():
                t.copy_(weights[part][k])


def load_bundle_state(args, cfg):
    """Load an eval-variant export bundle for the metric protocol ->
    (served, consts, assets, forward_override). The metric step runs the
    bundle's program in place of the live forward, so the scored forward is
    the deployed one."""
    from whmr_tpu_torch.data.assets import get_assets
    from whmr_tpu_torch.inference.export import bundle_meta, load_exported
    from whmr_tpu_torch.models.regressor import body_consts_from_assets

    device = resolve_device(getattr(args, "device", "cuda"))
    # the checks read meta.json only: they come before the program's load
    meta = bundle_meta(args.bundle)
    if meta["variant"] != "eval":
        raise SystemExit(
            f"{args.bundle} is a {meta['variant']!r}-variant bundle; "
            "metric evaluation needs the eval graph (GT cam_rotmat input, "
            "world-frame outputs) — re-export with whmr-export --eval"
        )
    if getattr(args, "regressor", "pymaf_net") != "pymaf_net":
        raise SystemExit("--bundle carries the WHMR (pymaf_net) graph; "
                         "--regressor hmr needs a live --checkpoint")
    if args.eval_parts or args.coco_ap:
        raise SystemExit(
            "--eval_parts/--coco_ap need forward outputs (crop verts, "
            "full-image keypoints) the eval bundle does not export; use "
            "a live --checkpoint"
        )
    if args.data_parallel:
        raise SystemExit(
            "--data_parallel shards the live model; the exported "
            "program pins its own shapes — run the bundle single-device"
        )
    have = tuple(meta.get("crop_hw", cfg.crop_hw))
    if have != tuple(cfg.crop_hw):
        raise SystemExit(
            f"bundle was exported with crop_hw={list(have)} but the eval "
            f"config has {list(cfg.crop_hw)}; pass the --cfg_file the "
            "bundle was exported with"
        )
    if meta["batch_size"] and args.batch_size > meta["batch_size"]:
        raise SystemExit(
            f"{args.bundle} was exported with a fixed batch of "
            f"{meta['batch_size']}; pass --batch_size {meta['batch_size']} "
            "or smaller (smaller batches are padded), or re-export with "
            "--batch_size 0 for a polymorphic bundle"
        )
    served = load_exported(args.bundle, device=device)
    assets = get_assets(args.data_dir)
    consts = body_consts_from_assets(assets, device=device)

    def forward_override(consts, batch):
        out = served.call_eval(
            batch["img"], batch["center"], batch["scale"], batch["bbox_height"],
            batch["orig_shape"], batch["bbox_info"], batch["cam_rotmat"],
        )
        last_params = {"pose": out["pose"], "pred_shape": out["shape"], "pred_cam": out["camera"]}
        return out["verts_world"], last_params

    return served, consts, assets, forward_override


def main(argv=None):
    args = build_parser().parse_args(argv)

    from whmr_tpu_torch.config import config_from_args
    from whmr_tpu_torch.data.loader import BatchLoader
    from whmr_tpu_torch.data.npz_dataset import NpzDataset
    from whmr_tpu_torch.inference.evaluate import run_evaluation

    cfg = config_from_args(args)
    if args.data_parallel and (args.eval_parts or args.coco_ap):
        # those protocols run their own single-device loops; failing
        # beats silently evaluating unsharded under a sharding flag
        raise SystemExit(
            "--data_parallel is not supported with --eval_parts/--coco_ap"
        )
    if bool(args.bundle) == bool(args.checkpoint):
        raise SystemExit(
            "pass exactly one of --checkpoint (live model) or --bundle "
            "(frozen eval-variant export)"
        )
    ds = NpzDataset(cfg, args.dataset_npz, args.img_dir, is_train=False)
    # The checks of the arguments and labels come before the model is built.
    if args.regressor == "hmr" and (args.eval_parts or args.coco_ap):
        raise SystemExit("--eval_parts/--coco_ap score the WHMR forward; --regressor hmr "
                         "runs the metric protocol only")
    if args.eval_parts and not args.parts_dir:
        raise SystemExit("--eval_parts requires --parts_dir")
    if args.coco_ap and not args.coco_gt:
        raise SystemExit("--coco_ap requires --coco_gt annotations.json")
    if not (args.eval_parts or args.coco_ap):
        if ds.cam_rotmat is None and not args.allow_identity_cam:
            raise SystemExit(
                "labels carry no 'cam_rotmat': world-frame metrics would be "
                "evaluated with an identity camera (wrong for any non-level "
                "camera). Provide eval labels with cam_rotmat (reference "
                "eval.py:157-163) or pass --allow_identity_cam to proceed."
            )
        if ds.cam_rotmat is not None and ds.global_pose is None:
            # Predictions are world-frame (rotated by cam_rotmat) but GT would
            # fall back to the crop-local 'pose' — frames would silently
            # mismatch and inflate MPJPE/PVE (PA-MPJPE hides it).
            raise SystemExit(
                "labels carry 'cam_rotmat' but no 'global_pose': world-frame "
                "predictions would be scored against camera-frame GT. Provide "
                "'global_pose' (reference eval labels carry both) or drop "
                "cam_rotmat and pass --allow_identity_cam for camera-frame eval."
            )

    served = forward_override = model = mesh = None
    if args.data_parallel and not args.bundle:
        mesh = data_parallel_mesh(args.data_parallel, resolve_device(args.device))
    if args.bundle:
        served, consts, assets, forward_override = load_bundle_state(args, cfg)
    else:
        model, consts, assets = load_model_state(args, cfg)
    device = consts.smpl.v_template.device
    loader = BatchLoader(ds, args.batch_size, shuffle=False, drop_last=False,
                         num_procs=args.loader_procs)

    if args.eval_parts:
        result = run_parts_evaluation(args, cfg, model, consts, assets, ds, loader)
        print(
            "*** Final Results ***\n"
            f"Mask Accuracy: {result['mask_accuracy']:.4f}\n"
            f"Mask F1: {result['mask_f1']:.4f}\n"
            f"Parts Accuracy: {result['parts_accuracy']:.4f}"
        )
        return result

    if args.coco_ap:
        result = run_coco_ap_evaluation(args, cfg, model, consts, ds, loader)
        print(
            "*** Final Results ***\n"
            f"AP: {result['AP']:.4f}\nAP50: {result['AP50']:.4f}\n"
            f"AP75: {result['AP75']:.4f}\nAR: {result['AR']:.4f}"
        )
        return result

    gendered_smpl = None
    if args.gendered:
        from whmr_tpu_torch.data.assets import get_assets
        from whmr_tpu_torch.models.smpl import smpl_params_from_assets

        gendered_smpl = {
            g: smpl_params_from_assets(get_assets(args.data_dir, g), device=device)
            for g in ("male", "female")
        }

    def batches():
        for host_batch in loader:
            b, _n = device_eval_batch(
                host_batch,
                extra_keys=("pose", "betas", "gender", "global_pose"),
                warn_identity=True,
                device=device,
            )
            b["valid"] = host_tensor(host_batch["has_smpl"]).to(device)
            yield b

    joint_mapper = "j17" if args.dataset in J17_DATASETS else "j14"
    result = run_evaluation(
        cfg, model, consts, batches(), log_every=args.log_freq,
        gendered_smpl=gendered_smpl, joint_mapper=joint_mapper,
        result_file=args.result_file, regressor=args.regressor,
        forward_override=forward_override,
        fixed_batch=served.batch_size if served is not None else None, mesh=mesh,
    )
    if mesh is None or dist.get_rank() == 0:
        print(
            f"*** Final Results ***\nPVE: {result['pve']:.2f}\n"
            f"MPJPE: {result['mpjpe']:.2f}\nPA-MPJPE (Reconstruction Error): {result['pa_mpjpe']:.2f}"
        )
    return result


@torch.no_grad()
def run_coco_ap_evaluation(args, cfg, model, consts, ds, loader):
    """COCO keypoint OKS-AP protocol.

    Reference counterpart: datasets/coco_keypoint_dataset.py:16 +
    datasets/JointsDataset.py score predictions with pycocotools
    COCOeval(iouType='keypoints'); here the model's 49-joint full-image
    keypoints (kp_2d_w, normalized to [-1, 1]) are unnormalized to pixels,
    mapped to COCO-17 by name, and scored by the numpy OKS-AP
    implementation (inference/coco_eval.py)."""
    from whmr_tpu_torch.inference.coco_eval import (
        evaluate_oks_ap,
        load_coco_gt,
        spin49_to_coco17,
    )

    device = consts.smpl.v_template.device
    gts, name_to_id = load_coco_gt(args.coco_gt, return_name_to_id=True)
    det_score = getattr(ds, "det_score", None)
    dts = {}
    for host_batch in loader:
        b, n = device_eval_batch(host_batch, device=device)
        preds = _forward(model, consts, b)
        kp_w = preds["smpl_out"][-1]["kp_2d_w"].float().cpu().numpy()  # (B, 49, 2) in [-1,1]
        # unnormalize: px = (kp + 1) * (W/2, H/2) (inverse of regressor.py
        # kp_2d_w normalization)
        centers = host_batch["orig_shape"][:, ::-1] / 2.0  # (W/2, H/2)
        kp_px = (kp_w + 1.0) * centers[:, None, :]
        kp17, _ = spin49_to_coco17(kp_px)
        for i in range(n):
            idx = int(host_batch["sample_index"][i])
            name = os.path.basename(str(ds.imgname[idx]))
            if name not in name_to_id:
                print(f"[eval] WARNING: no COCO image entry for {name}; skipped")
                continue
            img_id = name_to_id[name]
            entry = dts.setdefault(img_id, {"kps": [], "scores": []})
            entry["kps"].append(kp17[i])
            entry["scores"].append(
                float(det_score[idx]) if det_score is not None else 1.0
            )
    dts = {
        k: {"kps": np.stack(v["kps"]), "scores": np.asarray(v["scores"])}
        for k, v in dts.items()
    }
    return evaluate_oks_ap(gts, dts)


@torch.no_grad()
def run_parts_evaluation(args, cfg, model, consts, assets, ds, loader):
    """LSP mask/part protocol: render predicted 6-part maps in the crop
    frame, score against GT part pngs (reference eval.py:145-148 +
    utils/part_utils.py, rebuilt on the port's rasterizer)."""
    import cv2

    from whmr_tpu_torch.data.augment import crop_image
    from whmr_tpu_torch.inference.part_segm import (
        render_part_segmentation,
        segmentation_metrics,
    )

    device = consts.smpl.v_template.device
    res = (cfg.img_res[1], cfg.img_res[0])  # (H, W)
    agg = {"mask_accuracy": 0.0, "mask_f1": 0.0, "parts_accuracy": 0.0}
    count = 0
    for host_batch in loader:
        b, n = device_eval_batch(host_batch, device=device)
        last = _forward(model, consts, b)["smpl_out"][-1]
        pred_parts = render_part_segmentation(assets, last["verts"], last["pred_cam"], resolution=res).cpu().numpy()
        for i in range(n):
            idx = int(host_batch["sample_index"][i])
            stem = os.path.splitext(os.path.basename(str(ds.imgname[idx])))[0]
            gt_path = os.path.join(
                args.parts_dir, args.parts_template.format(stem=stem)
            )
            if not os.path.exists(gt_path):
                continue
            gt_full = cv2.imread(gt_path, cv2.IMREAD_GRAYSCALE)
            if gt_full is None:
                print(f"[eval] WARNING: unreadable GT part map skipped: {gt_path}")
                continue
            # GT part maps are full-image; crop with the eval bbox,
            # nearest-neighbor so labels stay integral.
            gt_crop = crop_image(
                gt_full.astype(np.float32), ds.center[idx], float(ds.scale[idx]),
                cfg.img_res, nearest=True,
            ).astype(np.int32)
            m = segmentation_metrics(pred_parts[i], gt_crop)
            for k in agg:
                agg[k] += m[k]
            count += 1
    if count == 0:
        raise SystemExit(f"no GT part maps matched in {args.parts_dir}")
    return {k: v / count for k, v in agg.items()}


if __name__ == "__main__":
    main()
