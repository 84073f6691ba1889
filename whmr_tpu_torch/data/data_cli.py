"""Dataset tooling for the reference npz label format (`whmr-data`).

A copy of `whmr_tpu/data/data_cli.py` (the port imports nothing of
whmr_tpu). Run as `python -m whmr_tpu_torch.data.data_cli <command>`.

Net-new vs the reference, which documents its label schema only
implicitly through `datasets/base_dataset.py:249-384` reads and ships no
validation — a malformed field there surfaces as a mid-epoch crash. Here:

    python -m whmr_tpu_torch.data.data_cli check labels.npz [--img_dir imgs/] [--sample 16]
    python -m whmr_tpu_torch.data.data_cli coco person_keypoints.json labels.npz
    python -m whmr_tpu_torch.data.data_cli tcmr 3dpw_test_db.pt labels.npz

`check` validates the schema NpzDataset consumes (data/npz_dataset.py): required fields and shapes, dtype coercibility,
finiteness, value-range sanity (scale > 0, keypoint confidences in
[0, 1], has_smpl binary, cam_rotmat orthonormal), cross-field length
consistency, and — with --img_dir — that a sample of the referenced
images exists and decodes. Unknown keys warn (the loader ignores them).
Exit code 0 = loadable, 1 = errors found.

`coco` converts a COCO person-keypoints json (data/coco.py:32).
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WHMR dataset tooling")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("check", help="validate an npz label file")
    c.add_argument("npz")
    c.add_argument("--img_dir", default=None,
                   help="also check that referenced images exist/decode")
    c.add_argument("--sample", type=int, default=16,
                   help="images to spot-check under --img_dir (0 = all)")
    c.add_argument("--train", action="store_true",
                   help="require the training-only fields (pose/shape)")

    k = sub.add_parser("coco", help="convert COCO person-keypoints json")
    k.add_argument("annotation_json")
    k.add_argument("out_npz")
    k.add_argument("--min_keypoints", type=int, default=6)

    t = sub.add_parser(
        "tcmr",
        help="convert a TCMR/VIBE db file (joblib .pt) to the npz schema "
             "(reference ThreeDPW_dataset.py:16-57 reads these directly)",
    )
    t.add_argument("db_pt")
    t.add_argument("out_npz")
    t.add_argument("--img_dir", default=None,
                   help="image root for probing sizes (path-list flavor)")
    return p


# field -> (trailing shape, required-in-train, value check name)
_SCHEMA = {
    "imgname": ((), True, None),
    "center": ((2,), True, "finite"),
    "scale": ((), True, "positive"),
    "pose": ((72,), "train", "finite"),
    "shape": ((10,), "train", "finite"),
    "has_smpl": ((), False, "binary"),
    "S": ((24, 4), False, "kp_conf"),
    "part": ((24, 3), False, "kp_conf"),
    "openpose": ((25, 3), False, "kp_conf"),
    "gender": ((), False, None),
    "cam_rotmat": ((3, 3), False, "rotmat"),
    "global_pose": ((72,), False, "finite"),
    "det_score": ((), False, "finite"),
}


def check_npz(npz_path, img_dir=None, sample=16, train=False,
              out=sys.stdout):
    """-> (errors, warnings): lists of strings. Printed to `out`."""
    import numpy as np

    errors, warnings = [], []

    def err(msg):
        errors.append(msg)

    def warn(msg):
        warnings.append(msg)

    try:
        data = np.load(npz_path, allow_pickle=True)
    except Exception as e:
        err(f"cannot read {npz_path}: {e}")
        return errors, warnings

    keys = set(data.files)
    if "imgname" not in keys:
        err("missing required field 'imgname'")
        return errors, warnings
    n = len(data["imgname"])
    if n == 0:
        # whmr-data coco on a json with no qualifying persons produces
        # exactly this — fail loudly rather than crash on empty reductions
        err("0 samples (empty 'imgname')")
        print(f"{npz_path}: 0 samples\n  ERROR: {errors[0]}\n  -> INVALID",
              file=out)
        return errors, warnings

    for field, (tail, required, vcheck) in _SCHEMA.items():
        if field not in keys:
            if required is True or (required == "train" and train):
                err(f"missing required field '{field}'")
            continue
        arr = data[field]
        want = (n, *tail)
        if tuple(arr.shape) != want:
            err(f"'{field}' has shape {tuple(arr.shape)}, expected {want}")
            continue
        if vcheck is None:
            continue
        try:
            vals = arr.astype(np.float64)
        except (TypeError, ValueError):
            err(f"'{field}' dtype {arr.dtype} is not numeric")
            continue
        if not np.isfinite(vals).all():
            err(f"'{field}' contains non-finite values "
                f"({int((~np.isfinite(vals)).sum())} entries)")
            continue
        if vcheck == "positive" and (vals <= 0).any():
            err(f"'{field}' must be > 0 (h/200 bbox scale); "
                f"min={vals.min():.4g}")
        elif vcheck == "binary":
            if not np.isin(vals, (0.0, 1.0)).all():
                err(f"'{field}' must be 0/1 flags")
        elif vcheck == "kp_conf":
            conf = vals[..., -1]
            if conf.min() < 0 or conf.max() > 1 + 1e-6:
                err(f"'{field}' confidence column outside [0, 1] "
                    f"(range [{conf.min():.3g}, {conf.max():.3g}])")
        elif vcheck == "rotmat":
            m = vals[: min(n, 64)]
            eye = np.eye(3)
            dev = np.abs(m @ np.swapaxes(m, -1, -2) - eye).max()
            if dev > 1e-3:
                err(f"'{field}' not orthonormal (max |R R^T - I| = {dev:.3g})")

    if ("pose" in keys) != ("shape" in keys):
        warn("'pose' and 'shape' should come together; the loader treats "
             "a lone one as no-SMPL-GT (npz_dataset.py:96-103)")
    if "part" not in keys and "openpose" not in keys and "S" not in keys:
        warn("no keypoint fields at all (part/openpose/S): every "
             "keypoint-supervised loss term will be masked out")
    unknown = keys - set(_SCHEMA)
    if unknown:
        warn(f"unknown fields ignored by the loader: {sorted(unknown)}")

    if img_dir is not None and not errors:
        import cv2

        names = data["imgname"]
        idx = range(n) if not sample else np.linspace(
            0, n - 1, min(sample, n), dtype=int
        )
        missing = bad = 0
        for i in idx:
            path = os.path.join(img_dir, str(names[i]))
            if not os.path.exists(path):
                missing += 1
                if missing <= 3:
                    err(f"image missing: {path}")
            elif cv2.imread(path) is None:
                bad += 1
                if bad <= 3:
                    err(f"image unreadable: {path}")
        if missing > 3 or bad > 3:
            err(f"... {missing} missing / {bad} unreadable of "
                f"{len(list(idx))} sampled")

    # summary
    print(f"{npz_path}: {n} samples", file=out)
    if "has_smpl" in keys:
        print(f"  has_smpl: {int(data['has_smpl'].sum())}/{n}", file=out)
    elif "pose" in keys:
        print(f"  has_smpl: {n}/{n} (implicit)", file=out)
    for k in ("S", "part", "openpose", "gender", "cam_rotmat",
              "global_pose", "det_score"):
        if k in keys:
            print(f"  {k}: present", file=out)
    for w in warnings:
        print(f"  WARNING: {w}", file=out)
    for e in errors:
        print(f"  ERROR: {e}", file=out)
    print(f"  -> {'OK' if not errors else 'INVALID'}", file=out)
    return errors, warnings


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "check":
        errors, _ = check_npz(args.npz, img_dir=args.img_dir,
                              sample=args.sample, train=args.train)
        raise SystemExit(1 if errors else 0)
    if args.cmd == "coco":
        from whmr_tpu_torch.data.coco import coco_to_npz

        out = coco_to_npz(args.annotation_json, args.out_npz,
                          min_keypoints=args.min_keypoints)
        n = len(out["imgname"])
        print(f"wrote {args.out_npz}: {n} persons")
        if n == 0:
            print("WARNING: no persons passed the min_keypoints filter — "
                  "the file is empty and will not validate", file=sys.stderr)
    if args.cmd == "tcmr":
        from whmr_tpu_torch.data.tcmr import tcmr_to_npz

        out = tcmr_to_npz(args.db_pt, args.out_npz, img_dir=args.img_dir)
        print(f"wrote {args.out_npz}: {len(out['imgname'])} samples, "
              f"fields {sorted(out.keys())}")


if __name__ == "__main__":
    main()
