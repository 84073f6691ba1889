"""The readings that the limits of `correct` are set from, for one cell.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        [--traced-seeds 4,5,6] [--control-seeds 7,8,9] [--fault-seeds 7,8,9] [--seconds 2]

On the card, in one process (the kernels are built once):
- the program: one run of the cell per seed (`run.execute`, the timed path
  at the cell's sizes and load, over a short window), printing the numbers
  its check compares; those of `--traced-seeds` with `--trace 1`'s reading
  too (its per-layer metrics, device and breakdown);
- the control: the plain reference in the program's place, computed in
  float8 (e4m3, the precision below the configuration's bfloat16), against
  the float32 reference on the same inputs: the numbers it would read;
- for training cells, the program with a fault planted under the timed
  path: half of each batch left out (the loss a mean over the rest: its
  first half, and its even rows). (A step that returns its state
  unchanged reads 1 on `head_grad_err` and `update_gap` by their
  definition; `tests/test_harness_faults.py` plants it.)
Each reading is one JSON line on standard output and in
<out>/calibrate_<workload>.jsonl (`--out`, build/calibrate by default).
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def half_batch_step(train_step, rows):
    def step(cfg, model, state, consts, batch, generator=None, render_consts=None):
        n = next(iter(batch.values())).shape[0]
        sl = slice(0, n // 2) if rows == "first" else slice(0, None, 2)
        return train_step(cfg, model, state, consts, {k: v[sl] for k, v in batch.items()}, generator, render_consts)
    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--traced-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="build/calibrate")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(HERE)]
    import torch

    import assets as assets_mod
    import inputs
    import port
    import run
    import weights as weights_mod

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload = {w["name"]: w for w in bench["workloads"]}[args.workload]
    dev = torch.device("cuda")
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    log = open(out / f"calibrate_{args.workload}.jsonl", "a")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    seeds = [(int(s), False) for s in args.seeds.split(",") if s]
    seeds += [(int(s), True) for s in args.traced_seeds.split(",") if s]
    for s, trace in seeds:
        line = run.execute(bench, workload, s, args.seconds, trace, dev)
        emit({"kind": "program_traced" if trace else "program", "seed": s, "correct": line["correct"],
              "checks": {k: c["value"] for k, c in line["checks"].items()}, "metrics": line["metrics"],
              "device": line["device"], "breakdown": line.get("breakdown")})
        torch.cuda.empty_cache()

    files = run.cell_files(workload)
    traffic, sizes = files["traffic"], files["config"]["model"]
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        h = run.Harness(workload, s, args.seconds, False, dev)
        assets = assets_mod.synthetic_assets()
        spec = port.weight_spec(port.port_config(files["config"]["model"], traffic.get("overrides", {})))
        if traffic["kind"] == "infer":
            from traffic import infer as drv

            hw = tuple(sizes["vit.img_size"])
            ref = drv.build_reference(sizes, drv.smpl_arrays(assets, dev), weights_mod.generate(spec, s, dev), dev).eval()
            ref.set_fp8(True)
            fp8_sample = {i: drv.reference_answers(h, ref, hw, dev, i) for i in range(2)}
            del ref
            # The fp8 reference's outputs in the program's place, judged by the fp32 reference.
            control = drv.check(h, sizes, spec, assets, fp8_sample, hw, dev)
            emit({"kind": "control", "seed": s, "checks": {k: v[0] for k, v in control.items()}})
        else:
            from reference.smpl import smpl_arrays
            from traffic import train as drv

            smpl = smpl_arrays(assets, dev)
            pool = drv.make_pool(h, sizes, smpl, dev)[:traffic["check_steps"]]
            drop_seed = inputs.generator(s, 7, dev).initial_seed()
            r32 = drv.reference_readings(h, sizes, spec, assets, smpl, pool, drop_seed)
            r8 = drv.reference_readings(h, sizes, spec, assets, smpl, pool, drop_seed, fp8=True)
            names = list(r8[1])
            loss_gaps, numbers, _, logged = drv.compare(names, r8[0], r8[1], r8[2], *r32)
            emit({"kind": "control", "seed": s, "checks": numbers, "loss_gaps": loss_gaps, "median_leaf": logged})
        torch.cuda.empty_cache()

    if traffic["kind"] == "train":
        from whmr_tpu_torch.training import train_step as ts

        for s in [int(x) for x in args.fault_seeds.split(",") if x]:
            for rows in ("first", "even"):
                line = run.execute(bench, workload, s, args.seconds, False, dev,
                                   hooks={"train_step": half_batch_step(ts.train_step, rows)})
                emit({"kind": f"fault_half_batch_{rows}", "seed": s, "correct": line["correct"],
                      "checks": {k: c["value"] for k, c in line["checks"].items()}})
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
