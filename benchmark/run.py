"""Runs one cell of the benchmark of `whmr_tpu_torch` once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (an entry of `workloads` in
BENCHMARK.json) names a configuration (`benchmark/configs/<config>.json`)
and a traffic mix (`benchmark/traffic/<traffic>.json`), whose `kind` names
the driver (`benchmark/traffic/<kind>.py`); the cell's limits are in
`benchmark/limits/<workload>.json` and each per-layer metric is read by
`benchmark/metrics/<name>.py`, or, where there is none, by the reader of
its base name, the part before the first dot (`mfu.py` reads `mfu.infer`
and `mfu.train`). A new configuration, mix, cell or metric is a new file:
nothing here changes.

With `--trace 0` the result's metrics are the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics (the same window, then a short
traced one). The last lines of standard error, and the result's `checks`,
give each number the check compares beside its limit. The result is the
last line of standard output; a run with no card, too few cards, or with
JAX or the JAX package loaded prints none and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "whmr_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from /proc (clock ticks)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = process_age_s()


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Harness:
    """What a driver gets: the cell's files, the run's arguments, and where
    to mark the end of set-up and write its log lines."""

    def __init__(self, workload, seed, seconds, trace, device, hooks=None, files=None):
        files = files or cell_files(workload)
        self.config, self.traffic, self.limits = files["config"], files["traffic"], files["limits"]
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.hooks = hooks or {}
        self.setup_s = None

    def mark_setup_done(self):
        self.setup_s = AGE0 + (time.perf_counter() - T0)
        self.phase("set-up done")

    def phase(self, name):
        """Logs how far into the process a step of set-up ended."""
        self.log(f"[{AGE0 + time.perf_counter() - T0:.2f} s] {name}")

    def log(self, msg):
        print(msg, file=sys.stderr, flush=True)


def cell_files(workload):
    """The cell's configuration, traffic mix and limits, by name."""
    def read(*parts):
        return json.loads(HERE.joinpath(*parts).read_text())

    return {"config": read("configs", f"{workload['config']}.json"),
            "traffic": read("traffic", f"{workload['traffic']}.json"),
            "limits": read("limits", f"{workload['name']}.json")}


def metric_path(name: str) -> Path:
    """The reader of per-layer metric `name`: metrics/<name>.py, else the
    reader of its base name."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.is_file() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def applies(metric, cell_name):
    return cell_name in metric.get("workloads", [cell_name])


def execute(bench, workload, seed, seconds, trace, device, hooks=None, files=None):
    """Runs the cell's driver; returns the result line."""
    h = Harness(workload, seed, seconds, trace, device, hooks, files)
    driver = load_module(HERE / "traffic" / f"{h.traffic['kind']}.py", f"driver_{h.traffic['kind']}")
    res = driver.run(h)
    name = workload["name"]
    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if not applies(m, name):
                continue
            value = load_module(metric_path(m["name"]), "metric_" + m["name"].replace(".", "_")).read(res["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(res["e2e"], setup_s=h.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, name)}
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in res["checks"].items()}
    correct = res["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics}
    if trace and res["ctx"].get("trace"):
        tr = res["ctx"]["trace"]
        h.log(f"traced window, CUDA-only pass: busy {tr['busy_s']!r} s of {tr['window_s']!r} s; "
              f"CPU+CUDA pass (labels the gaps): busy {tr.get('labelled_busy_s')!r} s of "
              f"{tr.get('labelled_window_s')!r} s")
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["device"] = device_info(device, res["memory_peak_bytes"], res["ctx"].get("trace") if trace else None)
    line["checks"] = checks
    return line


def device_info(device, peak, tr):
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if tr:
        info["busy_s"], info["window_s"] = tr["busy_s"], tr["window_s"]
    return info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    workload = cells[args.workload]

    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(HERE)]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    line = execute(bench, workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad} (the benchmark measures whmr_tpu_torch alone)", file=sys.stderr)
        return 4
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
