"""One rank of a tests/test_torch_parallel.py case: the port's Trainer on a
gloo process group on the CPU, at `tiny_config`, one torch thread.

`run_case(rank, world, port, spec)` joins the group, builds a Trainer on the
mesh the spec names, loads the spec's initial weights, takes the spec's
global batches through `Trainer.train_epoch` (each rank keeps its rows;
with `spec["local"]` each rank is handed only its rows, as whmr-train's
loader feeds it),
and has rank 0 write the gathered state (reference layout) to
`spec["out"]`. With `spec["save"]` the Trainer also writes a checkpoint;
with `spec["eval"]` the ranks run `run_evaluation(mesh=)` and `whmr-eval
--data_parallel` instead of training, and with `spec["cli"]` whmr-train's
main(argv), each rank saving the rows of each step it took and its
parameters. It imports whmr_tpu_torch only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _state(trainer):
    from whmr_tpu_torch.parallel.mesh import gather_full

    names = list(trainer.state.params)
    opt = trainer.state.opt_state
    return {
        "params": gather_full(trainer.model, trainer.state.params),
        "batch_stats": gather_full(trainer.model, trainer.state.batch_stats),
        "mu": gather_full(trainer.model, dict(zip(names, opt.mu))),
        "nu": gather_full(trainer.model, dict(zip(names, opt.nu))),
    }


def _train(spec):
    from whmr_tpu_torch.models.layers import Dropout
    from whmr_tpu_torch.parallel.mesh import load_full_state_dict
    from whmr_tpu_torch.training.trainer import Trainer
    from whmr_tpu_torch.utils.testing import tiny_config

    cfg = tiny_config().with_overrides(**spec.get("overrides", {}))
    trainer = Trainer(cfg, spec["log_dir"], device="cpu", model_parallel=spec["model_parallel"],
                      fsdp=spec["fsdp"], seed=0, local_batches=spec.get("local", False))
    for m in trainer.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    load_full_state_dict(trainer.model, torch.load(spec["weights"], weights_only=True))
    batches = [dict(np.load(path)) for path in spec["batches"]]
    if trainer.local_batches:
        # the rank's own rows, as whmr-train's loader of B / D yields them
        d, ranks = trainer.data_index, trainer.data_ranks
        batches = [{k: v[d * len(v) // ranks:(d + 1) * len(v) // ranks] for k, v in b.items()} for b in batches]
    trainer.train_epoch(iter(batches), log_every=1)
    out = _state(trainer)
    if spec.get("save"):
        trainer.save()
    if trainer.is_main:
        with open(trainer.metrics.path) as f:
            out["records"] = f.read()
        torch.save(out, spec["out"])


def _evaluate(spec):
    from whmr_tpu_torch.config import config_from_args
    from whmr_tpu_torch.data.loader import BatchLoader, host_tensor
    from whmr_tpu_torch.data.npz_dataset import NpzDataset
    from whmr_tpu_torch.inference import eval_cli
    from whmr_tpu_torch.inference.evaluate import run_evaluation
    from whmr_tpu_torch.parallel.mesh import make_mesh

    argv = spec["argv"]
    args = eval_cli.build_parser().parse_args(argv)
    cfg = config_from_args(args)
    model, consts, _ = eval_cli.load_model_state(args, cfg)
    ds = NpzDataset(cfg, args.dataset_npz, args.img_dir, is_train=False)

    def batches():
        for hb in BatchLoader(ds, args.batch_size, shuffle=False, drop_last=False):
            b, _ = eval_cli.device_eval_batch(hb, extra_keys=("pose", "betas", "gender", "global_pose"),
                                              device="cpu")
            b["valid"] = host_tensor(hb["has_smpl"])
            yield b

    mesh = make_mesh(device_type="cpu")
    direct = run_evaluation(cfg, model, consts, batches(), log_every=0, mesh=mesh,
                            result_file=spec["out"] + ".direct.npz")
    cli = eval_cli.main(argv + ["--data_parallel", str(dist.get_world_size()),
                                "--result_file", spec["out"] + ".cli.npz"])
    if dist.get_rank() == 0:
        torch.save({"direct": direct, "cli": cli}, spec["out"])


def _train_cli(spec):
    from whmr_tpu_torch.training import cli
    from whmr_tpu_torch.training.trainer import Trainer

    rows = []
    step = Trainer._step

    def counted(self, batch):
        rows.append(int(batch["has_smpl"].shape[0]))
        return step(self, batch)

    Trainer._step = counted
    trainer = cli.main(spec["argv"])
    torch.save({"rows": rows, "step": trainer.state.step, "params": trainer.state.params},
               f"{spec['out']}.{dist.get_rank()}.pt")


def run_case(rank: int, world: int, port: int, spec: dict) -> None:
    torch.set_num_threads(1)
    from whmr_tpu_torch.parallel.mesh import init_distributed

    init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    try:
        if spec.get("eval"):
            _evaluate(spec)
        elif spec.get("cli"):
            _train_cli(spec)
        else:
            _train(spec)
    finally:
        dist.destroy_process_group()
