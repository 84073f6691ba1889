"""Process groups, the ("data", "model") mesh and the sharding rules.

Counterpart of `whmr_tpu/parallel/mesh.py`. whmr_tpu runs one program over
a `jax.sharding.Mesh`; the port runs one process a card, as the reference
trains (one-process-per-GPU DDP, train.py:26-28), and each process is one
point of a `DeviceMesh` with the same two axes:

- "data": each rank takes its rows of the global batch. What whmr_tpu gets
  from GSPMD's global reductions the port sums over the data group itself:
  the BatchNorm statistics (`models/layers.py::_FP32BatchNorm`), the loss
  denominators (`training/losses.py`), the gradients and the metrics
  (`training/train_step.py`). A mean over the data group IS the global
  batch's mean, so one rank and R ranks take the same step.
- "model": Megatron-style tensor parallelism of the ViT blocks through
  DTensor: `attn.qkv` and `mlp.fc1` column-parallel, `attn.proj` and
  `mlp.fc2` row-parallel (whmr_tpu's `_TP_RULES`). The model axis runs over
  adjacent ranks.
- FSDP (ZeRO-3): FSDP2's `fully_shard` on each ViT block and on the model,
  over the data axis; tensors under `fsdp_min_size` elements stay
  replicated (whmr_tpu's `_fsdp_spec`), and their gradients are summed with
  the rest of the replicated ones. The shard layout is FSDP2's (dim 0), not
  XLA's; the numbers are the same.

The qkv rows under TP: `Attention.forward` reads the qkv output as
(B, N, 3, H, D), so a plain split of the (3d, d) weight would give rank 0
all of q and half of k. `shard_params` reorders the rows into per-rank
[q_r | k_r | v_r] blocks (`qkv_tp_order`) before the split, so each rank
holds whole heads and runs its attention, K1 included, on H / T local
heads. `gather_full` undoes the order and `load_full_state_dict` /
`place_full` redo it, so a checkpoint always holds the reference layout.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard

AXES = ("data", "model")
# The ViT blocks whose linears split over "model" (whmr_tpu's _TP_RULES,
# by the port's names), and their plan.
_TP_BLOCK = re.compile(r"(.*\.)?blocks\.\d+")
_TP_PLAN = {"attn.qkv": "colwise", "attn.proj": "rowwise", "mlp.fc1": "colwise", "mlp.fc2": "rowwise"}
# The gradient sync sums flat buckets of at most this many elements.
_BUCKET_ELEMS = 1 << 25
# A hung collective fails after this long instead of waiting forever.
_TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Join the process group (the reference's tcp:// NCCL rendezvous,
    train.py:26-28).

    With no arguments it reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK and
    MASTER_ADDR/MASTER_PORT; otherwise `coordinator_address` ("host:port"
    or a URL) with `num_processes` and `process_id`. The backend is NCCL
    when a card is present and gloo on the CPU; `backend="gloo"` puts
    several ranks on one card. A CUDA rank takes the card LOCAL_RANK (modulo
    the cards present). A second call is a no-op."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError("init_distributed() without arguments needs torchrun's environment "
                               "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
        init_method, rank, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        rank, world = int(process_id), int(num_processes)
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, timeout=_TIMEOUT)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A (data, model) DeviceMesh over every rank of the process group, the
    model axis over adjacent ranks (rank = data_index * model_parallel +
    model_index). Raises without an initialised process group: a mesh is
    never quietly a single process."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group: call "
                           "whmr_tpu_torch.parallel.init_distributed() first (torchrun, or its arguments)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"the mesh spans every rank: n_devices={n} but the process group has {world}")
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide the {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel, model_parallel), mesh_dim_names=AXES)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def data_group(mesh: Optional[DeviceMesh]):
    """The process group of this rank's data axis (None without a mesh)."""
    return None if mesh is None else mesh.get_group("data")


def is_main() -> bool:
    """Rank 0, or a run without a process group: the one writer of logs
    and checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def qkv_tp_order(dim: int, ranks: int) -> torch.Tensor:
    """The row order of a (3*dim, ...) qkv weight under `ranks`-way TP:
    rows [q_r | k_r | v_r] for r = 0..ranks-1, where q_r is rank r's
    contiguous share of q's rows (whole heads when the head count divides
    by `ranks`). `weight[order]` is the split layout;
    `split[order.argsort()]` undoes it."""
    if dim % ranks:
        raise ValueError(f"qkv width {dim} does not split over {ranks} ranks")
    return torch.arange(3 * dim).view(3, ranks, dim // ranks).transpose(0, 1).reshape(-1)


def set_data_group(model: nn.Module, group) -> None:
    """Give the layers that reduce over the batch (BatchNorm) or draw per
    sample (Dropout, DropPath) their data group."""
    from whmr_tpu_torch.models.layers import Dropout, _FP32BatchNorm
    from whmr_tpu_torch.models.vit import DropPath

    for m in model.modules():
        if isinstance(m, (_FP32BatchNorm, Dropout, DropPath)):
            m.data_group = group


def _tp_blocks(model: nn.Module):
    from whmr_tpu_torch.models.vit import ViTBlock

    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, ViTBlock) and _TP_BLOCK.fullmatch(name)]


def shard_params(model: nn.Module, mesh: DeviceMesh, use_tp: Optional[bool] = None, fsdp: bool = False,
                 fsdp_min_size: int = 1 << 16) -> nn.Module:
    """Place `model` on the mesh, in place: its batch layers on the data
    group, its ViT blocks split over "model" (default: when the model axis
    is larger than 1) and, with `fsdp`, its tensors of at least
    `fsdp_min_size` elements sharded over "data". Every rank must have
    built the same weights (the same seed). Returns the model."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel, parallelize_module

    tp = axis_size(mesh, "model")
    if use_tp is None:
        use_tp = tp > 1
    set_data_group(model, data_group(mesh))
    permuted: Dict[str, int] = {}
    if use_tp and tp > 1:
        styles = {"colwise": ColwiseParallel, "rowwise": RowwiseParallel}
        for name, block in _tp_blocks(model):
            attn = block.attn
            if attn.num_heads % tp:
                raise ValueError(f"{name}: {attn.num_heads} heads do not split over model_parallel={tp}")
            order = qkv_tp_order(attn.qkv.in_features, tp).to(attn.qkv.weight.device)
            with torch.no_grad():
                for pname, p in attn.qkv.named_parameters():
                    p.copy_(p[order])
                    permuted[f"{name}.attn.qkv.{pname}"] = tp
            parallelize_module(block, mesh["model"], {k: styles[v]() for k, v in _TP_PLAN.items()})
    model._tp_permuted = permuted
    if fsdp:
        small = {p for p in model.parameters() if p.numel() < fsdp_min_size}
        for _, block in _tp_blocks(model):
            fully_shard(block, mesh=mesh["data"], ignored_params=small)
        fully_shard(model, mesh=mesh["data"], ignored_params=small)
    return model


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def local_tensors(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's local shard (the tensor itself when it is not a
    DTensor); in-place updates of a shard update its DTensor."""
    return [_local(t) for t in tensors]


def sharded_over(t: torch.Tensor) -> set:
    """The mesh axes over which `t` is split (empty for a replicated one)."""
    if not isinstance(t, DTensor):
        return set()
    names = t.device_mesh.mesh_dim_names or ()
    return {name for name, pl in zip(names, t.placements) if isinstance(pl, Shard)}


def fsdp_managed(t: torch.Tensor) -> bool:
    """Whether FSDP reduces this parameter's gradient (split over "data")."""
    return "data" in sharded_over(t)


def _owner(t: torch.Tensor, mesh: DeviceMesh) -> bool:
    """Whether this rank counts `t`'s shard once in a sum over all ranks:
    it holds index 0 on every axis over which `t` is replicated."""
    split = sharded_over(t)
    return all(axis in split or axis_index(mesh, axis) == 0 for axis in AXES)


def sharded_global_norm(tensors: List[torch.Tensor], mesh: DeviceMesh) -> torch.Tensor:
    """optax.global_norm over tensors that may be split over the mesh: each
    shard's sum of squares counted once (by `_owner`), one all_reduce over
    all ranks."""
    owned = [_local(t) for t in tensors if _owner(t, mesh)]
    ref = _local(tensors[0])
    sq = torch.zeros((), dtype=torch.float32, device=ref.device)
    if owned:
        sq = torch.stack(torch._foreach_norm(owned)).float().square().sum()
    dist.all_reduce(sq)
    return sq.sqrt()


def all_reduce_mean(tensors: List[torch.Tensor], group) -> None:
    """In place: each tensor becomes its mean over `group`, summed in flat
    buckets of at most `_BUCKET_ELEMS` elements (one all_reduce a bucket)."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    ranks = dist.get_world_size(group)
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        if not buckets or size + t.numel() > _BUCKET_ELEMS or t.dtype != buckets[-1][0].dtype:
            buckets.append([])
            size = 0
        buckets[-1].append(t)
        size += t.numel()
    for bucket in buckets:
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=group)
        flat.mul_(1.0 / ranks)
        for t, v in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            t.copy_(v)


def _gather(t: DTensor) -> torch.Tensor:
    """The full tensor of a DTensor. On a 1-D mesh (FSDP's data axis, TP's
    model axis) one c10d all_gather_into_tensor of the padded shards, which
    gloo carries on CUDA tensors too (DTensor's own `full_tensor` crashes
    there, torch 2.11); otherwise `full_tensor`."""
    if t.device_mesh.ndim != 1 or not isinstance(t.placements[0], Shard):
        return t.full_tensor()
    mesh, dim = t.device_mesh, t.placements[0].dim
    n, size = mesh.size(), t.shape[dim]
    chunk = -(-size // n)
    sizes = [max(0, min(chunk, size - k * chunk)) for k in range(n)]
    local = t.to_local().movedim(dim, 0)
    pad = local.new_zeros((chunk, *local.shape[1:]))
    pad[:local.shape[0]] = local
    out = local.new_empty((n * chunk, *local.shape[1:]))
    dist.all_gather_into_tensor(out, pad.contiguous(), group=mesh.get_group(0))
    parts = [out[k * chunk:k * chunk + sizes[k]] for k in range(n)]
    return torch.cat(parts).movedim(0, dim)


def _to_full(name: str, t: torch.Tensor, permuted: Dict[str, int]) -> torch.Tensor:
    full = _gather(t) if isinstance(t, DTensor) else t
    if name in permuted:
        full = full[qkv_tp_order(full.shape[0] // 3, permuted[name]).argsort().to(full.device)]
    return full


def gather_full(model: nn.Module, named: Dict[str, torch.Tensor], main_only: bool = True) -> Dict[str, torch.Tensor]:
    """Host copies of the full tensors of `named` (keyed as the model's
    state_dict), in the reference layout: DTensors gathered and the TP qkv
    order undone. Collective: every rank calls it with the same names.
    With `main_only`, only rank 0 keeps the copies (the others get {})."""
    permuted = getattr(model, "_tp_permuted", {})
    keep = is_main() or not main_only
    out = {}
    for name, t in named.items():
        full = _to_full(name, t.detach(), permuted)
        if keep:
            out[name] = full.to("cpu", copy=True)
    return out


def is_sharded(model: nn.Module) -> bool:
    return bool(getattr(model, "_tp_permuted", None)) or any(isinstance(p, DTensor) for p in model.parameters())


@torch.no_grad()
def place_full(model: nn.Module, name: str, live: torch.Tensor, full: torch.Tensor) -> None:
    """Copy a full tensor (reference layout) into `live`, the model's tensor
    of that name or one shaped like it (an Adam moment, an EMA weight): its
    local shard when `live` is a DTensor, in the TP qkv order when the
    name is a permuted one."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    full = full.to(device=_local(live).device, dtype=live.dtype)
    permuted = getattr(model, "_tp_permuted", {})
    if name in permuted:
        full = full[qkv_tp_order(full.shape[0] // 3, permuted[name]).to(full.device)]
    if isinstance(live, DTensor):
        shape, offset = compute_local_shape_and_global_offset(full.shape, live.device_mesh, live.placements)
        for dim, (n, o) in enumerate(zip(shape, offset)):
            full = full.narrow(dim, o, n)
    _local(live).copy_(full)


def load_full_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """`model.load_state_dict(sd, strict=True)` for a full state_dict in the
    reference layout, onto a model that may be sharded."""
    if not is_sharded(model):
        model.load_state_dict(sd, strict=True)
        return
    live = model.state_dict()
    if live.keys() != sd.keys():
        raise ValueError(f"state_dict keys differ: missing {sorted(live.keys() - sd.keys())[:5]}, "
                         f"unexpected {sorted(sd.keys() - live.keys())[:5]}")
    for name, t in live.items():
        place_full(model, name, t, sd[name])


def shard_opt_state(model: nn.Module, moments: Dict[str, torch.Tensor],
                    params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Adam moments placed as their parameters (whmr_tpu's shard_opt_state):
    each full moment, in the reference layout, becomes a tensor like its
    parameter, a DTensor shard of the same placement when the parameter is
    one. (Moments made by `zeros_like` of a parameter are placed already.)"""
    out = {}
    for name, p in params.items():
        out[name] = torch.zeros_like(p.detach())
        place_full(model, name, out[name], moments[name])
    return out
