"""Serving across cards from one process: the (data, model) grid of devices,
one replica of the live model a grid row, and the inference-only
tensor-parallel split of its ViT blocks over the row.

Counterpart of whmr_tpu's mesh serving (`inference/pipeline.py`,
`DemoPipeline(mesh=)`): the crop batch sharded over "data", the ViT blocks
split over "model" by the Megatron rules, the CamCalib frame replicated.
whmr_tpu runs one SPMD program over a `jax.sharding.Mesh`. A torch
`DeviceMesh` needs a process group, and a server of ranks would need a
command channel from rank 0 to its followers for every batch, for
`/reload` and for the stop; so the port serves from one process:

- `ServingGrid`: d x m torch devices, `.shape == {"data": d, "model": m}`.
  `make_serving_grid` gives `cuda:0 .. cuda:d*m-1` row by row, or the CPU
  device in every entry (how the tests and the CPU CLIs run it); a
  `ServingGrid` built from lists may name one card more than once.
- Data parallel: each row holds one replica of the model on its lead
  device (the row's first). `split_rows` gives replica i the i-th block of
  max_people / d crop rows; each replica's forward is enqueued on its own
  device, and `inference/export.py::fetch` brings the replicas' outputs
  back, one copy a tensor a replica, and concatenates their rows.
- Tensor parallel: in each replica every ViT block becomes a
  `TensorParallelBlock` over the row's m devices, by `mesh._TP_PLAN`:
  `attn.qkv` and `mlp.fc1` split by output rows (qkv first reordered by
  `mesh.qkv_tp_order`, so each device holds whole heads and runs its
  attention, K1 included, on H / m heads), `attn.proj` and `mlp.fc2` by
  input columns. The partial outputs are copied to the lead device and
  summed there in fp32 with the bias: the all_reduce of the DTensor split
  in `mesh.shard_params`.
- CamCalib runs in each replica on the lead device, on its copy of the
  frame (batch 1).

One Python thread issues every replica's launches, so the host time of a
forward grows with the replicas and the shards: the grid buys batch
capacity and memory on more cards, not host speed.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn

from whmr_tpu_torch.parallel.mesh import _TP_PLAN, _tp_blocks, qkv_tp_order


class ServingGrid:
    """A (data, model) grid of torch devices: `devices[i][j]` is model
    index j of data row i."""

    def __init__(self, devices: Sequence[Sequence]):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError(f"a serving grid needs equal, non-empty rows of devices, got {devices}")
        self.devices = rows

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def lead(self) -> torch.device:
        return self.devices[0][0]


def make_serving_grid(data: int = 1, model: int = 1, device_type: str = "cuda") -> ServingGrid:
    """The grid of `data` x `model` devices: `cuda:0 ..` row by row, or the
    CPU repeated. `ServingGrid` takes any other layout."""
    if data < 1 or model < 1:
        raise ValueError(f"a serving grid needs data >= 1 and model >= 1, got {data} x {model}")
    n = data * model
    devices = ["cpu"] * n if torch.device(device_type).type == "cpu" else [f"cuda:{i}" for i in range(n)]
    return ServingGrid([devices[i * model:(i + 1) * model] for i in range(data)])


def _shard_weights(block: nn.Module, ranks: int, rank: int) -> Dict[str, torch.Tensor]:
    """Rank `rank`'s share of each linear of `_TP_PLAN`: a colwise linear's
    output rows with their bias (qkv's in `qkv_tp_order`), a rowwise
    linear's input columns without its bias (added once, after the sum)."""
    out = {}
    for path, style in _TP_PLAN.items():
        lin = block.get_submodule(path)
        w, b = lin.weight.detach(), lin.bias
        if path == "attn.qkv":
            order = qkv_tp_order(lin.in_features, ranks).to(w.device)
            w, b = w[order], None if b is None else b[order]
        if style == "colwise":
            k = w.shape[0] // ranks
            out[f"{path}.weight"] = w[rank * k:(rank + 1) * k]
            if b is not None:
                out[f"{path}.bias"] = b.detach()[rank * k:(rank + 1) * k]
        else:
            k = w.shape[1] // ranks
            out[f"{path}.weight"] = w[:, rank * k:(rank + 1) * k]
    return out


def _shard_module(block: nn.Module, ranks: int, device: torch.device) -> nn.Module:
    """An empty module with the block's `attn` and `mlp`, each linear of
    `_TP_PLAN` cut to one rank's share (built on the meta device, so no
    full-size initialisation), placed on `device`."""
    from whmr_tpu_torch.models.layers import MLP, Attention, Linear

    attn, mlp = block.attn, block.mlp
    dtype = attn.qkv.compute_dtype
    with torch.device("meta"):
        shard = nn.Module()
        shard.attn = Attention(attn.qkv.in_features, attn.num_heads, attn.qkv.bias is not None, dtype=dtype,
                               impl=attn.impl)
        shard.mlp = MLP(mlp.fc1.in_features, mlp.fc1.out_features, mlp.fc2.out_features, dtype=dtype)
        for path, style in _TP_PLAN.items():
            lin = block.get_submodule(path)
            rows, cols = lin.out_features, lin.in_features
            if style == "colwise":
                rows //= ranks
            else:
                cols //= ranks
            parent, leaf = path.split(".")
            setattr(shard.get_submodule(parent), leaf,
                    Linear(cols, rows, bias=lin.bias is not None and style == "colwise", dtype=dtype))
    return shard.to_empty(device=device)


class TensorParallelBlock(nn.Module):
    """A ViT block split over the devices of one grid row, for inference
    (eval mode: no drop path).

    Shard r (on `devices[r]`) holds qkv's and fc1's rows of its heads and
    hidden units and proj's and fc2's matching columns; norm1, norm2 and
    the two row-parallel biases stay on the lead device, where the block's
    input and output live."""

    def __init__(self, block: nn.Module, devices: Sequence[torch.device]):
        super().__init__()
        ranks = len(devices)
        if block.attn.num_heads % ranks:
            raise ValueError(f"{block.attn.num_heads} heads do not split over tensor_parallel={ranks}")
        self.devices = [torch.device(d) for d in devices]
        self.norm1, self.norm2 = block.norm1, block.norm2
        self.shards = nn.ModuleList()
        for r, dev in enumerate(self.devices):
            shard = _shard_module(block, ranks, dev)
            shard.load_state_dict(_shard_weights(block, ranks, r))
            self.shards.append(shard.eval().requires_grad_(False))
        self.register_buffer("proj_bias", block.attn.proj.bias.detach().clone())
        self.register_buffer("fc2_bias", block.mlp.fc2.bias.detach().clone())

    def _row_sum(self, branch: str, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """Each shard's partial output of `branch` on its copy of `h`, summed
        on `h`'s device in fp32 with `bias`, in the compute dtype."""
        parts = [getattr(shard, branch)(h.to(dev, non_blocking=True)) for shard, dev in zip(self.shards, self.devices)]
        total = parts[0].float()
        for p in parts[1:]:
            total = total + p.to(h.device).float()
        return (total + bias.float()).to(parts[0].dtype)

    def forward(self, x, generator=None):
        x = x + self._row_sum("attn", self.norm1(x), self.proj_bias)
        return x + self._row_sum("mlp", self.norm2(x), self.fc2_bias)


def split_vit_blocks(model: nn.Module, devices: Sequence[torch.device]) -> nn.Module:
    """In place: each ViT block of `model` (on `devices[0]`) becomes a
    `TensorParallelBlock` over `devices`. Returns the model."""
    for name, block in _tp_blocks(model):
        parent, index = name.rsplit(".", 1)
        model.get_submodule(parent)[int(index)] = TensorParallelBlock(block, devices)
    return model


def replicate(model: nn.Module, grid: ServingGrid) -> List[nn.Module]:
    """One eval-mode replica of `model` a grid row, on the row's lead
    device, its ViT blocks split over the row when the row has more than
    one device. `model` itself becomes the first row's replica; the later
    rows' copies are taken before it moves."""
    replicas = [None] * len(grid.devices)
    for i in reversed(range(len(grid.devices))):
        row = grid.devices[i]
        rep = (model if i == 0 else copy.deepcopy(model)).to(row[0]).eval().requires_grad_(False)
        if len(row) > 1:
            split_vit_blocks(rep, row)
        replicas[i] = rep
    return replicas


def split_rows(batch: Dict[str, np.ndarray], parts: int) -> List[Dict[str, np.ndarray]]:
    """The crop batch (every array's dim 0 a crop row) in `parts` equal
    blocks of consecutive rows."""
    rows = next(iter(batch.values())).shape[0]
    if rows % parts:
        raise ValueError(f"{rows} crop rows do not split over {parts} replicas")
    k = rows // parts
    return [{key: v[i * k:(i + 1) * k] for key, v in batch.items()} for i in range(parts)]
