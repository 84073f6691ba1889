"""Parallel training and evaluation on torch.distributed: the process group,
the ("data", "model") DeviceMesh and the sharding rules (data parallel with
group statistics, FSDP2, tensor-parallel ViT blocks). See `mesh.py`.
Serving across cards from one process: the (data, model) grid of devices,
the replicas and the inference-only split of the ViT blocks. See
`serving.py`."""

from whmr_tpu_torch.parallel.mesh import (  # noqa: F401
    axis_index,
    axis_size,
    data_group,
    gather_full,
    init_distributed,
    is_main,
    load_full_state_dict,
    make_mesh,
    place_full,
    qkv_tp_order,
    shard_opt_state,
    shard_params,
)
from whmr_tpu_torch.parallel.serving import (  # noqa: F401
    ServingGrid,
    TensorParallelBlock,
    make_serving_grid,
    replicate,
    split_rows,
    split_vit_blocks,
)
