"""Parallel training and evaluation on torch.distributed: the process group,
the ("data", "model") DeviceMesh and the sharding rules (data parallel with
group statistics, FSDP2, tensor-parallel ViT blocks). See `mesh.py`."""

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
