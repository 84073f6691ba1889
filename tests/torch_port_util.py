"""Shared helpers of the whmr_tpu_torch parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; weights
are made by a flax `init` and carried into the port by
`whmr_tpu_torch.utils.convert.state_dict_from_flax`.
"""

from __future__ import annotations

import ctypes
import gc

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from whmr_tpu_torch.utils.convert import state_dict_from_flax


@pytest.fixture(scope="module", autouse=True)
def release_memory():
    """Keep each port test module a light neighbour of the other xdist
    workers of the tier-1 run, which share one machine's cores and memory.
    Test modules activate it by importing it.

    - torch runs on one intra-op thread during the module (restored after):
      with six workers on 8 cores, torch's 8 OpenMP threads a worker wait on
      each other at every small op (a trainer test took 562 s under such
      load on 8 threads and 17 s on one).
    - After the module, JAX's compiled executables are dropped and the heap
      the module freed goes back to the OS; freed glibc heap would otherwise
      stay resident (about 1 GB after the WHMR parity modules)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc
        pass


def t(a, dtype=torch.float32):
    """numpy / jax array -> CPU torch tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def n(x):
    """torch tensor or jax array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def load_from_flax(module: torch.nn.Module, variables, wrap: str, prefix: str):
    """Load the flax `variables` of one submodule into the port `module`.

    `wrap` is the submodule's name in whmr_tpu's WHMR tree and `prefix` its
    key prefix in the port's state_dict; the load is strict.
    """
    tree = {
        coll: {wrap: variables[coll]} for coll in ("params", "batch_stats") if coll in variables
    }
    sd = state_dict_from_flax(tree)
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    assert len(sub) == len(sd), sorted(set(sd) - set(sub))
    module.load_state_dict(sub, strict=True)
    return module.eval()


def random_batch_stats(variables, seed=0):
    """Replace identity BN running statistics with random ones, so the
    mean/var mapping is exercised."""
    if "batch_stats" not in variables:
        return variables
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(jax.device_get(variables["batch_stats"]))
    for path, v in flat.items():
        v = np.asarray(v)
        flat[path] = (rng.randn(*v.shape) * 0.1 if path[-1] == "mean"
                      else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
    return {**variables, "batch_stats": traverse_util.unflatten_dict(flat)}



def carried_whmr(jcfg, seed=0):
    """whmr_tpu's WHMR at `jcfg` initialised by `model.init` (CamCalib
    included, random BatchNorm statistics) -> (flax variables, the port's
    state_dict of the same weights)."""
    import jax.numpy as jnp

    from whmr_tpu.data.assets import synthetic_smpl_assets
    from whmr_tpu.models.regressor import body_consts_from_assets
    from whmr_tpu.models.whmr import WHMR
    from whmr_tpu.utils.testing import make_example_inputs

    args = {k: jnp.asarray(v) for k, v in make_example_inputs(jcfg, 2).items()}
    args["full_x"] = jnp.zeros((2, 64, 64, 3), jnp.float32)
    consts = body_consts_from_assets(synthetic_smpl_assets())
    variables = jax.jit(lambda c, a: WHMR(jcfg).init(jax.random.PRNGKey(seed), c, **a))(consts, args)
    variables = random_batch_stats(jax.device_get(variables))
    return variables, state_dict_from_flax(variables)


def save_port_checkpoint(sd, path):
    """The port's state_dict `sd` as a weights-only checkpoint dir of the
    port (what `CheckpointManager.restore_weights` reads)."""
    from whmr_tpu_torch.utils.checkpoint import CheckpointManager

    stats = ("running_mean", "running_var")
    CheckpointManager(str(path)).save(1, {
        "params": {k: v for k, v in sd.items() if not k.endswith((*stats, "num_batches_tracked"))},
        "batch_stats": {k: v for k, v in sd.items() if k.endswith(stats)},
    })
    return str(path)


_DECODER_NAMES = ("decpose", "decshape", "deccam", "decrot")


def numpy_variables(init, *args, seed=0):
    """flax variables of the shapes `init(*args)` would make, drawn with
    numpy instead of compiled: lecun-normal kernels (xavier-like 0.01 for
    the residual decoders), small random biases and norm offsets, norm
    scales near 1, 0.02 normal position embeddings, random BatchNorm
    statistics. `jax.eval_shape` traces the init without compiling it, so
    a whole model's variables cost seconds, not a compile."""
    shapes = jax.eval_shape(init, *args)
    rng = np.random.RandomState(seed)
    out = {}
    for coll, tree in shapes.items():
        flat = traverse_util.flatten_dict(tree)
        for path, leaf in flat.items():
            shape, name = leaf.shape, path[-1]
            if coll == "batch_stats":
                v = rng.randn(*shape) * 0.1 if name == "mean" else rng.uniform(0.5, 1.5, shape)
            elif name == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                gain = 0.01 if any(p in _DECODER_NAMES for p in path) else 1.0
                v = rng.randn(*shape) * gain / np.sqrt(fan_in)
            elif name == "scale":
                v = 1.0 + 0.1 * rng.randn(*shape)
            elif name in ("pos_embed", "position_embeddings"):
                v = 0.02 * rng.randn(*shape)
            else:
                v = 0.01 * rng.randn(*shape)
            flat[path] = v.astype(np.float32)
        out[coll] = traverse_util.unflatten_dict(flat)
    return out


def to_float64(tree):
    """BodyConsts (or any nest of NamedTuples, dicts and tensors) with every
    floating tensor in float64: the whole of a float64 parity check."""
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: to_float64(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_float64(v) for v in tree))
    return tree


def float64_module(module):
    """`module` in float64, parameters and compute dtype alike."""
    module.double()
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return module
