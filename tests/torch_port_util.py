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

