"""The port's BatchLoader and device_prefetch (whmr_tpu_torch/data/loader.py).

BatchLoader is a copy of whmr_tpu's: for the same dataset, seed, epoch, host
stride and start batch, both yield the same batches in the same order, in
thread and in process worker mode, exactly. device_prefetch is checked on
the CPU (its CUDA path runs in chip_smoke.py's trainer phase).
"""

import numpy as np
import pytest
import torch

from whmr_tpu.data.loader import BatchLoader as JBatchLoader
from whmr_tpu_torch.data.loader import BatchLoader, device_prefetch

from torch_port_util import release_memory  # noqa: F401 (autouse fixture)


class _Dataset:
    """Samples drawn from a per-(epoch, index) rng, like whmr_tpu's
    NpzDataset, so worker scheduling cannot change their contents."""

    def __init__(self, n=23):
        self.n = n
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(1000 * self.epoch + i)
        return {"img": rng.rand(4, 3).astype(np.float32), "idx": np.int64(i), "epoch": np.int64(self.epoch)}


def _batches(cls, num_procs, epoch, start_batch, **kw):
    loader = cls(_Dataset(), batch_size=4, seed=3, num_workers=3, num_procs=num_procs, prefetch=2, **kw)
    loader.set_epoch(epoch)
    if start_batch:
        loader.set_start_batch(start_batch)
    return len(loader), list(loader)


@pytest.mark.parametrize("num_procs", [0, 2], ids=["threads", "processes"])
@pytest.mark.parametrize(
    "epoch,start_batch,kw",
    [
        (0, 0, {}),
        (1, 2, {}),
        (2, 0, {"num_hosts": 2, "host_index": 1}),
        (1, 1, {"shuffle": False, "drop_last": False}),
    ],
    ids=["plain", "resume", "host_stride", "ordered_ragged"],
)
def test_batches_match_whmr_tpu(num_procs, epoch, start_batch, kw):
    n_port, port = _batches(BatchLoader, num_procs, epoch, start_batch, **kw)
    n_jax, want = _batches(JBatchLoader, num_procs, epoch, start_batch, **kw)
    assert n_port == n_jax and len(port) == len(want) > 0
    for got, ref in zip(port, want):
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
        assert (got["epoch"] == epoch).all()
    # the index-level skip resets after one epoch
    assert not BatchLoader(_Dataset(), batch_size=4).start_batch


def test_device_prefetch_on_the_cpu():
    rng = np.random.RandomState(0)
    host = [{"x": rng.rand(2, 3), "i": np.arange(2, dtype=np.int32) + 2 * j} for j in range(5)]
    pulled = []

    def source():
        for j, b in enumerate(host):
            pulled.append(j)
            yield b

    it = device_prefetch(source(), size=2, device="cpu")
    first = next(it)
    # two batches are taken from the source before the first is handed out
    assert pulled == [0, 1]
    out = [first] + list(it)
    assert len(out) == 5
    for got, ref in zip(out, host):
        assert got["x"].dtype == torch.float32 and got["i"].dtype == torch.int32  # float64 -> float32, as jax
        np.testing.assert_array_equal(got["x"].numpy(), ref["x"].astype(np.float32))
        np.testing.assert_array_equal(got["i"].numpy(), ref["i"])


def test_device_prefetch_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(device_prefetch(iter([{"x": np.zeros(1)}])))
