"""Host-side batch loader (threads or processes) with device prefetch.

Counterpart of `whmr_tpu/data/loader.py` (which replaces torch DataLoader +
DistributedSampler, reference core/trainer.py:129-143). `BatchLoader` is a
copy of whmr_tpu's: workers run the numpy dataset pipeline and batches are
assembled in index order. Multi-host sharding strides the epoch permutation
by `host_index` / `num_hosts` (each host reads a disjoint slice), the
DistributedSampler equivalent.

Two worker modes:
- threads (default): zero-copy, but a numpy-heavy augment pipeline is
  GIL-bound.
- processes (`num_procs > 0`): fork-based workers like torch DataLoader's;
  scales with physical cores. Batch order and contents are IDENTICAL to
  thread mode when every sample draws from its own per-(seed, epoch, index)
  rng stream, as whmr_tpu's NpzDataset does.

`device_prefetch` keeps batches in flight on the card: pinned host memory,
copies on a side stream, the compute stream ordered after them.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Dict, Iterable, Iterator

import numpy as np
import torch


def _proc_worker(dataset, idx_q, out_q):
    """Worker-process loop: pull (pos, idx), push (pos, sample | error)."""
    while True:
        task = idx_q.get()
        if task is None:
            return
        pos, idx = task
        try:
            sample = dataset[int(idx)]
        except Exception as e:  # noqa: BLE001 — surface as sentinel
            sample = RuntimeError(f"dataset[{idx}] failed: {e!r}")
        out_q.put((pos, sample))


class BatchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 8,
        num_hosts: int = 1,
        host_index: int = 0,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 4,
        num_procs: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.num_procs = int(num_procs)
        self.num_hosts = num_hosts
        self.host_index = host_index
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        self.start_batch = 0

    def set_epoch(self, epoch: int):
        """Reshuffle per epoch (reference sampler.set_epoch, trainer.py:324)."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def set_start_batch(self, n: int):
        """Mid-epoch resume: the next iteration skips the first n batches at
        the INDEX level (no decode/augment work for skipped samples — an
        itertools.islice over the live iterator would still run the full
        pipeline for every skipped sample). Single-use: resets after one
        epoch."""
        self.start_batch = int(n)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + self.epoch)
        idx = rng.permutation(n) if self.shuffle else np.arange(n)
        # per-host disjoint stride (DistributedSampler equivalent)
        return idx[self.host_index::self.num_hosts]

    def __len__(self):
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        n_batches = len(self)
        work = list(indices[: n_batches * self.batch_size]) if self.drop_last else list(indices)
        if self.start_batch:
            work = work[self.start_batch * self.batch_size:]
            n_batches = max(n_batches - self.start_batch, 0)
            self.start_batch = 0
        if self.num_procs > 0:
            yield from self._iter_procs(work, n_batches)
        else:
            yield from self._iter_threads(work, n_batches)

    def _assemble(self, get_sample, total: int, n_batches: int):
        """Order-restoring collation shared by both worker modes."""
        buffer: Dict[int, Dict] = {}
        next_pos = 0
        for _ in range(n_batches):
            # final batch may be partial when drop_last=False
            want = min(self.batch_size, total - next_pos)
            batch_samples = []
            while len(batch_samples) < want:
                while next_pos not in buffer:
                    pos, sample = get_sample()
                    if isinstance(sample, Exception):
                        raise sample
                    buffer[pos] = sample
                batch_samples.append(buffer.pop(next_pos))
                next_pos += 1
            yield {
                k: np.stack([s[k] for s in batch_samples])
                for k in batch_samples[0]
            }

    def _iter_threads(self, work, n_batches: int):
        sample_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * self.batch_size)
        stop = threading.Event()
        work_iter = iter(enumerate(work))
        lock = threading.Lock()

        def worker():
            while not stop.is_set():
                with lock:
                    try:
                        pos, idx = next(work_iter)
                    except StopIteration:
                        return
                try:
                    sample = self.dataset[int(idx)]
                except Exception as e:  # noqa: BLE001 — surface as sentinel
                    sample = e
                sample_q.put((pos, sample))

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            yield from self._assemble(sample_q.get, len(work), n_batches)
        finally:
            stop.set()
            # drain to unblock workers
            while not sample_q.empty():
                try:
                    sample_q.get_nowait()
                except queue.Empty:
                    break

    def _iter_procs(self, work, n_batches: int):
        """Fork-based worker processes (torch-DataLoader-style): the GIL
        caps the threaded augment pipeline at ~2x single-core; forked
        workers scale with physical cores. The dataset is inherited by
        fork (no per-item pickling of state; samples come back through an
        OS pipe). Bounded index queue keeps in-flight samples ~prefetch
        batches."""
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        idx_q = ctx.Queue()
        out_q = ctx.Queue(maxsize=max(2, self.prefetch) * self.batch_size)
        procs = [
            ctx.Process(
                target=_proc_worker, args=(self.dataset, idx_q, out_q),
                daemon=True,
            )
            for _ in range(self.num_procs)
        ]
        for p in procs:
            p.start()
        for task in enumerate(work):
            idx_q.put(task)
        for _ in procs:
            idx_q.put(None)

        def get_sample():
            # Liveness watchdog: a worker killed by the OS (OOM, cv2
            # segfault) never posts its claimed (pos, sample); a bare
            # out_q.get() would then hang training forever mid-epoch.
            # torch DataLoader guards the same case with a SIGCHLD watchdog.
            while True:
                try:
                    return out_q.get(timeout=10.0)
                except queue.Empty:
                    dead = [p.pid for p in procs if not p.is_alive()
                            and p.exitcode not in (0, None)]
                    if dead:
                        raise RuntimeError(
                            f"loader worker process(es) died: pids {dead} "
                            f"(exitcodes {[p.exitcode for p in procs]}); "
                            "likely OOM or a native crash in decode/augment"
                        )
                    if not any(p.is_alive() for p in procs) and out_q.empty():
                        raise RuntimeError(
                            "all loader workers exited but samples are "
                            "still missing — results lost in a worker"
                        )

        try:
            yield from self._assemble(get_sample, len(work), n_batches)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)


def host_tensor(v) -> torch.Tensor:
    """A host batch leaf as a CPU tensor: float64 becomes float32, as
    jax.device_put makes it with x64 off; other dtypes stay."""
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def device_prefetch(iterator: Iterable[Dict[str, np.ndarray]], size: int = 2, device=None):
    """Overlap host batch assembly with device compute: keep `size` batches
    in flight on `device` (the card when None; replaces DataLoader
    prefetch_factor). As in whmr_tpu, `size` batches are taken from
    `iterator` before the first is handed out, on every device.

    On a CUDA device each host batch is staged in pinned memory and copied
    with `non_blocking=True` on a side stream, so the copies run beside the
    compute. An event recorded on the copy stream after a batch's copies is
    what the compute stream waits on when the batch is handed out (the
    `wait_stream` of that moment, without waiting for the copies of the
    batches behind it), and each tensor is marked with `record_stream`, so
    the caching allocator does not reuse its memory while the compute stream
    may still read it. Nothing here synchronises the host with the card.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to feed batches to the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        copy_stream = torch.cuda.Stream(device)

        def put(host):
            pinned = {k: host_tensor(v).pin_memory() for k, v in host.items()}
            with torch.cuda.stream(copy_stream):
                batch = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
                copied = torch.cuda.Event()
                copied.record(copy_stream)
            return batch, copied

        def hand_out(item):
            batch, copied = item
            compute = torch.cuda.current_stream(device)
            compute.wait_event(copied)
            for t in batch.values():
                t.record_stream(compute)
            return batch
    else:
        def put(host):
            return {k: host_tensor(v).to(device) for k, v in host.items()}

        def hand_out(batch):
            return batch

    buf: deque = deque()
    for host in iterator:
        buf.append(put(host))
        if len(buf) >= size:
            yield hand_out(buf.popleft())
    while buf:
        yield hand_out(buf.popleft())
