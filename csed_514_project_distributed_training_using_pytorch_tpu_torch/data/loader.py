"""Host-side batch loader: epoch index plans, host batches and the device prefetch.

Counterpart of the JAX package's ``data/loader.py`` (the reference's
``torch.utils.data.DataLoader``, ``src/train.py:25-41``, ``src/train_dist.py:40-45``). The
whole split is a resident numpy array (``data/mnist.py``), so loading a batch is one gather
by index; the native C++ gather and prefetcher (``data.native``) take the worker pool's
role, with numpy's gather, bit for bit alike, where the library is not built. Two ways to
feed a trainer:

- the device-resident path: the split lives on the device and each step gathers its batch
  there by the ``[num_steps, batch]`` plan of ``epoch_index_matrix``;
- the host-fed path: host batches in plan order, through ``prefetch_iter`` /
  ``iter_plan_batches`` (the native prefetcher's C++ workers gather ahead in a bounded
  ring), or through iteration (``__iter__``, the ragged last batch included unless
  ``drop_last``), optionally ``prefetch=N`` deep onto a device on a background thread.

Shuffling follows the reference: single-process ``shuffle=True``, an epoch-seeded
permutation; distributed, sharding by ``parallel.ShardedSampler`` (the
``DistributedSampler`` contract) with no shuffle in the loader. ``drop_last`` defaults to
False, like torch's: 60,000 / 64 gives 937 batches of 64 and one of 32.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Iterator

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import native
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data.mnist import Dataset
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.sampler import (
    ShardedSampler,
)

# a batch at least this big is gathered on 4 native threads; below it one thread inline
# pays less than spawning and joining workers for every batch
THREADED_GATHER_BYTES = 4 << 20


def iter_plan_batches(dataset: Dataset, plan: np.ndarray, *,
                      num_workers: int = 4) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield one ``(images, labels)`` host batch per row of a ``[steps, batch]`` index plan
    (any view of one, a column block of the distributed plan included): through the native
    threaded prefetcher where it is built (``num_workers`` C++ threads gather ahead while
    the consumer's batch is in flight), else by a numpy gather. Used by the single-process
    host pipeline and the distributed host-local feed."""
    if plan.shape[0] == 0:
        return
    if not native.available():
        for row in plan:
            yield dataset.images[row], dataset.labels[row]
        return
    with native.Prefetcher(dataset.images, dataset.labels, plan,
                           num_workers=num_workers) as pf:
        yield from pf


def _to_device(batch: tuple, device: torch.device, stream) -> tuple:
    """Host arrays to ``device``: on the CPU tensors over the same memory; on CUDA each
    array staged into pinned memory and copied without blocking on ``stream``. The pinned
    block comes from torch's caching host allocator, which records the copy's event on it
    and hands it out again only once the copy has finished, so no later batch overwrites
    a staging buffer that a copy still reads."""
    tensors = [torch.from_numpy(np.ascontiguousarray(b)) for b in batch]
    if device.type != "cuda":
        return tuple(tensors)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        return tuple(t.pin_memory().to(device, non_blocking=True) for t in tensors)


def _device_prefetch_iter(base: Iterator, depth: int, device: torch.device) -> Iterator:
    """Double-buffered device feed: a daemon thread stages up to ``depth`` batches ahead
    (host gather, then the copy to ``device``) while the consumer's batch is in flight.

    On CUDA the copies run on a side stream; each batch is handed over with the side
    stream's event, which the consumer's current stream waits on before it reads the batch,
    and its tensors are recorded on the consumer's stream (``record_stream``), so the
    caching allocator reuses none of them while the consumer's work may still read it.
    Order and values are the base iterator's; a worker's exception re-raises at the
    consumer's next pull; abandoning the iterator early unblocks and stops the worker."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for batch in base:
                tensors = _to_device(batch, device, stream)
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record(stream)
                if not put(("item", (tensors, event))):
                    return
            put(("done", None))
        except BaseException as e:               # re-raised by the consumer
            put(("error", e))

    thread = threading.Thread(target=worker, daemon=True, name="loader-prefetch")
    thread.start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "done":
                return
            if kind == "error":
                raise payload
            tensors, event = payload
            if cuda:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for t in tensors:
                    t.record_stream(consumer)
            yield tensors
    finally:
        stop.set()


class BatchLoader:
    """Batches of a dataset in a sampler-defined order.

    ``set_epoch`` mirrors ``train_loader.sampler.set_epoch(i)``; for the single-process
    shuffle case the same mechanism provides the per-epoch reshuffle.

    Iterating yields ``(images, labels)`` numpy batches (the last one ragged unless
    ``drop_last``). ``prefetch=N`` (0, the default, is off) yields them as tensors on
    ``device`` instead, staged N deep on a background thread (``_device_prefetch_iter``);
    order and values are unchanged. ``device`` must be given with ``prefetch``.

    Every second the consumer spends blocked pulling the next batch (the prefetch queue
    empty, the native prefetcher behind, or the gather itself) accumulates in ``wait_s``;
    ``pop_wait_s()`` reads and resets it: the trainers' data-wait seconds.
    """

    def __init__(self, dataset: Dataset, batch_size: int, *,
                 sampler: ShardedSampler | None = None, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False, prefetch: int = 0,
                 device: torch.device | str | None = None):
        if sampler is not None and shuffle:
            raise ValueError("shuffle must be False when a sampler is given")
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        if prefetch and device is None:
            raise ValueError("prefetch stages batches onto a device: pass device= "
                             "('cuda' or 'cpu')")
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.prefetch = int(prefetch)
        self.device = torch.device(device) if device is not None else None
        self.sampler = sampler or ShardedSampler(
            len(dataset), num_replicas=1, rank=0, shuffle=shuffle, seed=seed)
        self._epoch = 0
        self.wait_s = 0.0           # consumer-blocked seconds; see the class docstring

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def pop_wait_s(self) -> float:
        """Return and reset the accumulated consumer-blocked seconds."""
        w, self.wait_s = self.wait_s, 0.0
        return w

    def _timed(self, base: Iterator) -> Iterator:
        """Wrap an iterator so that the time the consumer spends blocked in ``next()``
        accumulates in ``wait_s``. Work a prefetch thread does ahead of the consumer
        charges nothing: only stalls count."""
        while True:
            t0 = time.perf_counter()
            try:
                item = next(base)
            except StopIteration:
                self.wait_s += time.perf_counter() - t0
                return
            self.wait_s += time.perf_counter() - t0
            yield item

    def __len__(self) -> int:
        n = self.sampler.num_samples
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        if self.prefetch:
            return self._timed(
                _device_prefetch_iter(self._host_iter(), self.prefetch, self.device))
        return self._timed(self._host_iter())

    def _host_iter(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        if native.available():
            sample_bytes = int(np.prod(self.dataset.images.shape[1:])) * 4
            threads = 4 if self.batch_size * sample_bytes >= THREADED_GATHER_BYTES else 1
            gather = lambda imgs, labs, idx: native.gather(imgs, labs, idx,
                                                           num_threads=threads)
        else:
            gather = lambda imgs, labs, idx: (imgs[idx], labs[idx])
        indices = self.sampler.epoch_indices(self._epoch)
        n = len(indices)
        end = n - n % self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            idx = indices[start:start + self.batch_size]
            yield gather(self.dataset.images, self.dataset.labels, idx)

    def prefetch_iter(self, epoch: int | None = None,
                      num_workers: int = 4) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """This epoch's full batches through ``iter_plan_batches`` (the native threaded
        prefetcher where it is built), timed into ``wait_s``. A split smaller than one batch
        yields nothing: the ragged tail is the caller's."""
        plan = self.epoch_index_matrix(epoch, allow_empty=True)
        yield from self._timed(
            iter_plan_batches(self.dataset, plan, num_workers=num_workers))

    def epoch_index_matrix(self, epoch: int | None = None, steps_multiple: int = 1,
                           allow_empty: bool = False) -> np.ndarray:
        """This epoch's order as a ``[num_steps, batch_size]`` index matrix: full batches
        only, optionally truncated to a multiple of ``steps_multiple``. ``epoch=None`` uses
        the ``set_epoch`` value. With zero full batch groups, raises — or returns a
        ``[0, batch_size]`` matrix when ``allow_empty`` (callers that train the ragged
        tail separately)."""
        indices = self.sampler.epoch_indices(self._epoch if epoch is None else epoch)
        steps = len(indices) // self.batch_size
        steps -= steps % steps_multiple
        if steps == 0 and not allow_empty:
            raise ValueError(
                f"no full batch groups: {len(indices)} samples, batch {self.batch_size}, "
                f"steps_multiple {steps_multiple} — lower batch_size or steps_multiple")
        return indices[:steps * self.batch_size].reshape(steps, self.batch_size)
