"""Epoch index plans for the device-resident trainer.

Counterpart of the parts of the JAX package's ``data/loader.py::BatchLoader`` that the
single-process trainer uses: the sampler-defined order, ``set_epoch``, and the
``[num_steps, batch]`` index matrix. The whole split lives on the device and each step
gathers its batch by index, so the loader hands out plans, not batches.
"""

from __future__ import annotations

import numpy as np

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data.mnist import Dataset
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.sampler import (
    ShardedSampler,
)


class BatchLoader:
    """Index plans over a dataset in a sampler-defined order.

    ``set_epoch`` mirrors ``train_loader.sampler.set_epoch(i)``; for the single-process
    shuffle case the same mechanism provides the per-epoch reshuffle.
    """

    def __init__(self, dataset: Dataset, batch_size: int, *,
                 sampler: ShardedSampler | None = None, shuffle: bool = False,
                 seed: int = 0):
        if sampler is not None and shuffle:
            raise ValueError("shuffle must be False when a sampler is given")
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(
            len(dataset), num_replicas=1, rank=0, shuffle=shuffle, seed=seed)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

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
