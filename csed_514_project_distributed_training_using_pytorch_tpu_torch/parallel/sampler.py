"""Epoch-seeded sharded sampling — the ``DistributedSampler`` contract as a pure function.

Counterpart of the JAX package's ``parallel/sampler.py`` (this package's own copy):

1. one *global* permutation of all indices, keyed on ``(seed, epoch)`` — identical on every
   replica with no communication;
2. pad the permuted list to a multiple of ``num_replicas`` by recycling its head
   (torch's ``drop_last=False`` behavior), so every replica gets the same count;
3. stride-shard: replica ``r`` takes ``indices[r::num_replicas]``.

The permutation comes from numpy's PCG64 seeded with ``SeedSequence([seed, epoch])``, so
plans are bitwise the JAX package's for every (seed, epoch, rank, num_replicas).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ShardedSampler:
    """Pure-function sampler: ``epoch_indices(epoch)`` -> this replica's index array."""

    dataset_size: int
    num_replicas: int = 1
    rank: int = 0
    shuffle: bool = True
    seed: int = 42

    def __post_init__(self):
        if not (0 <= self.rank < self.num_replicas):
            raise ValueError(f"rank {self.rank} out of range for {self.num_replicas} replicas")

    @property
    def total_size(self) -> int:
        """Padded global size (multiple of num_replicas)."""
        per = -(-self.dataset_size // self.num_replicas)  # ceil
        return per * self.num_replicas

    @property
    def num_samples(self) -> int:
        """Samples per replica per epoch."""
        return self.total_size // self.num_replicas

    def global_permutation(self, epoch: int) -> np.ndarray:
        """The (seed, epoch)-keyed global order, padded — identical on every replica."""
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            indices = rng.permutation(self.dataset_size)
        else:
            indices = np.arange(self.dataset_size)
        pad = self.total_size - self.dataset_size
        if pad:
            indices = np.concatenate([indices, indices[:pad]])
        return indices

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This replica's shard for ``epoch`` (the ``set_epoch`` + iterate equivalent)."""
        return self.global_permutation(epoch)[self.rank::self.num_replicas]
