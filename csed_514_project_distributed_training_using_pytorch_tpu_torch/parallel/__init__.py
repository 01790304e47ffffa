"""Parallelism: the sharded sampler (the data-parallel trainer comes later)."""

from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.sampler import (
    ShardedSampler,
)

__all__ = ["ShardedSampler"]
