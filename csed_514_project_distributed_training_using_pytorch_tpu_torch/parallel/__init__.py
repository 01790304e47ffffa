"""Parallelism: the sharded sampler and the mesh-spec grammar (the data-parallel trainer
comes later)."""

from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    parse_mesh_spec,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.sampler import (
    ShardedSampler,
)

__all__ = ["ShardedSampler", "parse_mesh_spec"]
