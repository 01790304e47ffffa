"""Parallelism: the sharded sampler, the process group and the mesh-spec grammar
(``mesh``), the collectives and the data-parallel gradient reducer."""

from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    parse_mesh_spec,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.sampler import (
    ShardedSampler,
)

__all__ = ["ShardedSampler", "parse_mesh_spec"]
