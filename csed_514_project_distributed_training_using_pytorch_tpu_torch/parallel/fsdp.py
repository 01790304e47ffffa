"""FSDP/ZeRO: parameters and their optimizer state sharded over the ``data`` axis.

Counterpart of the JAX package's ``parallel/fsdp.py``. Every large enough leaf, and its
optimizer state, is split over the same axis the batch is split over, so the weight and
optimizer memory of a rank shrinks with the data world. The rules are the JAX package's:

- ``_zero_dim`` is the one dim choice for plain and hybrid FSDP: the largest dim
  divisible by the axis size and at least as long, not already taken, for leaves of at
  least ``min_leaf_size`` elements; other leaves replicate. On the CNN the two small
  leaves replicate and the run is DP with the larger leaves sharded;
- ``fsdp_partition_specs`` (``train.distributed --fsdp``): that dim over ``data``;
- ``hybrid_partition_specs`` (the composed trainer's ``--fsdp``): ``tensor_parallel``'s
  rules first, then the largest free divisible dim over ``data`` as well, so memory
  divides by data × model (DeepSpeed ZeRO beside Megatron). It degrades to plain FSDP
  without a model axis and to plain TP at data 1.

Where JAX's SPMD partitioner inserts a per-use all-gather and a gradient reduce-scatter
from these annotations, the port calls them: ``gather_params`` gathers each sharded leaf
where the forward uses it (``collectives.gather_dim``: all-gather forward, reduce-scatter
of the gradient backward), and ``FsdpReducer`` finishes the step's reduction, dividing the
reduce-scattered sums by the data world and averaging every replicated leaf and the loss
in one all-reduce (``data_parallel.GradReducer``'s bucket). The SGD/AdamW update then runs
on the local shard, since the optimizer state shards with its parameter.

At a data world of 1 every split is the whole leaf: no collective runs, and the step is
the DP step (on the card at world 1 it stays inside the captured segment).
"""

from __future__ import annotations

import math

import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
    tensor_parallel as tp,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.data_parallel import (
    GradReducer,
)

MIN_LEAF_SIZE = 2048


def _zero_dim(shape, axis_size: int, min_leaf_size: int = MIN_LEAF_SIZE,
              taken: tuple = ()) -> int | None:
    """THE ZeRO dim rule: the largest ``axis_size``-divisible dim not in ``taken``, or
    None for a leaf too small (the gather would cost more than the memory saved) or
    with no divisible dim. Ties go to the first such dim, as Python's ``max`` gives."""
    shape = tuple(shape)
    if math.prod(shape) < min_leaf_size:
        return None
    divisible = [d for d in range(len(shape))
                 if d not in taken and shape[d] % axis_size == 0 and shape[d] >= axis_size]
    if not divisible:
        return None
    return max(divisible, key=lambda d: shape[d])


def fsdp_partition_specs(params: dict[str, torch.Tensor], axis_size: int, *,
                         axis_name: str = "data",
                         min_leaf_size: int = MIN_LEAF_SIZE) -> dict[str, tuple]:
    """Per leaf: ``axis_name`` on ``_zero_dim``'s choice, or replicated."""
    specs = {}
    for k, p in params.items():
        spec = [None] * p.dim()
        best = _zero_dim(p.shape, axis_size, min_leaf_size)
        if best is not None:
            spec[best] = axis_name
        specs[k] = tuple(spec)
    return specs


def hybrid_partition_specs(params: dict[str, torch.Tensor], names, data_size: int, *,
                           data_axis: str = "data", model_axis: str = "model",
                           min_leaf_size: int = MIN_LEAF_SIZE) -> dict[str, tuple]:
    """ZeRO × TP: ``tensor_parallel``'s specs filtered to the mesh's axis ``names``, then
    ``data_axis`` on each leaf's largest free divisible dim when ``data_size`` > 1 (the
    JAX package's ``hybrid_state_shardings``)."""
    specs = tp.filter_to_grid(tp.param_partition_specs(params, axis_name=model_axis),
                              names)
    out = {}
    for k, spec in specs.items():
        entries = list(spec)
        if data_size > 1:
            taken = tuple(d for d, e in enumerate(entries) if e is not None)
            best = _zero_dim(params[k].shape, data_size, min_leaf_size, taken)
            if best is not None:
                entries[best] = data_axis
        out[k] = tuple(entries)
    return out


def data_dims(specs: dict[str, tuple], data_axis: str = "data") -> dict[str, int]:
    """``{name: dim}`` of the leaves split over ``data_axis``."""
    return {k: spec.index(data_axis) for k, spec in specs.items() if data_axis in spec}


def gather_leaf(shard: torch.Tensor, dim: int | None, axis) -> torch.Tensor:
    """The leaf as the forward uses it: ``shard`` gathered along ``dim`` over the data
    axis (``collectives.gather_dim``; its backward reduce-scatters the gradient), or
    ``shard`` itself when the leaf is not split or the axis has one rank."""
    if dim is None or axis.size == 1:
        return shard
    return collectives.gather_dim(shard, dim, axis.group)


def gather_params(params: dict[str, torch.Tensor], dims: dict[str, int], axis
                  ) -> dict[str, torch.Tensor]:
    """Every leaf of ``params`` as the forward uses it (``gather_leaf``)."""
    return {k: gather_leaf(p, dims.get(k), axis) for k, p in params.items()}


class FsdpReducer(GradReducer):
    """``reducer(grads, loss)`` of an FSDP step: the gradients of the split leaves came
    back from ``gather_dim``'s backward already SUMmed over the data group and scattered,
    so they are divided by its size; every other gradient and the loss go through
    ``GradReducer``'s one bucketed all-reduce and its division. Every rank then holds the
    global batch's mean, each split leaf's gradient as its own shard."""

    def __init__(self, params: dict[str, torch.Tensor], dims: dict[str, int], *,
                 group=None):
        self.split = frozenset(dims)
        super().__init__({k: p for k, p in params.items() if k not in self.split},
                         group=group, device=next(iter(params.values())).device)

    @torch.no_grad()
    def allreduce_mean_(self, grads: dict[str, torch.Tensor], loss: torch.Tensor) -> None:
        for k in self.split:
            grads[k].div_(self.world)
        super().allreduce_mean_({k: g for k, g in grads.items() if k not in self.split},
                                loss)

    __call__ = allreduce_mean_


__all__ = ["FsdpReducer", "MIN_LEAF_SIZE", "data_dims", "fsdp_partition_specs",
           "gather_leaf", "gather_params", "hybrid_partition_specs"]
