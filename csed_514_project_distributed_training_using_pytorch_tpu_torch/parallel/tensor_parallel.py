"""Tensor parallelism: the transformer's weights split over the ``model`` axis, and the
one shard/unshard machinery every mesh layout uses.

Counterpart of the JAX package's ``parallel/tensor_parallel.py``. The leaf-name rules are
the JAX package's (``_COLUMN_PARALLEL``, ``_ROW_PARALLEL``, ``_COLUMN_PARALLEL_BIAS``,
``_EXPERT_STACKED``), so a leaf is split on exactly the dim JAX splits it:

- attention QKV and MLP up-projections are column-parallel (``(None, "model")``): each
  rank computes its local heads and hidden units;
- attention output and MLP down-projections are row-parallel (``("model", None)``): each
  rank holds the matching input slice, and its partial product is SUMmed over the model
  group (Megatron's *g*, ``collectives.reduce_from_group``) before the replicated bias;
- expert-stacked MoE weights split their expert dim over ``expert``;
- everything else (embeddings, LayerNorms, the head, row-parallel biases, the router, the
  CNN) replicates.

Where JAX's GSPMD reshards a ``P(None, "model")`` fused ``qkv_kernel`` as its program
needs, a torch rank computes with what it holds, so the fused ``qkv`` and GQA ``kv``
column dims are split by heads: rank ``r`` holds its ``1/n`` of each of q, k and v
(``mesh.shard_slices`` with ``groups``), which are its local heads. Every other split is
JAX's contiguous box. Unsharding puts the leaf back in the standard layout either way, and
the sharded checkpoint writes each held range as its own box, so files interchange with
the JAX package's.

A layout is a dict ``{name: spec}``, ``spec`` a tuple with one entry per dim: an axis name
or None (the JAX ``PartitionSpec`` as a tuple). ``filter_to_grid`` drops axes the mesh
spec lacks (an axis the spec names with size 1 stays: it is a no-op split, and the FSDP
dim choice treats the dim as taken, as JAX does). ``shard_leaf``/``unshard_leaf``, and the
``TrainState`` forms, move between the standard layout and a rank's shards; unsharding is
a collective over the axes' groups.
"""

from __future__ import annotations

import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.optim import (
    map_param_trees,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    ProcessGrid,
    shard_slices,
)

_COLUMN_PARALLEL = {"qkv_kernel", "q_kernel", "kv_kernel", "mlp_up_kernel"}
_ROW_PARALLEL = {"out_kernel", "mlp_down_kernel"}
_COLUMN_PARALLEL_BIAS = {"qkv_bias", "q_bias", "kv_bias", "mlp_up_bias"}
# MoE blocks: expert-stacked weights shard their expert dim; the router replicates
_EXPERT_STACKED = {"up_kernel", "down_kernel"}   # [E, in, out]
_EXPERT_STACKED_BIAS = {"up_bias", "down_bias"}  # [E, out]
# fused projections whose column dim is (part, heads, head_dim): split by heads
_HEAD_GROUPS = {"qkv_kernel": 3, "qkv_bias": 3, "kv_kernel": 2, "kv_bias": 2}


def leaf_name(name: str) -> str:
    """The module-local leaf name of a dotted parameter name (``block_0.attn.qkv_kernel``
    -> ``qkv_kernel``): the rules key on it, at any nesting depth."""
    return name.rsplit(".", 1)[-1]


def spec_for(name: str, ndim: int, *, axis_name: str = "model",
             expert_axis: str = "expert", shift: int = 0) -> tuple:
    """The JAX package's ``param_partition_specs`` rule for one leaf. ``shift`` is the
    number of leading stack dims (the pipeline's layer stack: every rule one dim right)."""
    name, core = leaf_name(name), ndim - shift
    lead = (None,) * shift
    if name in _COLUMN_PARALLEL and core == 2:
        return lead + (None, axis_name)
    if name in _ROW_PARALLEL and core == 2:
        return lead + (axis_name, None)
    if name in _COLUMN_PARALLEL_BIAS and core == 1:
        return lead + (axis_name,)
    if name in _EXPERT_STACKED and core == 3:
        return lead + (expert_axis, None, None)
    if name in _EXPERT_STACKED_BIAS and core == 2:
        return lead + (expert_axis, None)
    return (None,) * ndim


def param_partition_specs(params: dict[str, torch.Tensor], *, axis_name: str = "model",
                          expert_axis: str = "expert") -> dict[str, tuple]:
    """``{name: spec}`` of a parameter dict by the leaf-name rules (unrecognized leaves
    replicate, so the CNN degrades to plain DP). Specs may name axes the mesh lacks:
    ``filter_to_grid`` drops them."""
    return {k: spec_for(k, p.dim(), axis_name=axis_name, expert_axis=expert_axis)
            for k, p in params.items()}


def filter_to_grid(specs: dict[str, tuple], names) -> dict[str, tuple]:
    """Every spec entry naming an axis outside ``names`` (the mesh spec's axes) becomes
    replication on that dim: one rule set serves every mesh."""
    names = set(names)
    return {k: tuple(a if a in names else None for a in spec) for k, spec in specs.items()}


def sharded_axes(spec: tuple) -> tuple[str, ...]:
    """The axes a spec splits over, in dim order."""
    return tuple(a for a in spec if a is not None)


def _groups(name: str, axis: str) -> int:
    return _HEAD_GROUPS.get(leaf_name(name), 1) if axis == "model" else 1


def held_ranges(name: str, shape, spec: tuple, grid: ProcessGrid) -> list[list[slice]]:
    """Per dim, the ranges of the standard-layout leaf this rank holds (one range on a
    whole or contiguously split dim, one per part on a head-split fused dim)."""
    out = []
    for d, (n, axis) in enumerate(zip(shape, spec)):
        if axis is None:
            out.append([slice(0, n)])
        else:
            ax = grid.axis(axis)
            out.append(shard_slices(n, ax.size, ax.index, _groups(name, axis)))
    return out


def shard_leaf(full: torch.Tensor, spec: tuple, grid: ProcessGrid, name: str = ""
               ) -> torch.Tensor:
    """This rank's shard of the standard-layout leaf ``full`` (every rank holds it)."""
    out = full
    for d, axis in enumerate(spec):
        if axis is None or grid.size(axis) == 1:
            continue
        ax = grid.axis(axis)
        pieces = [out.narrow(d, s.start, s.stop - s.start)
                  for s in shard_slices(out.shape[d], ax.size, ax.index,
                                        _groups(name, axis))]
        out = torch.cat(pieces, dim=d) if len(pieces) > 1 else pieces[0]
    return out.contiguous()


def unshard_leaf(local: torch.Tensor, spec: tuple, grid: ProcessGrid, name: str = ""
                 ) -> torch.Tensor:
    """The standard-layout leaf from every rank's shard: one all-gather over each split
    axis's group (a collective: every rank of those groups calls it)."""
    out = local
    for d, axis in enumerate(spec):
        if axis is None or grid.size(axis) == 1:
            continue
        ax = grid.axis(axis)
        parts = collectives.all_gather(out, group=ax.group)        # [n, ...local...]
        g = _groups(name, axis)
        if g == 1:
            out = torch.cat(list(parts), dim=d)
        else:   # each rank's piece is g runs of w: interleave the runs part by part
            runs = [p.unflatten(d, (g, p.shape[d] // g)) for p in parts]
            out = torch.cat(runs, dim=d + 1).flatten(d, d + 1)
    return out


@torch.no_grad()
def shard_params(params: dict[str, torch.Tensor], specs: dict[str, tuple],
                 grid: ProcessGrid) -> dict[str, torch.Tensor]:
    return {k: shard_leaf(p, specs[k], grid, k) for k, p in params.items()}


@torch.no_grad()
def unshard_params(params: dict[str, torch.Tensor], specs: dict[str, tuple],
                   grid: ProcessGrid) -> dict[str, torch.Tensor]:
    return {k: unshard_leaf(p, specs[k], grid, k) for k, p in params.items()}


def map_state(state, fn):
    """``state`` with ``fn`` applied to its params, optimizer moments and EMA (each a
    params-congruent dict); the step, AdamW's count and the guard pass through."""
    return state._replace(params=fn(state.params),
                          velocity=map_param_trees(state.velocity, fn),
                          ema=fn(state.ema) if state.ema is not None else None)


def shard_train_state(state, specs: dict[str, tuple], grid: ProcessGrid):
    """This rank's shards of a standard-layout ``TrainState`` (the same on every rank):
    params, their optimizer state and the EMA split alike, so the update stays
    elementwise and local; the step and the guard replicate."""
    return map_state(state, lambda t: shard_params(t, specs, grid))


def unshard_train_state(state, specs: dict[str, tuple], grid: ProcessGrid):
    """The standard-layout ``TrainState`` on every rank, from every rank's shards."""
    return map_state(state, lambda t: unshard_params(t, specs, grid))


def sharded_norm_fn(specs: dict[str, tuple], grid: ProcessGrid):
    """The global L2 norm of a sharded gradient dict: each leaf's squared sum, those of
    the leaves split over the same axes added, then SUMmed over each of those axes'
    groups; None when nothing is split (the plain norm is exact)."""
    by_axes = {}
    for name, spec in specs.items():
        split = tuple(a for a in sharded_axes(spec) if grid.size(a) > 1)
        by_axes.setdefault(split, []).append(name)
    if set(by_axes) <= {()}:
        return None

    def norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
        total = None
        for split, names in by_axes.items():
            sq = sum(torch.sum(torch.square(grads[k].float())) for k in names)
            for axis in split:
                sq = collectives.all_reduce_sum(sq, group=grid.axis(axis).group)
            total = sq if total is None else total + sq
        return torch.sqrt(total)

    return norm


__all__ = ["filter_to_grid", "held_ranges", "leaf_name", "map_state", "sharded_norm_fn",
           "param_partition_specs", "shard_leaf", "shard_params", "shard_train_state",
           "sharded_axes", "spec_for", "unshard_leaf", "unshard_params",
           "unshard_train_state"]
