"""Expert parallelism: the routed mixture-of-experts MLP, its experts split over the
``expert`` axis.

Counterpart of the JAX package's ``parallel/expert_parallel.py``:

- ``init_moe_params``, ``moe_partition_specs``: the router ``[d, E]`` (replicated) and the
  expert-stacked MLP weights ``up_kernel [E, d, h]``, ``up_bias [E, h]``, ``down_kernel
  [E, h, d]``, ``down_bias [E, d]`` (split on their expert dim);
- ``_route``: top-1 Switch (the raw probability as the gate) or top-2 GShard (the pair's
  probabilities renormalized), each expert's queue taking every first choice before any
  second choice; a token past ``capacity = ceil(k·N/E·factor)`` is dropped (its output is
  zero: the MoE sits on the residual path). The load-balance auxiliary is Switch §2.2's
  ``E · Σ_e frac_tokens_e · frac_probs_e`` over the first choices;
- ``dispatch_tensors``: the one-hot ``[N, E, C]`` dispatch and combine layout of a routing,
  the JAX package's form (``x_e = einsum("nec,nd->ecd")``, ``out =
  einsum("nec,ecd->nd")``);
- ``moe_apply``: the layer, and ``moe_apply_dense_oracle``: every expert on every token,
  the kept assignments selected and gated, with the gates recomputed independently.

``moe_apply`` moves tokens by their slot index (``e·C + position``) instead of
multiplying by the one-hot tensor: each slot holds at most one token, so ``index_add`` and
``gather`` compute the einsums' values, and the ``[N, E, C]`` tensor (``N·E·C`` floats:
86 GB at the composed trainer's 64 images of 2,048 tokens) is never built.

Under an ``expert`` axis of ``n`` ranks (``expert``, a ``mesh.Axis``) each rank routes its
``1/n`` of the tokens (``collectives.seq_shard`` over the expert group: the layers outside
see every token on every rank). The queue positions and the auxiliary are the JAX
package's over the global token set: every chunk's per-expert counts are all-gathered over
the expert group (and over ``data``, whose ranks hold other examples of the global batch),
so a chunk's queue continues where the chunks before it in global order stop, and the
capacity is computed from the global ``N``. The dispatched ``[E, C, d]`` slots then go to
their experts' ranks by one tiled all-to-all (each rank sends the slots its tokens filled,
zeros elsewhere, and sums what it receives: the slots are disjoint), the local experts run,
and one all-to-all brings every expert's slots back; each rank combines its own tokens,
and ``collectives.seq_gather`` puts the token set back together. The router's gradient
comes from this rank's tokens only, so it is summed over the expert group (Megatron's
*f*, ``collectives.copy_to_group``); the auxiliary's probability means are summed over
the groups with ``collectives.sum_over``, whose backward scales by the data world (the
data ranks average their gradients, and each holds only its examples' terms).
"""

from __future__ import annotations

import math

import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch import ops
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    Axis,
)

INIT_STDDEV = 0.02


def init_moe_params(generator: torch.Generator, *, d_model: int, d_hidden: int,
                    num_experts: int) -> dict[str, torch.Tensor]:
    """Router and per-expert MLP weights (leading dim: the expert), drawn normal(0.02) on
    the CPU from ``generator``; expert biases start at zero."""
    normal = lambda *shape: torch.empty(shape).normal_(0.0, INIT_STDDEV,
                                                       generator=generator)
    return {"router_kernel": normal(d_model, num_experts),
            "up_kernel": normal(num_experts, d_model, d_hidden),
            "up_bias": torch.zeros(num_experts, d_hidden),
            "down_kernel": normal(num_experts, d_hidden, d_model),
            "down_bias": torch.zeros(num_experts, d_model)}


def moe_partition_specs(params: dict, *, axis_name: str = "expert") -> dict[str, tuple]:
    """Per leaf: the expert-stacked weights split their expert dim, the router
    replicates (every rank routes its tokens)."""
    return {"router_kernel": (None, None), "up_kernel": (axis_name, None, None),
            "up_bias": (axis_name, None), "down_kernel": (axis_name, None, None),
            "down_bias": (axis_name, None)}


def capacity_for(n_tokens: int, num_experts: int, num_selected: int,
                 capacity_factor: float) -> int:
    """``max(1, ceil(k·N/E·factor))``, in the JAX package's order of operations."""
    return max(1, math.ceil(num_selected * n_tokens / num_experts * capacity_factor))


def _choices(probs: torch.Tensor, num_selected: int):
    """The top-k one-hots ``[N, E]`` (first choice first) and their gates: the raw
    probability for Switch, renormalized over the selected pair for GShard."""
    num_experts = probs.shape[-1]
    remaining, onehots, raw = probs, [], []
    for _ in range(num_selected):
        onehot = torch.nn.functional.one_hot(remaining.argmax(-1), num_experts).float()
        onehots.append(onehot)
        raw.append((probs * onehot).sum(-1))
        remaining = remaining * (1.0 - onehot)
    if num_selected > 1:
        denom = sum(raw) + 1e-9
        return onehots, [g / denom for g in raw]
    return onehots, raw


class TokenChunks:
    """Where this rank's tokens sit in the global token order: chunk ``index`` of
    ``count`` equal chunks, data-major then expert (the expert group's ranks split a data
    rank's tokens, the data ranks hold other examples). ``all_counts`` gathers every
    chunk's ``[k, E]`` counts in that order, ``total`` sums a tensor over all chunks; the
    groups are the ones the layer spans (an axis of one rank, or one the tokens do not
    differ over, is left out)."""

    def __init__(self, expert: Axis, data: Axis | None = None):
        self.expert = expert
        self.data = data if data is not None and data.size > 1 else None
        n_data = self.data.size if self.data is not None else 1
        self.count = expert.size * n_data
        self.index = (self.data.index if self.data is not None else 0) * expert.size \
            + expert.index
        self.groups = tuple(a.group for a in (expert, self.data)
                            if a is not None and a.size > 1)
        self.data_scale = float(n_data)

    def all_counts(self, counts: torch.Tensor) -> torch.Tensor:
        out = counts[None]
        if self.expert.size > 1:
            out = collectives.all_gather(counts, group=self.expert.group)
        if self.data is not None:
            out = collectives.all_gather(out, group=self.data.group).flatten(0, 1)
        return out

    def total(self, x: torch.Tensor) -> torch.Tensor:
        if not self.groups:
            return x
        return collectives.sum_over(x, self.groups, scale=self.data_scale)


def _route(router_kernel: torch.Tensor, tokens: torch.Tensor, *, capacity: int,
           num_selected: int = 1, chunks: TokenChunks | None = None):
    """Top-k routing of ``tokens [N, d]`` to expert slots: ``(slots, kept, gates, aux)``,
    ``slots [k, N]`` the flat slot ``e·C + position`` of each token's j-th choice,
    ``kept [k, N]`` whether it fits, ``gates [k, N]`` its gate, and the Switch
    load-balance auxiliary. ``chunks`` places these tokens in the global token order."""
    probs = torch.softmax((tokens @ router_kernel).float(), dim=-1)      # [N, E]
    num_experts = probs.shape[-1]
    onehots, gates = _choices(probs, num_selected)
    counts = torch.stack([oh.sum(0) for oh in onehots])                 # [k, E]
    if chunks is None:
        before, total, n_global = torch.zeros_like(counts), counts, tokens.shape[0]
    else:
        every = chunks.all_counts(counts)                                # [chunks, k, E]
        before, total = every[:chunks.index].sum(0), every.sum(0)
        n_global = tokens.shape[0] * chunks.count
    slots, kept = [], []
    queued = torch.zeros(num_experts, device=probs.device)   # slots of earlier choices
    for j, onehot in enumerate(onehots):
        position = torch.cumsum(onehot, 0) - onehot + (before[j] + queued)[None]
        position = (position * onehot).sum(-1).long()                    # [N]
        expert = onehot.argmax(-1)
        kept.append(position < capacity)
        slots.append(expert * capacity + position.clamp(max=capacity - 1))
        queued = queued + total[j]
    frac_tokens = total[0] / n_global
    prob_sum = probs.sum(0)
    if chunks is not None:
        prob_sum = chunks.total(prob_sum)
    aux = num_experts * torch.sum(frac_tokens * (prob_sum / n_global))
    return torch.stack(slots), torch.stack(kept), torch.stack(gates), aux


def dispatch_tensors(slots: torch.Tensor, kept: torch.Tensor, gates: torch.Tensor,
                     num_experts: int, capacity: int):
    """The one-hot ``[N, E, C]`` dispatch and combine tensors of a routing (the JAX
    package's layout; small ``N`` only)."""
    n = slots.shape[1]
    dispatch = torch.zeros(n, num_experts * capacity, device=slots.device)
    combine = torch.zeros_like(dispatch)
    rows = torch.arange(n, device=slots.device)
    for j in range(slots.shape[0]):
        k = kept[j].float()
        dispatch = dispatch.index_put((rows, slots[j]), k, accumulate=True)
        combine = combine.index_put((rows, slots[j]), k * gates[j], accumulate=True)
    shape = (n, num_experts, capacity)
    return dispatch.view(shape), combine.view(shape)


def _expert_mlp(params: dict, x_e: torch.Tensor) -> torch.Tensor:
    """Per-expert MLP over the dispatched ``[E, C, d]`` slots, as batched matmuls."""
    h = ops.gelu(torch.einsum("ecd,edh->ech", x_e, params["up_kernel"])
                 + params["up_bias"][:, None])
    return torch.einsum("ech,ehd->ecd", h, params["down_kernel"]) + params["down_bias"][:, None]


def _dispatch(tokens, slots, kept, num_slots: int) -> torch.Tensor:
    """``[E·C, d]``: each kept assignment's token at its slot (zeros elsewhere)."""
    d = tokens.shape[-1]
    out = tokens.new_zeros(num_slots, d)
    for j in range(slots.shape[0]):
        keep = kept[j]
        out = out.index_add(0, slots[j][keep], tokens[keep])
    return out


def _combine(y_flat, slots, kept, gates, dtype) -> torch.Tensor:
    """``[N, d]``: each token's kept slots' outputs, gated and summed."""
    out = None
    for j in range(slots.shape[0]):
        w = (gates[j] * kept[j].float()).to(dtype)[:, None]
        term = w * y_flat.index_select(0, slots[j])
        out = term if out is None else out + term
    return out


def moe_apply(params: dict, tokens: torch.Tensor, *, capacity_factor: float = 1.25,
              num_selected: int = 1, expert: Axis | None = None,
              data: Axis | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer on ``tokens [N, d]`` -> ``(outputs [N, d], aux_loss)``.

    ``expert`` (an axis of more than one rank) runs it expert-parallel: ``params``'
    expert-stacked leaves are then this rank's ``E/n`` experts and the router is whole;
    ``tokens`` are the same on every rank of the expert group. ``data`` (a data axis whose
    ranks hold other examples) makes the capacity, the queues and the auxiliary those of
    the global batch. Without them the layer runs on one rank."""
    num_experts = params["router_kernel"].shape[-1]
    if not 1 <= num_selected <= num_experts:
        raise ValueError(f"num_selected must be in [1, num_experts], got {num_selected}")
    ep = expert is not None and expert.size > 1
    spans_data = data is not None and data.size > 1
    router = params["router_kernel"]
    order = None
    if ep:
        if tokens.shape[0] % expert.size:
            raise ValueError(f"{tokens.shape[0]} tokens do not split over the expert "
                             f"axis of {expert.size}")
        order = torch.arange(tokens.shape[0])
        tokens = collectives.seq_shard(tokens, order, dim=0, group=expert.group)
        router = collectives.copy_to_group(router, expert.group)
    chunks = TokenChunks(expert or Axis("expert"), data) if (ep or spans_data) else None
    n_global = tokens.shape[0] * (chunks.count if chunks is not None else 1)
    capacity = capacity_for(n_global, num_experts, num_selected, capacity_factor)
    slots, kept, gates, aux = _route(router, tokens, capacity=capacity,
                                     num_selected=num_selected, chunks=chunks)
    x_flat = _dispatch(tokens, slots, kept, num_experts * capacity)
    x_e = x_flat.view(num_experts, capacity, -1)
    if ep:
        # the slots of each rank's experts to that rank; the partial slot sets sum
        x_e = collectives.all_to_all(x_e[None], split_dim=1, concat_dim=0,
                                     group=expert.group).sum(0)
    y_e = _expert_mlp(params, x_e)
    if ep:
        # every expert's slots back to every rank of the group
        y_e = collectives.all_to_all(y_e[None].expand(expert.size, *y_e.shape),
                                     split_dim=0, concat_dim=1, group=expert.group)[0]
    out = _combine(y_e.reshape(num_experts * capacity, -1), slots, kept, gates,
                   tokens.dtype)
    if ep:
        out = collectives.seq_gather(out, order, dim=0, group=expert.group)
    return out.to(tokens.dtype), aux


def moe_apply_dense_oracle(params: dict, tokens: torch.Tensor, *,
                           capacity_factor: float = 1.25,
                           num_selected: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer's semantics with no dispatch machinery: every expert computes every
    token, then the kept assignments are selected and gated. The keep masks come from
    ``_route``; the gates are recomputed here, so the test keeps its power over the
    routing's gating math. ``O(E·N·d·h)``: a test oracle only."""
    num_experts = params["router_kernel"].shape[-1]
    capacity = capacity_for(tokens.shape[0], num_experts, num_selected, capacity_factor)
    slots, kept, gates, aux = _route(params["router_kernel"], tokens, capacity=capacity,
                                     num_selected=num_selected)
    dispatch, _ = dispatch_tensors(slots, kept, gates, num_experts, capacity)
    keep = dispatch.sum(-1)                                              # [N, E]
    probs = torch.softmax((tokens @ params["router_kernel"]).float(), dim=-1)
    top_probs, top_idx = torch.topk(probs, num_selected)
    selected = torch.nn.functional.one_hot(top_idx, num_experts).float()  # [N, k, E]
    if num_selected > 1:
        top_probs = top_probs / (top_probs.sum(-1, keepdim=True) + 1e-9)
    weights = keep * torch.einsum("nk,nke->ne", top_probs, selected)
    per_expert = ops.gelu(torch.einsum("nd,edh->neh", tokens, params["up_kernel"])
                          + params["up_bias"][None])
    per_expert = torch.einsum("neh,ehd->ned", per_expert, params["down_kernel"]) \
        + params["down_bias"][None]
    out = torch.einsum("ne,ned->nd", weights, per_expert)
    return out.to(tokens.dtype), aux


__all__ = ["TokenChunks", "capacity_for", "dispatch_tensors", "init_moe_params",
           "moe_apply", "moe_apply_dense_oracle", "moe_partition_specs"]
