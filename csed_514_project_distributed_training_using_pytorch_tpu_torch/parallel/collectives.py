"""Collectives and point-to-point over the process group or one of its axis groups.

Counterpart of the JAX package's ``parallel/collectives.py``: ``ring_pass`` (the
``ppermute`` ring of the connectivity smoke, the reference's rank 0 -> rank 1 send) and
``all_reduce_sum``, here explicit ``torch.distributed`` calls where the JAX package lets
XLA insert them; plus ``all_gather`` and ``broadcast_``, which the trainer and its checks
use, and ``all_gather_seq``, which puts the ring schedules' sequence shards back together
(``parallel/ring_attention.py``; its hops are ``ring_pass`` in either direction).

Every function takes ``group``: a ``torch.distributed`` group (an axis of
``parallel.mesh.ProcessGrid``: the ranks that share every other coordinate), or None for
the whole process group. Ranks inside a group are the group's own (0 .. size-1); the
point-to-point calls map them to global ranks.

The einsum schedules and the mesh layers differentiate through their collectives, as the
JAX package's do through ``ppermute``, ``psum`` and ``all_to_all``:

- ``ring_pass_diff`` is ``ring_pass`` whose backward passes the gradient the other way;
- ``all_to_all`` (Ulysses' head-scatter and the expert dispatch, the counterpart of
  ``lax.all_to_all(..., tiled=True)``) has the inverse all-to-all as its backward;
- ``seq_shard``/``seq_gather`` move between the full ``[..., S, ...]`` operand every rank
  holds and this rank's shard: the shard's backward gathers every rank's gradient shard,
  the gather's backward takes this rank's shard of the (replicated) gradient;
- Megatron's *f* and *g* on the model group: ``copy_to_group`` (identity forward, SUM
  all-reduce backward) and ``reduce_from_group`` (SUM all-reduce forward, identity
  backward);
- ``gather_dim`` (all-gather along a dim forward, reduce-scatter of the gradient backward:
  FSDP's gather of a sharded leaf where it is used) and ``sum_over`` (SUM all-reduce
  forward, the gradient times ``scale`` backward: a mean over the global batch whose
  loss the data ranks average);
- ``send``/``recv`` between neighbouring pipeline stages (the pipeline's own autograd
  function orders them, and sends each gradient back the other way).

Where the tensors live is the caller's business; how they travel is chosen by backend,
never by trying: NCCL takes tensors on the rank's card, gloo takes them on the host, so a
CUDA tensor on a gloo group goes through a host copy (``host_staged``). ``call_counts``
counts the calls of each differentiable mesh collective (forward and backward apart), so a
caller can hold a run's collectives against its plan.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

_CALLS: collections.Counter = collections.Counter()


def call_counts() -> dict[str, int]:
    """Calls of each differentiable mesh collective since the last reset, by name
    (``gather_dim``, ``gather_dim.backward``, ``all_to_all``, ``copy_to_group.backward``,
    ``reduce_from_group``, ``send``, ``recv``, ...)."""
    return dict(_CALLS)


def reset_call_counts() -> None:
    _CALLS.clear()


def _count(name: str) -> None:
    _CALLS[name] += 1


def host_staged(tensor: torch.Tensor) -> bool:
    """True when ``tensor`` must cross the group through host memory: a CUDA tensor on a
    gloo group (gloo reduces and sends host buffers)."""
    return tensor.is_cuda and dist.get_backend() == "gloo"


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


def _global(group, rank: int) -> int:
    """The global rank of ``group``'s rank ``rank``."""
    return rank if group is None else dist.get_global_rank(group, rank)


def _all_reduce_(tensor: torch.Tensor, op, host: torch.Tensor | None, group) -> None:
    if not host_staged(tensor):
        dist.all_reduce(tensor, op=op, group=group)
        return
    if host is None:
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    dist.all_reduce(host, op=op, group=group)
    tensor.copy_(host)


def all_reduce_sum_(tensor: torch.Tensor, *, host: torch.Tensor | None = None,
                    group=None) -> None:
    """SUM ``tensor`` over the group's ranks, in place. A host-staged tensor is reduced in
    ``host`` (a same-shape CPU buffer, pinned for the fast copies; one is made when not
    given) and copied back."""
    _all_reduce_(tensor, dist.ReduceOp.SUM, host, group)


def all_reduce_max_(tensor: torch.Tensor, *, group=None) -> None:
    """MAX ``tensor`` over the group's ranks, in place (host-staged as
    ``all_reduce_sum_``): a row's amax over a row-parallel input's slices."""
    _all_reduce_(tensor, dist.ReduceOp.MAX, None, group)


def all_reduce_sum(values: torch.Tensor, *, group=None) -> torch.Tensor:
    """The SUM of ``values`` over the group's ranks, as a new tensor (the explicit
    all-reduce of the connectivity checks; the trainer's gradient reduce is
    ``data_parallel``'s)."""
    out = values.clone()
    all_reduce_sum_(out, group=group)
    return out


def broadcast_(tensor: torch.Tensor, src: int = 0, *, group=None) -> None:
    """Overwrite ``tensor`` on every rank of the group with the group's rank ``src``'s,
    in place."""
    src = _global(group, src)
    if not host_staged(tensor):
        dist.broadcast(tensor, src=src, group=group)
        return
    host = tensor.cpu()
    dist.broadcast(host, src=src, group=group)
    tensor.copy_(host)


def all_gather(value: torch.Tensor, *, group=None) -> torch.Tensor:
    """Every rank's ``value`` stacked along a new leading axis, in rank order, on every
    rank of the group."""
    staged = host_staged(value)
    send = value.cpu() if staged else value.contiguous()
    parts = [torch.empty_like(send) for _ in range(_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.stack(parts).to(value.device)


def all_gather_seq(shard: torch.Tensor, dim: int = 1, *, group=None) -> torch.Tensor:
    """Every rank's shard concatenated along ``dim`` in rank order, on every rank:
    ``[B, S/n, H, D]`` shards back to the full ``[B, S, H, D]`` (the ring schedules'
    output, and in backward their gradients)."""
    staged = host_staged(shard)
    send = shard.cpu() if staged else shard.contiguous()
    parts = [torch.empty_like(send) for _ in range(_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, dim=dim).to(shard.device)


def reduce_scatter_dim(full: torch.Tensor, dim: int, *, group=None) -> torch.Tensor:
    """The SUM over the group's ranks of ``full``, of which each rank keeps its own
    contiguous ``1/n`` along ``dim`` (rank order): ``all_gather_seq``'s transpose. NCCL
    runs ``reduce_scatter_tensor``; a gloo group SUMs the whole tensor and keeps its part
    (one collective every torch version's gloo runs)."""
    n, rank = _size(group), _rank(group)
    part = full.shape[dim] // n
    if dist.get_backend(group) != "nccl":
        return all_reduce_sum(full, group=group).narrow(dim, rank * part, part).contiguous()
    send = full.movedim(dim, 0).contiguous()
    out = torch.empty((part,) + tuple(send.shape[1:]), dtype=send.dtype, device=send.device)
    dist.reduce_scatter_tensor(out, send, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def ring_pass(value: torch.Tensor, *, shift: int = 1, group=None) -> torch.Tensor:
    """Rotate one value per rank around the group's ring: rank ``i``'s ``value`` lands on
    rank ``(i + shift) % n``, which returns it. One ``batch_isend_irecv`` per rank (a send
    to the next rank and a receive from the previous, posted together, so no rank waits
    on its partner's order). At one rank the value comes back unchanged."""
    world, rank = _size(group), _rank(group)
    if world == 1 or shift % world == 0:
        return value.clone()
    staged = host_staged(value)
    send = value.cpu() if staged else value.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _global(group, (rank + shift) % world), group),
           dist.P2POp(dist.irecv, recv, _global(group, (rank - shift) % world), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(value.device)


def _all_to_all_tiled(x: torch.Tensor, split_dim: int, concat_dim: int,
                      group=None) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim, tiled=True)``:
    chunk ``i`` of ``split_dim`` goes to rank ``i``; the chunks received are concatenated
    along ``concat_dim`` in source-rank order. One ``all_to_all_single`` (dims >= 0)."""
    n = _size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all splits dim {split_dim} of size {x.shape[split_dim]} "
                         f"over {n} ranks: it must divide")
    send = x.unflatten(split_dim, (n, x.shape[split_dim] // n)).movedim(split_dim, 0)
    send = send.cpu().contiguous() if host_staged(x) else send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j] is rank j's chunk: the source axis goes just before concat_dim and merges
    return recv.to(x.device).movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim: int, concat_dim: int, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        _count("all_to_all")
        return _all_to_all_tiled(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        _count("all_to_all.backward")
        return _all_to_all_tiled(g, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, *, split_dim: int, concat_dim: int,
               group=None) -> torch.Tensor:
    """The tiled all-to-all over the group, differentiable: its backward is the inverse
    all-to-all (split ``concat_dim``, concatenate ``split_dim``)."""
    return _AllToAll.apply(x, split_dim, concat_dim, group)


class _RingPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift: int, group):
        ctx.shift, ctx.group = shift, group
        return ring_pass(x, shift=shift, group=group)

    @staticmethod
    def backward(ctx, g):
        return ring_pass(g.contiguous(), shift=-ctx.shift, group=ctx.group), None, None


def ring_pass_diff(value: torch.Tensor, *, shift: int = 1, group=None) -> torch.Tensor:
    """``ring_pass``, differentiable: the gradient of what rank ``i`` sent to rank
    ``i + shift`` comes back from it (``ppermute``'s transpose). Every rank must reach the
    backward of every pass it made, in the same order: the einsum schedules send K and V
    as one message and tie the last travelling block into their output
    (``ring_attention._anchor``)."""
    return _RingPass.apply(value, shift, group)


def _mine(order: torch.Tensor, group=None) -> torch.Tensor:
    c = order.numel() // _size(group)
    rank = _rank(group)
    return order[rank * c:(rank + 1) * c]


def _scatter_back(full: torch.Tensor, order: torch.Tensor, dim: int) -> torch.Tensor:
    """``full``'s slices along ``dim`` (rank-major: rank 0's positions first) put at the
    positions ``order`` names."""
    out = torch.empty_like(full)
    return out.index_copy_(dim, order.to(full.device), full)


class _SeqShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, order, dim: int, group):
        ctx.order, ctx.dim, ctx.group = order, dim, group
        return x.index_select(dim, _mine(order, group).to(x.device))

    @staticmethod
    def backward(ctx, g):
        full = all_gather_seq(g.contiguous(), dim=ctx.dim, group=ctx.group)
        return _scatter_back(full, ctx.order, ctx.dim), None, None, None


def seq_shard(x: torch.Tensor, order: torch.Tensor, *, dim: int = 1,
              group=None) -> torch.Tensor:
    """This rank's shard of the full ``x`` (the same on every rank of the group),
    differentiable: ``order`` lists the positions of ``dim`` rank by rank (``arange`` for
    contiguous shards; the zig-zag's chunk pairs), and rank ``r`` takes the ``r``-th equal
    run of it. The backward gathers every rank's gradient shard into the full gradient, so
    the layers outside see the same gradient on every rank."""
    return _SeqShard.apply(x, order, dim, group)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, order, dim: int, group):
        ctx.order, ctx.dim, ctx.group = order, dim, group
        return _scatter_back(all_gather_seq(shard, dim=dim, group=group), order, dim)

    @staticmethod
    def backward(ctx, g):
        mine = _mine(ctx.order, ctx.group).to(g.device)
        return g.index_select(ctx.dim, mine), None, None, None


def seq_gather(shard: torch.Tensor, order: torch.Tensor, *, dim: int = 1,
               group=None) -> torch.Tensor:
    """The inverse of ``seq_shard``: every rank's shard put back at its positions, the full
    tensor on every rank. The backward takes this rank's positions of the gradient, which
    every rank holds whole and equal (the loss is computed alike on every rank)."""
    return _SeqGather.apply(shard, order, dim, group)


# -- Megatron's f and g, FSDP's gather, the scaled sum ----------------------------------


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _count("copy_to_group.backward")
        return all_reduce_sum(g.contiguous(), group=ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: the identity forward; the backward SUMs the gradient over the
    group (each rank's part of it came through its own shard of the heads or hidden
    units)."""
    return _CopyToGroup.apply(x, group)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        _count("reduce_from_group")
        return all_reduce_sum(x.contiguous(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: the SUM of the ranks' partial products forward; the identity
    backward (every rank holds the same gradient of the replicated sum)."""
    return _ReduceFromGroup.apply(x, group)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim: int, group):
        ctx.dim, ctx.group = dim, group
        _count("gather_dim")
        return all_gather_seq(shard, dim=dim, group=group)

    @staticmethod
    def backward(ctx, g):
        _count("gather_dim.backward")
        return reduce_scatter_dim(g, ctx.dim, group=ctx.group), None, None


def gather_dim(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    """FSDP's gather: the whole leaf from every rank's contiguous shard along ``dim``;
    the backward reduce-scatters the gradient (the SUM over the ranks, this rank's shard
    of it)."""
    return _GatherDim.apply(shard, dim, group)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, scale: float):
        ctx.scale = scale
        out = x.contiguous()
        for group in groups:
            out = all_reduce_sum(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


def sum_over(x: torch.Tensor, groups, *, scale: float = 1.0) -> torch.Tensor:
    """The SUM of ``x`` over each group of ``groups`` in turn; the backward is the
    gradient times ``scale`` (the identity at 1: each rank's own terms, as *g*). A term of
    a loss that every rank of a data group computes alike, but whose gradient the data
    ranks average, takes ``scale`` = the data group's size."""
    return _SumOver.apply(x, tuple(groups), float(scale))


# -- point-to-point between pipeline stages ----------------------------------------------


def send(tensor: torch.Tensor, dst: int, *, group=None) -> None:
    """Send ``tensor`` to the group's rank ``dst`` (blocking until it is handed over)."""
    _count("send")
    staged = host_staged(tensor)
    dist.send(tensor.cpu() if staged else tensor.contiguous(), _global(group, dst),
              group=group)


def recv(like: torch.Tensor, src: int, *, group=None) -> torch.Tensor:
    """Receive a tensor of ``like``'s shape and dtype from the group's rank ``src``, on
    ``like``'s device."""
    _count("recv")
    staged = host_staged(like)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if staged else like.device)
    dist.recv(buf, _global(group, src), group=group)
    return buf.to(like.device)
