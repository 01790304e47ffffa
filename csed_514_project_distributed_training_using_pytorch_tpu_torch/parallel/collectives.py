"""Collectives and point-to-point over the process group.

Counterpart of the JAX package's ``parallel/collectives.py``: ``ring_pass`` (the
``ppermute`` ring of the connectivity smoke, the reference's rank 0 -> rank 1 send) and
``all_reduce_sum``, here explicit ``torch.distributed`` calls where the JAX package lets
XLA insert them; plus ``all_gather`` and ``broadcast_``, which the trainer and its checks
use, and ``all_gather_seq``, which puts the ring schedules' sequence shards back together
(``parallel/ring_attention.py``; its hops are ``ring_pass`` in either direction).

The einsum schedules differentiate through their collectives, as the JAX package's do
through ``ppermute`` and ``all_to_all``: ``ring_pass_diff`` is ``ring_pass`` whose backward
passes the gradient the other way, ``all_to_all`` (Ulysses' head-scatter, the counterpart of
``lax.all_to_all(..., tiled=True)``) has the inverse all-to-all as its backward, and
``seq_shard``/``seq_gather`` move between the full ``[..., S, ...]`` operand every rank
holds and this rank's sequence shard: the shard's backward gathers every rank's gradient
shard, the gather's backward takes this rank's shard of the (replicated) gradient.

Where the tensors live is the caller's business; how they travel is chosen by backend,
never by trying: NCCL takes tensors on the rank's card, gloo takes them on the host, so a
CUDA tensor on a gloo group goes through a host copy (``host_staged``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def host_staged(tensor: torch.Tensor) -> bool:
    """True when ``tensor`` must cross the group through host memory: a CUDA tensor on a
    gloo group (gloo reduces and sends host buffers)."""
    return tensor.is_cuda and dist.get_backend() == "gloo"


def all_reduce_sum_(tensor: torch.Tensor, *, host: torch.Tensor | None = None) -> None:
    """SUM ``tensor`` over every rank, in place. A host-staged tensor is reduced in
    ``host`` (a same-shape CPU buffer, pinned for the fast copies; one is made when not
    given) and copied back."""
    if not host_staged(tensor):
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
        return
    if host is None:
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    dist.all_reduce(host, op=dist.ReduceOp.SUM)
    tensor.copy_(host)


def all_reduce_sum(values: torch.Tensor) -> torch.Tensor:
    """The SUM of ``values`` over every rank, as a new tensor (the explicit all-reduce of
    the connectivity checks; the trainer's gradient reduce is ``data_parallel``'s)."""
    out = values.clone()
    all_reduce_sum_(out)
    return out


def broadcast_(tensor: torch.Tensor, src: int = 0) -> None:
    """Overwrite ``tensor`` on every rank with rank ``src``'s, in place."""
    if not host_staged(tensor):
        dist.broadcast(tensor, src=src)
        return
    host = tensor.cpu()
    dist.broadcast(host, src=src)
    tensor.copy_(host)


def all_gather(value: torch.Tensor) -> torch.Tensor:
    """Every rank's ``value`` stacked along a new leading axis, in rank order, on every
    rank."""
    staged = host_staged(value)
    send = value.cpu() if staged else value.contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, send)
    return torch.stack(parts).to(value.device)


def all_gather_seq(shard: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Every rank's sequence shard concatenated along ``dim`` in rank order, on every rank:
    ``[B, S/n, H, D]`` shards back to the full ``[B, S, H, D]`` (the ring schedules'
    output, and in backward their gradients)."""
    staged = host_staged(shard)
    send = shard.cpu() if staged else shard.contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, send)
    return torch.cat(parts, dim=dim).to(shard.device)


def ring_pass(value: torch.Tensor, *, shift: int = 1) -> torch.Tensor:
    """Rotate one value per rank around the ring: rank ``i``'s ``value`` lands on rank
    ``(i + shift) % world``, which returns it. One ``batch_isend_irecv`` per rank (a send
    to the next rank and a receive from the previous, posted together, so no rank waits
    on its partner's order). At world 1 the value comes back unchanged."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world == 1 or shift % world == 0:
        return value.clone()
    staged = host_staged(value)
    send = value.cpu() if staged else value.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (rank + shift) % world),
           dist.P2POp(dist.irecv, recv, (rank - shift) % world)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(value.device)


def _all_to_all_tiled(x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim, tiled=True)``:
    chunk ``i`` of ``split_dim`` goes to rank ``i``; the chunks received are concatenated
    along ``concat_dim`` in source-rank order. One ``all_to_all_single`` (dims >= 0)."""
    n = dist.get_world_size()
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all splits dim {split_dim} of size {x.shape[split_dim]} "
                         f"over {n} ranks: it must divide")
    send = x.unflatten(split_dim, (n, x.shape[split_dim] // n)).movedim(split_dim, 0)
    send = send.cpu().contiguous() if host_staged(x) else send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    # recv[j] is rank j's chunk: the source axis goes just before concat_dim and merges
    return recv.to(x.device).movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim: int, concat_dim: int):
        ctx.dims = (split_dim, concat_dim)
        return _all_to_all_tiled(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all_tiled(g, concat_dim, split_dim), None, None


def all_to_all(x: torch.Tensor, *, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all over the process group, differentiable: its backward is the
    inverse all-to-all (split ``concat_dim``, concatenate ``split_dim``)."""
    return _AllToAll.apply(x, split_dim, concat_dim)


class _RingPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shift: int):
        ctx.shift = shift
        return ring_pass(x, shift=shift)

    @staticmethod
    def backward(ctx, g):
        return ring_pass(g.contiguous(), shift=-ctx.shift), None


def ring_pass_diff(value: torch.Tensor, *, shift: int = 1) -> torch.Tensor:
    """``ring_pass``, differentiable: the gradient of what rank ``i`` sent to rank
    ``i + shift`` comes back from it (``ppermute``'s transpose). Every rank must reach the
    backward of every pass it made, in the same order: the einsum schedules send K and V
    as one message and tie the last travelling block into their output
    (``ring_attention._anchor``)."""
    return _RingPass.apply(value, shift)


def _mine(order: torch.Tensor) -> torch.Tensor:
    c = order.numel() // dist.get_world_size()
    rank = dist.get_rank()
    return order[rank * c:(rank + 1) * c]


def _scatter_back(full: torch.Tensor, order: torch.Tensor, dim: int) -> torch.Tensor:
    """``full``'s slices along ``dim`` (rank-major: rank 0's positions first) put at the
    positions ``order`` names."""
    out = torch.empty_like(full)
    return out.index_copy_(dim, order.to(full.device), full)


class _SeqShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, order, dim: int):
        ctx.order, ctx.dim = order, dim
        return x.index_select(dim, _mine(order).to(x.device))

    @staticmethod
    def backward(ctx, g):
        full = all_gather_seq(g.contiguous(), dim=ctx.dim)
        return _scatter_back(full, ctx.order, ctx.dim), None, None


def seq_shard(x: torch.Tensor, order: torch.Tensor, *, dim: int = 1) -> torch.Tensor:
    """This rank's shard of the full ``x`` (the same on every rank), differentiable:
    ``order`` lists the positions of ``dim`` rank by rank (``arange`` for contiguous
    shards; the zig-zag's chunk pairs), and rank ``r`` takes the ``r``-th equal run of it.
    The backward gathers every rank's gradient shard into the full gradient, so the layers
    outside attention see the same gradient on every rank."""
    return _SeqShard.apply(x, order, dim)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, order, dim: int):
        ctx.order, ctx.dim = order, dim
        return _scatter_back(all_gather_seq(shard, dim=dim), order, dim)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(ctx.dim, _mine(ctx.order).to(g.device)), None, None


def seq_gather(shard: torch.Tensor, order: torch.Tensor, *, dim: int = 1) -> torch.Tensor:
    """The inverse of ``seq_shard``: every rank's shard put back at its positions, the full
    tensor on every rank. The backward takes this rank's positions of the gradient, which
    every rank holds whole and equal (the loss is computed alike on every rank)."""
    return _SeqGather.apply(shard, order, dim)
