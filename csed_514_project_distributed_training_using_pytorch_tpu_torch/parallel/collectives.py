"""Collectives and point-to-point over the process group.

Counterpart of the JAX package's ``parallel/collectives.py``: ``ring_pass`` (the
``ppermute`` ring of the connectivity smoke, the reference's rank 0 -> rank 1 send) and
``all_reduce_sum``, here explicit ``torch.distributed`` calls where the JAX package lets
XLA insert them; plus ``all_gather`` and ``broadcast_``, which the trainer and its checks
use, and ``all_gather_seq``, which puts the ring schedules' sequence shards back together
(``parallel/ring_attention.py``; its hops are ``ring_pass`` in either direction).

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
