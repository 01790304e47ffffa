"""Data parallelism over the process group: the gradient reducer written by hand.

Counterpart of the JAX package's ``parallel/data_parallel.py`` (``compile_step``,
``compile_epoch``, ``compile_eval``). There XLA inserts the gradient all-reduce into one
compiled program from sharding annotations; here every rank runs the same eager step on
its shard of the global batch and calls the reducer between the backward and the update:

- ``broadcast_params_``: rank 0's parameters to every rank, once, at the start;
- ``GradReducer`` (``allreduce_mean_``): the step's gradients and its loss copied into one
  flat f32 bucket (21,841 floats, 87 KB, for the CNN), one SUM all-reduce a step, divided
  by the world size (gloo has no AVG), copied back. Every rank then holds the gradient
  and the loss of the global batch's mean, as the JAX program computes them;
- ``evaluate``: replicated (every rank evaluates the whole split, the reference's way) or
  sharded (each rank a contiguous block, the ``(sum_nll, correct)`` pair SUM-reduced).

``nn.parallel.DistributedDataParallel`` is not used: it needs a module that owns its
parameters and hooks their ``.grad``, while the port's step is functional
(``torch.func.functional_call`` over a parameter dict, ``train/step.py``), its gradients
the return value of ``torch.autograd.grad``.

On a gloo group with CUDA tensors the bucket crosses through a pinned host buffer
(``collectives.host_staged``), chosen from the backend.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
)


def broadcast_params_(params: dict[str, torch.Tensor], src: int = 0) -> None:
    """Overwrite every rank's parameters with rank ``src``'s, in place."""
    for p in params.values():
        collectives.broadcast_(p, src=src)


class GradReducer:
    """``reducer(grads, loss)``: the mean over ranks of the gradients and the loss, in
    place, through one flat bucket and one all-reduce. Built once for a parameter layout;
    the bucket (and, host-staged, its pinned twin) is reused every step."""

    def __init__(self, params: dict[str, torch.Tensor]):
        self.world = dist.get_world_size()
        first = next(iter(params.values()))
        self.numel = sum(p.numel() for p in params.values())
        self.bucket = torch.empty(self.numel + 1, dtype=torch.float32, device=first.device)
        self.host = (torch.empty(self.bucket.shape, dtype=torch.float32, pin_memory=True)
                     if collectives.host_staged(self.bucket) else None)
        self.calls = 0

    @torch.no_grad()
    def allreduce_mean_(self, grads: dict[str, torch.Tensor], loss: torch.Tensor) -> None:
        flat = [g.reshape(-1) for g in grads.values()] + [loss.reshape(1).float()]
        torch.cat(flat, out=self.bucket)
        collectives.all_reduce_sum_(self.bucket, host=self.host)
        self.bucket.div_(self.world)
        start = 0
        for g in grads.values():
            g.copy_(self.bucket[start:start + g.numel()].view_as(g))
            start += g.numel()
        loss.copy_(self.bucket[start].view_as(loss))
        self.calls += 1

    __call__ = allreduce_mean_


def evaluate(eval_fn: Callable, params, images: torch.Tensor, labels: torch.Tensor, *,
             shard: bool = False) -> tuple[float, int]:
    """``(sum_nll, num_correct)`` over the whole split as host numbers.

    ``shard=False`` is the reference's evaluation: every rank computes the full split, no
    collective. ``shard=True``: rank r evaluates the r-th contiguous block of the split
    (the split must divide by the world size, and each block by ``eval_fn``'s batch), and
    the pair is SUM-reduced in float64."""
    if not shard:
        sum_nll, correct = eval_fn(params, images, labels)
        return sum_nll.item(), int(correct.item())
    world, rank = dist.get_world_size(), dist.get_rank()
    n = images.shape[0]
    if n % world:
        raise ValueError(f"eval split size {n} not divisible by world size {world} — "
                         f"shard_eval needs equal blocks")
    per = n // world
    block = slice(rank * per, (rank + 1) * per)
    sum_nll, correct = eval_fn(params, images[block], labels[block])
    pair = torch.stack([sum_nll.double(), correct.double()])
    collectives.all_reduce_sum_(pair)
    sum_nll, correct = pair.tolist()
    return sum_nll, int(correct)
