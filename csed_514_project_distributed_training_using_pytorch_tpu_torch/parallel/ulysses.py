"""All-to-all (Ulysses) sequence parallelism over the process group.

Counterpart of the JAX package's ``parallel/ulysses.py``. Where the ring keeps the queries
in place and walks the K/V blocks past them, Ulysses re-shards once: this rank's
sequence shard ``[B, S/n, H, D]`` of q, k and v goes through one all-to-all to the full
sequence of its head group ``[B, S, H/n, D]`` (head chunk ``i`` to rank ``i``, sequence
pieces concatenated in source-rank order: ``lax.all_to_all(split_axis=2, concat_axis=1,
tiled=True)``), the local op runs unchanged over the whole sequence, and the inverse
all-to-all brings the output back to sequence shards. Attention is independent per head,
so no merge math is needed.

The local op is ``ops.flash_attention.flash_attention`` with ``use_flash`` (the CUDA flash
kernels B4/B5 on the card, their plain versions on the CPU), else the dense core
``ops.attention.full_attention``; ``window=W`` binds the band into it.

Interface, as ``parallel.ring_attention``'s: the full ``[B, S, H, D]`` q, k and v on every
rank of the seq group (``group``; None: the whole process group) in; under a ``model``
axis the heads are this model rank's local heads, so ``H`` here is the local count, the full output on every rank out. The
shard, the two all-to-alls and the gather are differentiable (``parallel.collectives``),
so autograd carries the gradients back: the all-to-all's backward is the inverse
all-to-all, and the full parameter gradients agree on every rank with no reduce. q, k and
v travel as one message each way.
"""

from __future__ import annotations

import functools

import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    flash_attention as fa,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
    full_attention,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.ring_attention import (
    _world,
)


def check_shapes(s: int, h: int, n: int, use_flash: bool) -> None:
    """Raise, with the JAX package's messages, unless ``n`` ranks can run Ulysses at
    sequence length ``s`` and ``h`` heads: ``S % n``, ``H % n`` and, with ``use_flash``,
    ``S % BLOCK`` (the local op sees the whole sequence)."""
    if s % n:
        raise ValueError(
            f"sequence length {s} not divisible by mesh axis 'seq' size {n} "
            f"— ulysses attention shards the sequence evenly")
    if h % n:
        raise ValueError(
            f"ulysses attention scatters heads over the 'seq' axis: local "
            f"head count {h} must divide by its size {n} (use ring attention "
            f"when heads are scarcer than sequence shards)")
    if use_flash:
        if s % fa.BLOCK:
            raise ValueError(
                f"ulysses attention with use_flash=True runs the flash kernel over "
                f"the full sequence locally — S must divide by BLOCK = {fa.BLOCK}, "
                f"got {s}")


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = False, use_flash: bool = False,
                      window: int = 0, group=None) -> torch.Tensor:
    """Sequence-parallel attention by head-scatter all-to-all: ``[B, S, H, D]`` q, k, v,
    the same on every rank, -> the full ``[B, S, H, D]`` attention on every rank,
    differentiable (``ops.full_attention``'s semantics). Needs ``S % ranks == 0`` and
    ``H % ranks == 0``, and with ``use_flash`` ``S % 128 == 0`` (``check_shapes``)."""
    n, _ = _world(group)
    _, s, h, _ = q.shape
    check_shapes(s, h, n, use_flash)
    local_op = fa.flash_attention if use_flash else full_attention
    if window:
        local_op = functools.partial(local_op, window=window)
    order = torch.arange(s)
    qkv = collectives.seq_shard(torch.stack([q, k, v]), order, dim=2,
                                group=group)                            # [3,B,S/n,H,D]
    qkv = collectives.all_to_all(qkv, split_dim=3, concat_dim=2,
                                 group=group)                           # [3,B,S,H/n,D]
    out = local_op(qkv[0], qkv[1], qkv[2], causal=causal)
    out = collectives.all_to_all(out, split_dim=1, concat_dim=2,
                                 group=group)                           # [B,S/n,H,D]
    return collectives.seq_gather(out, order, dim=1, group=group)


def make_ulysses_attention_fn(*, use_flash: bool = False, window: int = 0, group=None):
    """A ``(q, k, v, *, causal) -> out`` callable with ``ops.full_attention``'s signature
    over the process group (``ulysses_attention`` with ``use_flash`` and ``window``
    bound), the transformer's pluggable ``attention_fn``."""

    def attention_fn(q, k, v, *, causal: bool = False):
        return ulysses_attention(q, k, v, causal=causal, use_flash=use_flash,
                                 window=window, group=group)

    return attention_fn


__all__ = ["check_shapes", "make_ulysses_attention_fn", "ulysses_attention"]
