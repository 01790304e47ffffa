"""Ring-of-flash: sequence-parallel attention over the process group, the flash kernels on
every hop.

Counterpart of the JAX package's ``parallel/ring_attention.py``, its flash schedules:

- ``ring_flash_attention``: rank ``r`` of ``n`` holds sequence shard ``r`` (``C = S/n``
  rows); K/V blocks travel one rank a hop. Causal hops are whole past, diagonal or future
  blocks (non-causal kernel, causal kernel, skipped). With ``window=W`` the ring is
  truncated to the band's hop reach and runs both ways for a non-causal window; each hop's
  block, ``delta`` shards away, enters the kernels' masks as ``q_offset = delta·C``
  (negative on reverse and wrapped hops);
- ``zigzag_ring_flash_attention``: causal only; the sequence in ``2n`` chunks of ``c``,
  rank ``r`` holding the pair ``(r, 2n−1−r)``, so every rank has the same live work a hop.
  With a window the live past pairs take ``q_offset = (q_chunk − k_chunk)·c``;
- ``make_ring_attention_fn(use_flash=True[, use_zigzag=True], window=W)``: the pluggable
  ``attention_fn(q, k, v, *, causal)`` of the transformer.

Each op is a ``torch.autograd.Function``. Its forward runs the hops through
``ops.flash_attention.flash_forward_with_lse`` and merges the partial results exactly
(``lse = logsumexp_t lse_t``, ``out = Σ_t exp(lse_t − lse)·out_t``). Its backward runs
``flash_backward_blocks`` per live hop from the merged (global) lse and Δ; the dk/dv
accumulators travel with their K/V blocks and go home at the end of each walk in one
``ring_pass``. Operands are promoted to f32 at entry, as the JAX package does (merging
rounded bf16 partials would lose what the f32 merge keeps), so the 3xTF32 kernels run
the hops on the card.

Interface. As the JAX functions take global arrays that ``shard_map`` shards, these take
the full ``[B, S, H, D]`` q, k and v on every rank of the process group (the seq world,
``parallel.mesh.seq_axis_size``). Each rank takes its own shard (its chunk pair for the
zig-zag) and nothing else of its copy: the peers' K/V blocks arrive by
``collectives.ring_pass``. ``collectives.all_gather_seq`` then puts the full output
together, and in backward the full dq, dk and dv. So the layers outside attention compute
the same values on every rank, the parameter gradients agree across ranks with no reduce,
and the function is a drop-in ``attention_fn``.

Each hop's kernel calls are planned from ``(n, rank, causal, window, shard length)``
alone (``_ring_plan``, ``_zigzag_plan``): forward and backward walk the same plan, and
``planned_blocks`` counts its calls, i.e. each kernel's launches per rank per call.

Not ported (ROADMAP A10): the einsum ring and the einsum zig-zag (they run no kernel),
Ulysses, and batch or head dims sharded over further mesh axes (``_qkv_spec``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    flash_attention as fa,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
    MASK_VALUE,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
)

_ALL = slice(None)


# =========================================================================================
# Hop classification and the blockwise-softmax merge (the JAX package's helpers)
# =========================================================================================


def _case_index(origin: int, my_index: int) -> int:
    """Causal-hop classification for equal shards arriving whole: 0 = entirely future
    (skip), 1 = entirely past (unmasked), 2 = diagonal (masked)."""
    return 2 if origin == my_index else (1 if origin < my_index else 0)


def _zigzag_case(q_chunk: int, k_chunk: int, c: int, window: int) -> int:
    """Chunk-pair classification of the zig-zag schedule, ``_case_index``'s encoding with
    the key chunk as origin; with a window a past pair whose closest elements sit
    ``(delta−1)·c + 1 ≥ W`` apart is dead (0)."""
    if not window:
        return _case_index(k_chunk, q_chunk)
    delta = q_chunk - k_chunk
    live_past = delta > 0 and (delta - 1) * c + 1 < window
    return 2 if delta == 0 else (1 if live_past else 0)


def _zigzag_order(n: int) -> tuple[list[int], list[int]]:
    """The zig-zag layout's chunk order (rank ``i`` holds chunks ``i`` and ``2n−1−i``) and
    its inverse."""
    order = []
    for i in range(n):
        order += [i, 2 * n - 1 - i]
    inv = [0] * (2 * n)
    for pos, chunk in enumerate(order):
        inv[chunk] = pos
    return order, inv


def _window_hop_reach(window: int, shard_len: int) -> int:
    """Max |shard delta| with any in-band pair: blocks ``delta`` shards apart have
    closest-pair distance ``(delta−1)·C + 1``."""
    if window <= 1:
        return 0
    return (window - 2) // shard_len + 1


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, C]`` row statistics -> ``[B, C, H, 1]``, to scale ``[B, C, H, D]`` rows."""
    return x.transpose(1, 2)[..., None]


def _flash_merge(carry, out: torch.Tensor, lse: torch.Tensor):
    """Merge one partial result (``out [B, C, H, D]`` f32, its ``lse [B, H, C]``) into the
    accumulators ``(acc [B, C, H, D], m [B, H, C], l [B, H, C])``: the exact combination
    ``lse = logsumexp_t(lse_t)``, ``out = Σ_t exp(lse_t − lse)·out_t``. A row the partial
    did not see (lse = ``MASK_VALUE``, out 0) is weighed out by the first live one."""
    acc, m, l = carry
    m_new = torch.maximum(m, lse)
    corr = torch.exp(m - m_new)
    w = torch.exp(lse - m_new)
    return acc * _rows(corr) + out * _rows(w), m_new, l * corr + w


def _flash_finish(carry):
    """Normalise the accumulators: ``(out [B, C, H, D], lse [B, H, C])``; the guard only
    protects rows no hop saw from dividing by zero."""
    acc, m, l = carry
    l_safe = torch.where(l == 0.0, 1.0, l)
    return acc / _rows(l_safe), m + torch.log(l_safe)


# =========================================================================================
# The hop plans: which kernel calls each hop makes, from the ring's coordinates alone
# =========================================================================================


@dataclass(frozen=True)
class _Block:
    """One flash call of a hop: the local query part ``q`` (an index into the schedule's
    parts), the rows ``k`` of the visiting K/V block, and the call's mask."""

    q: int
    k: slice
    causal: bool
    q_offset: int


@dataclass(frozen=True)
class _Hop:
    """One hop: the ``ring_pass`` shift that brings its K/V block (0: the block in hand),
    then its calls (none for a dead hop, whose block still travels on)."""

    shift: int
    blocks: tuple[_Block, ...]


def _live(delta: int, shard_len: int, window: int) -> bool:
    return delta == 0 or (abs(delta) - 1) * shard_len + 1 < window


def _ring_plan(n: int, rank: int, causal: bool, window: int,
               shard_len: int) -> list[list[_Hop]]:
    """The walks of the ring-of-flash on ``rank``; each walk starts from the rank's own
    K/V block. Without a window: one walk of ``n`` hops forward, each block past,
    diagonal or future (``_make_ring_flash_op``). With one: the diagonal, then the
    forward walk and (non-causal) the reverse walk, each truncated to the band's reach;
    a hop's block ``delta`` shards away (wrapped across the sequence's end on the first
    or last ranks) is masked with ``q_offset = delta·C`` (``_make_windowed_ring_flash_op``)."""
    if not window:
        walk = []
        for t in range(n):
            case = _case_index((rank - t) % n, rank) if causal else 1
            blocks = (_Block(0, _ALL, case == 2, 0),) if case else ()
            walk.append(_Hop(1 if t else 0, blocks))
        return [walk]
    reach = _window_hop_reach(window, shard_len)
    hops_fwd = min(reach, n - 1)
    hops_rev = 0 if causal else min(reach, n - 1 - hops_fwd)
    walks = [[_Hop(0, (_Block(0, _ALL, causal, 0),))]]
    for reverse, hops in ((False, hops_fwd), (True, hops_rev)):
        walk = []
        for t in range(1, hops + 1):
            no_wrap, wrap = (-t, n - t) if reverse else (t, t - n)
            wrapped = rank + t >= n if reverse else rank < t
            delta = wrap if wrapped else no_wrap
            live = _live(delta, shard_len, window) and not (causal and delta < 0)
            blocks = (_Block(0, _ALL, False, delta * shard_len),) if live else ()
            walk.append(_Hop(-1 if reverse else 1, blocks))
        if walk:
            walks.append(walk)
    return walks


def _zigzag_plan(n: int, rank: int, window: int, c: int) -> list[list[_Hop]]:
    """The zig-zag ring-of-flash's one walk on ``rank`` (``_make_zigzag_flash_op``): the
    local queries in two parts, chunk ``rank`` (part 0) and chunk ``2n−1−rank`` (part 1);
    the block from rank ``o`` holds chunks ``o`` and ``2n−1−o``. Early queries never see a
    late chunk; the late queries see the early chunk whole (band-checked under a window);
    the two same-parity pairs are past, diagonal or dead."""
    early, late = slice(0, c), slice(c, 2 * c)
    walk = []
    for t in range(n):
        o = (rank - t) % n
        blocks = []

        def pair(part: int, q_chunk: int, rows: slice, k_chunk: int) -> None:
            case = _zigzag_case(q_chunk, k_chunk, c, window)
            if case:
                offset = (q_chunk - k_chunk) * c if case == 1 and window else 0
                blocks.append(_Block(part, rows, case == 2, offset))

        pair(0, rank, early, o)
        if window:
            pair(1, 2 * n - 1 - rank, early, o)
        else:
            blocks.append(_Block(1, early, False, 0))
        pair(1, 2 * n - 1 - rank, late, 2 * n - 1 - o)
        walk.append(_Hop(1 if t else 0, tuple(blocks)))
    return [walk]


def planned_blocks(schedule: str, world: int, rank: int, *, seq_len: int,
                   causal: bool = False, window: int = 0, offset_only: bool = False) -> int:
    """The flash calls one ring op makes on ``rank`` per call, forward and backward alike:
    the launches of ``flash_fwd`` in its forward, and of ``flash_dq`` and of ``flash_dkv``
    in its backward; with ``offset_only``, those with a nonzero ``q_offset``.
    ``schedule`` is ``"ring"`` or ``"zigzag"``."""
    if schedule == "zigzag":
        plan = _zigzag_plan(world, rank, window, seq_len // (2 * world))
    else:
        plan = _ring_plan(world, rank, causal, window, seq_len // world)
    return sum(1 for walk in plan for hop in walk for blk in hop.blocks
               if blk.q_offset or not offset_only)


# =========================================================================================
# Forward and backward over a plan
# =========================================================================================


def _plan_forward(plan, q, k, v, parts, window: int):
    """Out ``[B, C', H, D]`` and lse ``[B, H, C']`` of the local queries (f32), walking
    ``plan``'s hops; one accumulator set per query part."""
    b, _, h, d = q.shape
    carries = []
    for part in parts:
        rows = q[:, part].shape[1]
        carries.append((q.new_zeros((b, rows, h, d)),
                        q.new_full((b, h, rows), MASK_VALUE), q.new_zeros((b, h, rows))))
    for walk in plan:
        kv = torch.stack([k, v])                    # one message a hop
        for hop in walk:
            if hop.shift:
                kv = collectives.ring_pass(kv, shift=hop.shift)
            for blk in hop.blocks:
                out, lse = fa.flash_forward_with_lse(
                    q[:, parts[blk.q]], kv[0][:, blk.k], kv[1][:, blk.k],
                    causal=blk.causal, window=window, q_offset=blk.q_offset)
                carries[blk.q] = _flash_merge(carries[blk.q], out, lse)
    finished = [_flash_finish(carry) for carry in carries]
    return (torch.cat([o for o, _ in finished], dim=1),
            torch.cat([l for _, l in finished], dim=2))


def _plan_backward(plan, q, k, v, out, lse, g, parts, window: int, n: int):
    """dq, dk, dv of the local shard (f32): per hop ``flash_backward_blocks`` from the
    global lse and Δ; dk/dv accumulate in the travelling message beside their K/V block
    and go home in one ``ring_pass`` at the end of each walk."""
    delta = fa.flash_delta(out, g)
    stats = [(lse[..., p].contiguous(), delta[..., p].contiguous()) for p in parts]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for walk in plan:
        buf = torch.stack([k, v, torch.zeros_like(k), torch.zeros_like(v)])
        travelled = 0
        for hop in walk:
            if hop.shift:
                buf = collectives.ring_pass(buf, shift=hop.shift)
                travelled += hop.shift
            for blk in hop.blocks:
                part = parts[blk.q]
                dq_h, dk_h, dv_h = fa.flash_backward_blocks(
                    q[:, part], buf[0][:, blk.k], buf[1][:, blk.k], g[:, part],
                    *stats[blk.q], causal=blk.causal, window=window, q_offset=blk.q_offset)
                dq[:, part] += dq_h
                buf[2][:, blk.k] += dk_h
                buf[3][:, blk.k] += dv_h
        home = buf[2:]
        if travelled % n:
            home = collectives.ring_pass(home, shift=-travelled)   # straight home
        dk += home[0]
        dv += home[1]
    return dq, dk, dv


def _world() -> tuple[int, int]:
    if not dist.is_initialized():
        raise RuntimeError("ring attention runs over the process group: join it first "
                           "(parallel.mesh.initialize_cluster or mesh.cluster)")
    return dist.get_world_size(), dist.get_rank()


def _ring_shard(x: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    c = x.shape[1] // n
    return x[:, rank * c:(rank + 1) * c].float()


def _zigzag_shard(x: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    c = x.shape[1] // (2 * n)
    late = 2 * n - 1 - rank
    return torch.cat([x[:, rank * c:(rank + 1) * c], x[:, late * c:(late + 1) * c]],
                     dim=1).float()


def _from_zigzag(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """The gathered chunk pairs (zig-zag order along ``dim``) back in sequence order."""
    _, inv = _zigzag_order(n)
    chunks = x.unflatten(dim, (2 * n, x.shape[dim] // (2 * n)))
    index = torch.tensor(inv, device=x.device)
    return chunks.index_select(dim, index).flatten(dim, dim + 1)


class _RingFlash(torch.autograd.Function):
    """The ring-of-flash and the zig-zag ring-of-flash on full ``[B, S, H, D]`` operands:
    the local shard's hops, then the full output (and in backward the full gradients)
    gathered on every rank."""

    @staticmethod
    def forward(ctx, q, k, v, zigzag: bool, causal: bool, window: int):
        n, rank = _world()
        if zigzag:
            c = q.shape[1] // (2 * n)
            plan = _zigzag_plan(n, rank, window, c)
            parts, shard = [slice(0, c), slice(c, 2 * c)], _zigzag_shard
        else:
            plan = _ring_plan(n, rank, causal, window, q.shape[1] // n)
            parts, shard = [_ALL], _ring_shard
        q_r, k_r, v_r = (shard(x, n, rank) for x in (q, k, v))
        out_r, lse_r = _plan_forward(plan, q_r, k_r, v_r, parts, window)
        ctx.save_for_backward(q_r, k_r, v_r, out_r, lse_r)
        ctx.plan, ctx.parts, ctx.shard, ctx.window, ctx.zigzag, ctx.n = (
            plan, parts, shard, window, zigzag, n)
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        out = collectives.all_gather_seq(out_r)
        if zigzag:
            out = _from_zigzag(out, n, 1)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q_r, k_r, v_r, out_r, lse_r = ctx.saved_tensors
        n = ctx.n
        g_r = ctx.shard(g, n, dist.get_rank()).contiguous()   # the kernels' dO operand
        grads = _plan_backward(ctx.plan, q_r, k_r, v_r, out_r, lse_r, g_r, ctx.parts,
                               ctx.window, n)
        full = collectives.all_gather_seq(torch.stack(grads), dim=2)   # one collective
        if ctx.zigzag:
            full = _from_zigzag(full, n, 2)
        return (*(x.to(dtype) for x, dtype in zip(full, ctx.dtypes)), None, None, None)


# =========================================================================================
# Public API
# =========================================================================================


def _check_window(window: int) -> None:
    if window < 0:
        raise ValueError(f"window must be >= 0 (0 = full attention), got {window}")


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = False, window: int = 0) -> torch.Tensor:
    """Ring-of-flash over the process group: ``[B, S, H, D]`` q, k, v, the same on every
    rank, -> the full ``[B, S, H, D]`` attention on every rank, differentiable. The
    sequence is sharded over the ranks, ``S % (ranks·128) == 0``. ``window=W`` is the
    windowed ring (``full_attention``'s band: distance < W), truncated to the band's hop
    reach and bidirectional when non-causal."""
    n, _ = _world()
    s = q.shape[1]
    if s % (n * fa.BLOCK):
        raise ValueError(
            f"ring_flash_attention needs sequence length divisible by "
            f"shards·BLOCK = {n}·{fa.BLOCK}, got {s}")
    _check_window(window)
    return _RingFlash.apply(q, k, v, False, bool(causal), int(window))


def zigzag_ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                window: int = 0) -> torch.Tensor:
    """Zig-zag ring-of-flash over the process group: causal attention with the same live
    work on every rank a hop, ``S % (2·ranks·128) == 0``; ``window=W`` adds the causal
    band, each live past chunk pair masked with its ``q_offset``."""
    n, _ = _world()
    s = q.shape[1]
    if s % (2 * n * fa.BLOCK):
        raise ValueError(
            f"zigzag ring-of-flash needs sequence length divisible by "
            f"2·shards·BLOCK = 2·{n}·{fa.BLOCK}, got {s}")
    _check_window(window)
    return _RingFlash.apply(q, k, v, True, True, int(window))


def make_ring_attention_fn(*, use_flash: bool = False, use_zigzag: bool = False,
                           window: int = 0):
    """A ``(q, k, v, *, causal) -> out`` callable with ``ops.full_attention``'s signature
    over the process group: the ring-of-flash, or with ``use_zigzag`` the zig-zag
    ring-of-flash (causal only); ``window=W`` binds the band into either. The einsum
    schedules (``use_flash=False``) run no kernel and are not ported (ROADMAP A10)."""
    if not use_flash:
        raise ValueError("the einsum ring and zig-zag schedules are not ported (ROADMAP "
                         "A10): pass use_flash=True for the ring-of-flash")

    def attention_fn(q, k, v, *, causal: bool = False):
        if use_zigzag:
            if not causal:
                raise ValueError("the zig-zag schedule is causal-only — use "
                                 "ring_attention for bidirectional attention")
            return zigzag_ring_flash_attention(q, k, v, window=window)
        return ring_flash_attention(q, k, v, causal=causal, window=window)

    return attention_fn
