"""Paged-attention decode: one query token per slot attends through a page table.

Counterpart of the JAX package's ``ops/paged_attention.py``. Its TPU kernel
(``_paged_kernel``) has a hand-written CUDA kernel here (``csrc/paged_attention.cu``,
built by ``ops/_build.py``) and, beside it, the plain PyTorch version of the same function:

- ``paged_attend_reference``: gather each slot's ``[S]`` view through the table and run
  the serving decode's dense attention on it (``decode_attention``, the exact einsum, mask
  and softmax structure of ``models.lm.decode_step_slots``). The plain version and the
  numerics oracle;
- ``paged_attend``: the kernel entry. CPU tensors take ``paged_attend_reference``; CUDA
  tensors launch the kernel or raise. Nothing falls back. Each call adds one to
  ``paged_attend_launches``, so a run can show that it went through the kernel.

On the card each slot's positions are split over several blocks (flash-decoding): the
call launches ``paged_attend_kernel`` on ``split_plan``'s grid and, when it splits,
``paged_attend_combine_kernel``, which merges the chunks' partial softmaxes from a
workspace this wrapper allocates. The plan depends on the shapes and the card's SM count
alone, never on ``t``, so a call makes no device-to-host sync.

Layouts (the TPU kernel's): ``q [B, G, R, D]`` (query heads grouped by their shared KV
head; ``R == 1`` is plain MHA), pools ``[num_pages, page_size, G, D]`` with optional f32
scale pools ``[num_pages, page_size, G]`` (a row's value is ``code · scale``: int8 or fp8
e4m3 codes, or a plain pool), ``table [B, P_max]`` int32, ``t [B]`` int32. Slot ``b``
sees position ``p`` when ``p <= t[b]`` and ``p < seq_len`` (default ``P_max · page_size``;
the engine passes the model's context length) and ``t[b] - p < window`` when a window is
set. The kernel and the plain version take ``seq_len`` alike, so a slot whose ``t`` has run
past the context (a finished slot parks there) sees the same rows on either side.
Every visible position must be mapped (the engine's reservation invariant); unmapped
entries point at the allocator's null page, whose rows the mask hides. The output is
always f32 ``[B, G, R, D]``; a slot with no visible position gets zeros.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import _build
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
    MASK_VALUE,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
           torch.float8_e4m3fn: 3}   # pool dtype codes of the C interface

TILE = 64                  # positions per tile of the kernel (kTile in the source)
MAX_BLOCK_FLOATS = 512     # query rows x D a block of 128 threads owns: one float4 a thread
SPLIT_BLOCKS_PER_SM = 4    # blocks the split aims for on each SM

paged_attend_launches = 0


def reset_launch_counts() -> None:
    global paged_attend_launches
    paged_attend_launches = 0


def launch_counts() -> dict[str, int]:
    return {"paged_attend": paged_attend_launches}


def attention_scale(head_dim: int) -> float:
    """``1/sqrt(D)`` rounded as the JAX package computes it, in f32
    (``1.0 / jnp.sqrt(jnp.asarray(D, jnp.float32))``)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """The serving decode's dense attention: ``q [B, G, R, D]`` at per-slot positions
    ``t [B]`` against per-slot key/value views ``[B, S, G, D]`` (f32, or cast to f32) ->
    f32 ``[B, G, R, D]``. Positions past ``t[b]`` (and outside the window) score
    ``MASK_VALUE``, so their softmax weight is exactly 0 and whatever the view holds
    there (zeros, or another request's rows) changes nothing."""
    s = k.shape[1]
    pos = torch.arange(s, device=q.device)[None]                 # [1, S]
    tb = t.to(torch.int64)[:, None]                              # [B, 1]
    visible = pos <= tb
    if window:
        visible &= tb - pos < window
    visible = visible[:, None, None, :]                          # [B, 1, 1, S]
    scores = torch.einsum("bgrd,bsgd->bgrs", q.float() * attention_scale(q.shape[-1]),
                          k.float())
    weights = torch.softmax(torch.where(visible, scores, MASK_VALUE), dim=-1)
    return torch.einsum("bgrs,bsgd->bgrd", weights, v.float())


def gather_view(pool: torch.Tensor, table: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Each slot's logical view through the table: ``pool[table]`` ->
    ``[B, P_max·ps, ...]`` truncated to ``[B, seq_len, ...]`` (a copy)."""
    b, p_max = table.shape
    view = pool[table.long()]
    return view.reshape((b, p_max * pool.shape[1]) + tuple(pool.shape[2:]))[:, :seq_len]


def paged_attend_reference(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           table: torch.Tensor, t: torch.Tensor, *, seq_len: int,
                           window: int = 0, k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``paged_attend``: gather the table's ``[B, seq_len]`` view (rows
    dequantised by their scales when scale pools are given), then ``decode_attention``."""
    k_read = gather_view(k_pool, table, seq_len).float()
    v_read = gather_view(v_pool, table, seq_len).float()
    if k_scale is not None:
        k_read = k_read * gather_view(k_scale, table, seq_len)[..., None]
        v_read = v_read * gather_view(v_scale, table, seq_len)[..., None]
    return decode_attention(q, k_read, v_read, t, window=window)


def split_plan(b: int, g: int, r: int, d: int, seq_len: int,
               sm_count: int) -> tuple[int, int, int]:
    """The kernel's grid for ``q [b, g, r, d]`` over a ``seq_len``-position view on a card
    of ``sm_count`` SMs: ``(rows_per_block, n_split, split_tiles)``. A block takes up to
    ``rows_per_block`` query rows of one (slot, KV head) (``rows·d <= MAX_BLOCK_FLOATS``,
    at most 32) and one chunk of ``split_tiles`` tiles of ``TILE`` positions; each slot's
    view is cut into ``n_split`` chunks, enough for about ``SPLIT_BLOCKS_PER_SM`` blocks an
    SM, or 1 when the row blocks alone fill the card; no chunk lies wholly past the view.
    ``split_tiles`` is ``ceil(tiles / n_split)``, as the kernel's entry point computes it.
    Shapes only: never ``t``."""
    rows = max(1, min(r, 32, MAX_BLOCK_FLOATS // d))
    blocks = b * g * math.ceil(r / rows)
    tiles = math.ceil(seq_len / TILE)
    want = 1 if blocks >= sm_count else min(
        tiles, math.ceil(SPLIT_BLOCKS_PER_SM * sm_count / blocks))
    n_split = math.ceil(tiles / math.ceil(tiles / want))
    return rows, n_split, math.ceil(tiles / n_split)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _view_len(table: torch.Tensor, k_pool: torch.Tensor, seq_len: int | None) -> int:
    """The positions a slot's view holds: ``seq_len``, or the table's ``P_max · ps``."""
    full = table.shape[1] * k_pool.shape[1]
    if seq_len is None:
        return full
    if not 1 <= seq_len <= full:
        raise ValueError(f"paged_attend: seq_len {seq_len} outside [1, P_max·page_size = "
                         f"{full}]")
    return int(seq_len)


def _check(q, k_pool, v_pool, table, t, k_scale, v_scale) -> torch.device:
    """Raise unless the operands are what the kernel takes: CUDA tensors on one device,
    contiguous, at consistent shapes and dtypes."""
    dev = q.device
    named = {"q": q, "k_pool": k_pool, "v_pool": v_pool, "table": table, "t": t}
    if k_scale is not None or v_scale is not None:
        if k_scale is None or v_scale is None:
            raise ValueError("paged_attend: pass both k_scale and v_scale, or neither")
        named |= {"k_scale": k_scale, "v_scale": v_scale}
    for name, x in named.items():
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"paged_attend: {name} is on {x.device}, expected one CUDA "
                             f"device for every operand (the kernel runs on one device)")
        if not x.is_contiguous():
            raise ValueError(f"paged_attend: {name} must be contiguous")
    if q.dim() != 4:
        raise ValueError(f"paged_attend: expected q [B, G, R, D], got {tuple(q.shape)}")
    b, g, _, d = q.shape
    if d % 4:
        raise ValueError(f"paged_attend: head dim {d} is not a multiple of 4 (the kernel "
                         f"moves float4s)")
    if k_pool.dim() != 4 or k_pool.shape[2:] != (g, d) or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attend: pools must be [num_pages, page_size, {g}, {d}], "
                         f"got {tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    if k_pool.dtype not in _DTYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"paged_attend: pool dtypes {k_pool.dtype}/{v_pool.dtype}; the "
                        f"kernel takes one of {tuple(_DTYPES)} for both")
    if k_scale is not None:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if sc.dtype != torch.float32 or sc.shape != k_pool.shape[:3]:
                raise ValueError(f"paged_attend: {name} must be f32 "
                                 f"{tuple(k_pool.shape[:3])}, got {sc.dtype} "
                                 f"{tuple(sc.shape)}")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != b:
        raise ValueError(f"paged_attend: table must be int32 [{b}, P_max], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if t.dtype != torch.int32 or t.shape != (b,):
        raise ValueError(f"paged_attend: t must be int32 [{b}], got {t.dtype} "
                         f"{tuple(t.shape)}")
    return dev


def paged_attend(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 table: torch.Tensor, t: torch.Tensor, *, window: int = 0,
                 k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None,
                 seq_len: int | None = None) -> torch.Tensor:
    """Fused page-walk attention: f32 ``[B, G, R, D]`` over each slot's first
    ``seq_len`` positions (default ``P_max · page_size``; the engine passes the model's
    ``seq_len``, so the view has the contiguous cache's shape). On CUDA tensors, one
    launch of the kernel, which walks only slot ``b``'s visible positions (inside the
    window, up to ``min(t[b], seq_len - 1)``) without materialising the gathered view,
    split over ``split_plan``'s blocks and merged by the combine kernel (the call counts
    once). On CPU tensors, the plain version."""
    global paged_attend_launches
    seq_len = _view_len(table, k_pool, seq_len)
    tensors = [x for x in (q, k_pool, v_pool, table, t, k_scale, v_scale) if x is not None]
    if all(x.device.type == "cpu" for x in tensors):
        return paged_attend_reference(q, k_pool, v_pool, table, t, seq_len=seq_len,
                                      window=window, k_scale=k_scale, v_scale=v_scale)
    q = q.float().contiguous()
    dev = _check(q, k_pool, v_pool, table, t, k_scale, v_scale)
    b, g, r, d = q.shape
    out = torch.empty((b, g, r, d), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    rows, n_split, _ = split_plan(b, g, r, d, seq_len, _sm_count(dev.index))
    workspace = (torch.empty(n_split * b * g * r * (d + 2), dtype=torch.float32, device=dev)
                 if n_split > 1 else None)
    scales = ((k_scale.data_ptr(), v_scale.data_ptr()) if k_scale is not None
              else (None, None))
    _build.launch("paged_attention", "paged_attend", dev, "paged_attend",
                  _DTYPES[k_pool.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  *scales, table.data_ptr(), t.data_ptr(), out.data_ptr(),
                  None if workspace is None else workspace.data_ptr(), b, g, r, d,
                  k_pool.shape[1], table.shape[1], seq_len, int(window), rows, n_split,
                  attention_scale(d))
    paged_attend_launches += 1
    return out
