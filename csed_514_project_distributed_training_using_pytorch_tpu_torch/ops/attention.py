"""Scaled dot-product attention, the dense single-device formulation.

Counterpart of the JAX package's ``ops/attention.py``: the transformer family's default
attention core and the numerics oracle of the flash kernels. In the JAX package this is
XLA; here it is plain PyTorch (two matrix products and a softmax), not a hand kernel. The
hand kernels are in ``ops/flash_attention.py``.
"""

from __future__ import annotations

import functools
import math

import torch

# Large-but-finite mask value: keeps ``exp`` exactly 0 for masked scores without the NaN
# hazards of -inf arithmetic in the online-softmax recurrence.
MASK_VALUE = -1e30


def validate_window(window: int | None) -> None:
    """Shared sliding-window validation (one owner for the error message)."""
    if window is not None and window < 1:
        raise ValueError(f"attention window must be >= 1, got {window}")


def windowed_attention_fn(window: int):
    """The dense core with a fixed sliding window, in the pluggable
    ``(q, k, v, *, causal) -> out`` ``attention_fn`` contract (``--attention-window``)."""
    validate_window(window)
    return functools.partial(full_attention, window=window)


def visibility_mask(s_q: int, s_k: int, *, causal: bool, window: int | None,
                    device=None, k_offset: int = 0, q_offset: int = 0) -> torch.Tensor:
    """``[s_q, s_k]`` bool mask of the visible (query, key) pairs: causal keeps ``j <= i``,
    the window keeps ``|i - j| < window``. The keys sit at positions ``k_offset +
    arange(s_k)`` (a key tile of a longer sequence), the queries at ``q_offset +
    arange(s_q)`` (a ring hop's queries, ``q_offset`` positions past the keys' origin; it
    may be negative)."""
    i = torch.arange(s_q, device=device)[:, None] + q_offset
    j = torch.arange(s_k, device=device)[None, :] + k_offset
    mask = torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    if causal:
        mask &= i >= j
    if window:
        mask &= (i - j < window) & (j - i < window)
    return mask


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False, window: int | None = None) -> torch.Tensor:
    """Dense softmax attention. ``q, k, v: [B, S, H, D]`` → ``[B, S, H, D]``.

    ``causal=True`` masks key positions after the query position; ``window=W`` keeps keys
    within distance < W (causal: ``(i-W, i]``; bidirectional: ``|i-j| < W``). Scores and the
    softmax run in float32; the output is cast back to ``q.dtype``.
    """
    validate_window(window)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal or window is not None:
        mask = visibility_mask(scores.shape[-2], scores.shape[-1], causal=causal,
                               window=window, device=scores.device)
        scores = torch.where(mask, scores, MASK_VALUE)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    return out.to(q.dtype)
