"""Drafters: cheap token proposals for the engine's speculative decode loop.

Counterpart of the JAX package's ``serving/spec/drafter.py``. A drafter guesses the next
``k`` tokens of each in-flight slot; the engine's verify pass (``models.lm.verify_chunk``)
scores all guesses in one ``[B, k+1]`` forward and accepts the longest correct prefix plus
a correction token. The verify pass costs the same whether a guess is real or right, so a
drafter's only job is to maximize the accepted prefix.

Drafters are deterministic: each proposal is a function of the slot's emitted stream
(argmax for the draft LM, exact lookup for the n-gram). The draft distribution is then a
point mass, which is what makes the engine's rejection rule exact (accept ``d`` with
probability ``p(d)``, else resample from ``p`` with ``d`` masked) and greedy speculation
token-identical to sequential decode (an accepted draft is the target's argmax).

This module is numpy only; the torch draft-LM drafter lives in ``draft_lm.py``.
"""

from __future__ import annotations

import numpy as np

_EMPTY = np.zeros((0,), np.int32)


def greedy_chunk_plan(sizes: tuple[int, ...], start: int,
                      end: int) -> list[tuple[int, int, int]]:
    """``(start, length, chunk_size)`` triples covering ``[start, end)``: greedily the
    biggest configured size that fits, then the smallest size PADDED for the tail. The one
    owner of the rule: ``ContinuousBatchingEngine.plan_prefill`` and the draft LM's prompt
    install both use it, so a single configured size ``c`` costs exactly
    ``ceil((end - start) / c)`` invocations on both caches."""
    plan = []
    while start < end:
        rem = end - start
        fit = [c for c in sizes if c <= rem]
        size = max(fit) if fit else sizes[0]
        length = min(rem, size)
        plan.append((start, length, size))
        start += length
    return plan


class Drafter:
    """The drafter interface. ``propose_batch`` is the engine's per-tick call; the default
    fans out to per-slot ``propose``, which host-side drafters implement. The lifecycle
    hooks let a stateful drafter (the draft LM's own KV cache) follow the engine's slot
    churn; the base class ignores them, so a stateless drafter is one ``propose`` method.

    ``tokens`` arguments are the slot's whole emitted stream so far (its prompt included)
    as a list of ints. The stream holds accepted tokens only, so a drafter never sees, and
    never undoes, a rejected guess."""

    name = "none"

    def bind(self, *, num_slots: int, vocab_size: int, seq_len: int,
             device=None) -> None:
        """Called once by the engine before serving: check compatibility and size any
        per-slot state. ``device`` is the engine's (``torch.device``); host drafters
        ignore it."""

    def on_activate(self, slot: int, tokens: list[int]) -> None:
        """``slot`` enters the decode batch with ``tokens`` already emitted (its prompt;
        empty for a promptless request)."""

    def on_release(self, slot: int) -> None:
        """``slot``'s occupant finished, expired or was parked; the slot may be recycled.
        Called for every release, occupants that never activated included (a mid-prefill
        expiry), so it must tolerate unknown slots."""

    def propose(self, slot: int, tokens: list[int], last: int, k: int) -> np.ndarray:
        """Up to ``k`` draft tokens continuing ``tokens`` (``last`` is the final accepted
        token: ``tokens[-1]``, or BOS for an empty stream). Fewer, or none, are legal."""
        raise NotImplementedError

    def propose_batch(self, entries: list[tuple[int, list[int], int]],
                      k: int) -> list[np.ndarray]:
        """Proposals for every active slot: ``entries`` is ``[(slot, tokens, last),
        ...]``; returns one array (possibly empty) per entry, in order. Batched drafters
        (the draft LM) override it."""
        return [self.propose(slot, tokens, last, k) for slot, tokens, last in entries]


class NGramDrafter(Drafter):
    """Host-side n-gram / prompt-lookup self-speculation.

    The guess: the stream's trailing n-gram occurred before, so propose the tokens that
    followed its most recent earlier occurrence. No model and no device work, and the win
    is where serving traffic repeats itself: chat turns that resubmit their context,
    shared system prompts, and the long constant background runs of a digit image. Tries
    the longest suffix first (``max_n`` down to ``min_n``); no match proposes nothing, and
    that slot's verify row degenerates to plain decode."""

    name = "ngram"

    def __init__(self, *, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got min_n={min_n} max_n={max_n}")
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def propose(self, slot: int, tokens: list[int], last: int, k: int) -> np.ndarray:
        hist = np.asarray(tokens, np.int32)
        m = len(hist)
        for n in range(min(self.max_n, m - 1), self.min_n - 1, -1):
            pat = hist[m - n:]
            # windows starting at 0 .. m-n-1: the suffix itself (at m-n) is left out
            windows = np.lib.stride_tricks.sliding_window_view(hist, n)[:-1]
            hits = np.flatnonzero((windows == pat).all(axis=1))
            if hits.size:
                i = int(hits[-1])                 # the most recent occurrence
                return hist[i + n:i + n + k].astype(np.int32).copy()
        return _EMPTY


__all__ = ["Drafter", "NGramDrafter", "greedy_chunk_plan"]
