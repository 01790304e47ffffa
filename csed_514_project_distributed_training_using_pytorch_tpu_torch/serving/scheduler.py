"""The serving engine's request types: ``SamplingParams`` and ``Request``.

Copied from the JAX package's ``serving/scheduler.py`` (which imports no JAX; the port
keeps its own copy). The rest of that module — ``RequestQueue``, tenant quotas, shedding,
the ``Parked`` preemption record — is not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy. ``temperature <= 0`` decodes greedily; ``top_k = 0``
    / ``top_p = 1.0`` disable those filters (applied after temperature scaling, top-k
    first, as the JAX package's ``filter_logits`` composes them)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def validate(self, vocab_size: int) -> None:
        if not 0 <= self.top_k <= vocab_size:
            raise ValueError(f"top_k {self.top_k} outside [0, {vocab_size}]")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p {self.top_p} outside (0, 1]")


@dataclasses.dataclass
class Request:
    """One decode request. ``prompt`` is a ``[P]`` int32 slice of the TARGETS stream
    (output positions ``0..P-1`` are forced to it, its K/V populating the cache);
    ``max_new_tokens`` bounds the sampled suffix. ``deadline_s``/``arrival_s`` are
    ``time.monotonic()`` stamps (absolute), both optional. ``trace_id``, ``tenant``,
    ``priority`` and ``preemptible`` are the JAX package's service-class fields, kept so
    that a request means the same in both packages; the port's engine reads only
    ``priority`` (the prefill order)."""

    prompt: np.ndarray
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    request_id: int = 0
    deadline_s: float | None = None
    arrival_s: float | None = None
    trace_id: str | None = None
    tenant: str = "default"
    priority: int = 0
    preemptible: bool = False
