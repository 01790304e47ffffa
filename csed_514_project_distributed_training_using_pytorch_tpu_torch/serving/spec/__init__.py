"""Speculative decoding: the drafters of the engine's propose -> verify -> accept loop.

Counterpart of the JAX package's ``serving/spec/``. A ``Drafter`` guesses the next ``k``
tokens of each in-flight slot; the engine scores every guess in one verify forward
(``models.lm.verify_chunk``, or ``paged_verify_chunk`` through the page table) and keeps
the longest correct prefix plus a correction: 1..k+1 tokens per pass over the cache,
token-identical to sequential decode under greedy acceptance, exact rejection sampling at
temperature > 0.

- ``drafter``: the interface, ``NGramDrafter`` (host numpy n-gram / prompt-lookup
  self-speculation) and ``greedy_chunk_plan``, the one owner of the chunk-plan rule;
- ``draft_lm``: ``DraftLMDrafter``, a small ``TransformerLM`` sharing the target's
  tokenizer, with its own slot cache on the engine's device.

Imports are lazy (PEP 562), as in the JAX package: importing this package loads neither
drafter module, and ``drafter`` itself is numpy only.
"""

_EXPORTS = {
    "Drafter": "drafter",
    "NGramDrafter": "drafter",
    "greedy_chunk_plan": "drafter",
    "DraftLMDrafter": "draft_lm",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    value = getattr(mod, name)
    globals()[name] = value          # later lookups skip __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
