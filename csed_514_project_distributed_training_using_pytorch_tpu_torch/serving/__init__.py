"""Serving: the continuous-batching engine over the LM's contiguous or paged KV cache.

- ``engine``: ``ContinuousBatchingEngine``, one decode step over a fixed ``[num_slots]``
  batch with chunked prefill, quantized KV and weights (``kv_dtype``, ``quant_policy``),
  the prefix cache, park/resume and speculative decoding (``spec``/``spec_k``/``drafter``);
- ``spec``: speculative decoding's drafters (``Drafter``, host n-gram self-speculation
  ``NGramDrafter``, the small-model ``DraftLMDrafter``): the engine's propose -> verify ->
  accept loop emits up to ``spec_k + 1`` tokens per pass over the cache, token-identical
  under greedy;
- ``prefix_cache``: the host-side LRU of prefilled rows keyed by prompt tokens;
- ``pagepool``: the paged layout's allocator;
- ``scheduler``: the request types and ``RequestQueue``, the thread-safe multi-tenant
  queue (quotas, weighted-fair and priority dequeue, shedding);
- ``server``: ``Server``, the in-process front end (``submit() -> Future``, a background
  loop that owns the engine, drain, expiry, tenant caps and priority preemption);
- ``replica``: ``build_engine_server``, the engine and server from the load generator's
  flags, and the replica process behind the fleet's line protocol (``python -m
  <port>.serving.replica``);
- ``wire``: the protocol's framing (length + CRC frames, negotiated), decoders and the
  jittered backoff;
- ``router``: ``Router``, the fleet's front door over N replica processes (prefix
  affinity, at-least-once redispatch, backpressure, restarts, straggler ejection,
  hedging, elasticity, rolling and canary reloads, tenant budgets, SLO windows);
- ``tiers``: the prefill/decode roles and the replica-to-replica KV handoff's codec and
  wire;
- ``autoscaler``: ``AutoscalePolicy`` and ``FleetAutoscaler``, the hysteresis that drives
  the router's scale-up and scale-down from its snapshots;
- ``shard``: the serve mesh, one replica's engine over ``tp * dp`` ranks
  (``build_serve_mesh``, the engine's ``mesh=``, ``MeshLeader``/``follow``).

The load generator is ``<port>.serve_loadgen`` and the speculative A/B ``<port>.bench_spec_ab``.

The names the JAX package's ``serving/__init__.py`` exports are exported here. They load
on first use (PEP 562), so a process that imports only ``serving.router``,
``serving.wire``, ``serving.scheduler`` or an ``--echo`` replica imports neither the
engine nor ``torch``.
"""

import importlib

_EXPORTS = {
    "engine": ("Completion", "ContinuousBatchingEngine", "KVPagesExhausted",
               "filter_logits_per_slot", "greedy_chunk_plan"),
    "pagepool": ("PagePool", "PagePoolExhausted", "pages_for"),
    "prefix_cache": ("PrefixCache",),
    "router": ("Router", "RouterCompletion"),
    "scheduler": ("Parked", "QueueClosed", "QueueFull", "QuotaExceeded", "Request",
                  "RequestQueue", "SamplingParams", "ServerStopped", "Shed", "TenantSpec",
                  "TenantTable", "parse_tenants"),
    "server": ("Server",),
}
_HOME = {name: module for module, names in _EXPORTS.items() for name in names}

__all__ = sorted(_HOME)


def __getattr__(name: str):
    module = _HOME.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_HOME))
