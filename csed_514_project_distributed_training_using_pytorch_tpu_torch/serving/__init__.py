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
  flags (the replica process and its wire protocol wait with ROADMAP A11);
- ``shard``: the serve mesh, one replica's engine over ``tp * dp`` ranks
  (``build_serve_mesh``, the engine's ``mesh=``, ``MeshLeader``/``follow``).

The load generator is ``<port>.serve_loadgen`` and the speculative A/B ``<port>.bench_spec_ab``.

The names the JAX package's ``serving/__init__.py`` exports are exported here, except the
fleet's ``Router``/``RouterCompletion`` (ROADMAP A11).
"""

from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.engine import (
    Completion,
    ContinuousBatchingEngine,
    KVPagesExhausted,
    filter_logits_per_slot,
    greedy_chunk_plan,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.pagepool import (
    PagePool,
    PagePoolExhausted,
    pages_for,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.prefix_cache import (
    PrefixCache,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
    Parked,
    QueueClosed,
    QueueFull,
    QuotaExceeded,
    Request,
    RequestQueue,
    SamplingParams,
    ServerStopped,
    Shed,
    TenantSpec,
    TenantTable,
    parse_tenants,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.server import (
    Server,
)

__all__ = ["Completion", "ContinuousBatchingEngine", "KVPagesExhausted", "PagePool",
           "PagePoolExhausted", "Parked", "PrefixCache", "QueueClosed", "QueueFull",
           "QuotaExceeded", "Request", "RequestQueue", "SamplingParams", "Server",
           "ServerStopped", "Shed", "TenantSpec", "TenantTable", "filter_logits_per_slot",
           "greedy_chunk_plan", "pages_for", "parse_tenants"]
