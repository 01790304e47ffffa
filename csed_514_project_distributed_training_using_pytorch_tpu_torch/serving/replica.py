"""The engine and server from the load generator's flags.

Counterpart of ``build_engine_server`` in the JAX package's ``serving/replica.py``: the one
place that turns the model, engine and server flags (``<port>.serve_loadgen`` declares them
as the JAX package's ``tools/serve_loadgen.py`` does) into a ``ContinuousBatchingEngine``
and a ``Server`` with the same checkpoint fallback, draft-LM recipe and warm-up recipe.

``--shard tp=T,dp=D`` builds the engine on the serve mesh (``serving/shard.py``) over the
process group, which must hold ``T * D`` ranks (``train.launch``): every rank builds the
engine and warms it up alike, rank 0 gets the ``Server`` over a ``shard.MeshLeader`` and
every other rank ``None`` (it runs ``shard.follow``). ``--telemetry PATH`` is the server's
JSONL stream.

Only ``build_engine_server`` is ported. The replica process, its line protocol and the
fleet that spawns it wait with ROADMAP A11 (the router); so does ``trace=``. The
prefill/decode tiers (``--tiers``, ``--tier``) raise naming A11.
"""

from __future__ import annotations

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import SLOSpec
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.engine import (
    ContinuousBatchingEngine,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    shard as shard_mod,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
    Request,
    parse_tenants,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.server import (
    Server,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import checkpoint


def refuse_unported(args) -> None:
    """The flags of the fleet's replica that the port does not serve yet."""
    if getattr(args, "tiers", "") or getattr(args, "tier", "unified") != "unified":
        raise ValueError("prefill/decode tiers are not ported yet (ROADMAP A11: "
                         "serving/tiers.py and the replica wire)")


def build_draft_model(args) -> lm.TransformerLM:
    """The draft LM's recipe: ``--draft-layers`` (1), ``--draft-embed-dim`` (0 = half the
    target's, at least its head count) and ``--draft-heads`` (0 = the target's), the
    target's tokenizer, KV heads, window and RoPE."""
    return lm.TransformerLM(
        vocab_size=args.num_levels + 1, seq_len=args.seq_len,
        embed_dim=args.draft_embed_dim or max(args.embed_dim // 2, args.num_heads),
        num_layers=args.draft_layers, num_heads=args.draft_heads or args.num_heads,
        num_kv_heads=args.kv_heads or None, attention_window=args.attention_window,
        rope=args.rope)


def build_engine_server(args, trace: object = None):
    """The engine and the server from an argparse namespace: the target model at the
    model flags, its parameters from ``--checkpoint`` (a train state or a params-only
    file, ``utils.checkpoint.load_params_or_state``) or a seeded init, the drafter for
    ``--spec`` (``"draft-lm"`` builds ``build_draft_model`` from ``--draft-checkpoint`` or
    a seeded init at ``seed + 1``), the engine on ``args.device``, the ``--warmup`` recipe
    (every prefill chunk size, the prefix-cache hit path, a promptless request; then the
    counters reset), and the ``Server`` with ``--telemetry``. Returns ``(engine,
    server)``; the server is not started. Under ``--shard`` with more than one rank the
    server is rank 0's, over a ``shard.MeshLeader``, and ``None`` on the other ranks."""
    if trace is not None or getattr(args, "trace", ""):
        raise ValueError("distributed tracing is not ported yet (ROADMAP A11: "
                         "utils/trace.py)")
    refuse_unported(args)
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.spec.draft_lm import (
        DraftLMDrafter,
    )

    model = lm.TransformerLM(
        vocab_size=args.num_levels + 1, seq_len=args.seq_len, embed_dim=args.embed_dim,
        num_layers=args.num_layers, num_heads=args.num_heads,
        num_kv_heads=args.kv_heads or None, attention_window=args.attention_window,
        rope=args.rope)
    params = model.init(torch.Generator().manual_seed(args.seed))
    if args.checkpoint:
        params = checkpoint.load_params_or_state(args.checkpoint, params)
    chunk_sizes = tuple(int(x) for x in args.prefill_chunks.split(",") if x)
    tp, dp = shard_mod.parse_shard_spec(getattr(args, "shard", ""))
    mesh = shard_mod.build_serve_mesh(tp, dp) if tp * dp > 1 else None
    spec = getattr(args, "spec", "off")
    drafter = None
    if spec == "draft-lm":
        draft_model = build_draft_model(args)
        draft_params = draft_model.init(torch.Generator().manual_seed(args.seed + 1))
        if args.draft_checkpoint:
            draft_params = checkpoint.load_params_or_state(args.draft_checkpoint,
                                                           draft_params)
        drafter = DraftLMDrafter(draft_model, draft_params,
                                 chunk_sizes=chunk_sizes or lm.PREFILL_CHUNK_SIZES)
    engine = ContinuousBatchingEngine(
        model, params, num_slots=args.num_slots, seed=args.seed,
        prefill_chunk_sizes=chunk_sizes, prefill_chunk_budget=args.prefill_budget,
        prefix_cache_entries=args.prefix_cache,
        prefix_cache_bytes=getattr(args, "prefix_cache_bytes", 0) or None,
        kv_dtype=getattr(args, "kv_dtype", "model"),
        quant_policy=getattr(args, "quant_policy", "off"),
        kv_layout=getattr(args, "kv_layout", "contiguous"),
        page_size=getattr(args, "page_size", 64),
        num_pages=getattr(args, "num_pages", 0) or None,
        spec=spec, spec_k=getattr(args, "spec_k", 4), drafter=drafter, mesh=mesh,
        device=getattr(args, "device", "cuda"))
    if args.warmup:
        # every chunk size, the prefix cache's hit path and a promptless request run once
        # before traffic, then the ledger is wiped: the percentiles measure the schedule
        rng = np.random.default_rng(args.seed + 17)
        for _ in range(args.warmup):
            for size in engine.prefill_chunk_sizes:
                wp = rng.integers(0, model.vocab_size - 1,
                                  size=min(size, args.seq_len - 1)).astype(np.int32)
                engine.run([Request(prompt=wp, max_new_tokens=1)])
                if engine.prefix_cache is not None:
                    engine.run([Request(prompt=wp, max_new_tokens=1)])
            engine.run([Request(prompt=np.zeros(0, np.int32), max_new_tokens=2)])
        engine.reset_stats()
    if mesh is not None and mesh.rank != 0:
        return engine, None
    front = shard_mod.MeshLeader(engine) if mesh is not None else engine
    server = Server(front, max_pending=args.max_pending,
                    default_timeout_s=args.timeout_s or None,
                    telemetry=getattr(args, "telemetry", "") or None,
                    slo=SLOSpec.parse(getattr(args, "slo", "")),
                    tenants=parse_tenants(getattr(args, "tenants", "")))
    return engine, server


__all__ = ["build_draft_model", "build_engine_server", "refuse_unported"]
