"""Load generator for the serving stack: open loop, closed loop and chat sessions.

The in-process path of the JAX package's ``tools/serve_loadgen.py``: one
``ContinuousBatchingEngine`` behind one ``serving.Server``, built by
``serving.replica.build_engine_server`` from the same model, engine and server flags, and
driven by a reproducible synthetic workload:

- **open loop** (``--mode open``): requests arrive on a Poisson process at ``--rate``
  req/s (``--arrival-pattern burst``: ``--burst-size`` back to back, then
  ``--burst-idle-s`` of silence) whatever the completions: the latency-under-load probe;
- **closed loop** (``--mode closed``): ``--concurrency`` clients each keep one request in
  flight: the throughput probe;
- **chat** (``--scenario chat``): ``--sessions`` concurrent multi-turn sessions, each turn
  resubmitting the prior context plus the model's reply plus ``--turn-user-tokens`` fresh
  tokens: the traffic prefix reuse and n-gram speculation exist for.

The prompt and length mix is drawn per request from ``--prompt-lens`` and ``[1,
--max-new-tokens]`` under a seeded RNG, so an A-vs-B pair of runs offers byte-identical
traffic (the chat scenario too, under greedy decoding). ``--summary-json PATH`` writes the
run's summary in the JAX tool's single-server keys, so an A-vs-B pair reads the same in
both packages. The keys that name XLA compilations (``decode_compilations``,
``prefill_compilations``, ``verify_compilations``) are None: the port compiles nothing
while it serves. ``prefill_wall_s`` and ``prefill_tokens_per_s`` are None too: the port's
engine puts no device fence around a prefill chunk, so it has no honest host wall for one.

The engine runs on ``--device`` (``cuda`` by default; ``--device cpu`` must be asked for).
``--telemetry PATH`` writes the server's JSONL stream (``tools/telemetry_report.py``
renders it). ``--shard tp=T,dp=D`` serves on the serve mesh (``serving/shard.py``): run it
as a world of ``T * D`` ranks through ``train.launch``. Every rank builds and warms the
engine; rank 0 runs the server, the workload and the clock, the other ranks replay its
engine calls (``serving.shard.follow``); then every rank gathers the byte accounting and
the replica check compares the ranks' ledgers. Only rank 0 prints. On one card the ranks
time-slice it over gloo: a correctness run, not a speed.
``--trace-dir DIR`` traces every request: this process is the trace's origin and writes
``DIR/loadgen.jsonl`` (one ``client`` span a request), the server writes
``DIR/server.jsonl`` (the engine's spans and ``resolve``); the summary gains the critical
path (``trace``), and ``python -m <port>.trace_report DIR`` renders the trees.
Not ported, each refused naming its ROADMAP item: the fleet (``--replicas`` and every
router, affinity, echo, elasticity, gray-failure and framed-wire flag), ``--tiers`` and
``--snapshot-interval-s`` (A11).

Usage::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.serve_loadgen \\
        --requests 32 --mode open --rate 16 --num-slots 8 --summary-json serve.json
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.serve_loadgen \\
        --scenario chat --sessions 6 --turns 3 --spec ngram --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import threading
import time

import numpy as np

# Flags of the JAX tool that the port refuses, by destination, with the ROADMAP item that
# holds them. A flag counts as given when its value differs from its default.
_FLEET = "the serving fleet's router is not ported yet (ROADMAP A11: serving/router.py; " \
         "the replica process and its wire are: <port>.serving.replica)"
UNPORTED_FLAGS = {
    "replicas": _FLEET, "affinity": _FLEET, "echo": _FLEET, "echo_delay_s": _FLEET,
    "replica_platform": _FLEET, "router_max_pending": _FLEET, "heartbeat_dir": _FLEET,
    "heartbeat_timeout_s": _FLEET, "max_restarts": _FLEET, "backoff_s": _FLEET,
    "autoscale": _FLEET, "min_replicas": _FLEET, "max_replicas": _FLEET,
    "scale_up_age_s": _FLEET, "scale_up_util": _FLEET, "scale_down_util": _FLEET,
    "scale_sustain_up": _FLEET, "scale_sustain_down": _FLEET, "scale_cooldown_s": _FLEET,
    "scale_slo_floor": _FLEET, "scale_slo_tenant": _FLEET,
    "scale_slo_min_requests": _FLEET, "warm_prefixes": _FLEET, "drain_timeout_s": _FLEET,
    "straggler_k": _FLEET, "eject_min_samples": _FLEET, "eject_cooldown_s": _FLEET,
    "hedge": _FLEET, "hedge_after_s": _FLEET, "hedge_quantile": _FLEET,
    "hedge_factor": _FLEET, "chaos": _FLEET, "chaos_seed": _FLEET, "framed_wire": _FLEET,
    "tiers": "prefill/decode tiers are not ported yet (ROADMAP A11: serving/tiers.py)",
    "snapshot_interval_s": "fleet snapshots are not ported yet (ROADMAP A11: "
                           "serving/router.py)",
}


def percentiles(xs, qs=(50, 95, 99)) -> dict | None:
    """Nearest-rank percentiles of the non-None values, as ``{"p50": ..., ...}`` (the
    JAX package's ``utils/jsonl.py::percentiles``; a non-finite value reads None). None
    when no values survive."""
    xs = sorted(x for x in xs if x is not None)
    if not xs:
        return None
    out = {}
    for q in qs:
        x = float(xs[max(0, math.ceil(q / 100 * len(xs)) - 1)])
        out[f"p{q}"] = x if math.isfinite(x) else None
    return out


def prompt_len_mix(args) -> list[int]:
    """The prompt-length mixture: ``--prompt-lens`` verbatim, or the ``long`` preset,
    seq_len/2 .. 3·seq_len/4 (the prompt-heavy regime where prefill dominates TTFT)."""
    if args.prompt_dist == "long":
        s = args.seq_len
        lens = sorted({max(1, s // 2), max(1, (5 * s) // 8), max(1, min(s - 2, (3 * s) // 4))})
    else:
        lens = [int(x) for x in args.prompt_lens.split(",") if x != ""]
    bad = [n for n in lens if not 0 <= n < args.seq_len]
    if bad:
        raise SystemExit(f"prompt lengths outside [0, seq_len): {bad}")
    return lens


def tenant_shares(text: str) -> dict[str, float]:
    """The load generator's reading of the ``--tenants`` grammar: tenant names and their
    ``share=`` traffic fractions (the scheduler ignores ``share``), normalized to sum to 1.
    Tenants without a share split the remainder equally."""
    shares: dict[str, float | None] = {}
    for chunk in (text or "").split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        name, _, body = chunk.partition(":")
        share = None
        for part in body.split(","):
            key, _, value = part.strip().partition("=")
            if key.strip() == "share":
                share = float(value)
        shares[name.strip()] = share
    named = sum(v for v in shares.values() if v is not None)
    rest = [k for k, v in shares.items() if v is None]
    for k in rest:
        shares[k] = max(0.0, 1.0 - named) / len(rest)
    total = sum(shares.values()) or 1.0
    return {k: v / total for k, v in shares.items()}


def make_workload(args, vocab_size):
    """The seeded request mix: ``[(prompt, max_new, sampling, tenant), ...]``.
    ``--shared-prefix-len N`` gives every prompt one common first-N-token prefix
    (truncated for shorter ones); with ``--tenants`` each request draws its tenant from
    the ``share=`` mix under the same seed."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        SamplingParams,
    )

    rng = np.random.default_rng(args.seed)
    lens = prompt_len_mix(args)
    shared = rng.integers(0, vocab_size - 1,
                          size=max(args.shared_prefix_len, 0)).astype(np.int32)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p)
    shares = tenant_shares(args.tenants) if getattr(args, "tenants", "") else {"default": 1.0}
    names = sorted(shares)
    probs = np.asarray([shares[n] for n in names])
    specs = []
    for _ in range(args.requests):
        p = int(rng.choice(lens))
        prompt = rng.integers(0, vocab_size - 1, size=p).astype(np.int32)
        k = min(len(shared), p)
        if k:
            prompt[:k] = shared[:k]
        new = int(rng.integers(1, args.max_new_tokens + 1))
        tenant = str(rng.choice(names, p=probs))
        specs.append((prompt, new, sampling, tenant))
    return specs


def new_rejections() -> dict:
    return {"rejected": 0, "quota_rejected": 0, "shed_submits": 0, "by_tenant": {}}


def _tally_refusal(rejections: dict, tenant: str, exc, lock) -> None:
    """The three-way refusal ledger: ``QueueFull`` (capacity backpressure),
    ``QuotaExceeded`` (over the tenant's contract), ``Shed`` (priority shedding), in
    total and per tenant."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        QueueFull,
        QuotaExceeded,
    )

    key = ("rejected" if isinstance(exc, QueueFull)
           else "quota_rejected" if isinstance(exc, QuotaExceeded) else "shed_submits")
    with lock:
        rejections[key] += 1
        rejections["by_tenant"].setdefault(
            tenant, {"rejected": 0, "quota_rejected": 0, "shed_submits": 0})[key] += 1


def _submit_counted(server, spec, futures, rejections, lock):
    """One submit through the refusal ledger; returns the future or None."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        QueueFull,
        QuotaExceeded,
        Shed,
    )

    prompt, new, sampling, tenant = spec
    try:
        fut = server.submit(prompt, max_new_tokens=new, sampling=sampling,
                            **({"tenant": tenant} if tenant != "default" else {}))
    except (QueueFull, QuotaExceeded, Shed) as e:
        _tally_refusal(rejections, tenant, e, lock)
        return None
    with lock:
        futures.append(fut)
    return fut


def run_open_loop(server, specs, rate, rng, *, pattern="poisson", burst_size=8,
                  burst_idle_s=1.0, burst_tenant=""):
    """Open-loop arrivals; returns ``(futures, rejections)``. ``pattern="poisson"`` is the
    memoryless stream at ``rate`` req/s; ``"burst"`` sends ``burst_size`` requests back
    to back, then ``burst_idle_s`` of silence. With several tenants each has its own
    arrival stream at its share of ``rate``; ``burst_tenant`` bursts that tenant's stream
    alone while the others stay Poisson."""
    futures: list = []
    rejections = new_rejections()
    tenants = sorted({s[3] for s in specs})
    if len(tenants) <= 1 and not burst_tenant:
        lone = threading.Lock()
        for i, spec in enumerate(specs):
            if pattern == "burst":
                if i and i % burst_size == 0:
                    time.sleep(burst_idle_s)
            else:
                time.sleep(float(rng.exponential(1.0 / rate)))
            _submit_counted(server, spec, futures, rejections, lone)
        return futures, rejections
    lock = threading.Lock()
    by_tenant = {t: [s for s in specs if s[3] == t] for t in tenants}

    def stream(tenant: str, tspecs, seed: int):
        trng = np.random.default_rng(seed)
        trate = max(rate * len(tspecs) / max(len(specs), 1), 1e-6)
        bursty = tenant == burst_tenant or (pattern == "burst" and not burst_tenant)
        for i, spec in enumerate(tspecs):
            if bursty:
                if i and i % burst_size == 0:
                    time.sleep(burst_idle_s)
            else:
                time.sleep(float(trng.exponential(1.0 / trate)))
            _submit_counted(server, spec, futures, rejections, lock)

    threads = [threading.Thread(target=stream, args=(t, by_tenant[t], i + 11),
                                name=f"loadgen-{t}") for i, t in enumerate(tenants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return futures, rejections


def run_closed_loop(server, specs, concurrency):
    """``concurrency`` clients, each with one request in flight; returns ``(futures,
    rejections)``. A refused submit sheds the request and the client moves on."""
    it = iter(specs)
    lock = threading.Lock()
    futures: list = []
    rejections = new_rejections()

    def client():
        while True:
            with lock:
                spec = next(it, None)
            if spec is None:
                return
            fut = _submit_counted(server, spec, futures, rejections, lock)
            if fut is not None:
                fut.result()                    # keep exactly one in flight

    threads = [threading.Thread(target=client, name=f"loadgen-{i}")
               for i in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return futures, rejections


def run_chat(front, args, vocab_size):
    """``--sessions`` concurrent multi-turn sessions against ``front`` (anything with
    ``Server.submit``). Each session keeps one request in flight: turn t's prompt is turn
    t-1's whole emitted stream (context plus reply) plus ``--turn-user-tokens`` fresh
    tokens. Under greedy decoding the whole workload is a function of the parameters, so
    an A-vs-B pair of runs offers byte-identical traffic.

    Returns ``(completions, rejections, sessions_done)``: a session is done when it ran
    all its turns or reached the seq_len ceiling. With ``--tenants`` each session draws
    its tenant from the ``share=`` mix. A session that dies raises here, after the
    others have ended."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
        QueueFull,
        QuotaExceeded,
        SamplingParams,
        Shed,
    )

    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p)
    lens = [n for n in prompt_len_mix(args) if n > 0] or [1]
    lock = threading.Lock()
    comps: list = []
    rejections = new_rejections()
    done_sessions = [0]
    errors: list = []
    shares = tenant_shares(args.tenants) if getattr(args, "tenants", "") else {"default": 1.0}
    names = sorted(shares)
    probs = np.asarray([shares[n] for n in names])

    def session(sid: int):
        rng = np.random.default_rng(args.seed + 1000 * (sid + 1))
        tenant = str(rng.choice(names, p=probs))
        prompt = rng.integers(0, vocab_size - 1,
                              size=int(rng.choice(lens))).astype(np.int32)
        for _ in range(args.turns):
            new = int(rng.integers(1, args.max_new_tokens + 1))
            if len(prompt) + new >= args.seq_len:
                break                      # the context window is full: session over
            try:
                fut = front.submit(prompt, max_new_tokens=new, sampling=sampling,
                                   **({"tenant": tenant} if tenant != "default" else {}))
            except (QueueFull, QuotaExceeded, Shed) as e:
                _tally_refusal(rejections, tenant, e, lock)
                return                     # overloaded: the session gives up
            comp = fut.result()
            with lock:
                comps.append(comp)
            if not comp.ok:
                return
            user = rng.integers(0, vocab_size - 1,
                                size=args.turn_user_tokens).astype(np.int32)
            prompt = np.concatenate([np.asarray(comp.tokens, np.int32), user])
        with lock:
            done_sessions[0] += 1

    def guarded(sid: int):
        try:
            session(sid)
        except BaseException as e:         # noqa: BLE001 — recorded, raised below
            with lock:
                errors.append((sid, e))

    threads = [threading.Thread(target=guarded, args=(i,), name=f"chat-{i}")
               for i in range(args.sessions)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        sid, first = errors[0]
        raise RuntimeError(f"{len(errors)}/{args.sessions} chat sessions died (first: "
                           f"session {sid}: {type(first).__name__}: {first})") from first
    return comps, rejections, done_sessions[0]


def build_parser() -> argparse.ArgumentParser:
    """The JAX tool's flags (its fleet, telemetry, tracing, shard and tier flags kept so
    that they can be refused by name) and ``--device``."""
    p = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    m = p.add_argument_group("model")
    m.add_argument("--checkpoint", default="",
                   help="train state or params file from train.lm (default: a seeded "
                        "random init)")
    m.add_argument("--seq-len", type=int, default=784)
    m.add_argument("--num-levels", type=int, default=16)
    m.add_argument("--embed-dim", type=int, default=64)
    m.add_argument("--num-layers", type=int, default=2)
    m.add_argument("--num-heads", type=int, default=4)
    m.add_argument("--kv-heads", type=int, default=0)
    m.add_argument("--attention-window", type=int, default=0)
    m.add_argument("--rope", action="store_true")
    m.add_argument("--device", default="cuda",
                   help="the engine's device: cuda (the default; no quiet fallback) or cpu")
    e = p.add_argument_group("engine/server")
    e.add_argument("--num-slots", type=int, default=8)
    e.add_argument("--max-pending", type=int, default=128)
    e.add_argument("--timeout-s", type=float, default=0.0,
                   help="per-request deadline, 0 = none")
    e.add_argument("--prefill-chunks", default="32,128,512",
                   help="static chunk-size set for batched prefill; empty = "
                        "prefill-as-decode")
    e.add_argument("--prefill-budget", type=int, default=1,
                   help="prefill chunk invocations per engine step")
    e.add_argument("--prefix-cache", type=int, default=0,
                   help="prefix KV cache LRU entries, 0 = off")
    e.add_argument("--prefix-cache-bytes", type=int, default=0,
                   help="byte budget of the prefix cache on top of the entry count")
    e.add_argument("--kv-layout", default="contiguous", choices=("contiguous", "paged"))
    e.add_argument("--page-size", type=int, default=64)
    e.add_argument("--num-pages", type=int, default=0,
                   help="paged layout: pool size in pages (0 = the contiguous capacity)")
    e.add_argument("--kv-dtype", default="model",
                   choices=("model", "fp32", "bf16", "int8", "fp8"))
    e.add_argument("--quant-policy", default="off", choices=("off", "w8", "w8a8"))
    e.add_argument("--spec", default="off", choices=("off", "ngram", "draft-lm"),
                   help="speculative decoding: 'ngram' = host n-gram self-speculation, "
                        "'draft-lm' = a small draft LM sharing the tokenizer")
    e.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens per verify step (verify width spec_k + 1)")
    e.add_argument("--draft-layers", type=int, default=1)
    e.add_argument("--draft-embed-dim", type=int, default=0,
                   help="draft LM embed dim (0 = half the target's)")
    e.add_argument("--draft-heads", type=int, default=0,
                   help="draft LM heads (0 = the target's)")
    e.add_argument("--draft-checkpoint", default="",
                   help="trained draft-LM params or train state (default: seeded init)")
    e.add_argument("--slo", default="", help="SLO spec 'ttft=0.5,e2e=2.0,window=30'")
    e.add_argument("--tenants", default="",
                   help="tenant classes and traffic mix, e.g. "
                        "'paid:w=4,prio=2,share=0.25;free:w=1,preempt=1,share=0.75'")
    e.add_argument("--warmup", type=int, default=1,
                   help="warm-up rounds before measuring (every prefill chunk size, the "
                        "prefix-cache hit path), then the counters reset; 0 = off")
    e.add_argument("--shard", default="",
                   help="the serve mesh, tp=<n>,dp=<n>: a world of tp*dp ranks "
                        "(train.launch --num-processes)")
    f = p.add_argument_group("fleet: not ported (ROADMAP A11); each flag is refused")
    f.add_argument("--tiers", default="")
    f.add_argument("--replicas", type=int, default=0)
    f.add_argument("--affinity", choices=("on", "off"), default="on")
    f.add_argument("--echo", action="store_true")
    f.add_argument("--echo-delay-s", type=float, default=0.0)
    f.add_argument("--replica-platform", default="cpu")
    f.add_argument("--router-max-pending", type=int, default=0)
    f.add_argument("--heartbeat-dir", default="")
    f.add_argument("--heartbeat-timeout-s", type=float, default=20.0)
    f.add_argument("--max-restarts", type=int, default=3)
    f.add_argument("--backoff-s", type=float, default=0.5)
    f.add_argument("--autoscale", choices=("on", "off"), default="off")
    f.add_argument("--min-replicas", type=int, default=0)
    f.add_argument("--max-replicas", type=int, default=0)
    f.add_argument("--scale-up-age-s", type=float, default=0.5)
    f.add_argument("--scale-up-util", type=float, default=0.95)
    f.add_argument("--scale-down-util", type=float, default=0.25)
    f.add_argument("--scale-sustain-up", type=int, default=2)
    f.add_argument("--scale-sustain-down", type=int, default=4)
    f.add_argument("--scale-cooldown-s", type=float, default=3.0)
    f.add_argument("--scale-slo-floor", type=float, default=0.0)
    f.add_argument("--scale-slo-tenant", default="")
    f.add_argument("--scale-slo-min-requests", type=int, default=5)
    f.add_argument("--warm-prefixes", type=int, default=8)
    f.add_argument("--drain-timeout-s", type=float, default=30.0)
    f.add_argument("--straggler-k", type=float, default=0.0)
    f.add_argument("--eject-min-samples", type=int, default=8)
    f.add_argument("--eject-cooldown-s", type=float, default=5.0)
    f.add_argument("--hedge", choices=("on", "off"), default="off")
    f.add_argument("--hedge-after-s", type=float, default=0.0)
    f.add_argument("--hedge-quantile", type=float, default=95.0)
    f.add_argument("--hedge-factor", type=float, default=2.0)
    f.add_argument("--chaos", default="")
    f.add_argument("--chaos-seed", type=int, default=0)
    f.add_argument("--framed-wire", choices=("on", "off"), default="on")
    g = p.add_argument_group("load")
    g.add_argument("--scenario", choices=("batch", "chat"), default="batch")
    g.add_argument("--sessions", type=int, default=8, help="chat: concurrent sessions")
    g.add_argument("--turns", type=int, default=4, help="chat: turns per session")
    g.add_argument("--turn-user-tokens", type=int, default=4,
                   help="chat: fresh 'user' tokens appended between turns")
    g.add_argument("--mode", choices=("open", "closed"), default="open")
    g.add_argument("--rate", type=float, default=8.0,
                   help="open loop: Poisson arrival rate, req/s")
    g.add_argument("--arrival-pattern", choices=("poisson", "burst"), default="poisson")
    g.add_argument("--burst-size", type=int, default=8)
    g.add_argument("--burst-idle-s", type=float, default=1.0)
    g.add_argument("--burst-tenant", default="")
    g.add_argument("--concurrency", type=int, default=4,
                   help="closed loop: clients with one request in flight each")
    g.add_argument("--requests", type=int, default=32)
    g.add_argument("--prompt-dist", choices=("custom", "long"), default="custom")
    g.add_argument("--prompt-lens", default="0,16,64",
                   help="comma list; each request draws uniformly from it")
    g.add_argument("--shared-prefix-len", type=int, default=0)
    g.add_argument("--max-new-tokens", type=int, default=32,
                   help="each request draws its length from [1, this]")
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--seed", type=int, default=0)
    p.add_argument("--telemetry", default="", help="the server's JSONL telemetry stream")
    p.add_argument("--trace-dir", default="",
                   help="distributed tracing: loadgen.jsonl (client spans) and "
                        "server.jsonl (the engine's and server's spans) under this "
                        "directory; render with <port>.trace_report")
    p.add_argument("--snapshot-interval-s", type=float, default=0.0,
                   help="not ported (ROADMAP A11)")
    p.add_argument("--summary-json", default="",
                   help="write the run summary as one JSON document (the JAX tool's "
                        "single-server keys)")
    return p


def check_args(p: argparse.ArgumentParser, args) -> None:
    """The JAX tool's argument checks, then the refusal of every unported flag."""
    for dest, why in UNPORTED_FLAGS.items():
        if getattr(args, dest) != p.get_default(dest):
            raise SystemExit(f"--{dest.replace('_', '-')}: {why}")
    if args.scenario == "batch":
        if args.mode == "open" and args.rate <= 0:
            raise SystemExit("--rate must be > 0 in open-loop mode")
        if args.mode == "closed" and args.concurrency < 1:
            raise SystemExit("--concurrency must be >= 1 in closed-loop mode")
    elif args.sessions < 1 or args.turns < 1:
        raise SystemExit("--sessions and --turns must be >= 1 in chat mode")
    if args.max_new_tokens < 1:
        raise SystemExit("--max-new-tokens must be >= 1")
    if args.burst_tenant:
        known = set(tenant_shares(args.tenants)) if args.tenants else set()
        if args.burst_tenant not in known:
            raise SystemExit(f"--burst-tenant {args.burst_tenant!r} is not one of the "
                             f"--tenants names {sorted(known) or '(none declared)'}")


def summarize(args, engine, server, comps, rejections, sessions_done, wall,
              acct: dict) -> dict:
    """The run summary in the JAX tool's single-server keys (``acct``: the engine's
    ``byte_accounting``)."""
    ok = sum(c.ok for c in comps)
    prefix = engine.prefix_cache.stats() if engine.prefix_cache else None
    new_tokens = sum(c.new_tokens for c in comps)
    doc = {
        "scenario": args.scenario,
        "mode": args.mode if args.scenario == "batch" else None,
        "requests": len(comps), "ok": ok,
        "timeout": sum(c.finish == "timeout" for c in comps),
        "shed": sum(c.finish == "shed" for c in comps),
        "rejected": rejections["rejected"],
        "quota_rejected": rejections["quota_rejected"],
        "shed_submits": rejections["shed_submits"],
        "tenants_spec": args.tenants or None,
        "burst_tenant": args.burst_tenant or None,
        "tenants": tenant_rows(args, comps, rejections),
        "wall_s": wall,
        "prompt_dist": args.prompt_dist,
        "prompt_lens": prompt_len_mix(args),
        "shared_prefix_len": args.shared_prefix_len,
        "num_slots": args.num_slots,
        "prefill_chunk_budget": args.prefill_budget,
        "prefix_cache_entries": args.prefix_cache,
        "kv_dtype": args.kv_dtype,
        "quant_policy": args.quant_policy,
        "spec": args.spec,
        "spec_k": args.spec_k if args.spec != "off" else None,
        "new_tokens": new_tokens,
        "tokens_per_s": new_tokens / wall if wall else None,
        "ttft_s": percentiles([c.ttft_s for c in comps]),
        "e2e_s": percentiles([c.e2e_s for c in comps]),
        "queue_wait_s": percentiles([c.queue_wait_s for c in comps]),
        "slo": args.slo or None,
    }
    if args.scenario == "chat":
        doc.update(sessions=args.sessions, turns=args.turns,
                   turn_user_tokens=args.turn_user_tokens, sessions_done=sessions_done)
    doc.update(
        shard=args.shard or None,
        bytes=acct,
        prefill_chunk_sizes=list(engine.prefill_chunk_sizes),
        prefill_tokens=engine.prefill_tokens,
        prefill_chunks=engine.prefill_invocations,
        prefill_wall_s=None,
        prefill_tokens_per_s=None,
        prefix_cache=prefix,
        prefix_hit_rate=(prefix["hits"] / prefix["queries"]
                         if prefix and prefix["queries"] else None),
        decode_compilations=None,
        prefill_compilations=None,
        decode_invocations=engine.steps,
        generated_tokens=engine.generated_tokens,
        spec_stats=engine.spec_stats(),
        slo_attainment=server.slo_summary(),
        tenant_summary=server.tenant_summaries() or None,
        preemptions=engine.preemptions,
        resumes=engine.resumes,
        verify_compilations=None)
    return doc


def tenant_rows(args, comps, rejections) -> dict | None:
    """Per-tenant counts and percentiles (``--tenants`` only)."""
    if not args.tenants:
        return None
    rows = {}
    tenant = lambda c: getattr(c.request, "tenant", None) or "default"   # noqa: E731
    for t in sorted({tenant(c) for c in comps} | set(rejections["by_tenant"])):
        tc = [c for c in comps if tenant(c) == t]
        rows[t] = {
            "requests": len(tc), "ok": sum(c.ok for c in tc),
            "timeout": sum(c.finish == "timeout" for c in tc),
            "shed": sum(c.finish == "shed" for c in tc),
            "preemptions": sum(c.preemptions for c in tc),
            "new_tokens": sum(c.new_tokens for c in tc),
            "ttft_s": percentiles([c.ttft_s for c in tc]),
            "e2e_s": percentiles([c.e2e_s for c in tc]),
            **(rejections["by_tenant"].get(t) or {}),
        }
    return rows


class TracedFront:
    """A ``Server`` front end whose every request is a trace origin: a new ``trace_id``
    a submit (carried through the serve path) and a ``client`` span from the submit call
    to the future's resolution, the outermost span of the tree. Everything else passes
    through."""

    def __init__(self, inner, tracer):
        self._inner = inner
        self._tracer = tracer

    def submit(self, prompt, **kw):
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.trace import (
            new_trace_id,
        )

        tid = new_trace_id()
        t0 = time.monotonic()
        fut = self._inner.submit(prompt, trace_id=tid, **kw)

        def _done(f, tid=tid, t0=t0):
            try:
                finish = f.result().finish
            except BaseException as e:       # noqa: BLE001 — the span records it
                finish = f"error:{type(e).__name__}"
            self._tracer.span("client", tid, t0, time.monotonic(), finish=finish)

        fut.add_done_callback(_done)
        return fut

    def __getattr__(self, name):
        return getattr(self._inner, name)


def trace_summary_doc(args) -> dict:
    """The summary's ``trace`` entry: where the spans live and the span-derived critical
    path beside the serve percentiles (with the TTFT reconciliation against the run's
    telemetry stream when there is one)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
        read_jsonl,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.trace import (
        read_spans,
        reconcile_ttft,
        summarize_traces,
    )

    spans, _ = read_spans([args.trace_dir])
    summary = summarize_traces(spans)
    events = (read_jsonl(args.telemetry)
              if args.telemetry and os.path.exists(args.telemetry) else [])
    return {"dir": args.trace_dir, "traces": summary["traces"],
            "spans": summary["spans"], "orphans": summary["orphans"],
            "redispatched": summary["redispatched"], "segments": summary["segments"],
            "ttft_s": summary["ttft_s"], "e2e_s": summary["e2e_s"],
            "ttft_reconciliation": reconcile_ttft(summary, events)}


def run(args, engine, server) -> tuple[list, dict, int | None, float]:
    """Drive the started ``server`` with the run's workload: ``(completions,
    rejections, sessions_done, wall_s)``. The wall stops when the last completion is in
    hand."""
    vocab_size = args.num_levels + 1
    t0 = time.monotonic()
    sessions_done = None
    if args.scenario == "chat":
        comps, rejections, sessions_done = run_chat(server, args, vocab_size)
    else:
        specs = make_workload(args, vocab_size)
        if args.mode == "open":
            futures, rejections = run_open_loop(
                server, specs, args.rate, np.random.default_rng(args.seed + 1),
                pattern=args.arrival_pattern, burst_size=args.burst_size,
                burst_idle_s=args.burst_idle_s, burst_tenant=args.burst_tenant)
        else:
            futures, rejections = run_closed_loop(server, specs, args.concurrency)
        comps = [f.result() for f in futures]
    return comps, rejections, sessions_done, time.monotonic() - t0


def main(argv: list[str] | None = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    check_args(p, args)
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
        cluster,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.shard import (
        parse_shard_spec,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
        resolve_device,
    )

    args.device = str(resolve_device(args.device))
    tp, dp = parse_shard_spec(args.shard)
    if tp * dp > 1:
        with cluster(args.device):
            return _serve(args)
    return _serve(args)


def _serve(args) -> int:
    """Build, serve, summarize; under a serve mesh every rank calls it."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        shard as shard_mod,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.replica import (
        build_engine_server,
    )

    engine, server = build_engine_server(
        args, trace=os.path.join(args.trace_dir, "server.jsonl") if args.trace_dir else None)
    sharded = engine.mesh is not None
    if server is None:                        # a follower rank of the serve mesh
        shard_mod.follow(engine)
        engine.byte_accounting()
        shard_mod.check_replicas(engine)
        return 0
    server.start()
    tracer = None
    if args.trace_dir:
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.trace import (
            Tracer,
        )

        tracer = Tracer(os.path.join(args.trace_dir, "loadgen.jsonl"), proc="loadgen")
    front = TracedFront(server, tracer) if tracer is not None else server
    try:
        try:
            comps, rejections, sessions_done, wall = run(args, engine, front)
        except BaseException:
            server.stop(drain=False)
            raise
        server.stop()
    finally:
        if sharded:
            server.engine.close()             # the followers leave their loops
        if tracer is not None:
            tracer.close()       # after stop(): every client span's callback has run
    acct = engine.byte_accounting()
    if sharded:
        shard_mod.check_replicas(engine)
    doc = summarize(args, engine, server, comps, rejections, sessions_done, wall, acct)
    if args.trace_dir:
        doc["trace"] = trace_summary_doc(args)
    label = (f"chat ({args.sessions} sessions x {args.turns} turns)"
             if args.scenario == "chat" else f"{args.mode}-loop")
    print(f"{label}: {doc['requests']} completed ({doc['ok']} ok, {doc['timeout']} timeout, "
          f"{doc['shed']} shed, {doc['rejected']} rejected, {doc['quota_rejected']} "
          f"over-quota, {doc['shed_submits']} shed-at-submit) in {wall:.2f}s"
          + (f", {sessions_done}/{args.sessions} sessions ran to completion"
             if sessions_done is not None else ""))
    for t, row in (doc["tenants"] or {}).items():
        p95 = (row["ttft_s"] or {}).get("p95")
        print(f"tenant {t}: {row['requests']} requests ({row['ok']} ok, {row['timeout']} "
              f"timeout, {row['shed']} shed, {row['preemptions']} preemption(s)), ttft p95 "
              f"{'-' if p95 is None else f'{p95:.3f}'}s")
    occ = engine.slot_occupancy
    print(f"generated {doc['new_tokens']} tokens, {doc['new_tokens'] / wall:.1f} tokens/s, "
          f"slot occupancy {'-' if occ is None else f'{occ:.2f}'}, on {engine.device}")
    sp = engine.spec_stats()
    if sp:
        rate, tps = sp["acceptance_rate"], sp["accepted_tokens_per_step"]
        print(f"spec: {sp['mode']} k={sp['k']}: {sp['accepted']}/{sp['proposed']} drafts "
              f"accepted (rate {'-' if rate is None else f'{rate:.2f}'}), "
              f"{'-' if tps is None else f'{tps:.2f}'} accepted tok/step, "
              f"{engine.generated_tokens} tokens in {engine.steps} program invocations")
    if doc["slo_attainment"]:
        att = doc["slo_attainment"].get("attainment")
        print(f"slo: attainment {'-' if att is None else f'{att:.3f}'} "
              f"({doc['slo_attainment'].get('met')}/"
              f"{doc['slo_attainment'].get('requests')} met vs {args.slo})")
    if engine.preemptions or engine.resumes:
        print(f"preemption: {engine.preemptions} park(s), {engine.resumes} resume(s)")
    hits = doc["prefix_cache"]
    print(f"prefilled {engine.prefill_tokens} prompt tokens in {engine.prefill_invocations} "
          f"chunks (sizes {list(engine.prefill_chunk_sizes) or 'off'})"
          + (f", prefix hits {hits['hits']}/{hits['queries']} ({hits['hit_tokens']} "
             f"tokens reused)" if hits else ""))
    acct = doc["bytes"]
    print(f"bytes (measured): kv {acct['kv_dtype']} / weights {acct['quant_policy']}, "
          f"{acct['kv_bytes_per_slot']} B/slot, {acct['decode_bytes_per_token']:.0f} B "
          f"decode read/token, {acct['slots_at_budget']} slots per "
          f"{acct['hbm_budget_bytes'] >> 30} GiB budget")
    if sharded:
        print(f"shard {args.shard}: {len(acct['per_chip'])} ranks, params+kv "
              f"{acct['params_kv_bytes_per_chip_max']} B/chip max (unsharded "
              f"{acct['params_bytes'] + acct['kv_bytes_resident']} B), "
              f"{acct['bytes_per_chip_max']} B/chip max in all; replica check passed")
    if args.trace_dir:
        tr = doc["trace"]
        seg = tr["segments"]
        top = sorted(seg, key=lambda n: -(seg[n]["p50"] or 0))[:3]
        path = ", ".join(f"{n} p50 {(seg[n]['p50'] or 0) * 1e3:.1f}ms" for n in top)
        print(f"trace: {tr['traces']} traces, {tr['spans']} spans, {tr['orphans']} "
              f"orphans, {tr['redispatched']} redispatched"
              + (f"; critical path {path}" if path else ""))
        print(f"trace spans -> {args.trace_dir} (render: python -m "
              f"csed_514_project_distributed_training_using_pytorch_tpu_torch.trace_report "
              f"{args.trace_dir})")
    if args.summary_json:
        with open(args.summary_json, "w") as fh:
            json.dump(doc, fh, indent=1)
        print(f"summary json -> {args.summary_json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
