"""Load generator for the serving stack: open loop, closed loop, chat sessions, fleets.

The port of the JAX package's ``tools/serve_loadgen.py``: one ``ContinuousBatchingEngine``
behind one ``serving.Server``, built by ``serving.replica.build_engine_server`` from the
same model, engine and server flags, or — with ``--replicas N`` — ``serving.Router`` over N
replica processes (``python -m <port>.serving.replica``), driven by a reproducible
synthetic workload:

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
``DIR/server.jsonl`` (the engine's spans and ``resolve``), a fleet's router
``DIR/router.jsonl`` and each replica ``DIR/replica<i>.jsonl``; the summary gains the
critical path (``trace``), and ``python -m <port>.trace_report DIR`` renders the trees.

The fleet (``--replicas N``): this process imports no ``torch``; the engines live in the
replicas, which run on ``--replica-platform`` (a device word; empty = ``--device``, so the
card by default, and the CPU must be asked for). Before spawning a paged fleet on the
card it builds the B6 library once in a child process, so N replicas do not race the
build. ``--affinity``, the restart and heartbeat knobs, ``--autoscale`` and its policy,
``--warm-prefixes``, ``--drain-timeout-s``, ``--straggler-k``, ``--hedge``, ``--chaos``,
``--framed-wire`` and ``--snapshot-interval-s`` are the router's; ``--echo`` spawns
deterministic model-free replicas; ``--tiers prefill:1,decode:1`` assigns the replicas'
roles by position (contiguous KV only). The summary has the JAX tool's fleet keys.
``--shard tp=T,dp=D`` with ``--replicas N`` passes the flag to every replica, as the JAX
tool does: each replica is then a world of ``T * D`` ranks that the router spawns, restarts
and addresses as one (``serving/replica.py``).

Usage::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.serve_loadgen \\
        --requests 32 --mode open --rate 16 --num-slots 8 --summary-json serve.json
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.serve_loadgen \\
        --scenario chat --sessions 6 --turns 3 --spec ngram --device cpu
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.serve_loadgen \\
        --replicas 2 --scenario chat --sessions 8 --turns 4 --prefix-cache 8 \\
        --kv-layout paged --telemetry router.jsonl --summary-json fleet.json
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

PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"


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
    """The JAX tool's flags and ``--device``."""
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
    f = p.add_argument_group("fleet (0 replicas = the in-process server)")
    f.add_argument("--tiers", default="",
                   help="prefill/decode tiers, e.g. 'prefill:1,decode:1' (roles assigned "
                        "to replicas by position; contiguous KV): prefill-tier replicas "
                        "prefill and ship KV planes to decode-tier replicas; empty = a "
                        "unified fleet")
    f.add_argument("--replicas", type=int, default=0,
                   help="run a serving.Router fleet of N replica processes instead of "
                        "the in-process server")
    f.add_argument("--affinity", choices=("on", "off"), default="on",
                   help="prefix-affinity routing vs the least-loaded baseline")
    f.add_argument("--echo", action="store_true",
                   help="fleet mode: model-free --echo replicas (deterministic tokens, "
                        "--echo-delay-s a token), the router-mechanics workload")
    f.add_argument("--echo-delay-s", type=float, default=0.0,
                   help="echo replicas: per-token sleep (keeps work in flight)")
    f.add_argument("--replica-platform", default="",
                   help="the replicas' device (cuda or cpu); empty = --device")
    f.add_argument("--router-max-pending", type=int, default=0,
                   help="router admission queue bound (0 = unbounded)")
    f.add_argument("--heartbeat-dir", default="",
                   help="replica liveness dir (default: a temporary dir)")
    f.add_argument("--heartbeat-timeout-s", type=float, default=20.0,
                   help="beat staleness that counts a replica as hung")
    f.add_argument("--max-restarts", type=int, default=3,
                   help="per-replica restart budget")
    f.add_argument("--backoff-s", type=float, default=0.5,
                   help="restart backoff base (exponential, capped, jittered)")
    a = p.add_argument_group("elasticity (fleet mode)")
    a.add_argument("--autoscale", choices=("on", "off"), default="off",
                   help="drive scale_up/scale_down from the fleet_snapshot signal "
                        "(needs --snapshot-interval-s > 0)")
    a.add_argument("--min-replicas", type=int, default=0,
                   help="scale-down floor (0 = --replicas, i.e. never shrink)")
    a.add_argument("--max-replicas", type=int, default=0,
                   help="scale-up cap (0 = --replicas when autoscaling, unbounded for "
                        "manual scaling)")
    a.add_argument("--scale-up-age-s", type=float, default=0.5,
                   help="queue head older than this counts as overloaded")
    a.add_argument("--scale-up-util", type=float, default=0.95,
                   help="in-flight/capacity at/above this counts as overloaded")
    a.add_argument("--scale-down-util", type=float, default=0.25,
                   help="empty queue + utilization at/below this counts idle")
    a.add_argument("--scale-sustain-up", type=int, default=2,
                   help="consecutive overloaded snapshots before a scale-up")
    a.add_argument("--scale-sustain-down", type=int, default=4,
                   help="consecutive idle snapshots before a scale-down")
    a.add_argument("--scale-cooldown-s", type=float, default=3.0,
                   help="dead time after any scale action")
    a.add_argument("--scale-slo-floor", type=float, default=0.0,
                   help="windowed SLO attainment below this counts as overloaded and "
                        "blocks every shrink (0 = utilization-only policy)")
    a.add_argument("--scale-slo-tenant", default="",
                   help="watch this tenant's window instead of the fleet-wide one")
    a.add_argument("--scale-slo-min-requests", type=int, default=5,
                   help="completions in the window before attainment is trusted")
    a.add_argument("--warm-prefixes", type=int, default=8,
                   help="hot affinity prefixes a new replica replays before it is "
                        "marked ready (0 = cold starts)")
    a.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="how long a retiring/reloading replica may finish in-flight "
                        "work before stragglers redispatch")
    gf = p.add_argument_group("gray failures (fleet mode)")
    gf.add_argument("--straggler-k", type=float, default=0.0,
                    help="eject a replica whose windowed dispatch p95 exceeds k x the "
                         "fleet-median peer p95 (0 = off)")
    gf.add_argument("--eject-min-samples", type=int, default=8,
                    help="windowed samples on the scored replica before ejection")
    gf.add_argument("--eject-cooldown-s", type=float, default=5.0,
                    help="degraded dwell before the probe re-opens dispatch")
    gf.add_argument("--hedge", choices=("on", "off"), default="off",
                    help="hedged dispatch: a request pending past the hedge deadline "
                         "gets a second copy on another replica; first completion wins")
    gf.add_argument("--hedge-after-s", type=float, default=0.0,
                    help="fixed hedge deadline (0 = from the windowed latency quantile)")
    gf.add_argument("--hedge-quantile", type=float, default=95.0,
                    help="quantile of the fleet's windowed dispatch latency")
    gf.add_argument("--hedge-factor", type=float, default=2.0,
                    help="multiplier on the quantile for the derived deadline")
    gf.add_argument("--chaos", default="",
                    help="network-chaos spec (resilience/netfaults.py grammar): every "
                         "router<->replica link through a seeded fault proxy")
    gf.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the chaos proxy's corrupt-byte positions")
    gf.add_argument("--framed-wire", choices=("on", "off"), default="on",
                    help="negotiate length+CRC framing ('off' pins newline JSON)")
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
                   help="fleet mode: a fleet_snapshot event every N seconds (the "
                        "elasticity load signal; needs --telemetry, 0 = off)")
    p.add_argument("--summary-json", default="",
                   help="write the run summary as one JSON document (the JAX tool's "
                        "single-server keys)")
    return p


def check_args(args) -> list[str]:
    """The JAX tool's argument checks; returns the tier roles (``[]``: a unified fleet)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.tiers import (
        parse_shard_spec,
        parse_tier_spec,
    )

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
    if args.echo and args.replicas < 1:
        raise SystemExit("--echo needs --replicas N (echo replicas are a fleet-mode "
                         "workload)")
    roles: list[str] = []
    if args.tiers:
        if args.replicas < 1:
            raise SystemExit("--tiers needs --replicas N (tiered serving is a fleet-mode "
                             "workload)")
        try:
            roles = parse_tier_spec(args.tiers)
        except ValueError as exc:
            raise SystemExit(str(exc))
        if len(roles) != args.replicas:
            raise SystemExit(
                f"--tiers names {len(roles)} replica role(s) but --replicas is "
                f"{args.replicas} — the spec assigns roles by position and must cover "
                f"the whole fleet")
    if args.shard:
        if args.echo:
            raise SystemExit("--shard needs a real engine (echo replicas build no mesh)")
        try:
            parse_shard_spec(args.shard)
        except ValueError as exc:
            raise SystemExit(str(exc))
        if roles:
            raise SystemExit("--shard with --tiers: the KV handoff installs planes on one "
                             "rank; run sharded replicas unified")
    return roles


def summary_head(args, comps, rejections, sessions_done, wall) -> dict:
    """The run summary's keys common to the JAX tool's single-server and fleet
    summaries."""
    ok = sum(c.ok for c in comps)
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
    return doc


def summarize(args, engine, server, comps, rejections, sessions_done, wall,
              acct: dict) -> dict:
    """The run summary in the JAX tool's single-server keys (``acct``: the engine's
    ``byte_accounting``)."""
    prefix = engine.prefix_cache.stats() if engine.prefix_cache else None
    doc = summary_head(args, comps, rejections, sessions_done, wall)
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


def summarize_fleet(args, comps, rejections, sessions_done, wall, rs: dict) -> dict:
    """The run summary in the JAX tool's fleet keys (``rs``: the router's summary)."""
    pc = rs.get("prefix_cache") or {}
    doc = summary_head(args, comps, rejections, sessions_done, wall)
    doc.update(
        replicas=args.replicas, affinity=args.affinity,
        echo=args.echo, autoscale=args.autoscale,
        arrival_pattern=(args.arrival_pattern
                         if args.scenario == "batch" and args.mode == "open" else None),
        scale=rs.get("scale"),
        scale_events=rs.get("scale_events"),
        target=rs.get("target"),
        replicas_ready_p50=rs.get("replicas_ready_p50"),
        replicas_ready_max=rs.get("replicas_ready_max"),
        replicas_ready_min=rs.get("replicas_ready_min"),
        affinity_rate=rs["affinity_rate"],
        redispatches=rs["redispatches"],
        redispatched_requests=rs["redispatched_requests"],
        duplicate_completions=rs["duplicates"],
        hedge=args.hedge, straggler_k=args.straggler_k or None,
        chaos=args.chaos or None,
        ejections=rs.get("ejections"),
        probes=rs.get("probes"),
        hedges=rs.get("hedges"),
        hedge_wins=rs.get("hedge_wins"),
        hedge_win_rate=rs.get("hedge_win_rate"),
        wire_corrupt=rs.get("wire_corrupt"),
        replica_restarts=rs["replica_restarts"],
        prefix_cache=rs.get("prefix_cache"),
        prefix_hit_rate=pc["hits"] / pc["queries"] if pc.get("queries") else None,
        spec_stats=rs.get("spec"),
        tiers=args.tiers or None,
        shard=args.shard or None,
        handoffs=rs.get("handoffs"),
        handoff_bytes=rs.get("handoff_bytes"),
        handoff_failures=rs.get("handoff_failures"),
        disagg_requests=sum(getattr(c, "disagg", False) for c in comps),
        per_replica=[{k: r[k] for k in ("replica", "state", "restarts", "dispatched",
                                        "completed", "tier", "handoffs") if k in r}
                     for r in rs["per_replica"]],
        slo_attainment=rs.get("slo"),
        replica_latency=rs.get("replica_latency"),
        tenant_summary=rs.get("tenants"),
        preemptions=rs.get("preemptions"),
        resumes=rs.get("resumes"),
        router_queue=rs.get("queue"))
    return doc


def _comp_tenant(c) -> str:
    """A completion's tenant: a ``RouterCompletion`` carries it, a ``Completion`` through
    its request."""
    return (getattr(c, "tenant", None)
            or getattr(getattr(c, "request", None), "tenant", None) or "default")


def tenant_rows(args, comps, rejections) -> dict | None:
    """Per-tenant counts and percentiles (``--tenants`` only)."""
    if not args.tenants:
        return None
    rows = {}
    for t in sorted({_comp_tenant(c) for c in comps} | set(rejections["by_tenant"])):
        tc = [c for c in comps if _comp_tenant(c) == t]
        rows[t] = {
            "requests": len(tc), "ok": sum(c.ok for c in tc),
            "timeout": sum(c.finish == "timeout" for c in tc),
            "shed": sum(c.finish == "shed" for c in tc),
            "preemptions": sum(getattr(c, "preemptions", 0) for c in tc),
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


def build_replica_command(args) -> list[str]:
    """The replica process's argv from this run's model, engine and server flags (the
    router appends ``--port``, ``--replica-id``, ``--heartbeat-dir``, ``--device`` and the
    tier). The JAX tool's command, plus the paged layout's flags, which the port's fleet
    runs B6 through."""
    if args.echo:
        cmd = ["-m", f"{PKG}.serving.replica", "--echo",
               "--seq-len", str(args.seq_len), "--num-levels", str(args.num_levels),
               "--num-slots", str(args.num_slots), "--max-pending", str(args.max_pending)]
        if args.echo_delay_s:
            cmd += ["--echo-delay-s", str(args.echo_delay_s)]
        return cmd
    cmd = ["-m", f"{PKG}.serving.replica",
           "--seq-len", str(args.seq_len), "--num-levels", str(args.num_levels),
           "--embed-dim", str(args.embed_dim), "--num-layers", str(args.num_layers),
           "--num-heads", str(args.num_heads), "--kv-heads", str(args.kv_heads),
           "--attention-window", str(args.attention_window), "--seed", str(args.seed),
           "--num-slots", str(args.num_slots), "--max-pending", str(args.max_pending),
           "--timeout-s", str(args.timeout_s), "--prefill-chunks", args.prefill_chunks,
           "--prefill-budget", str(args.prefill_budget),
           "--prefix-cache", str(args.prefix_cache),
           "--prefix-cache-bytes", str(args.prefix_cache_bytes),
           "--kv-layout", args.kv_layout, "--page-size", str(args.page_size),
           "--num-pages", str(args.num_pages),
           "--kv-dtype", args.kv_dtype, "--quant-policy", args.quant_policy,
           "--spec", args.spec, "--spec-k", str(args.spec_k),
           "--draft-layers", str(args.draft_layers),
           "--draft-embed-dim", str(args.draft_embed_dim),
           "--draft-heads", str(args.draft_heads), "--warmup", str(args.warmup)]
    if args.slo:
        cmd += ["--slo", args.slo]
    if args.draft_checkpoint:
        cmd += ["--draft-checkpoint", args.draft_checkpoint]
    if args.rope:
        cmd.append("--rope")
    if args.checkpoint:
        cmd += ["--checkpoint", args.checkpoint]
    if args.shard:
        cmd += ["--shard", args.shard]
    return cmd


def prebuild_kernels(args, device: str, env: dict) -> None:
    """Build the B6 library once, in a child process (this one imports no ``torch``),
    before a paged fleet's replicas start on the card: each would otherwise run its own
    ``nvcc``. The build needs ``nvcc``, not a card; a replica without one fails on its
    own."""
    if args.echo or args.kv_layout != "paged" or not device.startswith("cuda"):
        return
    import subprocess

    code = (f"from {PKG}.ops import _build; "
            f"print(_build.build(('paged_attention',)), flush=True)")
    subprocess.run([sys.executable, "-c", code], env=env, check=True)


def build_router(args, roles: list[str]):
    """The ``serving.Router`` of the fleet flags over ``build_replica_command``'s
    replicas, on ``--replica-platform`` (else ``--device``). Not started."""
    import tempfile

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import SLOSpec
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import (
        Router,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
        parse_tenants,
    )

    # the replicas import this package whatever their working directory
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{root}:{env['PYTHONPATH']}" if env.get("PYTHONPATH") else root
    device = args.replica_platform or args.device
    prebuild_kernels(args, device, env)
    autoscale = None
    if args.autoscale == "on":
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.autoscaler import (
            AutoscalePolicy,
        )

        autoscale = AutoscalePolicy(
            min_replicas=args.min_replicas or args.replicas,
            max_replicas=args.max_replicas or args.replicas,
            up_queue_age_s=args.scale_up_age_s, up_utilization=args.scale_up_util,
            down_utilization=args.scale_down_util, sustain_up=args.scale_sustain_up,
            sustain_down=args.scale_sustain_down, cooldown_s=args.scale_cooldown_s,
            slo_floor=args.scale_slo_floor or None,
            slo_tenant=args.scale_slo_tenant or None,
            slo_min_requests=args.scale_slo_min_requests)
    return Router(
        build_replica_command(args), num_replicas=args.replicas, device=device,
        max_pending=args.router_max_pending, default_timeout_s=args.timeout_s or None,
        affinity=args.affinity == "on",
        heartbeat_dir=args.heartbeat_dir or tempfile.mkdtemp(prefix="serve_hb_"),
        heartbeat_timeout_s=args.heartbeat_timeout_s, max_restarts=args.max_restarts,
        backoff_s=args.backoff_s, telemetry=args.telemetry, trace_dir=args.trace_dir,
        snapshot_interval_s=args.snapshot_interval_s, autoscale=autoscale,
        min_replicas=args.min_replicas or None, max_replicas=args.max_replicas or None,
        warm_prefixes=args.warm_prefixes, drain_timeout_s=args.drain_timeout_s,
        straggler_k=args.straggler_k, eject_min_samples=args.eject_min_samples,
        eject_cooldown_s=args.eject_cooldown_s, hedge=args.hedge == "on",
        hedge_after_s=args.hedge_after_s, hedge_quantile=args.hedge_quantile,
        hedge_factor=args.hedge_factor, chaos=args.chaos, chaos_seed=args.chaos_seed,
        framed_wire=args.framed_wire == "on", slo=SLOSpec.parse(args.slo),
        # the router is the fleet's one quota-charging front door: the replicas' argv
        # has no --tenants (the tenancy fields ride the wire), so nothing is charged twice
        tenants=parse_tenants(args.tenants), env=env,
        replica_extra_args=[["--tier", role] for role in roles] if roles else None)


def main(argv: list[str] | None = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    roles = check_args(args)
    if args.replicas > 0:
        return _serve_fleet(args, roles)
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


def _serve_fleet(args, roles: list[str]) -> int:
    """Start the router's fleet, drive it, stop it, summarize (the JAX tool's fleet
    lines and keys)."""
    router = build_router(args, roles)
    router.start()
    if not router.wait_ready(timeout=600):
        router.stop(drain=False)
        raise SystemExit("fleet did not come up within 600s (or crash-looped its restart "
                         "budget away — check the replica command and its stderr)")
    tracer = None
    if args.trace_dir:
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.trace import (
            Tracer,
        )

        tracer = Tracer(os.path.join(args.trace_dir, "loadgen.jsonl"), proc="loadgen")
    front = TracedFront(router, tracer) if tracer is not None else router
    try:
        comps, rejections, sessions_done, wall = run(args, None, front)
    except BaseException:
        router.stop(drain=False)         # never orphan a replica process
        raise
    rs = router.stop(timeout=600)
    if tracer is not None:
        tracer.close()           # after stop(): every client span's callback has run
    doc = summarize_fleet(args, comps, rejections, sessions_done, wall, rs)
    if args.trace_dir:
        doc["trace"] = trace_summary_doc(args)
    label = (f"chat ({args.sessions} sessions x {args.turns} turns)"
             if args.scenario == "chat" else f"{args.mode}-loop")
    print(f"{label}: {doc['requests']} completed ({doc['ok']} ok, {doc['timeout']} timeout, "
          f"{doc['shed']} shed, {doc['rejected']} rejected, {doc['quota_rejected']} "
          f"over-quota, {doc['shed_submits']} shed-at-submit) in {wall:.2f}s"
          + (f", {sessions_done}/{args.sessions} sessions ran to completion"
             if sessions_done is not None else ""))
    hit_rate, aff = doc["prefix_hit_rate"], rs["affinity_rate"]
    print(f"fleet: {args.replicas} replicas on {'echo' if args.echo else args.replica_platform or args.device}, affinity "
          f"{args.affinity}: {doc['new_tokens']} tokens, {doc['new_tokens'] / wall:.1f} "
          f"tokens/s, affinity rate {'-' if aff is None else f'{aff:.2f}'}, prefix hit "
          f"rate {'-' if hit_rate is None else f'{hit_rate:.2f}'}")
    print(f"resilience: {rs['redispatches']} redispatches ({rs['redispatched_requests']} "
          f"requests), {rs['replica_restarts']} replica restart(s), {rs['duplicates']} "
          f"duplicate completion(s)")
    if rs.get("ejections") or rs.get("hedges") or rs.get("wire_corrupt"):
        win = rs.get("hedge_win_rate")
        print(f"gray failures: {rs.get('ejections', 0)} ejection(s), "
              f"{rs.get('probes', 0)} probe recover(ies), {rs.get('hedges', 0)} hedge(s) "
              f"(win rate {'-' if win is None else f'{win:.2f}'}), "
              f"{rs.get('wire_corrupt', 0)} typed wire fault(s)")
    if rs.get("handoffs") or rs.get("handoff_failures"):
        print(f"tiers ({args.tiers or '?'}): {rs.get('handoffs', 0)} kv handoff(s), "
              f"{rs.get('handoff_bytes', 0)} bytes shipped, "
              f"{rs.get('handoff_failures', 0)} bounced to local prefill, "
              f"{doc['disagg_requests']} request(s) served disaggregated")
    sc = rs.get("scale") or {}
    if rs.get("scale_events"):
        print(f"elasticity: {sc.get('scale_ups', 0)} scale-up(s), {sc.get('retired', 0)} "
              f"graceful retire(s), {sc.get('reloads', 0)} reload(s); replicas ready p50 "
              f"{rs.get('replicas_ready_p50') or '-'} / max "
              f"{rs.get('replicas_ready_max') or '-'} (target ended at {rs.get('target')})")
    if args.summary_json:
        with open(args.summary_json, "w") as fh:
            json.dump(doc, fh, indent=1)
        print(f"summary json -> {args.summary_json}")
    return 0


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
