"""One serving replica behind the fleet's line protocol on a local TCP port, and the
engine and server from the load generator's flags.

Counterpart of the JAX package's ``serving/replica.py``, speaking its protocol byte for
byte (``serving/wire.py``), so the JAX package's ``serving/router.py::Router`` drives a port
replica as it drives its own. Run it as::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.replica \\
        --port 7000 --kv-layout paged --trace spans/replica0.jsonl

- ``build_engine_server``: the one place that turns the model, engine and server flags
  (``serve_loadgen`` declares them as the JAX package's tool does) into a
  ``ContinuousBatchingEngine`` and a ``Server``: the checkpoint fallback, the draft-LM
  recipe, the warm-up recipe, ``--telemetry`` and ``trace``. ``--shard tp=T,dp=D`` builds
  the engine on the serve mesh over a process group of ``T * D`` ranks (``train.launch``):
  rank 0 gets the ``Server`` over a ``shard.MeshLeader``, every other rank ``None`` (it
  runs ``shard.follow``).
- ``serve_forever`` / ``main``: the replica process. It writes heartbeats from a ticker
  thread (``resilience/heartbeat.py``, process index = ``--replica-id``), ticks fault
  injection from the engine's per-step hook (``engine.on_step`` ->
  ``resilience.faults.on_tick``: ``kill``/``preempt``/``stall`` after N decode steps, with
  requests in flight; ``proc=`` matches ``--replica-id``), exits 75 on SIGTERM without
  resolving in-flight work (so a router drains and replays it), and exits 1 when the
  serving loop dies.
- ``--shard tp=T,dp=D``: the replica is a world of ``T * D`` processes (the router spawns
  it through ``train.launch.Fleet(whole=True)``; every rank runs this same command) and
  the router addresses it as one replica. Rank 0 binds ``--port``, speaks the protocol,
  writes the heartbeats, ticks the faults and owns the ``Server`` over a
  ``shard.MeshLeader``; every other rank replays its engine calls (``shard.follow``) and
  exits with the world: 75 on SIGTERM, 0 when the leader stops or drains. ``stats``
  carries every rank's B6 launches and decode steps (``engine.ranks``) beside the
  per-rank bytes; ``stop`` and ``drain`` run ``shard.closing_check`` (the replica check,
  which fails the replica's exit when a rank parted) before the world ends. A rank that
  hangs holds rank 0 inside one mesh call, and rank 0 then stops beating, so the router's
  heartbeat timeout restarts the world. A tier with ``--shard`` is refused: the handoff
  installs planes on one rank.

Line protocol (one JSON object per message both ways; newline-framed, or length + CRC
frames after negotiation):

- router -> replica: ``hello_ack`` (the framing opt-in, newline JSON, the router's first
  message when sent), ``submit`` (``{"op", "id", "prompt", "max_new_tokens",
  "temperature", "top_k", "top_p", "timeout_s"}``, ``trace_id`` only on a traced
  request), ``cancel`` (a hedge this replica lost: abort if queued, else suppress the
  reply), ``prefill`` (prefill tier: prefill the prompt, ship its planes to the decode
  replica named in ``handoff``), ``stats``, ``warm`` (replay prompts through prefill;
  acked ``warm_done``), ``drain`` (refuse new submits, finish accepted work, ack
  ``drained``, exit 0), ``stop`` (finish accepted work, exit 0);
- replica -> router: ``hello`` (always newline JSON: replica id, ``num_slots``,
  ``max_pending``, ``pid``, ``caps: ["framed1"]``; ``tier`` and ``handoff_port`` only on
  a tiered replica), ``done`` (tokens, finish, latencies), ``error`` (``queue_full``,
  ``draining``, ``quota``, ``shed``, ``invalid``, ``failed``, or ``wire_corrupt`` with
  ``id: null``), ``prefill_done``/``prefill_failed``, ``warm_done``, ``drained``,
  ``stats``.

Tiers (``--tier prefill|decode``, ``serving/tiers.py``): a decode replica opens a
second, always-framed listener for ``kv_handoff`` messages from prefill replicas (its
port rides the hello), checks each plane's crc32 and the layout signature, copies the
planes to its device on a side stream, waits for the copy, and only then inserts them
into its prefix cache, so the engine's next admission of that prompt is a full-prefix
hit and a torn or corrupt handoff leaves nothing behind. A prefill replica prefills the
prompt (one generated token), looks its planes up in its own prefix cache and ships them;
it reports ``prefill_failed`` on any fault, and the router then prefills locally. The
handoff ships whole contiguous planes, so a paged engine refuses a tier.

Every blocking point of the main thread times out after 0.5 s, so a SIGTERM (or a
``preempt`` fault's signal to itself) runs its handler promptly; a peer that connects and
stalls is dropped after ``--wire-idle-timeout-s``. Greedy decode makes a replay
token-identical, which is what makes a router's at-least-once delivery safe.

``--echo`` serves deterministic tokens without the engine or ``torch``: the protocol,
heartbeats, faults, preemption and the handoff wire are the same code (an echo decode
replica counts and acks handoffs).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time

import numpy as np

from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import SLOSpec
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
    faults,
    heartbeat as hb,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience.preemption import (
    EXIT_PREEMPTED,
    PreemptionHandler,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
    QueueClosed,
    QueueFull,
    QuotaExceeded,
    Request,
    SamplingParams,
    Shed,
    parse_tenants,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    tiers as tiers_mod,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.wire import (
    CAP_FRAMED,
    FrameDecoder,
    LineDecoder,
    WireCorrupt,
    write_msg,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.trace import (
    Tracer,
)


# Seconds one mesh call may run before a sharded replica's rank 0 withholds its heartbeat
# (a decode step or prefill chunk takes milliseconds; warm-up runs before the server).
MESH_CALL_STUCK_S = 1.0


def build_draft_model(args):
    """The draft LM's recipe: ``--draft-layers`` (1), ``--draft-embed-dim`` (0 = half the
    target's, at least its head count) and ``--draft-heads`` (0 = the target's), the
    target's tokenizer, KV heads, window and RoPE."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm

    return lm.TransformerLM(
        vocab_size=args.num_levels + 1, seq_len=args.seq_len,
        embed_dim=args.draft_embed_dim or max(args.embed_dim // 2, args.num_heads),
        num_layers=args.draft_layers, num_heads=args.draft_heads or args.num_heads,
        num_kv_heads=args.kv_heads or None, attention_window=args.attention_window,
        rope=args.rope)


def build_engine_server(args, trace: Tracer | str | None = None):
    """The engine and the server from an argparse namespace: the target model at the
    model flags, its parameters from ``--checkpoint`` (a train state or a params-only
    file, ``utils.checkpoint.load_params_or_state``) or a seeded init, the drafter for
    ``--spec`` (``"draft-lm"`` builds ``build_draft_model`` from ``--draft-checkpoint`` or
    a seeded init at ``seed + 1``), the engine on ``args.device``, the ``--warmup`` recipe
    (every prefill chunk size, the prefix-cache hit path, a promptless request; then the
    counters reset), and the ``Server`` with ``--telemetry`` and ``trace`` (a
    ``utils.trace.Tracer`` or a span JSONL path; None falls back to ``args.trace``).
    Returns ``(engine, server)``; the server is not started. Under ``--shard`` with more
    than one rank the server is rank 0's, over a ``shard.MeshLeader``, and ``None`` on the
    other ranks. The engine's modules (and ``torch``) are imported here, so an ``--echo``
    replica never loads them."""
    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        shard as shard_mod,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.engine import (
        ContinuousBatchingEngine,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.server import (
        Server,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )
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
    tier = getattr(args, "tier", tiers_mod.ROLE_UNIFIED)
    kv_layout = getattr(args, "kv_layout", "contiguous")
    if kv_layout != "contiguous" and tier != tiers_mod.ROLE_UNIFIED:
        # The handoff ships whole contiguous planes; a paged engine's prefix entries are
        # page ids with no planes to encode. Refused at start-up, not per request.
        raise ValueError(
            f"--kv-layout {kv_layout} is incompatible with --tier "
            f"{args.tier}: the prefill/decode KV handoff ships contiguous "
            f"planes (run paged engines as unified replicas)")
    # The tiers ride the prefix cache (the prefill tier snapshots finished prompts into
    # it, the decode tier installs handed-off planes from it): a tier without
    # --prefix-cache gets 32 entries rather than a handoff path that cannot work.
    prefix_entries = args.prefix_cache
    if tier != tiers_mod.ROLE_UNIFIED and not prefix_entries:
        prefix_entries = 32
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
        prefix_cache_entries=prefix_entries,
        prefix_cache_bytes=getattr(args, "prefix_cache_bytes", 0) or None,
        kv_dtype=getattr(args, "kv_dtype", "model"),
        quant_policy=getattr(args, "quant_policy", "off"),
        kv_layout=kv_layout,
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
                    tenants=parse_tenants(getattr(args, "tenants", "")),
                    trace=trace if trace is not None else getattr(args, "trace", ""))
    return engine, server


class _EchoServer:
    """A model-free stand-in for ``Server``: deterministic tokens, the same protocol.

    The reply for a prompt is the prompt followed by ``(sum(prompt) + i) % (vocab - 1)``,
    a pure function of the request, so a redispatched replay is token-identical as greedy
    decode is. ``delay_s`` stretches each request so that faults land with work in
    flight. With tracing on it emits the engine's ``decode`` span shape (the first-token
    split included). It imports neither ``torch`` nor the engine."""

    def __init__(self, args, tracer: Tracer | None = None):
        self.vocab = args.num_levels + 1
        self.seq_len = args.seq_len
        self.delay_s = args.echo_delay_s
        self.steps = 0               # protocol parity with engine.steps
        self.tracer = tracer
        self._lock = threading.Lock()
        # Drain protocol parity with the real server: once draining, admission
        # raises QueueClosed (the shrink/submit race bounce) while accepted
        # work finishes; ``drain()`` blocks until the ledger empties.
        self.draining = False
        self._inflight = 0
        self._cond = threading.Condition(self._lock)

    def begin_request(self) -> None:
        with self._cond:
            if self.draining:
                raise QueueClosed("echo replica draining")
            self._inflight += 1

    def end_request(self) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    def drain(self) -> None:
        with self._cond:
            self.draining = True
            self._cond.wait_for(lambda: self._inflight == 0)

    def complete(self, prompt: np.ndarray, max_new: int, *,
                 trace_id: str | None = None,
                 request_id: int | None = None) -> tuple[np.ndarray, float | None]:
        """Returns ``(tokens, ttft_s)`` — the first-token split rides the done
        line so fleet-level TTFT percentiles (the hedging A/B's gate metric)
        work on the echo tier too."""
        p = len(prompt)
        total = min(p + max_new, self.seq_len)
        base = int(prompt.sum()) if p else 0
        out = list(prompt) + [(base + i) % (self.vocab - 1)
                              for i in range(total - p)]
        t0 = time.monotonic()
        first = None
        for i in range(total - p):
            faults.on_tick(step=self.steps)
            with self._lock:
                self.steps += 1
            if self.delay_s:
                time.sleep(self.delay_s)
            if i == 0:
                first = time.monotonic()
        if self.tracer is not None:
            now = time.monotonic()
            self.tracer.span(
                "decode", trace_id, t0, now, request_id=request_id,
                finish="ok", new_tokens=total - p,
                first_token_s=(None if first is None
                               else round(first - t0, 6)),
                first_token_ts=first)
        return np.asarray(out, np.int32), (None if first is None
                                           else first - t0)


class _WireOut:
    """The mode-aware reply channel one connection's handlers write through:
    newline JSON until the router's ``hello_ack`` flips :attr:`framed`, frames
    after. The flip happens while processing the FIRST router message — before
    any op that could produce a reply has been handled — so no reply can
    straddle the mode switch. ``cancelled`` is the hedge-loser ledger: ids
    whose done line must be suppressed (the router already resolved the
    request on the winning replica)."""

    def __init__(self, wfile):
        self.wfile = wfile
        self.lock = threading.Lock()
        self.framed = False
        self.cancelled: set = set()
        # Engine-mode submit futures still unresolved, by id: a cancel op for
        # one still queued can abort it outright instead of wasting decode.
        self.pending_futures: dict = {}

    def send(self, obj: dict) -> None:
        write_msg(self.wfile, self.lock, obj, framed=self.framed)


def _send(out: _WireOut, obj: dict) -> None:
    out.send(obj)


def _handle_submit(msg, server, out: _WireOut, *, sharded: bool = False):
    prompt = np.asarray(msg.get("prompt") or [], np.int32)
    rid = msg["id"]
    sampling = SamplingParams(temperature=msg.get("temperature", 0.0),
                              top_k=msg.get("top_k", 0),
                              top_p=msg.get("top_p", 1.0))
    try:
        # trace_id rides the wire verbatim (present only when the router side
        # traces): the replica's spans join the fleet-wide trace by id alone.
        # Same contract for the tenancy fields — tenant/priority/preemptible
        # appear only on non-default requests (the router front door already
        # charged the quota; the replica enforces the ENGINE-side half:
        # priority preemption and per-tenant slot caps).
        fut = server.submit(prompt, max_new_tokens=msg["max_new_tokens"],
                            sampling=sampling, timeout_s=msg.get("timeout_s"),
                            trace_id=msg.get("trace_id"),
                            tenant=msg.get("tenant", "default"),
                            priority=msg.get("priority"),
                            preemptible=msg.get("preemptible"))
    except QueueFull:
        _send(out, {"op": "error", "id": rid, "error": "queue_full",
                    "message": "replica queue at capacity"})
        return
    except QuotaExceeded as e:
        # Replica-local quota (standalone --tenants): a typed refusal reply,
        # never a crash — an over-quota request must not kill the process.
        _send(out, {"op": "error", "id": rid, "error": "quota",
                    "message": str(e)})
        return
    except Shed as e:
        _send(out, {"op": "error", "id": rid, "error": "shed",
                    "message": str(e)})
        return
    except QueueClosed:
        # The shrink/submit race: this dispatch crossed the drain op on the
        # wire. The request is intact — bounce it so the router re-queues it
        # at the front and tries another replica.
        _send(out, {"op": "error", "id": rid, "error": "draining",
                    "message": "replica draining (retire/reload)"})
        return
    except ValueError as e:
        _send(out, {"op": "error", "id": rid, "error": "invalid",
                    "message": str(e)})
        return

    def _done(f, rid=rid):
        with out.lock:
            out.pending_futures.pop(rid, None)
            # A hedge this replica lost: the router resolved the request on
            # the winning peer and asked us to stand down — the reply (result
            # OR failure) is unwanted. Discard the marker: ids are
            # router-unique, so it can never match again.
            cancelled = rid in out.cancelled and (out.cancelled.discard(rid)
                                                  or True)
        if cancelled:
            return
        try:
            comp = f.result()
        except BaseException as e:           # server died mid-request
            if sharded:
                # A sharded replica's loop dies when a rank of its world does: that is a
                # crashed replica, whose accepted work the router replays, never fails.
                print(f"[replica] the serving loop died with a rank of the world "
                      f"({e!r}); exiting 1", flush=True)
                os._exit(1)
            try:
                _send(out, {"op": "error", "id": rid,
                            "error": "failed", "message": str(e)})
            except OSError:
                pass
            return
        try:
            _send(out, {
                "op": "done", "id": rid,
                "tokens": [int(t) for t in comp.tokens],
                "finish": comp.finish, "prompt_len": comp.prompt_len,
                "new_tokens": comp.new_tokens,
                "queue_wait_s": comp.queue_wait_s, "ttft_s": comp.ttft_s,
                "tpot_s": comp.tpot_s, "e2e_s": comp.e2e_s,
            })
        except OSError:
            pass                             # router gone; it will redispatch

    with out.lock:
        out.pending_futures[rid] = fut
    fut.add_done_callback(_done)


def _stats_payload(engine, server, handoff=None) -> dict:
    eng: dict = {"steps": engine.steps}
    for name in ("prefill_tokens", "prefill_invocations", "slot_occupancy",
                 "generated_tokens", "preemptions", "resumes"):
        if hasattr(engine, name):
            eng[name] = getattr(engine, name)
    if hasattr(engine, "spec_stats"):
        # Speculative-decoding ledger (None with spec off): the router folds
        # accepted-tokens/step into fleet_snapshot and router_summary.
        eng["spec"] = engine.spec_stats()
    cache = getattr(engine, "prefix_cache", None)
    eng["prefix_cache"] = cache.stats() if cache is not None else None
    if hasattr(engine, "byte_accounting"):
        # Measured bytes/token for the router's fleet_snapshot timeline.
        eng["bytes"] = engine.byte_accounting()
    if hasattr(engine, "page_stats"):
        # Paged-KV pool ledger (None on contiguous engines): the router folds
        # free/in_use/refusals into fleet_snapshot, fleet_top renders a column.
        eng["kv_pages"] = engine.page_stats()
    if hasattr(engine, "rank_counters"):
        # A sharded replica: every rank's B6 launches and decode steps (the bytes' per_chip
        # rows are each rank's resident bytes).
        eng["ranks"] = engine.rank_counters()
    out = {"engine": eng,
           "queue": (server.queue.snapshot()
                     if hasattr(server, "queue") else None)}
    if hasattr(server, "latency_histograms"):
        # The replica-local latency sketches (obs/hist.py) ride the stats
        # protocol as plain JSON; the router MERGES them fleet-wide — the
        # bounded-memory replacement for shipping per-request series.
        out["latency_hist"] = server.latency_histograms()
    if hasattr(server, "slo_summary"):
        slo = server.slo_summary()
        if slo is not None:
            out["slo"] = slo
    if hasattr(server, "tenant_summaries"):
        tenants = server.tenant_summaries()
        if tenants:
            # Per-tenant replica-local ledgers (counts + windowed attainment):
            # the router folds these into fleet_snapshot's tenants section —
            # what an SLO-driven autoscaler and fleet_top read per tier.
            out["tenants"] = tenants
    if handoff is not None:
        # Tiered-serving ledger (decode tier: received; prefill tier: shipped): the
        # router folds these into fleet_snapshot per tier.
        out["handoff"] = handoff.snapshot()
    return out


class _HandoffState:
    """The tiered replica's KV-handoff ledger and (decode tier) listener port.

    The listener is a port of its own: the main protocol socket is a one-connection
    ``listen(1)`` owned by the router, so plane bytes ride a second, always-framed socket
    replica to replica; the router learns the port from the hello and never sees a plane
    byte. The counters are lock-guarded: handler threads race the stats op."""

    def __init__(self):
        self.lock = threading.Lock()
        self.port = 0
        self.received = 0
        self.shipped = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.crc_failures = 0
        self.layout_rejects = 0

    def snapshot(self) -> dict:
        with self.lock:
            return {"port": self.port, "received": self.received,
                    "shipped": self.shipped, "bytes_in": self.bytes_in,
                    "bytes_out": self.bytes_out,
                    "crc_failures": self.crc_failures,
                    "layout_rejects": self.layout_rejects}


def _planes_to_device(planes: dict, device) -> dict:
    """Decoded (CPU) planes onto the engine's device, off the engine's thread: on a card
    the copies run on a side stream that is waited for before this returns, and each
    tensor is marked as used by the default stream (the engine's), so the entry is
    complete before the engine can hit it and its memory is not reused under a pending
    install."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return planes
    side = torch.cuda.Stream(device=device)
    engine_stream = torch.cuda.default_stream(device)
    with torch.cuda.stream(side):
        moved = {name: {key: t.to(device) for key, t in layer.items()}
                 for name, layer in planes.items()}
    side.synchronize()
    for layer in moved.values():
        for t in layer.values():
            t.record_stream(engine_stream)
    return moved


def _start_handoff_listener(args, engine, state: _HandoffState,
                            stop_flag: threading.Event) -> int:
    """Bind the handoff listener (port 0 = ephemeral; the port rides the hello) and serve
    one framed ``kv_handoff`` per connection: verify CRC and layout, copy the planes to
    the engine's device, insert them into the engine's prefix cache (the decode engine's
    next admission of that prompt is a full-prefix hit), ack, close. An echo replica (no
    prefix cache) counts and acks only."""
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", int(getattr(args, "handoff_port", 0) or 0)))
    lsock.listen(4)
    lsock.settimeout(0.5)
    port = lsock.getsockname()[1]
    with state.lock:
        state.port = port

    def _one(conn):
        rid = None
        try:
            conn.settimeout(10.0)
            msg = tiers_mod.read_handoff(conn)
            if msg is None:
                return
            rid = msg.get("id")
            tokens = np.asarray(msg.get("tokens") or [], np.int32)
            cache = getattr(engine, "prefix_cache", None)
            nbytes = int(msg.get("bytes") or 0)
            if cache is not None and len(tokens):
                layout = getattr(engine, "plane_layout", None)
                try:
                    planes = tiers_mod.decode_planes(msg, layout=layout)
                except WireCorrupt as e:
                    with state.lock:
                        state.crc_failures += 1
                    tiers_mod.send_ack(conn, request_id=rid, ok=False,
                                       reason=f"crc: {e}")
                    return
                except ValueError as e:
                    with state.lock:
                        state.layout_rejects += 1
                    tiers_mod.send_ack(conn, request_id=rid, ok=False,
                                       reason=f"layout: {e}")
                    return
                # the whole entry is on the device before the (lock-guarded) insert
                cache.insert(tokens, _planes_to_device(planes, engine.device),
                             layout=layout)
            with state.lock:
                state.received += 1
                state.bytes_in += nbytes
            tiers_mod.send_ack(conn, request_id=rid, ok=True, nbytes=nbytes)
        except (OSError, WireCorrupt) as e:
            # A torn connection mid-handoff: no ack leaves, the prefill side reports
            # prefill_failed, the router falls back to local prefill.
            with state.lock:
                state.crc_failures += isinstance(e, WireCorrupt)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _loop():
        while not stop_flag.is_set():
            try:
                conn, _ = lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=_one, args=(conn,), daemon=True,
                             name="handoff-recv").start()
        try:
            lsock.close()
        except OSError:
            pass

    threading.Thread(target=_loop, daemon=True, name="handoff-listen").start()
    return port


def _handle_prefill(msg, args, engine, server, out: _WireOut,
                    state: _HandoffState):
    """The prefill-tier op: prefill the prompt here (one generated token, the admission
    that fills the prefix cache), look its planes up, ship them to the decode replica
    named in ``msg["handoff"]``, and report ``prefill_done`` (the router then dispatches
    the request to that replica as a full-prefix hit) or ``prefill_failed`` (the router
    falls back to local prefill: disaggregation is an optimization, never a
    dependency)."""
    rid = msg["id"]
    prompt = np.asarray(msg.get("prompt") or [], np.int32)
    target = msg.get("handoff") or {}
    host = target.get("host", "127.0.0.1")
    port = int(target.get("port") or 0)

    def _fail(reason):
        try:
            _send(out, {"op": "prefill_failed", "id": rid, "reason": reason})
        except OSError:
            pass

    if not len(prompt) or not port:
        _fail("bad_prefill_op")
        return

    def _ship(ttft_s):
        # A worker thread: the cache lookup is lock-safe, the planes come to the host
        # here, and the socket must never block the decode loop.
        t0 = time.monotonic()
        try:
            if args.echo:
                payload = tiers_mod.encode_planes({"echo": prompt})
            else:
                cache = getattr(engine, "prefix_cache", None)
                layout = getattr(engine, "plane_layout", None)
                hit, planes = (0, None)
                if cache is not None:
                    hit, planes = cache.lookup(prompt, min_len=1, layout=layout)
                if planes is None or hit < len(prompt):
                    _fail("no_planes")
                    return
                payload = tiers_mod.encode_planes(planes, layout=layout)
            ack = tiers_mod.ship_planes(host, port, request_id=rid,
                                        tokens=prompt, payload=payload,
                                        timeout_s=args.handoff_timeout_s)
        except (OSError, WireCorrupt) as e:
            _fail(f"ship: {e}")
            return
        if not ack.get("ok"):
            _fail(f"nack: {ack.get('reason', 'rejected')}")
            return
        wall = time.monotonic() - t0
        with state.lock:
            state.shipped += 1
            state.bytes_out += int(payload["bytes"])
        try:
            _send(out, {"op": "prefill_done", "id": rid,
                        "prompt_len": int(len(prompt)),
                        "handoff_bytes": int(payload["bytes"]),
                        "handoff_wall_s": round(wall, 6),
                        "ttft_s": ttft_s})
        except OSError:
            pass

    if args.echo:
        try:
            server.begin_request()
        except QueueClosed:
            _send(out, {"op": "error", "id": rid, "error": "draining",
                        "message": "echo replica draining"})
            return

        def _echo_job():
            try:
                _tokens, ttft = server.complete(
                    prompt, 1, trace_id=msg.get("trace_id"), request_id=rid)
                _ship(ttft)
            finally:
                server.end_request()

        threading.Thread(target=_echo_job, daemon=True,
                         name="prefill-echo").start()
        return
    try:
        fut = server.submit(prompt, max_new_tokens=1,
                            trace_id=msg.get("trace_id"),
                            tenant=msg.get("tenant", "default"),
                            priority=msg.get("priority"),
                            preemptible=msg.get("preemptible"))
    except QueueFull:
        _send(out, {"op": "error", "id": rid, "error": "queue_full",
                    "message": "replica queue at capacity"})
        return
    except QueueClosed:
        _send(out, {"op": "error", "id": rid, "error": "draining",
                    "message": "replica draining (retire/reload)"})
        return
    except (QuotaExceeded, Shed, ValueError) as e:
        _fail(f"admit: {e}")
        return

    def _done(f):
        try:
            comp = f.result()
        except BaseException as e:           # server died mid-prefill
            _fail(f"prefill: {e}")
            return
        threading.Thread(target=_ship, args=(comp.ttft_s,), daemon=True,
                         name="handoff-ship").start()

    fut.add_done_callback(_done)


def _follow_forever(args, engine, handler) -> int:
    """A follower rank of a sharded replica: replay rank 0's engine calls until it
    closes (returns 0), exit 75 on SIGTERM (also when rank 0, on the same signal, went
    first), return 1 when rank 0 is gone otherwise. The replay runs on a thread, so this
    main thread runs the signal handler promptly."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        shard as shard_mod,
    )

    failed: list[BaseException] = []

    def _run():
        try:
            shard_mod.follow(engine)
        except BaseException as e:          # noqa: BLE001 — the leader died mid-call
            failed.append(e)

    t = threading.Thread(target=_run, daemon=True, name="replica-follow")
    t.start()
    while t.is_alive():
        if handler.requested:
            os._exit(EXIT_PREEMPTED)
        t.join(0.5)
    if handler.requested:        # the world's SIGTERM ended rank 0 first
        os._exit(EXIT_PREEMPTED)
    if failed:
        print(f"[replica {args.replica_id} rank {os.environ.get('RANK')}] the world's "
              f"rank 0 is gone ({failed[0]!r}); exiting 1", flush=True)
        return 1
    return 0


def _close_world(leader, replica_id: int) -> dict:
    """A sharded replica's end: the closing replica check over every rank (raises when a
    rank parted), then the followers' loops end."""
    check = leader.closing_check()
    leader.close()
    ranks = ", ".join(f"rank {r['rank']}: {r['b6_launches']} B6 launches, {r['steps']} "
                      f"steps, {check['per_chip'][str(r['rank'])]['total_bytes']} B"
                      for r in check["ranks"])
    print(f"[replica {replica_id}] replica check passed ({ranks})", flush=True)
    return check


def serve_forever(args) -> int:
    """The replica process: build (or echo), listen on ``127.0.0.1:args.port``, serve one
    router connection at a time until ``stop`` (returns 0), ``drain`` (exits 0), SIGTERM
    (exits 75), a ``kill`` fault (its exit code) or a dead serving loop (exits 1). Under
    ``--shard`` every rank of the world calls it; the ranks after 0 follow."""
    replica_id = args.replica_id
    faults.set_process_index(replica_id)     # ``proc=`` and ``flag`` match the replica id
    handler = PreemptionHandler().install()
    leader = None                            # a sharded replica's MeshLeader (rank 0)
    tp, dp = tiers_mod.parse_shard_spec(getattr(args, "shard", ""))
    if not args.echo and tp * dp > 1:
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
            initialize_cluster,
        )

        initialize_cluster(args.device)      # the world's group; it ends with the process
        if int(os.environ.get("RANK", "0")) != 0:
            engine, _ = build_engine_server(args)
            return _follow_forever(args, engine, handler)

    # This process's span track (``--trace`` empty = everything below is a
    # no-op): one file per replica, appended across restarts — a crashed
    # generation's spans survive it, tearing at most its own final line.
    tracer = Tracer(args.trace, proc=f"replica{replica_id}")
    if args.echo:
        engine = server = _EchoServer(args, tracer if tracer.enabled else None)
    else:
        engine, server = build_engine_server(args, trace=tracer)
        # the serve-path resilience tick: kill/preempt/stall faults fire between decode
        # steps, with requests in flight
        engine.on_step = lambda step: faults.on_tick(step=step)
        if engine.mesh is not None:
            leader = server.engine
        server.start()
    front = leader if leader is not None else engine     # what ``stats`` reads

    beat = hb.HeartbeatWriter(args.heartbeat_dir,
                              process_index=replica_id) if args.heartbeat_dir \
        else None
    stop_flag = threading.Event()

    # A decode replica opens its handoff listener BEFORE the hello, so the port it
    # advertises is live the moment the router reads it.
    tier = getattr(args, "tier", tiers_mod.ROLE_UNIFIED)
    handoff = _HandoffState()
    handoff_port = 0
    if tier == tiers_mod.ROLE_DECODE:
        handoff_port = _start_handoff_listener(args, engine, handoff, stop_flag)

    def _ticker():
        # Liveness + preemption watch. A `freeze` fault silences the beat while
        # the process keeps running — the "hung, not slow" replica the router's
        # staleness drain exists for.
        while not stop_flag.is_set():
            if not args.echo and getattr(server, "_error", None) is not None:
                # The serving loop died (engine raised): its accepted futures
                # were already failed and the queue closed, but the PROCESS
                # would otherwise live on — fresh heartbeats, open connection —
                # an undetectable zombie that bounces every new dispatch.
                # Exit nonzero so the router classifies a crash, drains the
                # ledger, and restarts a working replica.
                print(f"[replica {replica_id}] serving loop died: "
                      f"{server._error!r}; exiting for restart", flush=True)
                os._exit(1)
            step = int(engine.steps)
            # a rank that hangs holds rank 0 inside one mesh call: no beat then, so the
            # router's heartbeat timeout ends the world rather than a collective's own
            stuck = leader is not None and leader.busy_s > MESH_CALL_STUCK_S
            if beat is not None and not faults.heartbeat_frozen(step=step) and not stuck:
                beat.beat(step=step, epoch=0)
            if handler.requested:
                # Preemption exits WITHOUT resolving in-flight work: expiring
                # it here would flush client-visible finish="timeout" done
                # lines, which the router settles for good BEFORE it ever sees
                # the exit code — preempted requests would surface as timeouts
                # instead of being drained and replayed. Leaving the ledger
                # untouched makes preempt behave like any other death: the
                # work looks undelivered, the router's exit-75 classification
                # requeues it, and greedy replay is token-identical.
                os._exit(EXIT_PREEMPTED)
            time.sleep(args.heartbeat_interval_s)

    threading.Thread(target=_ticker, daemon=True, name="replica-tick").start()

    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", args.port))
    lsock.listen(1)
    # Every blocking point in the MAIN thread carries a short timeout: a signal
    # raised from a worker thread (the preempt fault's os.kill-to-self) only
    # runs its Python-level handler when the main thread executes bytecode, and
    # a main thread parked forever in accept()/recv() never does — the
    # preemption latch would sit unprocessed until the next message arrived.
    lsock.settimeout(0.5)
    print(f"[replica {replica_id}] listening on 127.0.0.1:{args.port} "
          f"(pid {os.getpid()}, echo={bool(args.echo)})", flush=True)

    def _handle(msg, out: _WireOut) -> bool:
        """One protocol message; returns False when the replica should stop."""
        op = msg.get("op")
        if op == "submit":
            if args.echo:
                # Validate BEFORE the worker thread exists: a malformed
                # submit must produce the typed `invalid` reply from the
                # handler (the caller wraps us), never an uncaught KeyError
                # in a detached thread.
                rid, max_new = msg["id"], int(msg["max_new_tokens"])
                try:
                    server.begin_request()       # draining => bounce, not accept
                except QueueClosed:
                    _send(out, {"op": "error", "id": rid,
                                "error": "draining",
                                "message": "echo replica draining"})
                    return True

                def _echo_job(m=msg, max_new=max_new):
                    prompt = np.asarray(m.get("prompt") or [], np.int32)
                    t0 = time.monotonic()
                    # The done line must hit the wire BEFORE end_request()
                    # releases the gate: drain() wakes the instant in-flight
                    # reaches 0, and the drained ack overtaking the last done
                    # line would make the router retire with this request
                    # still in its ledger (straggler redispatch + duplicate).
                    try:
                        tokens, ttft = server.complete(
                            prompt, max_new, trace_id=m.get("trace_id"),
                            request_id=m["id"])
                        with out.lock:
                            cancelled = (m["id"] in out.cancelled
                                         and (out.cancelled.discard(m["id"])
                                              or True))
                        if cancelled:
                            return           # hedge lost: reply suppressed
                        try:
                            _send(out, {
                                "op": "done", "id": m["id"],
                                "tokens": [int(t) for t in tokens],
                                "finish": "ok", "prompt_len": len(prompt),
                                "new_tokens": len(tokens) - len(prompt),
                                "ttft_s": ttft,
                                "e2e_s": time.monotonic() - t0,
                            })
                        except OSError:
                            pass
                    finally:
                        server.end_request()
                threading.Thread(target=_echo_job, daemon=True).start()
            else:
                _handle_submit(msg, server, out, sharded=leader is not None)
        elif op == "cancel":
            # Hedge-loser stand-down: the router resolved this id on a peer.
            # Still queued here -> abort outright (frees the slot); already
            # decoding -> let it finish but suppress the reply (the marker).
            rid = msg.get("id")
            if rid is not None:
                with out.lock:
                    fut = out.pending_futures.get(rid)
                    out.cancelled.add(rid)
                if fut is not None:
                    fut.cancel()         # only wins while it is still queued
        elif op == "prefill":
            # Prefill-tier dispatch: prefill here, ship the planes to the decode
            # replica the router named, report prefill_done/failed.
            _handle_prefill(msg, args, engine, server, out, handoff)
        elif op == "stats":
            _send(out, {"op": "stats", "id": msg.get("id"),
                        **_stats_payload(
                            front, server,
                            handoff if tier != tiers_mod.ROLE_UNIFIED else None)})
        elif op == "warm":
            # Prefix-cache warm-start (scale-up/reload): replay the fleet's
            # hot prefixes through prefill BEFORE taking traffic — one
            # generated token each, which is what populates the prefix cache
            # (planes are a pure function of tokens and params, so replay
            # re-derives the retired/peer replica's paid-for state). The
            # router keeps this replica in ``warming`` until the ack, so the
            # replay never competes with real requests.
            def _warm_job(m=msg):
                prompts = m.get("prompts") or []
                count = 0
                if args.echo:
                    count = len(prompts)         # protocol parity, no cache
                else:
                    # One at a time: a burst would bounce off this replica's
                    # OWN max_pending backpressure and silently skip prefixes
                    # (the whole point is that every shipped prefix lands).
                    for ptoks in prompts:
                        arr = np.asarray(ptoks, np.int32)
                        if not 0 < len(arr) < args.seq_len:
                            continue
                        try:
                            # traced=False: the replay must not mint trace
                            # trees (it is fleet setup, not traffic).
                            f = server.submit(arr, max_new_tokens=1,
                                              traced=False)
                            count += bool(f.result(timeout=120).ok)
                        except Exception:        # full/closed/invalid: skip
                            continue
                    cache = getattr(engine, "prefix_cache", None)
                    if cache is not None:
                        # The replay's compulsory misses are setup cost, not
                        # traffic: the post-ready hit rate must measure what
                        # the fleet actually served (the warm-vs-cold A/B
                        # reads it). Counters only — the warmed ENTRIES are
                        # the whole point and must survive.
                        cache.queries = cache.hits = cache.hit_tokens = 0
                try:
                    _send(out, {"op": "warm_done", "id": m.get("id"),
                                "count": count, "prompts": prompts})
                except OSError:
                    pass
            threading.Thread(target=_warm_job, daemon=True,
                             name="replica-warm").start()
        elif op == "drain":
            # Graceful retire/reload: refuse new work (submits racing this op
            # bounce as ``error: draining``), finish everything accepted —
            # every done line is flushed before the ack — then exit 0. The
            # ack-then-exit order lets the router retire this replica without
            # classifying the exit as a crash.
            def _drain_job(m=msg):
                ack = {"op": "drained", "id": m.get("id")}
                if args.echo:
                    server.drain()
                    tracer.close()
                else:
                    server.stop(drain=True)      # blocks until the loop exits;
                                                 # closes telemetry + tracer
                    if leader is not None:
                        try:
                            ack["ranks"] = _close_world(leader, replica_id)["ranks"]
                        except Exception as e:   # noqa: BLE001 — a desync fails the exit
                            print(f"[replica {replica_id}] replica check failed: {e!r}",
                                  flush=True)
                            os._exit(1)
                ack["steps"] = int(engine.steps)
                try:
                    _send(out, ack)
                except OSError:
                    pass
                print(f"[replica {replica_id}] drained; exiting 0", flush=True)
                os._exit(0)
            threading.Thread(target=_drain_job, daemon=True,
                             name="replica-drain").start()
        elif op == "stop":
            return False
        return True

    idle_timeout = float(getattr(args, "wire_idle_timeout_s", 0.0) or 0.0)

    while True:
        try:
            conn, _ = lsock.accept()
        except socket.timeout:
            continue                # wakeup: pending signal handlers run here
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(0.5)
        # Writes ride a dup'd blocking handle: the read timeout above must not
        # turn a momentarily full send buffer into a dropped completion.
        wsock = conn.dup()
        wsock.settimeout(None)
        out = _WireOut(wsock.makefile("wb"))
        # The hello is ALWAYS newline JSON — the negotiation anchor a legacy
        # router parses unchanged. ``caps`` advertises what this replica can
        # speak; only a hello_ack echoing a capability switches modes.
        hello = {"op": "hello", "replica": replica_id,
                 "num_slots": args.num_slots,
                 "max_pending": args.max_pending,
                 "pid": os.getpid(), "caps": [CAP_FRAMED]}
        # Tier fields appear only on tiered replicas: an untiered fleet's hello is
        # unchanged.
        if tier != tiers_mod.ROLE_UNIFIED:
            hello["tier"] = tier
            if handoff_port:
                hello["handoff_port"] = handoff_port
        _send(out, hello)
        # Mode is decided by the FIRST router message: until its newline
        # arrives, bytes accumulate RAW (feeding them to a line splitter
        # would mangle frames that share the chunk — frame payloads may
        # contain 0x0A). A hello_ack carrying the framed capability flips
        # both directions to frames and the remainder of the buffer is fed to
        # the frame decoder; anything else is a legacy router: the first line
        # is handled as a normal message and the wire stays newline JSON.
        raw_buf = b""
        decoder: LineDecoder | FrameDecoder | None = None
        got_msg = False
        last_progress = time.monotonic()
        try:
            while True:
                try:
                    chunk = conn.recv(1 << 16)
                except socket.timeout:
                    # Recv/idle deadline: a peer that never sent a complete
                    # message, or has half a message stuck in the buffer,
                    # is stalling — free the handler slot instead of wedging
                    # it (the accept loop serves one connection at a time).
                    # A peer with an EMPTY buffer that already spoke is a
                    # legitimately idle router and never times out.
                    pending = (len(raw_buf) if decoder is None
                               else decoder.pending)
                    if (idle_timeout > 0
                            and (not got_msg or pending)
                            and time.monotonic() - last_progress
                            > idle_timeout):
                        how = ("stalled mid-message" if pending
                               else "sent nothing")
                        print(f"[replica {replica_id}] wire idle timeout: "
                              f"peer {how} for {idle_timeout:.1f}s; "
                              f"disconnecting", flush=True)
                        break
                    continue        # wakeup: pending signal handlers run here
                if not chunk:
                    break           # router disconnected
                msgs: list[bytes] = []
                if decoder is None:
                    raw_buf += chunk
                    line, sep, rest = raw_buf.partition(b"\n")
                    if not sep:
                        continue    # first message still incomplete
                    raw_buf = b""
                    first = None
                    try:
                        first = json.loads(line) if line else None
                    except ValueError:
                        pass        # garbage first line: legacy path below
                    if (isinstance(first, dict)
                            and first.get("op") == "hello_ack"
                            and CAP_FRAMED in (first.get("caps") or [])):
                        out.framed = True
                        decoder = FrameDecoder()
                        print(f"[replica {replica_id}] wire: framed "
                              f"({CAP_FRAMED})", flush=True)
                        got_msg = True
                        chunk = rest        # frames from here on
                    else:
                        decoder = LineDecoder()
                        if isinstance(first, dict) \
                                and first.get("op") == "hello_ack":
                            chunk = rest    # ack without a cap we speak: eat it
                        else:
                            # A legacy router's first op (or a garbage line):
                            # process it through the common path below.
                            chunk = (line + b"\n" + rest) if line else rest
                try:
                    msgs.extend(decoder.feed(chunk))
                except WireCorrupt as e:
                    # Framed mode: typed damage. The stream position is
                    # untrustworthy — reject and drop the connection; the
                    # router reconnects and its ledger drain replays.
                    print(f"[replica {replica_id}] wire corrupt: {e}; "
                          f"disconnecting for reconnect", flush=True)
                    break
                if msgs:
                    last_progress = time.monotonic()
                stop_now = False
                for raw in msgs:
                    got_msg = True
                    try:
                        msg = json.loads(raw)
                        if not isinstance(msg, dict):
                            raise ValueError("non-object message")
                    except ValueError as e:
                        # A damaged line. Legacy newline mode self-syncs on
                        # the next newline, so reply typed and keep serving;
                        # the router treats wire_corrupt as a connection-
                        # level fault and reconnects (draining its ledger —
                        # whatever this line was gets replayed).
                        print(f"[replica {replica_id}] wire corrupt: "
                              f"unparseable line ({e})", flush=True)
                        try:
                            _send(out, {"op": "error", "id": None,
                                        "error": "wire_corrupt",
                                        "message": f"unparseable line: {e}"})
                        except OSError:
                            pass
                        continue
                    try:
                        keep = _handle(msg, out)
                    except Exception as e:  # noqa: BLE001 — typed, not a death
                        # A parseable but malformed op (garbage submit with a
                        # missing field, wrong types): typed refusal, never a
                        # stack-trace death of the handler.
                        print(f"[replica {replica_id}] malformed "
                              f"{msg.get('op')!r} op: {e!r}", flush=True)
                        try:
                            _send(out, {"op": "error", "id": msg.get("id"),
                                        "error": "invalid",
                                        "message": f"malformed "
                                                   f"{msg.get('op')!r} op: "
                                                   f"{e}"})
                        except OSError:
                            pass
                        continue
                    if not keep:
                        stop_now = True
                        break
                if stop_now:
                    stop_flag.set()
                    if not args.echo:
                        server.stop(drain=True)   # loop closes the tracer
                        if leader is not None:
                            try:
                                _close_world(leader, replica_id)
                            except Exception as e:   # noqa: BLE001 — fails the exit
                                print(f"[replica {replica_id}] replica check failed: "
                                      f"{e!r}", flush=True)
                                return 1
                    else:
                        tracer.close()
                    return 0
        except OSError:
            pass
        finally:
            for f in (out.wfile, wsock, conn):
                try:
                    f.close()
                except OSError:
                    pass
        # Router disconnected (e.g. it restarted): keep serving — accepted work
        # drains, and the next accept() hands the fresh router a hello.


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--replica-id", type=int, default=0)
    p.add_argument("--heartbeat-dir", default="")
    p.add_argument("--heartbeat-interval-s", type=float, default=0.2)
    p.add_argument("--echo", action="store_true",
                   help="deterministic tokens, no model and no torch: the router's tests")
    p.add_argument("--echo-delay-s", type=float, default=0.0,
                   help="echo mode: per-token sleep, keeps work in flight")
    m = p.add_argument_group("model (mirrors serve_loadgen)")
    m.add_argument("--checkpoint", default="")
    m.add_argument("--seq-len", type=int, default=784)
    m.add_argument("--num-levels", type=int, default=16)
    m.add_argument("--embed-dim", type=int, default=64)
    m.add_argument("--num-layers", type=int, default=2)
    m.add_argument("--num-heads", type=int, default=4)
    m.add_argument("--kv-heads", type=int, default=0)
    m.add_argument("--attention-window", type=int, default=0)
    m.add_argument("--rope", action="store_true")
    m.add_argument("--seed", type=int, default=0)
    e = p.add_argument_group("engine/server")
    e.add_argument("--device", default="cuda",
                   help="the engine's device: cuda (the default; raises without a card) "
                        "or cpu")
    e.add_argument("--num-slots", type=int, default=8)
    e.add_argument("--max-pending", type=int, default=128)
    e.add_argument("--timeout-s", type=float, default=0.0)
    e.add_argument("--prefill-chunks", default="32,128,512")
    e.add_argument("--prefill-budget", type=int, default=1)
    e.add_argument("--prefix-cache", type=int, default=0)
    e.add_argument("--prefix-cache-bytes", type=int, default=0,
                   help="measured-byte budget for the prefix cache on top of "
                        "the entry count (0 = entry-count LRU only)")
    e.add_argument("--kv-layout", default="contiguous",
                   choices=("contiguous", "paged"),
                   help="KV store layout: 'paged' decouples slot count from "
                        "max context via a fixed page pool (DESIGN.md §27)")
    e.add_argument("--page-size", type=int, default=64,
                   help="paged layout: tokens per KV page")
    e.add_argument("--num-pages", type=int, default=0,
                   help="paged layout: pool size in pages (0 = capacity "
                        "parity with the contiguous cache)")
    e.add_argument("--kv-dtype", default="model",
                   choices=("model", "fp32", "bf16", "int8", "fp8"))
    e.add_argument("--quant-policy", default="off",
                   choices=("off", "w8", "w8a8"))
    e.add_argument("--spec", default="off",
                   choices=("off", "ngram", "draft-lm"),
                   help="speculative decoding: 'ngram' = host n-gram/prompt-"
                        "lookup self-speculation (free), 'draft-lm' = a small "
                        "draft LM sharing the tokenizer")
    e.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens per verify step (the verify program's "
                        "static width is spec_k + 1)")
    e.add_argument("--draft-layers", type=int, default=1)
    e.add_argument("--draft-embed-dim", type=int, default=0,
                   help="draft LM embed dim (0 = half the target's)")
    e.add_argument("--draft-heads", type=int, default=0,
                   help="draft LM heads (0 = the target's)")
    e.add_argument("--draft-checkpoint", default="",
                   help="trained draft-LM params (default: seeded init)")
    e.add_argument("--warmup", type=int, default=1,
                   help="run every prefill chunk size, the prefix-cache hit path "
                        "and a decode once before accepting traffic, then reset the "
                        "counters (0 = off)")
    e.add_argument("--slo", default="",
                   help="replica-local SLO spec, e.g. 'ttft=0.5,e2e=2.0,"
                        "window=30' (obs/slo.py) — attainment lands in the "
                        "serve_summary and the 'slo' drain event; empty = "
                        "no promise")
    e.add_argument("--tenants", default="",
                   help="tenant service classes, e.g. 'paid:w=4,prio=2,"
                        "slo=ttft:0.3;free:w=1,preempt=1,rate=50' "
                        "(serving/scheduler.py grammar) — activates per-"
                        "tenant quotas, weighted-fair dequeue, slot caps, "
                        "and priority preemption in this replica's server; "
                        "empty = single implicit tenant")
    t = p.add_argument_group("tiered / sharded serving")
    t.add_argument("--tier", default=tiers_mod.ROLE_UNIFIED,
                   choices=tiers_mod.ROLES,
                   help="replica role: 'prefill' serves only prefill ops and "
                        "ships finished KV planes; 'decode' runs a handoff "
                        "listener and serves decode traffic; 'unified' "
                        "(default) is the classic do-everything replica")
    t.add_argument("--handoff-port", type=int, default=0,
                   help="decode tier: the KV-handoff listener port (0 = "
                        "ephemeral; the actual port rides the hello)")
    t.add_argument("--handoff-timeout-s", type=float, default=10.0,
                   help="prefill tier: per-handoff connect/ack deadline — a "
                        "dead decode peer becomes prefill_failed (router "
                        "falls back to local prefill), never a hang")
    t.add_argument("--shard", default="",
                   help="in-replica serve mesh, e.g. 'tp=2,dp=2': the replica is a "
                        "world of tp*dp processes running this command (train.launch; "
                        "the router spawns it so), rank 0 serving the protocol over "
                        "the sharded engine (serving/shard.py)")
    p.add_argument("--wire-idle-timeout-s", type=float, default=120.0,
                   help="disconnect a peer that connected but never sent a "
                        "complete message, or stalled mid-message, for this "
                        "long — a stalling client must not wedge the handler "
                        "slot (0 = no deadline; a quiet peer that already "
                        "spoke complete messages never times out). Note: a "
                        "framed-wire router speaks immediately (hello_ack), "
                        "so only a LEGACY-mode router with a fully idle "
                        "fleet trips this — a benign empty-ledger reconnect "
                        "every interval, the price of the stall protection")
    p.add_argument("--telemetry", default="",
                   help="this replica's own serve JSONL (optional)")
    p.add_argument("--trace", default="",
                   help="distributed-tracing span JSONL for THIS replica "
                        "(a router appends one per replica under its "
                        "--trace-dir); empty = tracing off")
    args = p.parse_args(argv)
    if args.shard:
        if args.echo:
            p.error("--shard needs a real engine (echo replicas build no mesh)")
        if args.tier != tiers_mod.ROLE_UNIFIED:
            p.error("--shard with --tier: the KV handoff installs planes on one rank; "
                    "run sharded replicas unified")
        try:
            tiers_mod.parse_shard_spec(args.shard)
        except ValueError as exc:
            p.error(str(exc))
    if not args.echo:
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
            resolve_device,
        )

        args.device = str(resolve_device(args.device))   # fail fast: no card, no cuda
    return serve_forever(args)


if __name__ == "__main__":
    code = main()
    # No interpreter teardown: the ticker and a hedge's io threads may still be live, and
    # torch's runtime can abort ("terminate called without an active exception") when the
    # interpreter finalizes under a live thread. Everything durable is flushed by now.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
