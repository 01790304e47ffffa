"""Fleet front door: shard traffic across N replica processes, and survive them.

The port's counterpart of the JAX package's ``serving/router.py``, with its API,
lifecycle, wire and telemetry. ``Server`` is one engine on one card; this router runs N
independent ``serving/replica.py`` processes of the port — each a whole engine and
server, spawned and supervised through ``train.launch.Fleet(num_processes=1,
process_id_base=i)`` so replicas crash and restart *individually* — behind one
``submit() -> Future`` door. A replica whose command carries ``--shard tp=T,dp=D`` is a
world of ``T*D`` ranks (``Fleet(num_processes=T*D, whole=True)``): one replica to
everything below, dying and restarting whole. Failure is an input:

- **at-least-once delivery** — every dispatched request stays in the router's
  per-replica in-flight ledger until its completion line arrives. A replica
  crash (process exit), preemption (exit 75), or hang (heartbeat staleness,
  ``resilience/heartbeat.py``) drains that ledger back into the FRONT of the
  router queue and redispatches elsewhere. Safe because greedy decode is
  idempotent: replay on a fresh engine is token-identical (argmax consults no
  RNG; on the card the replicas run the same kernels at the same shapes). A
  "dead" replica that was merely slow may still deliver; the first completion
  wins, later duplicates are counted and dropped.
- **prefix-affinity routing** — requests sharing a prompt prefix are routed to
  the replica whose ``prefix_cache`` already holds it (longest-common-prefix
  over a bounded LRU of recently dispatched prompts, the same matching rule as
  the cache itself), with load-based spill-over: a hot prefix never starves —
  when the affine replica is at capacity the request goes to the least-loaded
  one instead, and the index learns the new home.
- **admission backpressure** — each replica's capacity (``num_slots +
  max_pending``, from its hello line) caps the router's in-flight count for it:
  the router never blind-fires into a ``QueueFull`` replica. The router's own
  bounded queue raises ``QueueFull`` to submitters, and its ``snapshot()``
  (depth / oldest-age / rejected) is the fleet's load signal.
- **bounded-backoff restart** — a failed replica is restarted
  supervisor-style (exponential backoff, capped attempts). When every replica
  has exhausted its budget, outstanding work fails with ``ServerStopped``
  instead of hanging.
- **gray-failure tolerance** — a replica that is merely SLOW heartbeats as
  healthy while it poisons tail latency. Three defenses, all router-side:
  **straggler ejection** — per-replica windowed dispatch-p95 (``obs/hist.py``
  sliding sketches) against the fleet median; a replica whose p95 exceeds
  ``straggler_k``x the median flips to a ``degraded`` lifecycle state (no new
  dispatch, in-flight finishes, probed back to ``ready`` after
  ``eject_cooldown_s`` — DISTINCT from the heartbeat-staleness ``hang`` path,
  which drains and restarts the process); **hedged dispatch** — after a
  quantile-derived per-request hedge deadline, a still-pending request is
  speculatively re-dispatched to a second replica, first completion wins, the
  loser is cancelled over the wire; **wire hardening** — length+CRC framing
  negotiated via the hello's capability list (legacy newline peers
  byte-identical), with typed ``WireCorrupt`` reject-and-reconnect,
  decorrelated-jitter backoff on every restart and reconnect schedule, and an
  optional in-process chaos proxy (``resilience/netfaults.py``) between the
  router and each replica for deterministic network-fault injection.
- **runtime elasticity** — replicas move through ``starting → warming → ready →
  draining → retired`` (plus ``restarting``/``dead`` on the failure path):
  ``scale_up()`` spawns a new replica and **warm-starts** its prefix cache
  (the hottest affinity-index prefixes are shipped for replay before it is
  marked ready); ``scale_down()`` retires one **gracefully** — dispatch stops
  the instant it turns ``draining``, in-flight work finishes under a deadline,
  stragglers ride ``_drain_ledger`` redispatch (zero lost requests);
  ``reload()`` rolls a new checkpoint through the fleet one replica at a time
  on the same drain machinery, so capacity never dips below N−1 and no request
  ever mixes params; ``canary_reload``/``promote_canary``/``rollback_canary``
  qualify a checkpoint on one replica first. A
  :class:`serving.autoscaler.FleetAutoscaler` (hysteresis over the
  ``fleet_snapshot`` signal) can drive scale_up/scale_down from the snapshot loop.
- **tiers** — with ``--tier prefill``/``--tier decode`` replicas
  (``replica_extra_args``), a prompt prefills on a prefill replica, which ships its
  KV planes straight to a decode replica (``serving/tiers.py``); any fault on that
  path falls back to local prefill.

The router computes nothing on a device and imports no ``torch`` (nor the engine): it
supervises processes that own the card. Its replicas run on their own ``--device``
default, the card; ``device="cpu"`` appends ``--device cpu`` to every replica's argv,
and nothing falls back to the CPU by itself. Its telemetry goes through
``utils.jsonl.JsonlWriter`` — ``route`` (per request), ``replica`` (lifecycle),
``router_summary`` (drain aggregate), ``fleet_snapshot``, ``chaos`` — the JAX package's
JSONL schema. Load generator: ``<port>.serve_loadgen --replicas N`` (``--scenario chat``
is the workload where affinity pays).
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import os
import socket
import threading
import time

import numpy as np

from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
    heartbeat as hb,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience.netfaults import (
    ChaosProxy,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience.preemption import (
    EXIT_PREEMPTED,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.autoscaler import (
    AutoscalePolicy,
    FleetAutoscaler,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.prefix_cache import (
    common_prefix_len,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.hist import (
    LogHistogram,
    WindowedLogHistogram,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import (
    AttainmentTracker,
    SLOSpec,
    slo_event,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
    QuotaExceeded,
    RequestQueue,
    SamplingParams,
    ServerStopped,
    Shed,
    TenantTable,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.tiers import (
    parse_shard_spec,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.wire import (
    JitterBackoff,
    FrameDecoder,
    LineDecoder,
    WireCorrupt,
    encode_msg,
    hello_wants_framing,
    make_hello_ack,
    write_msg,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.launch import (
    Fleet,
    _free_port,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
    JsonlWriter,
    percentiles,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.trace import (
    Tracer,
    new_trace_id,
)


@dataclasses.dataclass
class RouterRequest:
    """One request in the router's custody. Carries the same ``arrival_s`` /
    ``deadline_s`` contract as the engine's ``Request`` so ``RequestQueue``
    queues it verbatim; ``redispatches`` counts replays after replica failures."""

    prompt: np.ndarray
    max_new_tokens: int
    sampling: SamplingParams
    request_id: int
    future: concurrent.futures.Future
    arrival_s: float
    deadline_s: float | None = None
    redispatches: int = 0
    dispatch_s: float | None = None     # last dispatch time (queue-wait split)
    affinity_hit: bool = False          # last dispatch landed on the affine replica
    trace_id: str | None = None         # distributed-tracing id (None = untraced)
    tenant: str = "default"             # service class (``scheduler.TenantTable``)
    priority: int = 0                   # shed/preempt ordering (higher = paid)
    preemptible: bool = False           # engine may park this mid-decode
    enqueued_s: float = 0.0             # last (re)entry into the router queue —
                                        # the current queue_wait span's start
    hedged: bool = False                # a speculative second copy is in flight
    hedge_replica: int | None = None    # where the hedge copy went
    # Per-replica dispatch stamps for the CURRENT hop set (primary + hedge):
    # the winning completion's dispatch span — and its latency sample — must
    # start at the WINNER's send time, not the primary's.
    dispatch_by: dict = dataclasses.field(default_factory=dict)
    # Disaggregated-serving phase marker: "prefill" while the request sits in
    # a prefill-tier replica's ledger awaiting the KV handoff; None otherwise.
    phase: str | None = None
    # Latched after any handoff-path fault (prefill rejection, ship failure,
    # mid-handoff replica death): this request falls back to classic local
    # prefill on a decode/unified replica and never re-enters the disagg path.
    no_disagg: bool = False
    disagg: bool = False                # completed via a prefill-tier handoff
    decode_target: int | None = None    # decode replica the planes shipped to


@dataclasses.dataclass
class RouterCompletion:
    """A finished request as the router saw it: the replica's token stream plus
    fleet-level accounting. Attribute-compatible with the engine's
    ``Completion`` where the load generator cares (``ok``/``finish``/``tokens``/
    ``new_tokens``/latency fields)."""

    request_id: int
    tokens: np.ndarray
    finish: str                         # "ok" | "timeout" | "shed"
    prompt_len: int
    new_tokens: int
    replica: int
    redispatches: int = 0
    affinity_hit: bool = False
    hedged: bool = False                # a hedge copy was in flight
    hedge_won: bool = False             # ...and the hedge copy resolved first
    tenant: str = "default"
    queue_wait_s: float | None = None   # router queue + replica queue
    ttft_s: float | None = None
    tpot_s: float | None = None
    e2e_s: float | None = None          # router arrival -> resolution
    disagg: bool = False                # prefilled on a prefill-tier replica

    @property
    def ok(self) -> bool:
        return self.finish == "ok"


def _shard_world(command: list[str]) -> int:
    """The processes one replica of ``command`` runs as: ``tp * dp`` of its
    ``--shard`` (the serve mesh's world), else 1."""
    spec = ""
    for i, tok in enumerate(command):
        if tok == "--shard" and i + 1 < len(command):
            spec = command[i + 1]
        elif tok.startswith("--shard="):
            spec = tok.partition("=")[2]
    tp, dp = parse_shard_spec(spec)
    return tp * dp


def _with_checkpoint(command: list[str], checkpoint: str) -> list[str]:
    """The replica argv with its ``--checkpoint`` swapped for ``checkpoint``
    (appended when the command never had one) — how ``Router.reload`` makes
    every post-roll spawn pick up the new params. Pure so tests can pin it."""
    cmd = list(command)
    for i, tok in enumerate(cmd):
        if tok == "--checkpoint" and i + 1 < len(cmd):
            cmd[i + 1] = checkpoint
            return cmd
        if tok.startswith("--checkpoint="):
            cmd[i] = f"--checkpoint={checkpoint}"
            return cmd
    return cmd + ["--checkpoint", checkpoint]


class _AffinityIndex:
    """Bounded LRU of (prompt tokens -> replica) with longest-common-prefix
    lookup — the router-side mirror of the engine's ``PrefixCache`` matching
    rule (any common prefix length is reusable; ``min_tokens`` floors a useful
    hit). Entries for a failed replica are dropped (its cache died with it);
    entries for a gracefully RETIRED replica are re-homed to a surviving one
    (``rehome``) so a hot prefix keeps one consistent home instead of
    scattering across the fleet on the next few dispatches. ``lookup`` only
    returns replicas in the caller's ``alive`` set — a ``draining`` replica
    must stop receiving traffic the instant it flips, even though its entries
    survive until the retire completes."""

    def __init__(self, capacity: int = 128, max_tokens: int = 1024):
        self.capacity = int(capacity)
        self.max_tokens = int(max_tokens)
        self._entries: collections.OrderedDict[int, tuple[np.ndarray, int]] = \
            collections.OrderedDict()
        self._next = 0

    # THE matching rule is the cache's own (one owner — drift here would break
    # the routes-to-warm-cache guarantee silently).
    _common = staticmethod(common_prefix_len)

    def lookup(self, prompt: np.ndarray, min_tokens: int,
               alive: set[int] | None = None) -> int | None:
        """Best-prefix replica among ``alive`` (None = no filter). Entries
        homed on a non-alive replica are SKIPPED, not deleted: draining is
        transient state-side (the entries are re-homed or dropped when the
        retire/failure actually lands), and a shorter match on a ready replica
        beats a longer one on a replica that cannot take the request."""
        best_key, best_len = None, 0
        for key, (tokens, rep) in self._entries.items():
            if alive is not None and rep not in alive:
                continue
            m = self._common(tokens, prompt)
            if m > best_len and (m >= min_tokens or m == len(prompt) > 0):
                best_key, best_len = key, m
        if best_key is None:
            return None
        self._entries.move_to_end(best_key)
        return self._entries[best_key][1]

    def insert(self, prompt: np.ndarray, replica: int) -> None:
        if len(prompt) == 0:
            return
        tokens = np.asarray(prompt[:self.max_tokens], np.int32).copy()
        # Covered-entry dedup, same as PrefixCache.insert: a stored prefix of
        # the new prompt can never out-match it.
        covered = [k for k, (t, _) in self._entries.items()
                   if len(t) <= len(tokens) and self._common(t, tokens) == len(t)]
        for k in covered:
            del self._entries[k]
        self._entries[self._next] = (tokens, int(replica))
        self._next += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def drop_replica(self, replica: int) -> None:
        for k in [k for k, (_, r) in self._entries.items() if r == replica]:
            del self._entries[k]

    def rehome(self, replica: int, target: int | None) -> int:
        """Reassign every entry homed on ``replica`` to ``target`` (the retire
        path: the prefix's next request routes to ONE consistent survivor,
        which prefills once and becomes the real home). ``target`` None drops
        them instead (no survivor to point at). Returns entries moved."""
        if target is None:
            self.drop_replica(replica)
            return 0
        moved = 0
        for k, (tokens, r) in list(self._entries.items()):
            if r == replica:
                self._entries[k] = (tokens, int(target))
                moved += 1
        return moved

    def hot_prefixes(self, n: int) -> list[np.ndarray]:
        """The ``n`` most-recently-used prefixes, hottest first — the
        warm-start EXPORT the router ships to a newly spawned replica. The
        planes themselves never cross a process boundary; the tokens are the
        portable half: replaying them through the fresh engine's prefill
        re-derives the planes (rows are a pure function of tokens and
        params), which is the warm-start IMPORT."""
        if n <= 0:
            return []
        return [tokens.copy()
                for tokens, _ in list(self._entries.values())[: -n - 1: -1]]


class _Replica:
    """Per-replica state: process handle, connection, in-flight ledger.

    Lifecycle: ``starting`` (spawned, connecting/compiling) → ``warming``
    (hello received, prefix-cache warm replay in flight) → ``ready`` (serving;
    the only state ``room()`` dispatches to) → ``draining`` (retire/reload in
    progress: no new dispatch, in-flight finishing) → ``retired`` (gone for
    good, slot kept for the ledger/history). Failures branch to ``restarting``
    (backoff then respawn) or ``dead`` (restart budget exhausted) — plus
    ``degraded`` (straggler ejection): alive and connected,
    in-flight allowed to finish, but no NEW dispatch until the cooldown
    probes it back to ``ready``. Degraded is deliberately not a failure
    state: the process keeps running, the ledger stays, nothing restarts.
    ``retiring`` names who owns a draining replica (``"retire"`` |
    ``"reload"``) so the failure paths can tell an expected teardown from a
    crash."""

    def __init__(self, index: int):
        self.index = index
        self.state = "starting"
        self.retiring: str | None = None
        self.drain_deadline = 0.0     # draining: stragglers redispatch at this
        self.warmed = 0               # prefixes replayed before last ready
        self.generation = 0
        self.fleet: Fleet | None = None
        self.port = 0
        self.proxy: ChaosProxy | None = None   # chaos harness: the wire detour
        self.sock: socket.socket | None = None
        self.wfile = None
        self.wlock = threading.Lock()
        self.framed = False           # negotiated wire mode (this connection)
        self.capacity: int | None = None
        self.inflight: dict[int, RouterRequest] = {}
        self.started_wall = 0.0
        self.started_mono = 0.0
        self.restart_due = 0.0
        self.restarts = 0
        self.dispatched = 0
        self.completed = 0
        self.exit_code: int | None = None
        self.stats: dict | None = None
        # Gray-failure ledgers: windowed dispatch-latency sketch (send ->
        # completion line, the router-observed number ejection scores on),
        # cumulative eject/probe/hedge counters, and the cooldown clock.
        self.lat: WindowedLogHistogram | None = None
        self.degraded_until = 0.0
        self.ejections = 0
        self.probes = 0
        self.hedges = 0               # hedge copies dispatched TO this replica
        # Disaggregated serving (serving/tiers.py): the role this replica's
        # hello declared, its direct KV-handoff listener port (decode tier
        # only), and how many handoffs it took part in (prefills shipped from
        # a prefill replica, planes received on a decode replica).
        self.tier = "unified"
        self.handoff_port: int | None = None
        self.handoffs = 0
        # Seeded decorrelated-jitter schedules (serving/wire.py): restart
        # backoff and connect-retry pacing. Distinct per-replica seeds keep a
        # fleet-wide blip from producing a synchronized restart storm.
        self.restart_backoff: JitterBackoff | None = None
        self.connect_backoff: JitterBackoff | None = None
        # Canary rollout (deploy/promoter.py): a per-replica checkpoint that
        # OVERRIDES the fleet command's --checkpoint for every spawn of this
        # replica — including monitor respawns after a crash, so a canary
        # that dies mid-window comes back on the candidate params, not on a
        # silent rollback. None = spawn on the shared fleet command.
        self.checkpoint_override: str | None = None

    def room(self) -> bool:
        # wfile gates dispatchability too: between a connection dying and the
        # io thread's teardown (which may sit out a death-classification
        # grace), the state still reads "ready" — and dispatching into a dead
        # socket spins send->fail->requeue at poll speed. The first failed
        # send clears wfile, which closes the room here.
        return (self.state == "ready" and self.wfile is not None
                and (self.capacity is None or len(self.inflight) < self.capacity))

    def send(self, obj: dict) -> None:
        """Mode-aware wire write (newline JSON or negotiated frames); raises
        ``OSError`` when the connection is gone. One owner for every
        router->replica message EXCEPT the hello_ack (sent raw by the io
        thread while still in line mode, before ``framed`` flips)."""
        wfile = self.wfile
        if wfile is None:
            raise OSError("replica connection is down")
        write_msg(wfile, self.wlock, obj, framed=self.framed)


class Router:
    """The fleet serving front door. ``replica_command`` is the python argv for
    ``serving/replica.py`` WITHOUT ``--port``/``--replica-id``/
    ``--heartbeat-dir`` (the router appends those per replica per attempt).

    ``affinity=False`` degrades routing to least-loaded (the A/B baseline);
    everything else — backpressure, redispatch, restart — is identical.

    Elasticity: ``num_replicas`` is the STARTING count, not a constant.
    ``scale_up()``/``scale_down()`` move the fleet between ``min_replicas``
    and ``max_replicas`` (``max_replicas=0`` = unbounded manual scaling);
    passing an ``autoscale`` policy makes the snapshot loop drive them from
    the ``fleet_snapshot`` load signal (requires ``snapshot_interval_s > 0``).
    ``warm_prefixes`` is how many hot affinity prefixes a newly spawned
    replica replays before it is marked ready (0 = cold starts);
    ``drain_timeout_s`` bounds how long a retiring/reloading replica may
    finish in-flight work before stragglers are redispatched.
    """

    def __init__(self, replica_command: list[str], *, num_replicas: int,
                 device: str | None = None,
                 max_pending: int = 0, default_timeout_s: float | None = None,
                 affinity: bool = True, affinity_min_tokens: int = 8,
                 affinity_entries: int = 128,
                 heartbeat_dir: str = "", heartbeat_timeout_s: float = 0.0,
                 max_restarts: int = 3, backoff_s: float = 0.5,
                 backoff_max_s: float = 10.0, connect_timeout_s: float = 240.0,
                 telemetry: str = "", poll_s: float = 0.05,
                 trace_dir: str = "", snapshot_interval_s: float = 0.0,
                 autoscale: AutoscalePolicy | None = None,
                 min_replicas: int | None = None,
                 max_replicas: int | None = None,
                 warm_prefixes: int = 8, drain_timeout_s: float = 30.0,
                 slo: SLOSpec | None = None, hist_rel_err: float = 0.01,
                 tenants: TenantTable | None = None,
                 straggler_k: float = 0.0, eject_min_samples: int = 8,
                 eject_cooldown_s: float = 5.0, eject_window_s: float = 30.0,
                 hedge: bool = False, hedge_quantile: float = 95.0,
                 hedge_factor: float = 2.0, hedge_min_s: float = 0.05,
                 hedge_after_s: float = 0.0,
                 framed_wire: bool = True,
                 chaos: str = "", chaos_seed: int = 0,
                 backoff_jitter: bool = True, jitter_seed: int = 0,
                 env: dict | None = None,
                 replica_extra_args: list[list[str]] | None = None,
                 disagg_min_prompt: int = 1,
                 sample_completions: int = 0):
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        self._autoscaler = FleetAutoscaler(autoscale) if autoscale else None
        self._min_replicas = int(
            min_replicas if min_replicas is not None
            else autoscale.min_replicas if autoscale else 1)
        self._max_replicas = int(
            max_replicas if max_replicas is not None
            else autoscale.max_replicas if autoscale else 0)
        if self._min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self._min_replicas}")
        if num_replicas < self._min_replicas or (
                self._max_replicas and num_replicas > self._max_replicas):
            raise ValueError(
                f"num_replicas {num_replicas} outside "
                f"[{self._min_replicas}, {self._max_replicas or 'inf'}]")
        if autoscale is not None and snapshot_interval_s <= 0:
            raise ValueError("autoscale needs snapshot_interval_s > 0 — the "
                             "fleet_snapshot loop is the policy's input")
        self._warm_prefixes = int(warm_prefixes)
        self._drain_timeout_s = float(drain_timeout_s)
        self._command = list(replica_command)
        # None: each replica takes its own --device default (the card)
        self._device = device
        self._env = env
        # Tiered fleets: per-index argv suffixes (cycled by replica index) —
        # how a launcher assigns ``--tier prefill`` to replica 0 and ``--tier
        # decode`` to the rest without forking the shared base command. None/
        # empty keeps every spawn byte-identical to the untiered fleet.
        self._extra_args = [list(a) for a in (replica_extra_args or [])]
        # Prompts shorter than this never take the disagg detour: shipping
        # whole KV planes to save a one-chunk prefill costs more than it buys.
        self._disagg_min_prompt = int(disagg_min_prompt)
        # The tenant table: quotas + weighted-fair/priority dequeue live in
        # the queue (the fleet's one front door — replicas never double-charge
        # a quota), per-tenant in-flight caps in the dispatch gate below, and
        # the engine-side half (slot caps, priority preemption) rides the wire
        # per request. None = the implicit single-tenant class.
        self.tenants = tenants
        self.queue = RequestQueue(max_pending, tenants=tenants)
        self._default_timeout_s = default_timeout_s
        self._affinity_on = bool(affinity)
        self._affinity_min = int(affinity_min_tokens)
        self._affinity = _AffinityIndex(affinity_entries)
        self._hb_dir = heartbeat_dir
        self._hb_timeout_s = heartbeat_timeout_s
        self._max_restarts = int(max_restarts)
        self._backoff_s = backoff_s
        self._backoff_max_s = backoff_max_s
        self._connect_timeout_s = connect_timeout_s
        self._poll_s = poll_s
        # Gray-failure knobs. Ejection: straggler_k=0 is OFF
        # (the pre-gray-failure behavior, bitwise); k>0 flips a replica whose
        # windowed dispatch p95 exceeds k x the fleet-median peer p95 to
        # ``degraded`` for eject_cooldown_s. Hedging: hedge=False is OFF; on,
        # a request still pending hedge-deadline seconds after dispatch gets
        # a speculative second copy (deadline = hedge_after_s when set, else
        # hedge_factor x the fleet-wide windowed dispatch-latency
        # hedge_quantile, floored at hedge_min_s). framed_wire opts into the
        # length+CRC framing when a replica's hello advertises it; chaos
        # routes every replica connection through a seeded
        # resilience/netfaults.py proxy.
        self._straggler_k = float(straggler_k)
        self._eject_min_samples = int(eject_min_samples)
        self._eject_cooldown_s = float(eject_cooldown_s)
        self._eject_window_s = float(eject_window_s)
        self._hedge = bool(hedge)
        self._hedge_quantile = float(hedge_quantile)
        self._hedge_factor = float(hedge_factor)
        self._hedge_min_s = float(hedge_min_s)
        self._hedge_after_s = float(hedge_after_s)
        self._framed_wire = bool(framed_wire)
        self._chaos = chaos
        self._chaos_seed = int(chaos_seed)
        self._backoff_jitter = bool(backoff_jitter)
        self._jitter_seed = int(jitter_seed)
        # Fleet-wide windowed dispatch-latency sketch: the hedge deadline's
        # quantile source (per-replica sketches live on the replicas).
        self._lat_fleet = WindowedLogHistogram(hist_rel_err, eject_window_s)
        self._writer = JsonlWriter(telemetry)
        # Distributed tracing (utils/trace.py): trace_dir holds one span JSONL
        # per process — the router writes router.jsonl, each replica gets
        # ``--trace <dir>/replica<i>.jsonl`` appended to its argv. Empty = off:
        # no Tracer file, no --trace flag, and the wire protocol stays
        # byte-identical (``_submit_msg`` adds trace_id only when present).
        self._trace_dir = trace_dir
        self.tracer = Tracer(os.path.join(trace_dir, "router.jsonl")
                             if trace_dir else "", proc="router")
        # Metrics timeline: every ``snapshot_interval_s`` the router emits one
        # ``fleet_snapshot`` event — queue depth/oldest-age vs per-replica
        # occupancy/pending/capacity, prefill backlog, prefix/affinity hit
        # rates, restarts, bytes/token — the load signal the autoscaler
        # consumes. 0 = off.
        self._snapshot_interval_s = float(snapshot_interval_s)
        self.replicas = [_Replica(i) for i in range(num_replicas)]
        # The DESIRED replica count: scale_up/scale_down move it inside
        # [min_replicas, max_replicas]; wait_ready and the autoscaler bound
        # themselves against it (never against the start-time count).
        self._target = num_replicas
        self._scale_counts = {"scale_ups": 0, "scale_downs": 0, "retired": 0,
                              "reloads": 0}
        self._replica_series: list[int] = []   # ready count per snapshot tick
        self._reloading = False
        # Fleet-lifecycle spans (scale/reload) share one synthetic trace id —
        # they are timeline annotations, not request traces, and the trace
        # summarizer excludes LIFECYCLE_SPANS from per-request accounting.
        self._fleet_trace = new_trace_id() if self.tracer.enabled else None
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._next_id = 0
        # The one request the dispatch thread may hold between queue.take()
        # and a replica ledger: _drained() and the stop/abort sweeps must see
        # it, or a submit racing a shutdown could strand its future.
        self._in_transit: RouterRequest | None = None
        self._rr = 0                  # round-robin tiebreak cursor
        self._stopping = False
        self._aborted = False
        self._threads: list[threading.Thread] = []
        self._started_s: float | None = None
        # Serving wall starts at readiness/first dispatch, NOT at start():
        # replica cold-start (torch import, CUDA context, warm-up) can dwarf the measured
        # run, and the single-engine serve_summary this gets A/B'd against
        # starts its clock on an already-built engine.
        self._served_from_s: float | None = None
        # Aggregates for router_summary (scalars + bounded sketches only: the
        # latency series are obs/hist.py LogHistograms — O(buckets) memory,
        # quantiles within hist_rel_err of the nearest-rank oracle).
        self._counts = {"requests": 0, "ok": 0, "timeout": 0, "shed": 0,
                        "failed": 0,
                        "redispatches": 0, "redispatched_requests": 0,
                        "duplicates": 0, "affinity_hits": 0, "new_tokens": 0,
                        "hedges": 0, "hedge_wins": 0, "ejections": 0,
                        "probes": 0, "wire_corrupt": 0,
                        "handoffs": 0, "handoff_bytes": 0,
                        "handoff_failures": 0}
        # Per-tenant fleet-level ledgers: counts + client-facing ttft/e2e
        # sketches + attainment against the tenant's own SLO (global spec as
        # fallback) — the fleet_snapshot "tenants" section and the
        # router-sourced tenant_summary events.
        self._tenant_counts: dict[str, dict] = {}
        self._tenant_series: dict[str, dict[str, LogHistogram]] = {}
        self._slo_by_tenant: dict[str, AttainmentTracker] = {}
        self._hist_rel_err = float(hist_rel_err)
        self._series: dict[str, LogHistogram] = {
            name: LogHistogram(hist_rel_err)
            for name in ("ttft_s", "e2e_s", "queue_wait_s")}
        # SLO attainment (obs/slo.py): the fleet-level promise as the CLIENT
        # sees it (router-side latencies), plus one windowed tracker per
        # replica index so fleet_snapshot can report per-replica recent
        # attainment — the signal an attainment-driven autoscaler reads.
        self._slo_spec = slo
        self._slo_fleet = (AttainmentTracker(slo) if slo is not None
                           else None)
        self._slo_by_replica: dict[int, AttainmentTracker] = {}
        # Canary rollout state + sampled-completion evidence
        # (deploy/promoter.py): at most ONE replica canaries a candidate
        # checkpoint at a time; while sampling is on (sample_completions > 0)
        # every replica keeps a bounded ring of its recent ok completions
        # (prompt + generated tokens) so the promoter can score canary-served
        # vs fleet-served tokens under one fixed scorer.
        self._canary: int | None = None
        self._canary_checkpoint = ""
        self._sample_keep = int(sample_completions)
        self._samples_by_replica: dict[int, collections.deque] = {}
        self.last_summary: dict | None = None

    # ------------------------------------------------------------------ lifecycle

    def start(self) -> "Router":
        if self._started_s is not None:
            raise RuntimeError("router already started")
        self._started_s = time.monotonic()
        self._writer.emit({
            "event": "router_config", "replicas": len(self.replicas),
            "affinity": self._affinity_on, "max_pending": self.queue.max_pending,
            "heartbeat_timeout_s": self._hb_timeout_s,
            "max_restarts": self._max_restarts, "backoff_s": self._backoff_s,
            "min_replicas": self._min_replicas,
            "max_replicas": self._max_replicas or None,
            "autoscale": (dataclasses.asdict(self._autoscaler.policy)
                          if self._autoscaler else None),
            "warm_prefixes": self._warm_prefixes,
            "drain_timeout_s": self._drain_timeout_s,
            "slo": (self._slo_spec.describe() if self._slo_spec else None),
            "tenants": (self.tenants.describe() if self.tenants else None),
            "straggler_k": self._straggler_k or None,
            "eject_cooldown_s": (self._eject_cooldown_s
                                 if self._straggler_k else None),
            "hedge": self._hedge,
            "hedge_after_s": (self._hedge_after_s or None) if self._hedge
            else None,
            "framed_wire": self._framed_wire,
            "chaos": self._chaos or None,
        })
        with self._lock:
            for rep in self.replicas:
                self._spawn(rep)
        loops = [("router-dispatch", self._dispatch_loop),
                 ("router-monitor", self._monitor_loop)]
        if self._snapshot_interval_s > 0 and (self._writer.enabled
                                              or self._autoscaler is not None):
            loops.append(("router-snapshot", self._snapshot_loop))
        for name, target in loops:
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        return self

    def wait_ready(self, timeout: float | None = None, *,
                   min_ready: int | None = None) -> bool:
        """Block until the fleet serves its CURRENT target (or ``timeout``).
        Load generators call this before offering measured load: replicas cold
        -start at different speeds (torch import, CUDA context), and measuring — or
        A/B-comparing routing policies — against a half-up fleet would skew
        everything toward whichever replica won the race.

        Readiness tracks the *current* target, never the start-time replica
        count: the bar is ``min(target-at-call, current target, live
        replicas)`` ready replicas. So a scale-up mid-wait (a new replica
        still compiling) does not extend the wait past the fleet the caller
        asked for, a scale-down mid-wait lowers the bar with the target, and
        a replica that dies for good (restart budget exhausted) stops being
        waited on as long as someone still serves. ``min_ready`` replaces only
        the target-at-call term — it stays clamped by the current target and
        live count (demanding more replicas than the fleet will ever spawn
        would hang forever). Returns False if the fleet aborts first (every
        live replica crash-looped its restart budget away)."""
        want0 = min_ready
        with self._cond:
            if want0 is None:
                want0 = self._target

            def bar() -> int:
                live = sum(r.state not in ("retired", "dead")
                           for r in self.replicas)
                return max(1, min(want0, self._target, live))

            def ok() -> bool:
                return sum(r.state == "ready"
                           for r in self.replicas) >= bar()

            self._cond.wait_for(lambda: self._aborted or ok(),
                                timeout=timeout)
            ready = not self._aborted and ok()
            if ready and self._served_from_s is None:
                self._served_from_s = time.monotonic()
            return ready

    def __enter__(self) -> "Router":
        return self.start() if self._started_s is None else self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ elasticity

    def scale_up(self, *, reason: str = "manual") -> int | None:
        """Spawn one more replica (up to ``max_replicas``); returns its index,
        or None when the fleet is at its cap or shutting down. The new replica
        follows the full lifecycle — ``starting`` (spawn + compile), then the
        prefix-cache warm-start (``warming``: the router ships its hottest
        affinity prefixes for replay), then ``ready`` — so by the time it takes
        traffic it is not cold. Dispatch picks it up automatically; nothing in
        flight moves."""
        now = time.monotonic()
        with self._cond:
            if self._stopping or self._aborted or self._reloading:
                return None
            if self._max_replicas and self._target >= self._max_replicas:
                return None
            rep = _Replica(len(self.replicas))
            self.replicas.append(rep)
            self._target += 1
            self._scale_counts["scale_ups"] += 1
            target = self._target
            self._spawn(rep)
            self._cond.notify_all()
        self._writer.emit({"event": "scale", "action": "up",
                           "replica": rep.index, "target": target,
                           "reason": reason})
        self.tracer.span("scale", self._fleet_trace, now, time.monotonic(),
                         action="up", replica=rep.index, target=target,
                         reason=reason)
        return rep.index

    def scale_down(self, *, reason: str = "manual") -> int | None:
        """Retire one replica gracefully (down to ``min_replicas``); returns
        its index, or None when the fleet is at its floor, mid-reload, or has
        no spare ready replica. The victim — the least-loaded ready replica —
        flips to ``draining`` immediately (dispatch and affinity stop routing
        to it in the same transaction), finishes its in-flight work under
        ``drain_timeout_s``, then exits; stragglers ride the normal
        ``_drain_ledger`` redispatch, so retiring loses zero requests."""
        now = time.monotonic()
        with self._cond:
            if self._stopping or self._aborted or self._reloading:
                return None
            if self._target <= self._min_replicas:
                return None
            ready = [r for r in self.replicas if r.state == "ready"]
            if len(ready) <= 1:
                return None           # never drain the last serving replica
            victim = min(ready, key=lambda r: (len(r.inflight), -r.index))
            self._target -= 1
            self._scale_counts["scale_downs"] += 1
            target = self._target
            self._begin_drain(victim, "retire")
        self._send_drain(victim)
        self._writer.emit({"event": "scale", "action": "down",
                           "replica": victim.index, "target": target,
                           "reason": reason})
        self.tracer.span("scale", self._fleet_trace, now, time.monotonic(),
                         action="down", replica=victim.index, target=target,
                         reason=reason)
        return victim.index

    def reload(self, checkpoint: str = "", *,
               timeout_s: float = 600.0) -> dict:
        """Roll new params through the fleet ONE replica at a time on the
        retire drain machinery: drain (in-flight finishes, nothing new lands)
        → restart with the new ``--checkpoint`` → prefix-cache warm → ready —
        then the next replica. The fleet never dips below N−1 ready replicas
        and no request ever mixes params (a request is pinned to one process,
        and a process is pinned to one checkpoint for its whole life).
        ``checkpoint`` empty rolls the fleet onto its current command (a param
        refresh from a file that changed in place). Blocks until the roll
        completes; raises ``RuntimeError`` if a rolled replica fails to come
        back within ``timeout_s``."""
        t_start = time.monotonic()
        with self._cond:
            if self._reloading:
                raise RuntimeError("reload already in progress")
            if self._stopping or self._aborted or self._started_s is None:
                raise RuntimeError("router is not serving")
            self._reloading = True
            if checkpoint:
                self._command = _with_checkpoint(self._command, checkpoint)
            # Every replica spawned BEFORE the command rewrite carries the old
            # params — including ones still mid-spawn (starting/warming).
            # Those must roll too, or a scale-up racing the reload comes up
            # ready on stale params and serves a mixed-version fleet forever.
            # dead/restarting replicas are excluded: their respawn happens
            # after this point and picks up the rewritten command.
            targets = [r for r in self.replicas
                       if r.state in ("starting", "warming", "ready")]
        rolled: list[int] = []
        try:
            for rep in targets:
                if self._roll_one(rep, timeout_s, checkpoint):
                    rolled.append(rep.index)
        finally:
            with self._lock:
                self._reloading = False
        return {"reloaded": rolled, "checkpoint": checkpoint,
                "wall_s": time.monotonic() - t_start}

    def _roll_one(self, rep: _Replica, timeout_s: float, checkpoint: str,
                  *, action: str = "reload") -> bool:
        """Roll ONE replica through the drain→respawn→ready sequence (the
        shared leg of ``reload``/``canary_reload``/``promote_canary``/
        ``rollback_canary``; caller owns ``_reloading``). Returns False when
        the replica crashed/retired before the roll could start (its respawn
        picks up the current command anyway); raises ``RuntimeError`` when it
        fails to drain or come back ready within ``timeout_s``. ``action``
        labels the scale telemetry/trace lines."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            # A target caught mid-spawn must reach ready before it
            # can drain (drain rides the ready protocol).
            self._cond.wait_for(
                lambda: rep.state not in ("starting", "warming")
                or self._aborted or self._stopping,
                timeout=max(0.0, deadline - time.monotonic()))
            if rep.state in ("starting", "warming"):
                raise RuntimeError(
                    f"{action}: replica {rep.index} never became "
                    f"ready to roll (state {rep.state})")
            if rep.state != "ready":
                return False      # crashed/retired since the roll began:
                                  # any respawn uses the new command
            self._begin_drain(rep, "reload")
        self._send_drain(rep)
        self._writer.emit({"event": "scale", "action": f"{action}_drain",
                           "replica": rep.index,
                           "checkpoint": checkpoint})
        with self._cond:
            # The monitor bounds this wait: drain deadline, process
            # death, and connect timeout all finalize the drain.
            self._cond.wait_for(
                lambda: rep.state in ("retired", "dead")
                or self._aborted or self._stopping,
                timeout=max(0.0, deadline - time.monotonic()))
            if rep.state != "retired":
                raise RuntimeError(
                    f"{action}: replica {rep.index} never drained "
                    f"(state {rep.state})")
            self._spawn(rep)   # picks up the updated self._command
        with self._cond:
            self._cond.wait_for(
                lambda: rep.state == "ready" or self._aborted
                or rep.state == "dead",
                timeout=max(0.0, deadline - time.monotonic()))
            if rep.state != "ready":
                raise RuntimeError(
                    f"{action}: replica {rep.index} did not come back "
                    f"ready (state {rep.state})")
            self._scale_counts["reloads"] += 1
        self._writer.emit({"event": "scale", "action": action,
                           "replica": rep.index,
                           "checkpoint": checkpoint,
                           "warmed": rep.warmed})
        self.tracer.span(action, self._fleet_trace,
                         deadline - timeout_s, time.monotonic(),
                         replica=rep.index, checkpoint=checkpoint)
        return True

    # ------------------------------------------------------------------ canary

    def canary_reload(self, checkpoint: str, *, replica: int | None = None,
                      timeout_s: float = 600.0) -> dict:
        """Roll a candidate checkpoint onto ONE replica (the canary) while the
        rest of the fleet keeps serving the incumbent — the qualification
        half of checkpoint promotion.
        The canary's per-replica attainment window and completion samples are
        reset at readiness so ``canary_report`` compares post-roll evidence
        only. The override sticks across crash-respawns until
        ``promote_canary``/``rollback_canary`` settles the verdict."""
        t_start = time.monotonic()
        with self._cond:
            if self._reloading:
                raise RuntimeError("reload already in progress")
            if self._stopping or self._aborted or self._started_s is None:
                raise RuntimeError("router is not serving")
            if self._canary is not None:
                raise RuntimeError(
                    f"canary already active on replica {self._canary}")
            ready = [r for r in self.replicas if r.state == "ready"]
            if replica is not None:
                picks = [r for r in ready if r.index == replica]
                if not picks:
                    raise RuntimeError(
                        f"canary_reload: replica {replica} is not ready")
                rep = picks[0]
            else:
                if len(ready) < 2:
                    raise RuntimeError(
                        "canary_reload needs >= 2 ready replicas (one canary "
                        "plus a fleet to compare against)")
                # Highest index: on tiered fleets the low indices hold the
                # positional roles (prefill first), and the autoscaler also
                # retires from the top — a canary there never collides with a
                # role assignment.
                rep = max(ready, key=lambda r: r.index)
            rep.checkpoint_override = checkpoint
            self._reloading = True
        try:
            self._roll_one(rep, timeout_s, checkpoint, action="canary")
        except BaseException:
            with self._cond:
                rep.checkpoint_override = None
            raise
        finally:
            with self._lock:
                self._reloading = False
        with self._lock:
            self._canary = rep.index
            self._canary_checkpoint = checkpoint
            # Fresh evidence only: attainment observed before the roll (and
            # samples generated by the incumbent) must not dilute the canary
            # comparison window.
            self._slo_by_replica.pop(rep.index, None)
            self._samples_by_replica.pop(rep.index, None)
        return {"replica": rep.index, "checkpoint": checkpoint,
                "wall_s": time.monotonic() - t_start}

    def canary_report(self) -> dict:
        """The canary-vs-fleet evidence the promoter judges: the canary's
        windowed SLO attainment against the aggregated window of every OTHER
        serving replica (windows, not raw latencies), plus
        both sides' sampled completions (prompt + generated tokens) for the
        fixed-scorer NLL comparison. Raises when no canary is active."""
        now = time.monotonic()
        with self._lock:
            if self._canary is None:
                raise RuntimeError("no canary is active")
            idx = self._canary
            tracker = self._slo_by_replica.get(idx)
            canary_win = (tracker.window(now) if tracker is not None
                          else {"attainment": None, "requests": 0})
            met = n = 0
            for other, tr in self._slo_by_replica.items():
                if other == idx:
                    continue
                win = tr.window(now)
                if win["attainment"] is not None:
                    n += win["requests"]
                    met += round(win["attainment"] * win["requests"])
            fleet_win = {"attainment": met / n if n else None, "requests": n}
            canary_samples = list(self._samples_by_replica.get(idx) or ())
            fleet_samples = [s for other, ring in
                             self._samples_by_replica.items()
                             if other != idx for s in ring]
        return {"replica": idx, "checkpoint": self._canary_checkpoint,
                "canary": canary_win, "fleet": fleet_win,
                "canary_samples": canary_samples,
                "fleet_samples": fleet_samples}

    def promote_canary(self, *, timeout_s: float = 600.0) -> dict:
        """The canary passed: make its checkpoint THE fleet checkpoint and
        roll every other replica onto it one at a time (same
        never-below-N−1-ready drain machinery as ``reload``). The canary
        itself is NOT restarted — its running process already serves the
        candidate params, and with the fleet command rewritten its override
        becomes redundant and is cleared."""
        t_start = time.monotonic()
        with self._cond:
            if self._reloading:
                raise RuntimeError("reload already in progress")
            if self._stopping or self._aborted or self._started_s is None:
                raise RuntimeError("router is not serving")
            if self._canary is None:
                raise RuntimeError("no canary is active")
            canary_rep = self.replicas[self._canary]
            checkpoint = self._canary_checkpoint
            self._reloading = True
            self._command = _with_checkpoint(self._command, checkpoint)
            canary_rep.checkpoint_override = None
            targets = [r for r in self.replicas
                       if r is not canary_rep
                       and r.state in ("starting", "warming", "ready")]
        rolled: list[int] = []
        try:
            for rep in targets:
                if self._roll_one(rep, timeout_s, checkpoint,
                                  action="promote"):
                    rolled.append(rep.index)
        finally:
            with self._lock:
                self._reloading = False
        with self._lock:
            self._canary = None
            self._canary_checkpoint = ""
        self._writer.emit({"event": "scale", "action": "promoted",
                           "replica": canary_rep.index,
                           "checkpoint": checkpoint, "rolled": rolled})
        return {"promoted": rolled, "canary": canary_rep.index,
                "checkpoint": checkpoint,
                "wall_s": time.monotonic() - t_start}

    def rollback_canary(self, *, timeout_s: float = 600.0) -> dict:
        """The canary failed: clear its override and roll it back onto the
        fleet command (still the last-good checkpoint — ``promote_canary`` is
        the only writer of ``self._command`` on this path). Its attainment
        window and samples reset so the restored incumbent starts clean."""
        t_start = time.monotonic()
        with self._cond:
            if self._reloading:
                raise RuntimeError("reload already in progress")
            if self._stopping or self._aborted or self._started_s is None:
                raise RuntimeError("router is not serving")
            if self._canary is None:
                raise RuntimeError("no canary is active")
            rep = self.replicas[self._canary]
            checkpoint = self._canary_checkpoint
            rep.checkpoint_override = None
            self._reloading = True
        try:
            self._roll_one(rep, timeout_s, "", action="rollback")
        finally:
            with self._lock:
                self._reloading = False
        with self._lock:
            self._canary = None
            self._canary_checkpoint = ""
            self._slo_by_replica.pop(rep.index, None)
            self._samples_by_replica.pop(rep.index, None)
        self._writer.emit({"event": "scale", "action": "rolled_back",
                           "replica": rep.index, "checkpoint": checkpoint})
        return {"replica": rep.index, "rolled_back": checkpoint,
                "wall_s": time.monotonic() - t_start}

    def _begin_drain(self, rep: _Replica, mode: str) -> None:
        """Flip one ready replica to ``draining`` (caller holds the lock):
        ``room()`` refuses it and the affinity alive-filter skips it from this
        transaction on, so no new work can land; in-flight entries stay in the
        ledger until the replica's completions (or the drain deadline) settle
        them. ``mode`` is who owns the retire ("retire" | "reload")."""
        rep.state = "draining"
        rep.retiring = mode
        rep.drain_deadline = time.monotonic() + self._drain_timeout_s
        self._cond.notify_all()

    def _send_drain(self, rep: _Replica) -> None:
        """Ship the drain op (outside the lock — it's a blocking socket write).
        A failed write means the connection is already dying; the monitor's
        draining branch finalizes via process-exit or deadline either way."""
        try:
            rep.send({"op": "drain", "id": -3})
        except OSError:
            pass

    def _finish_retire(self, rep: _Replica, *, how: str) -> None:
        """Terminal half of a graceful retire/reload drain — the ONE owner of
        the draining→retired transition (the drained ack, the process's own
        exit, and the drain deadline all land here; the state guard makes a
        second arrival a no-op). Stragglers still in the ledger are
        redispatched (zero lost requests), affinity entries re-home to the
        least-loaded surviving ready replica so a hot prefix keeps ONE
        consistent home, and the process is reaped."""
        with self._cond:
            if rep.state != "draining":
                return
            mode = rep.retiring
            rep.generation += 1       # io thread for this generation stands down
            sock, rep.sock, rep.wfile = rep.sock, None, None
            now = time.monotonic()
            stragglers = self._drain_ledger(rep, now, cause="retire")
            survivors = [r for r in self.replicas
                         if r.state == "ready" and r is not rep]
            target = (min(survivors, key=lambda r: len(r.inflight)).index
                      if survivors else None)
            rehomed = self._affinity.rehome(rep.index, target)
            rep.state = "retired"
            if mode == "retire":
                self._scale_counts["retired"] += 1
            self._cond.notify_all()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if rep.fleet is not None:
            rep.fleet.terminate(grace=2.0)   # no-op when it already exited 0
        self._writer.emit({"event": "replica", "replica": rep.index,
                           "action": "retired", "mode": mode, "how": how,
                           "stragglers": stragglers, "rehomed": rehomed})
        print(f"[router] replica {rep.index} retired ({mode}, {how}); "
              f"{stragglers} straggler(s) redispatched, "
              f"{rehomed} affinity entries re-homed", flush=True)

    # ------------------------------------------------------------------ submit

    def submit(self, prompt, *, max_new_tokens: int,
               sampling: SamplingParams | None = None,
               timeout_s: float | None = None,
               trace_id: str | None = None,
               tenant: str = "default",
               priority: int | None = None,
               preemptible: bool | None = None) -> concurrent.futures.Future:
        """Thread-safe enqueue; returns a Future resolving to a
        ``RouterCompletion``. Raises ``QueueFull`` (router backpressure),
        ``QuotaExceeded`` (the tenant's admission quota — the router is the
        fleet's ONE quota-charging front door), or ``Shed`` (the queue is
        full of strictly higher-priority work) immediately in the caller's
        thread; an admission may DISPLACE queued lower-priority requests,
        whose futures resolve ``finish="shed"``. Deep validation (prompt vs
        seq_len, sampling bounds) happens replica-side — an ``invalid`` reply
        fails the future with ``ValueError`` (replays would fail identically,
        so it is never redispatched). ``trace_id`` joins this request to an
        existing distributed trace; with tracing on and no id given, this
        submit is the trace origin and assigns one."""
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if self._aborted:
            raise ServerStopped("router aborted: every replica is dead")
        now = time.monotonic()
        timeout_s = self._default_timeout_s if timeout_s is None else timeout_s
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        if trace_id is None and self.tracer.enabled:
            trace_id = new_trace_id()
        spec = (self.tenants.spec_for(tenant) if self.tenants is not None
                else None)
        req = RouterRequest(
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens),
            sampling=sampling or SamplingParams(),
            request_id=rid, future=concurrent.futures.Future(),
            arrival_s=now,
            deadline_s=None if timeout_s is None else now + timeout_s,
            trace_id=trace_id, tenant=tenant,
            priority=(priority if priority is not None
                      else spec.priority if spec else 0),
            preemptible=(preemptible if preemptible is not None
                         else spec.preemptible if spec else False),
            enqueued_s=now)
        try:
            shed = self.queue.submit(req)    # may raise QueueFull/Quota/Shed
        except (Shed, QuotaExceeded) as e:
            self._writer.emit({
                "event": "shed", "source": "router", "tenant": tenant,
                "reason": ("quota" if isinstance(e, QuotaExceeded)
                           else "refused"),
                "request_id": rid, "priority": req.priority})
            raise
        for victim in shed:
            self._shed_victim(victim, now)
        return req.future

    def _shed_victim(self, victim: RouterRequest, now: float) -> None:
        """Resolve a queued request displaced by a higher-priority admission:
        its future settles ``finish="shed"`` (the typed degradation, distinct
        from a timeout) and the route/shed telemetry records which tenant
        absorbed the squeeze."""
        self._writer.emit({
            "event": "shed", "source": "router", "tenant": victim.tenant,
            "reason": "displaced", "request_id": victim.request_id,
            "priority": victim.priority})
        comp = RouterCompletion(
            request_id=victim.request_id, tokens=np.zeros((0,), np.int32),
            finish="shed", prompt_len=len(victim.prompt), new_tokens=0,
            replica=-1, redispatches=victim.redispatches,
            tenant=victim.tenant,
            queue_wait_s=now - victim.arrival_s, e2e_s=now - victim.arrival_s)
        try:
            victim.future.set_result(comp)
        except concurrent.futures.InvalidStateError:
            return                        # lost a resolve race: already settled
        self.tracer.span("resolve", victim.trace_id, now, time.monotonic(),
                         request_id=victim.request_id, finish="shed")
        self._record(comp)

    # ------------------------------------------------------------------ spawn/io

    def _spawn(self, rep: _Replica) -> None:
        """(Re)launch one replica as its own Fleet: one process, or a sharded
        replica's world of ranks. Caller holds the lock."""
        rep.generation += 1
        rep.port = _free_port()
        rep.capacity = None
        rep.stats = None
        rep.exit_code = None
        rep.retiring = None
        rep.warmed = 0
        rep.framed = False
        if rep.lat is None:
            rep.lat = WindowedLogHistogram(self._hist_rel_err,
                                           self._eject_window_s)
        else:
            rep.lat.reset()       # a fresh process owes nothing to old scores
        if rep.restart_backoff is None:
            rep.restart_backoff = JitterBackoff(
                self._backoff_s, self._backoff_max_s,
                seed=self._jitter_seed ^ (rep.index * 2654435761 & 0x7FFFFFFF))
            rep.connect_backoff = JitterBackoff(
                0.05, 1.0,
                seed=(self._jitter_seed + 1) ^ (rep.index * 40503 & 0x7FFFFFFF))
        if rep.proxy is not None:
            rep.proxy.stop()
            rep.proxy = None
        if self._chaos:
            # The chaos detour: the router connects to the proxy, the proxy
            # to the replica. One proxy per spawn (the replica's port is
            # fresh each time); connection ordinals reset with it — the
            # determinism contract is per-spawn.
            rep.proxy = ChaosProxy(
                rep.port, self._chaos, proxy_id=rep.index,
                seed=self._chaos_seed,
                on_fault=lambda info: self._writer.emit(
                    {"event": "chaos", **info}))
            rep.proxy.start()
        cmd = list(self._command)
        if rep.checkpoint_override:
            # The canary exception: this replica spawns on ITS checkpoint, not
            # the fleet's — and keeps doing so across crash-respawns until
            # promote_canary/rollback_canary clears the override.
            cmd = _with_checkpoint(cmd, rep.checkpoint_override)
        cmd += ["--port", str(rep.port), "--replica-id", str(rep.index)]
        if self._extra_args:
            # Role assignment is positional and survives restarts: the same
            # index always restarts into the same tier (cycled when the fleet
            # scales past the suffix list).
            cmd += self._extra_args[rep.index % len(self._extra_args)]
        if self._hb_dir:
            hb.clear(self._hb_dir, rep.index)
            cmd += ["--heartbeat-dir", self._hb_dir]
        if self._trace_dir:
            # One span file per replica, appended across restarts: a crashed
            # generation's history survives, and it tears at most its own
            # final line (which the shared guarded reader tolerates).
            cmd += ["--trace",
                    os.path.join(self._trace_dir, f"replica{rep.index}.jsonl")]
        if self._device:
            cmd += ["--device", self._device]
        # A sharded replica (``--shard tp=T,dp=D`` in its command) is a world of T*D
        # ranks that lives and dies whole, every rank under the replica's index: one
        # death, one restart of the whole world.
        world = _shard_world(cmd)
        rep.fleet = Fleet(cmd, num_processes=world, process_id_base=rep.index,
                          env=self._env, whole=world > 1)
        rep.started_wall = time.time()
        rep.started_mono = time.monotonic()
        rep.state = "starting"
        t = threading.Thread(target=self._io_loop, args=(rep, rep.generation),
                             daemon=True, name=f"router-io-{rep.index}")
        t.start()
        self._threads.append(t)

    def _read_hello(self, sock) -> tuple[dict, bytes]:
        """The handshake: recv until the hello's newline (the one message that
        is ALWAYS line-framed — the negotiation anchor). Returns the parsed
        hello plus any bytes that followed it in the same chunks. Raises
        ``OSError``/``ValueError`` on EOF, timeout, or a non-hello line."""
        buf = b""
        while b"\n" not in buf:
            chunk = sock.recv(1 << 16)      # connect timeout still armed
            if not chunk:
                raise OSError("eof before hello")
            buf += chunk
            if len(buf) > 1 << 20:
                raise OSError("oversized hello")
        line, _, rest = buf.partition(b"\n")
        hello = json.loads(line or b"null")
        if not hello or hello.get("op") != "hello":
            raise OSError("bad hello")
        return hello, rest

    def _io_loop(self, rep: _Replica, gen: int) -> None:
        """Connect to one replica generation (through its chaos proxy when the
        harness armed one), read its hello, negotiate the wire mode, then pump
        its replies until disconnect, typed wire corruption, or the generation
        is superseded."""
        while True:
            with self._lock:
                if self._stopping or rep.generation != gen:
                    return
                port = rep.proxy.port if rep.proxy is not None else rep.port
                fleet = rep.fleet
                connect_backoff = rep.connect_backoff
            if not fleet.running:
                return                      # monitor classifies the exit
            try:
                sock = socket.create_connection(("127.0.0.1", port), timeout=1.0)
            except OSError:
                time.sleep(connect_backoff.next())
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                hello, carry = self._read_hello(sock)
            except (OSError, ValueError):
                sock.close()
                time.sleep(connect_backoff.next())
                continue
            connect_backoff.reset()         # a good hello forgives the history
            # Wire-mode negotiation: the replica ADVERTISES (hello caps), the
            # router OPTS IN (hello_ack) — only then do both directions speak
            # length+CRC frames. A legacy replica (no caps) or framed_wire
            # False keeps the byte-identical newline protocol.
            framed = self._framed_wire and hello_wants_framing(hello)
            # The connect/hello timeout must NOT outlive the handshake: reply
            # gaps are unbounded (a long decode, an idle fleet), and a read
            # timeout here would masquerade as a lost connection — tearing
            # down a healthy replica's ledger every quiet second. Teardown is
            # signalled by the socket being closed (stop/_fail_replica), EOF,
            # typed wire corruption, or the process dying — never by silence.
            sock.settimeout(None)
            wfile = sock.makefile("wb")
            if framed:
                # The opt-in must be on the wire BEFORE any thread can
                # dispatch through this connection: a submit overtaking the
                # hello_ack would leave the two ends disagreeing about the
                # framing mode forever. The ack itself is the last line-mode
                # message.
                try:
                    wfile.write(encode_msg(make_hello_ack(), framed=False))
                    wfile.flush()
                except (OSError, ValueError):
                    sock.close()
                    time.sleep(connect_backoff.next())
                    continue
            with self._cond:
                if self._stopping or rep.generation != gen:
                    sock.close()
                    return
                rep.sock = sock
                rep.wfile = wfile
                rep.framed = framed
                slots = int(hello.get("num_slots", 1))
                pending = int(hello.get("max_pending", 0))
                rep.capacity = slots + pending if pending else None
                # Tiered serving: the hello declares the replica's role and
                # (decode tier) its direct KV-handoff listener port — the
                # address prefill replicas ship planes to. Untiered hellos
                # carry neither field and the defaults keep routing classic.
                rep.tier = hello.get("tier") or "unified"
                rep.handoff_port = hello.get("handoff_port") or None
                # Prefix-cache warm-start: before this replica takes traffic,
                # replay the fleet's hottest prefixes into its cache (the
                # affinity index is the router's view of what is hot). Cold
                # starts (empty index, warm_prefixes=0, affinity off) skip
                # straight to ready.
                warm = (self._affinity.hot_prefixes(self._warm_prefixes)
                        if self._affinity_on and rep.state != "degraded"
                        else [])
                if rep.state == "degraded":
                    pass          # reconnected, but only the probe un-ejects
                elif warm:
                    rep.state = "warming"
                else:
                    rep.state = "ready"
                self._cond.notify_all()
            if warm:
                msg = {"op": "warm", "id": -2,
                       "prompts": [[int(t) for t in p] for p in warm]}
                try:
                    rep.send(msg)
                except OSError:
                    pass          # conn already dying: handled below as usual
            self._writer.emit({"event": "replica", "replica": rep.index,
                               "action": "warming" if warm else "ready",
                               "restarts": rep.restarts,
                               "capacity": rep.capacity,
                               "warm_prefixes": len(warm),
                               "framed": framed})
            if rep.tier != "unified":
                # Tier membership as a telemetry fact: fleet_top and the
                # report can attribute load per role without parsing argv.
                self._writer.emit({"event": "tier", "replica": rep.index,
                                   "tier": rep.tier,
                                   "handoff_port": rep.handoff_port,
                                   "restarts": rep.restarts})
            decoder = FrameDecoder() if framed else LineDecoder()
            corrupt: str | None = None
            try:
                chunk = carry    # bytes that trailed the hello (replicas send
                while True:      # nothing unsolicited, so in practice empty)
                    if chunk:
                        for raw in decoder.feed(chunk):
                            msg = json.loads(raw)
                            if not isinstance(msg, dict):
                                raise WireCorrupt("non-object message")
                            self._handle_line(rep, gen, msg)
                    chunk = sock.recv(1 << 16)
                    if not chunk:
                        break             # EOF: process death or conn loss
            except WireCorrupt as e:
                corrupt = str(e)
            except (ValueError, KeyError, TypeError) as e:
                # A reply that passed framing (or legacy line splitting) but
                # cannot be parsed/attributed — same typed treatment: the
                # stream is suspect, reconnect and let the ledger drain
                # replay whatever was outstanding.
                corrupt = f"garbled reply: {e}"
            except OSError:
                pass                      # dead socket
            if corrupt is not None:
                with self._lock:
                    self._counts["wire_corrupt"] += 1
                self._writer.emit({"event": "replica", "replica": rep.index,
                                   "action": "wire_corrupt",
                                   "detail": corrupt})
                print(f"[router] replica {rep.index} wire corrupt: {corrupt}; "
                      f"reconnecting", flush=True)
            # EOF usually means the PROCESS died (its exit closed the socket a
            # few ms before the monitor can observe the reaped child). Give
            # that classification a moment: a crash must flow through
            # _fail_replica — one owner for drain + restart accounting — and
            # only a genuine live-process connection loss is handled here.
            # Typed corruption skips the grace: the peer was demonstrably
            # WRITING to us a moment ago, and every 100ms the reconnect waits
            # is tail latency for the drained ledger's replays (the monitor
            # still classifies a death that races this independently).
            if corrupt is None:
                grace = time.monotonic() + 0.5
                while fleet.running and time.monotonic() < grace:
                    time.sleep(0.02)
            if not fleet.running:
                return                # monitor classifies, drains, restarts
            reconnect = False
            with self._cond:
                if rep.generation == gen:
                    rep.sock = None
                    rep.wfile = None
                    rep.framed = False
                    if not self._stopping and rep.state in ("ready", "warming",
                                                            "degraded"):
                        # Connection lost (or typed wire corruption) with the
                        # generation current and the process alive: reconnect
                        # — but first drain the ledger. The replica's
                        # completion callbacks hold the DEAD socket's write
                        # file, so replies for these requests can never reach
                        # us; without redispatch they would strand their
                        # futures while heartbeats stay fresh. A degraded
                        # replica reconnects too (its in-flight must replay
                        # elsewhere) but stays degraded until its probe.
                        self._drain_ledger(
                            rep, time.monotonic(),
                            cause="wire_corrupt" if corrupt else "conn_lost")
                        if rep.state != "degraded":
                            rep.state = "starting"
                        rep.started_mono = time.monotonic()
                        self._cond.notify_all()
                        reconnect = True
            if reconnect:
                if corrupt is not None:
                    # Reject-and-reconnect rides the decorrelated-jitter
                    # schedule: a fleet-wide wire blip must not hammer every
                    # replica back in lockstep. OUTSIDE the router lock — a
                    # backoff sleep holding it would stall every other
                    # replica's completions on one link's damage.
                    time.sleep(connect_backoff.next())
                continue
            return

    # ------------------------------------------------------------------ replies

    def _handle_line(self, rep: _Replica, gen: int, msg: dict) -> None:
        op = msg.get("op")
        if op == "done":
            self._handle_done(rep, msg)
        elif op == "prefill_done":
            self._handle_prefill_done(rep, msg)
        elif op == "prefill_failed":
            self._handle_prefill_failed(rep, msg)
        elif op == "error":
            if msg.get("error") == "wire_corrupt" and msg.get("id") is None:
                # The replica saw a damaged line it cannot attribute (legacy
                # newline mode: CRC-less). The CONNECTION is suspect — treat
                # it as typed corruption on our side too: reconnect, drain,
                # replay. Whatever the damaged line carried is outstanding in
                # our ledger and rides the redispatch.
                raise WireCorrupt(
                    f"replica {rep.index} reported a corrupt line: "
                    f"{msg.get('message')}")
            self._handle_error(rep, msg)
        elif op == "stats":
            with self._cond:
                rep.stats = {"engine": msg.get("engine"),
                             "queue": msg.get("queue")}
                self._cond.notify_all()
        elif op == "drained":
            # Graceful retire/reload ack: the replica finished everything it
            # had accepted (its done lines all precede this one on the wire)
            # and is about to exit 0. Finalize: ledger should be empty — any
            # entry left is a straggler the redispatch path replays.
            with self._lock:
                if rep.generation != gen:
                    return
            self._finish_retire(rep, how="drained")
        elif op == "warm_done":
            # Warm replay finished: the replica's prefix cache now holds the
            # shipped prefixes — re-home their affinity entries onto it (it
            # literally has the paid-for state) and open it for dispatch.
            with self._cond:
                if rep.generation != gen or rep.state != "warming":
                    return
                rep.warmed = int(msg.get("count") or 0)
                if self._affinity_on:
                    for p in msg.get("prompts") or []:
                        self._affinity.insert(np.asarray(p, np.int32),
                                              rep.index)
                rep.state = "ready"
                self._cond.notify_all()
            self._writer.emit({"event": "replica", "replica": rep.index,
                               "action": "ready", "restarts": rep.restarts,
                               "capacity": rep.capacity,
                               "warmed": rep.warmed})

    def _handle_done(self, rep: _Replica, msg: dict) -> None:
        now = time.monotonic()
        if msg.get("id") is None:         # torn line: nothing to attribute it to
            return
        with self._cond:
            req = rep.inflight.pop(msg["id"], None)
            if req is None:
                # A drained-and-redispatched request completing on the replica
                # we gave up on — at-least-once's harmless tail.
                self._counts["duplicates"] += 1
                return
            rep.completed += 1
            # The gray-failure evidence: router-observed dispatch latency
            # (send -> completion line) into this replica's windowed sketch
            # and the fleet-wide one the hedge deadline derives from — then
            # score the replica against its peers while the sample is fresh.
            # One sample per request per replica: a hedged request's PRIMARY
            # already contributed its censored sample at hedge time, and a
            # second, correlated sample here would halve the
            # eject_min_samples noise guard.
            t0 = req.dispatch_by.get(rep.index, req.dispatch_s)
            primary_already_sampled = (req.hedged
                                       and rep.index != req.hedge_replica)
            if t0 is not None and rep.lat is not None \
                    and not primary_already_sampled:
                rep.lat.add(max(0.0, now - t0), now)
                self._lat_fleet.add(max(0.0, now - t0), now)
                self._maybe_eject(rep, now)
            self._cond.notify_all()
        if req.future.done():
            # Resolved elsewhere (an earlier attempt completed, or it expired):
            # this is a replayed duplicate — drop it, never double-count.
            with self._lock:
                self._counts["duplicates"] += 1
            return
        dispatch_s = req.dispatch_by.get(rep.index, req.dispatch_s)
        router_wait = (dispatch_s - req.arrival_s
                       if dispatch_s is not None else 0.0)
        queue_wait = router_wait + (msg.get("queue_wait_s") or 0.0)
        ttft = msg.get("ttft_s")
        if ttft is not None:
            # Client-facing TTFT must be WIRE-AWARE: ``replica_ttft +
            # router_wait`` assumes the reply transit is free, which is
            # exactly what a gray-failing link violates — a done line delayed
            # 2s would report a 20ms TTFT. Nothing is visible to the client
            # before the done line lands, so floor the estimate at arrival-of
            # -done minus the replica-side decode tail (the streaming-
            # equivalent first-token instant: had the replica streamed, every
            # token would ride the same slow wire). On a healthy wire the
            # floor collapses to the classic estimate plus the measured
            # transit.
            rep_e2e = msg.get("e2e_s")
            ttft = ttft + router_wait
            if rep_e2e is not None and rep_e2e >= msg["ttft_s"]:
                ttft = max(ttft, (now - req.arrival_s)
                           - (rep_e2e - msg["ttft_s"]))
        hedge_won = req.hedged and rep.index == req.hedge_replica
        comp = RouterCompletion(
            request_id=req.request_id,
            tokens=np.asarray(msg.get("tokens") or [], np.int32),
            finish=msg.get("finish", "ok"),
            prompt_len=int(msg.get("prompt_len", len(req.prompt))),
            new_tokens=int(msg.get("new_tokens", 0)),
            replica=rep.index, redispatches=req.redispatches,
            affinity_hit=req.affinity_hit, tenant=req.tenant,
            hedged=req.hedged, hedge_won=hedge_won, disagg=req.disagg,
            queue_wait_s=queue_wait,
            ttft_s=ttft,
            tpot_s=msg.get("tpot_s"),
            e2e_s=now - req.arrival_s)
        try:
            req.future.set_result(comp)
        except concurrent.futures.InvalidStateError:
            # Lost a resolve race (the same id was legitimately in flight
            # twice — a drain and a failed-send both requeued it): this copy
            # is the duplicate, and it must not poison the io thread.
            with self._lock:
                self._counts["duplicates"] += 1
            return
        if hedge_won:
            with self._lock:
                self._counts["hedge_wins"] += 1
        # A hedge race this completion just won: stand the loser down (pop its
        # ledger entry, wire a cancel) so its reply — if any — is a counted
        # duplicate, not a ledger resident blocking the drain.
        self._settle_peers(rep, req, now)
        # The winning hop's dispatch span (send -> completion line) plus the
        # terminal resolve span (completion line -> future resolved). ok
        # dispatches OVERLAP the replica's own spans, so the critical-path
        # breakdown charges only drained ones — see utils.trace.SEGMENTS.
        self.tracer.span("dispatch", req.trace_id, dispatch_s, now,
                         request_id=req.request_id, replica=rep.index,
                         outcome="ok", hop=req.redispatches,
                         hedge=hedge_won or None)
        self.tracer.span("resolve", req.trace_id, now, time.monotonic(),
                         request_id=req.request_id, replica=rep.index,
                         finish=comp.finish, new_tokens=comp.new_tokens,
                         redispatches=req.redispatches)
        self._record(comp)
        self._note_sample(rep.index, req, comp)

    def _note_sample(self, replica: int, req: RouterRequest,
                     comp: RouterCompletion) -> None:
        """Keep this ok completion (prompt + generated tokens) in the
        replica's bounded sample ring — the canary NLL evidence. Only the
        resolved-ok path records (a shed/timeout has no tokens to score), and
        ``sample_completions=0`` keeps the router byte-identical to the
        pre-canary behavior."""
        if self._sample_keep <= 0 or not comp.ok or comp.new_tokens <= 0:
            return
        sample = {"prompt": np.asarray(req.prompt, np.int32).tolist(),
                  "tokens": np.asarray(comp.tokens, np.int32).tolist()}
        with self._lock:
            ring = self._samples_by_replica.get(replica)
            if ring is None:
                ring = self._samples_by_replica[replica] = \
                    collections.deque(maxlen=self._sample_keep)
            ring.append(sample)

    def _settle_peers(self, winner: _Replica, req: RouterRequest,
                      now: float) -> None:
        """Pop ``req`` from every OTHER replica's ledger (the hedge losers —
        at most one today) and wire each a ``cancel``: still queued there it
        aborts outright, already decoding it finishes silently with the done
        line suppressed. Either way the loser's window closes with a
        ``hedge_lost`` dispatch span — visible in the tree, excluded from the
        critical path (the winner's spans cover the same wall clock)."""
        losers: list[_Replica] = []
        with self._cond:
            for other in self.replicas:
                if other is not winner \
                        and other.inflight.pop(req.request_id, None) is not None:
                    losers.append(other)
            if losers:
                self._cond.notify_all()
        for other in losers:
            self.tracer.span(
                "dispatch", req.trace_id,
                req.dispatch_by.get(other.index, req.dispatch_s), now,
                request_id=req.request_id, replica=other.index,
                outcome="hedge_lost", hop=req.redispatches)
            try:
                other.send({"op": "cancel", "id": req.request_id})
            except OSError:
                pass          # conn dying; the duplicate dedup covers it

    def _handle_error(self, rep: _Replica, msg: dict) -> None:
        if msg.get("id") is None:
            return
        with self._cond:
            req = rep.inflight.pop(msg["id"], None)
            if req is None:
                return
            self._cond.notify_all()
        now = time.monotonic()
        kind = msg.get("error")
        dispatch_s = req.dispatch_by.get(rep.index, req.dispatch_s)
        with self._lock:
            # A hedged twin still lives on another replica: this copy's
            # refusal changes nothing for the client — the live copy resolves
            # it. Never requeue (a third concurrent copy) and never fail the
            # future; just close this hop and re-arm hedging.
            elsewhere = any(req.request_id in r.inflight
                            for r in self.replicas if r is not rep)
        if elsewhere:
            self.tracer.span("dispatch", req.trace_id, dispatch_s, now,
                             request_id=req.request_id, replica=rep.index,
                             outcome="bounced", error=kind,
                             hop=req.redispatches)
            with self._cond:
                req.hedged = False
                req.hedge_replica = None
                req.dispatch_by.pop(rep.index, None)
                self._cond.notify_all()
            return
        if kind in ("queue_full", "draining"):
            # queue_full: router/replica capacity accounting drifted (e.g. a
            # replica restarted thinner). draining: the shrink/submit race —
            # a dispatch crossed the drain op on the wire and the replica's
            # closed queue refused it. Either way the request is intact:
            # bounce back to the queue front, try elsewhere.
            self.tracer.span("dispatch", req.trace_id, dispatch_s, now,
                             request_id=req.request_id, replica=rep.index,
                             outcome="bounced", hop=req.redispatches)
            req.enqueued_s = now
            self.queue.requeue(req)
            return
        err_cls = {"invalid": ValueError, "shed": Shed,
                   "quota": QuotaExceeded}.get(kind, RuntimeError)
        err = err_cls(msg.get("message", kind or "replica error"))
        try:
            req.future.set_exception(err)
        except concurrent.futures.InvalidStateError:
            return                        # lost a resolve race: already settled
        self.tracer.span("dispatch", req.trace_id, dispatch_s, now,
                         request_id=req.request_id, replica=rep.index,
                         outcome="error", error=kind, hop=req.redispatches)
        self.tracer.span("resolve", req.trace_id, now, time.monotonic(),
                         request_id=req.request_id, replica=rep.index,
                         finish="error", error=kind)
        with self._lock:
            self._counts["failed"] += 1

    def _handle_prefill_done(self, rep: _Replica, msg: dict) -> None:
        """Disaggregated phase 2: the prefill-tier replica finished the
        prompt AND its KV planes were CRC-acked by the decode replica's
        handoff listener. Close the prefill hop, record the handoff, and
        dispatch the request to the decode replica that now holds the planes
        — its admission is a full prefix-cache hit, so it decodes without
        ever prefilling. Any invalidation in between (decode replica died,
        lost its room, restarted into a new generation) falls back to the
        classic path via a front requeue with ``no_disagg`` latched."""
        now = time.monotonic()
        if msg.get("id") is None:
            return
        with self._cond:
            req = rep.inflight.pop(msg["id"], None)
            if req is None:
                return
            req.phase = None
            rep.completed += 1
            rep.handoffs += 1
            self._cond.notify_all()
        nbytes = int(msg.get("handoff_bytes") or 0)
        wall = float(msg.get("handoff_wall_s") or 0.0)
        t0 = req.dispatch_by.get(rep.index, req.dispatch_s)
        with self._lock:
            self._counts["handoffs"] += 1
            self._counts["handoff_bytes"] += nbytes
        # The disagg span pair: the prefill-tier service interval (dispatch ->
        # prefill_done line, which CONTAINS the handoff) and the handoff ship
        # itself (replica-measured wall, anchored at the line's arrival) —
        # the trace evidence for "did disaggregation buy TTFT".
        self.tracer.span("prefill_tier", req.trace_id, t0, now,
                         request_id=req.request_id, replica=rep.index,
                         prompt_len=int(msg.get("prompt_len") or 0),
                         ttft_s=msg.get("ttft_s"))
        self.tracer.span("handoff", req.trace_id, now - wall, now,
                         request_id=req.request_id, replica=rep.index,
                         to_replica=req.decode_target, bytes=nbytes)
        self._writer.emit({"event": "kv_handoff", "ok": True,
                           "request_id": req.request_id,
                           "from_replica": rep.index,
                           "to_replica": req.decode_target,
                           "bytes": nbytes, "wall_s": round(wall, 6),
                           "prefill_ttft_s": msg.get("ttft_s"),
                           "prompt_len": int(msg.get("prompt_len") or 0)})
        if req.future.done():
            return                        # expired mid-prefill: nothing to run
        with self._cond:
            dec = (self.replicas[req.decode_target]
                   if req.decode_target is not None
                   and req.decode_target < len(self.replicas) else None)
            if dec is None or not dec.room() or dec.handoff_port is None:
                # The planes' owner can't take the request: the shipped state
                # is stranded, so the classic path (local prefill elsewhere)
                # is the only correct continuation.
                req.no_disagg = True
                req.decode_target = None
                req.enqueued_s = now
                self.queue.requeue(req)
                self._cond.notify_all()
                return
            req.disagg = True
            req.dispatch_by[dec.index] = now
            dec.inflight[req.request_id] = req
            dec.dispatched += 1
            dec.handoffs += 1
            if self._affinity_on:
                # The planes live in dec's prefix cache now — future prompts
                # sharing this prefix should route there.
                self._affinity.insert(req.prompt, dec.index)
            self._cond.notify_all()
        try:
            dec.send(self._submit_msg(req, now))
        except OSError:
            with self._cond:
                dec.inflight.pop(req.request_id, None)
                dec.wfile = None
                req.no_disagg = True
                req.enqueued_s = time.monotonic()
                self.queue.requeue(req)
                self._cond.notify_all()

    def _handle_prefill_failed(self, rep: _Replica, msg: dict) -> None:
        """Any prefill-tier fault (no planes, admission refusal, ship/CRC
        failure, decode-side nack): the request is intact in our custody —
        latch ``no_disagg`` and bounce it to the queue front for classic
        local prefill. Zero requests lost is the contract."""
        now = time.monotonic()
        if msg.get("id") is None:
            return
        with self._cond:
            req = rep.inflight.pop(msg["id"], None)
            if req is None:
                return
            req.phase = None
            self._cond.notify_all()
        reason = msg.get("reason") or "prefill_failed"
        with self._lock:
            self._counts["handoff_failures"] += 1
        self.tracer.span("dispatch", req.trace_id,
                         req.dispatch_by.get(rep.index, req.dispatch_s), now,
                         request_id=req.request_id, replica=rep.index,
                         outcome="bounced", error=f"prefill:{reason}",
                         hop=req.redispatches)
        self._writer.emit({"event": "kv_handoff", "ok": False,
                           "request_id": req.request_id,
                           "from_replica": rep.index,
                           "to_replica": req.decode_target,
                           "reason": reason})
        if req.future.done():
            return
        with self._cond:
            req.no_disagg = True
            req.decode_target = None
            req.dispatch_by.pop(rep.index, None)
            req.enqueued_s = now
            self.queue.requeue(req)
            self._cond.notify_all()

    def _record(self, comp: RouterCompletion) -> None:
        now = time.monotonic()
        with self._lock:
            self._counts["requests"] += 1
            self._counts["ok"] += comp.ok
            self._counts["timeout"] += comp.finish == "timeout"
            self._counts["shed"] += comp.finish == "shed"
            self._counts["new_tokens"] += comp.new_tokens
            self._counts["affinity_hits"] += comp.affinity_hit
            self._counts["redispatched_requests"] += comp.redispatches > 0
            for name in self._series:
                self._series[name].add(getattr(comp, name))
            row = self._tenant_counts.setdefault(
                comp.tenant, {"requests": 0, "ok": 0, "timeout": 0,
                              "shed": 0, "new_tokens": 0})
            row["requests"] += 1
            row["ok"] += comp.ok
            row["timeout"] += comp.finish == "timeout"
            row["shed"] += comp.finish == "shed"
            row["new_tokens"] += comp.new_tokens
            tseries = self._tenant_series.setdefault(comp.tenant, {
                "ttft_s": LogHistogram(self._hist_rel_err),
                "e2e_s": LogHistogram(self._hist_rel_err)})
            tseries["ttft_s"].add(comp.ttft_s)
            tseries["e2e_s"].add(comp.e2e_s)
            tspec = ((self.tenants.spec_for(comp.tenant).slo
                      if self.tenants is not None else None)
                     or self._slo_spec)
            if tspec is not None:
                tracker = self._slo_by_tenant.get(comp.tenant)
                if tracker is None:
                    tracker = self._slo_by_tenant[comp.tenant] = \
                        AttainmentTracker(tspec)
                # The client-facing per-tenant promise: the windowed view is
                # what fleet_snapshot ships the SLO-driven autoscaler.
                tracker.observe(now, ok=comp.ok, ttft_s=comp.ttft_s,
                                tpot_s=comp.tpot_s, e2e_s=comp.e2e_s)
            if self._slo_fleet is not None:
                self._slo_fleet.observe(now, ok=comp.ok, ttft_s=comp.ttft_s,
                                        tpot_s=comp.tpot_s, e2e_s=comp.e2e_s)
                per = self._slo_by_replica.setdefault(
                    comp.replica, AttainmentTracker(self._slo_spec))
                per.observe(now, ok=comp.ok, ttft_s=comp.ttft_s,
                            tpot_s=comp.tpot_s, e2e_s=comp.e2e_s)
        ev = {
            "event": "route", "request_id": comp.request_id,
            "replica": comp.replica, "affinity_hit": comp.affinity_hit,
            "redispatches": comp.redispatches, "finish": comp.finish,
            "prompt_len": comp.prompt_len, "new_tokens": comp.new_tokens,
            "queue_wait_s": comp.queue_wait_s, "ttft_s": comp.ttft_s,
            "tpot_s": comp.tpot_s, "e2e_s": comp.e2e_s,
            "tenant": comp.tenant,
        }
        if comp.hedged:
            # Only on hedged requests: hedging off keeps route lines
            # field-identical to the pre-hedging schema.
            ev["hedged"] = True
            ev["hedge_won"] = comp.hedge_won
        if comp.disagg:
            # Same rule for disaggregation: only requests that actually rode
            # the prefill-tier handoff mark their route line.
            ev["disagg"] = True
        self._writer.emit(ev)

    # ------------------------------------------------------------- gray failures

    def _maybe_eject(self, rep: _Replica, now: float) -> None:
        """Straggler scoring (caller holds the lock): flip ``rep`` to
        ``degraded`` when its windowed dispatch p95 exceeds ``straggler_k``
        times the median of its ready peers' p95s. Guards: enough samples on
        both sides (one slow request is noise, not a gray failure), at least
        one OTHER ready replica (never eject the last server — a degraded
        fleet member still beats an empty fleet), and k=0 disables scoring
        entirely (the pre-gray-failure path, bitwise).

        Deliberately DISTINCT from the heartbeat hang path: ejection keeps
        the process, the connection, and the in-flight ledger (work finishes;
        only NEW dispatch stops), while ``hung`` drains and restarts. A slow
        replica is an asset cooling off; a hung one is a corpse."""
        if self._straggler_k <= 0 or rep.state != "ready":
            return
        if rep.lat is None or rep.lat.count(now) < self._eject_min_samples:
            return
        peer_floor = max(1, self._eject_min_samples // 2)
        peers = [r for r in self.replicas
                 if r is not rep and r.state == "ready"
                 and r.lat is not None and r.lat.count(now) >= peer_floor]
        if not peers:
            return                # nobody to compare against / last server
        p95 = rep.lat.quantile(95, now)
        peer_p95s = sorted(r.lat.quantile(95, now) for r in peers)
        median = peer_p95s[len(peer_p95s) // 2]
        if p95 is None or median is None or median <= 0:
            return
        if p95 <= self._straggler_k * median:
            return
        rep.state = "degraded"
        rep.degraded_until = now + self._eject_cooldown_s
        rep.ejections += 1
        self._counts["ejections"] += 1
        # Emit INSIDE the transaction (the _fail_replica precedent): the
        # moment another thread can see the degraded state, the event is on
        # disk.
        self._writer.emit({"event": "eject", "action": "eject",
                           "replica": rep.index, "p95_s": round(p95, 6),
                           "fleet_p95_s": round(median, 6),
                           "k": self._straggler_k,
                           "cooldown_s": self._eject_cooldown_s,
                           "inflight": len(rep.inflight),
                           "ejections": rep.ejections})
        self._cond.notify_all()
        self.tracer.span("eject", self._fleet_trace, now, action="eject",
                         replica=rep.index, p95_s=round(p95, 6),
                         fleet_p95_s=round(median, 6))
        print(f"[router] replica {rep.index} EJECTED (degraded): dispatch "
              f"p95 {p95 * 1e3:.1f}ms vs fleet median {median * 1e3:.1f}ms "
              f"(k={self._straggler_k:g}); probe in "
              f"{self._eject_cooldown_s:g}s", flush=True)

    def _probe_replica(self, rep: _Replica, now: float) -> None:
        """Cooldown expiry: open the degraded replica back up. The probe IS
        the next real dispatch — the sketch restarts empty, so the verdict
        comes from post-recovery evidence only: still slow, it re-ejects
        after ``eject_min_samples`` fresh completions; recovered, it simply
        serves."""
        with self._cond:
            if rep.state != "degraded":
                return
            rep.state = "ready"
            if rep.lat is not None:
                rep.lat.reset()
            rep.probes += 1
            self._counts["probes"] += 1
            self._writer.emit({"event": "eject", "action": "probe",
                               "replica": rep.index,
                               "ejections": rep.ejections,
                               "probes": rep.probes})
            self._cond.notify_all()
        self.tracer.span("eject", self._fleet_trace, now, action="probe",
                         replica=rep.index)
        print(f"[router] replica {rep.index} probed back to ready "
              f"(ejection {rep.ejections})", flush=True)

    def _hedge_deadline(self, now: float) -> float | None:
        """Seconds a dispatch may stay pending before it earns a hedge:
        ``hedge_after_s`` verbatim when set, else ``hedge_factor`` x the
        fleet-wide windowed dispatch-latency ``hedge_quantile`` (floored at
        ``hedge_min_s``). None while the sketch is empty — with no evidence
        of what "normal" looks like, a hedge would be a blind duplicate."""
        if self._hedge_after_s > 0:
            return self._hedge_after_s
        with self._lock:
            if self._lat_fleet.count(now) < max(4, self._eject_min_samples // 2):
                return None
            q = self._lat_fleet.quantile(self._hedge_quantile, now)
        if q is None:
            return None
        return max(self._hedge_min_s, q * self._hedge_factor)

    def _hedge_scan(self, now: float) -> None:
        """Speculative re-dispatch (the monitor tick's hedging half): any
        request pending past the hedge deadline on a ready/degraded replica
        gets ONE copy on a second replica — first completion wins
        (``_handle_done`` resolves; ``_settle_peers`` cancels the loser).
        Correct by the same argument as crash redispatch: greedy decode is
        deterministic, so both copies produce identical tokens, and the
        duplicate-completion dedup already exists."""
        deadline = self._hedge_deadline(now)
        if deadline is None:
            return

        def stuck(r: _Replica) -> bool:
            # A replica already sitting on work older than the hedge deadline
            # is visibly slow RIGHT NOW — hedging onto it trades one straggler
            # for another (pre-ejection, its sketch may not have tripped yet;
            # its ledger already tells the story).
            return any(now - (q.dispatch_by.get(r.index) or q.dispatch_s
                              or now) > deadline
                       for q in r.inflight.values())

        sends: list[tuple[_Replica, RouterRequest]] = []
        with self._cond:
            for rep in self.replicas:
                if rep.state not in ("ready", "degraded"):
                    continue      # draining/failed ledgers have their own path
                for req in list(rep.inflight.values()):
                    # A prefill-phase entry is not a decode in progress: its
                    # planes are mid-handoff, and a hedged submit copy would
                    # race the decode-tier dispatch prefill_done triggers.
                    if req.hedged or req.future.done() \
                            or req.phase == "prefill":
                        continue
                    t0 = req.dispatch_by.get(rep.index, req.dispatch_s)
                    if t0 is None or now - t0 < deadline:
                        continue
                    ups = [r for r in self.replicas
                           if r is not rep and r.room()
                           and req.request_id not in r.inflight
                           and not stuck(r)]
                    if not ups:
                        continue  # no healthy spare: the hedge can wait
                    tgt = min(ups, key=lambda r: (len(r.inflight), r.index))
                    # The hedge decision is itself a latency sample — a
                    # CENSORED one (the true latency is >= elapsed). Without
                    # it a straggler whose completions keep losing hedge
                    # races never scores (its late done lines arrive as
                    # settled duplicates, which record nothing), and the
                    # ejection detector starves exactly when hedging works.
                    # One sample per hedge, never per scan tick.
                    if rep.lat is not None:
                        rep.lat.add(now - t0, now)
                        self._maybe_eject(rep, now)
                    req.hedged = True
                    req.hedge_replica = tgt.index
                    req.dispatch_by[tgt.index] = now
                    tgt.inflight[req.request_id] = req
                    tgt.dispatched += 1
                    tgt.hedges += 1
                    self._counts["hedges"] += 1
                    sends.append((tgt, req))
            if sends:
                self._cond.notify_all()
        for tgt, req in sends:
            self._writer.emit({"event": "hedge", "request_id": req.request_id,
                               "replica": tgt.index,
                               "deadline_s": round(deadline, 6),
                               "tenant": req.tenant})
            # The hedge marker is a point span (like redispatch): the copy's
            # own dispatch window closes later as "ok" or "hedge_lost".
            self.tracer.span("hedge", req.trace_id, now,
                             request_id=req.request_id, replica=tgt.index,
                             deadline_s=round(deadline, 6))
            try:
                tgt.send(self._submit_msg(req, now))
            except OSError:
                # The hedge target's connection died under us: unwind — the
                # primary copy is still in flight, and a later scan may
                # re-hedge elsewhere.
                with self._cond:
                    tgt.inflight.pop(req.request_id, None)
                    req.hedged = False
                    req.hedge_replica = None
                    req.dispatch_by.pop(tgt.index, None)
                    self._cond.notify_all()

    # ------------------------------------------------------------------ dispatch

    def _choose(self, prompt: np.ndarray) -> tuple[_Replica | None, bool, bool]:
        """Pick the dispatch target (caller holds the lock): the affine replica
        when it has room, else the least-loaded replica with room (spill-over),
        else None (everyone is at capacity — backpressure holds the request).
        Returns ``(replica, affinity_hit, spilled)`` — ``spilled`` marks an
        affine replica that existed but had no room (the route span records it:
        a paid-for warm cache the fleet was too loaded to use)."""
        spilled = False
        if self._affinity_on:
            # Only ready replicas are candidates: an entry homed on a
            # draining/retired/dead replica must not route traffic there (the
            # affinity satellite fix — before, draining replicas kept
            # receiving affine traffic until they actually died).
            alive = {r.index for r in self.replicas
                     if r.state == "ready" and r.tier != "prefill"}
            idx = self._affinity.lookup(prompt, self._affinity_min,
                                        alive=alive)
            if idx is not None:
                if self.replicas[idx].room():
                    return self.replicas[idx], True, False
                spilled = True
        ups = [r for r in self.replicas if r.room()]
        if any(r.tier == "prefill" for r in self.replicas):
            # Tiered fleet: classic (decode-holding) dispatch never lands on
            # the prefill tier — those replicas take ``prefill`` ops only.
            # Degenerate all-prefill fleets keep serving (misconfig beats
            # deadlock).
            serve = [r for r in ups if r.tier != "prefill"]
            if serve or any(r.tier != "prefill" for r in self.replicas):
                ups = serve
        if not ups:
            return None, False, spilled
        self._rr += 1
        rep = min(ups, key=lambda r: (len(r.inflight),
                                      (r.index - self._rr) % len(self.replicas)))
        return rep, False, spilled

    def _choose_disagg(self, req: RouterRequest) \
            -> tuple[_Replica, _Replica] | None:
        """Disaggregated target pair (caller holds the lock): a ready
        prefill-tier replica with room plus a ready decode-tier replica with
        a handoff listener and room. None whenever the detour isn't
        available or isn't worth it (no tiers, a latched ``no_disagg``, a
        short prompt, either tier at capacity) — the caller falls through to
        classic dispatch, because disaggregation is an optimization, never a
        dependency."""
        if req.no_disagg or len(req.prompt) < self._disagg_min_prompt:
            return None
        pres = [r for r in self.replicas if r.tier == "prefill" and r.room()]
        if not pres:
            return None
        decs = [r for r in self.replicas
                if r.tier == "decode" and r.room()
                and r.handoff_port is not None]
        if not decs:
            return None
        pre = min(pres, key=lambda r: (len(r.inflight), r.index))
        dec = min(decs, key=lambda r: (len(r.inflight), r.index))
        return pre, dec

    @staticmethod
    def _submit_msg(req: RouterRequest, now: float) -> dict:
        """The wire-protocol submit line. ``trace_id`` is added ONLY when the
        request carries one — tracing off keeps the message byte-identical to
        the pre-tracing protocol (pinned in tests). The tenancy fields follow
        the same rule: a default-class request (tenant "default", priority 0,
        not preemptible) ships the exact pre-tenancy line, so single-tenant
        fleets never change on the wire."""
        msg = {"op": "submit", "id": req.request_id,
               "prompt": [int(t) for t in req.prompt],
               "max_new_tokens": req.max_new_tokens,
               "temperature": req.sampling.temperature,
               "top_k": req.sampling.top_k, "top_p": req.sampling.top_p,
               "timeout_s": (None if req.deadline_s is None
                             else max(0.001, req.deadline_s - now))}
        if req.trace_id is not None:
            msg["trace_id"] = req.trace_id
        if req.tenant != "default":
            msg["tenant"] = req.tenant
        if req.priority:
            msg["priority"] = req.priority
        if req.preemptible:
            msg["preemptible"] = True
        return msg

    def _dispatch_one(self, req: RouterRequest) -> bool:
        """Send one request to a chosen replica; False when everyone is full.
        On a tiered fleet a qualifying request takes the disaggregated detour
        instead: a ``prefill`` op to the prefill tier naming the decode-tier
        replica whose handoff listener will receive the planes — the decode
        dispatch itself happens when ``prefill_done`` lands."""
        now = time.monotonic()
        with self._cond:
            pair = self._choose_disagg(req)
            if pair is not None:
                pre, dec = pair
                req.dispatch_s = now
                req.dispatch_by = {pre.index: now}
                req.hedged = False
                req.hedge_replica = None
                req.affinity_hit = False
                req.phase = "prefill"
                req.decode_target = dec.index
                if self._served_from_s is None:
                    self._served_from_s = now
                pre.inflight[req.request_id] = req
                pre.dispatched += 1
                if self._in_transit is req:
                    self._in_transit = None
                handoff_port = dec.handoff_port
            if pair is None:
                rep, hit, spilled = self._choose(req.prompt)
                if rep is None:
                    return False
                # Stamp the LAST dispatch: the client's first token comes
                # from the attempt that succeeds, so a redispatched request's
                # ttft/queue wait must include the failed attempt + detection
                # + backoff time it sat through, not just its first hop.
                req.dispatch_s = now
                # A fresh hop set: stale stamps (a drained hop's replica, a
                # past hedge) must not leak into this attempt's spans or
                # sketches.
                req.dispatch_by = {rep.index: now}
                req.hedged = False
                req.hedge_replica = None
                req.phase = None
                req.decode_target = None
                if self._served_from_s is None:
                    self._served_from_s = now
                req.affinity_hit = hit
                rep.inflight[req.request_id] = req
                rep.dispatched += 1
                if self._in_transit is req:  # visible in the ledger from here
                    self._in_transit = None
                if self._affinity_on:
                    self._affinity.insert(req.prompt, rep.index)
        if pair is not None:
            self.tracer.span("queue_wait", req.trace_id, req.enqueued_s, now,
                             request_id=req.request_id, hop=req.redispatches)
            self.tracer.span("route", req.trace_id, now,
                             request_id=req.request_id, replica=pre.index,
                             disagg=True, decode_replica=req.decode_target,
                             hop=req.redispatches)
            msg = {"op": "prefill", "id": req.request_id,
                   "prompt": [int(t) for t in req.prompt],
                   "handoff": {"host": "127.0.0.1", "port": handoff_port}}
            if req.trace_id is not None:
                msg["trace_id"] = req.trace_id
            if req.tenant != "default":
                msg["tenant"] = req.tenant
            if req.priority:
                msg["priority"] = req.priority
            if req.preemptible:
                msg["preemptible"] = True
            try:
                pre.send(msg)
            except OSError:
                # Prefill connection died under us: same pull-back as below,
                # plus the no_disagg latch — the retry goes classic.
                with self._cond:
                    pre.inflight.pop(req.request_id, None)
                    pre.wfile = None
                    req.phase = None
                    req.no_disagg = True
                    self._cond.notify_all()
                req.enqueued_s = time.monotonic()
                self.queue.requeue(req)
            return True
        # This queue stint ends here (enqueued_s -> dispatch); the route span
        # records the decision itself — target, affinity outcome, spill-over.
        self.tracer.span("queue_wait", req.trace_id, req.enqueued_s, now,
                         request_id=req.request_id, hop=req.redispatches)
        self.tracer.span("route", req.trace_id, now,
                         request_id=req.request_id, replica=rep.index,
                         affinity_hit=hit, spilled=spilled,
                         hop=req.redispatches)
        msg = self._submit_msg(req, now)
        try:
            rep.send(msg)
        except OSError:
            # Connection died under us: pull the request back and close the
            # room (wfile None -> room() False) so the dispatch loop waits
            # for the io thread's teardown instead of spinning this replica;
            # the monitor/io thread classifies it.
            with self._cond:
                rep.inflight.pop(req.request_id, None)
                rep.wfile = None
                self._cond.notify_all()
            req.enqueued_s = time.monotonic()   # a fresh queue stint begins
            self.queue.requeue(req)
        return True

    def _expire(self, req: RouterRequest, now: float) -> None:
        if req.future.done():
            return
        comp = RouterCompletion(
            request_id=req.request_id, tokens=np.zeros((0,), np.int32),
            finish="timeout", prompt_len=len(req.prompt), new_tokens=0,
            replica=-1, redispatches=req.redispatches, tenant=req.tenant,
            queue_wait_s=now - req.arrival_s, e2e_s=now - req.arrival_s)
        try:
            req.future.set_result(comp)
        except concurrent.futures.InvalidStateError:
            return                        # lost a resolve race: already settled
        # Expiry is terminal too: a timed-out trace must not read as an orphan.
        self.tracer.span("resolve", req.trace_id, now, time.monotonic(),
                         request_id=req.request_id, finish="timeout",
                         redispatches=req.redispatches)
        self._record(comp)

    def _tenant_inflight_locked(self) -> dict[str, int]:
        """Concurrent dispatches per tenant, summed over the replica ledgers
        (on demand — the ledgers are the one source of truth, so no counter
        can drift through the redispatch/drain/expiry paths)."""
        counts: dict[str, int] = {}
        for rep in self.replicas:
            for req in rep.inflight.values():
                counts[req.tenant] = counts.get(req.tenant, 0) + 1
        return counts

    def _tenant_budgets_locked(self) -> dict | None:
        """Per-tenant dispatch allowance (``max_inflight`` minus the ledger
        count): the budget decrements inside ``take``, so one pass can never
        overshoot a cap — a best-effort burst cannot occupy the whole fleet
        while other tenants' work flows around it."""
        if self.tenants is None:
            return None
        counts = self._tenant_inflight_locked()
        budgets = {name: spec.max_inflight - counts.get(name, 0)
                   for name, spec in self.tenants.specs.items()
                   if spec.max_inflight}
        return budgets or None

    def _dispatch_loop(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    return
            now = time.monotonic()
            with self._cond:
                # take-and-mark is one transaction: a request must never be in
                # neither the queue nor anywhere a shutdown sweep looks.
                admitted, expired = self.queue.take(
                    now, 1, tenant_budgets=self._tenant_budgets_locked())
                if admitted:
                    self._in_transit = admitted[0]
            for req in expired:
                self._expire(req, now)
            if not admitted:
                if len(self.queue):
                    # Work is queued but nothing was takeable: every queued
                    # lane is at its tenant's in-flight cap. Throttle — cap
                    # room opens when a completion lands, not when the queue
                    # stirs, so spinning on the condition would burn a core.
                    time.sleep(self._poll_s)
                    continue
                # wait_for_work returns immediately once the queue is closed
                # (drain in progress); don't turn that into a hot spin.
                if not self.queue.wait_for_work(self._poll_s) and self.queue.closed:
                    time.sleep(self._poll_s)
                continue
            req = admitted[0]
            if req.future.done():             # resolved while queued (expiry race)
                with self._cond:
                    self._in_transit = None
                    self._cond.notify_all()
                continue
            if not self._dispatch_one(req):
                # Everyone at capacity (or restarting): the request goes BACK
                # into the queue — it must stay visible to stop()'s drain wait
                # and to deadline expiry — and we wait for room.
                with self._cond:
                    self.queue.requeue(req)
                    self._in_transit = None
                    self._cond.wait(self._poll_s)

    def _drained(self) -> bool:
        with self._lock:
            return (len(self.queue) == 0
                    and self._in_transit is None
                    and all(not r.inflight for r in self.replicas))

    # ------------------------------------------------------------------ monitor

    # Failure reasons as trace-span causes: the vocabulary the redispatch span
    # uses — crash / preempt / hang, plus the two
    # connection-level ones.
    _CAUSES = {"preempted": "preempt", "hung": "hang"}

    def _drain_ledger(self, rep: _Replica, now: float,
                      cause: str = "conn_lost") -> int:
        """Move a dead/unreachable replica's in-flight work back into the queue
        FRONT (caller holds the lock): FIFO order preserved, already-settled
        requests skipped, past-deadline requests resolved as timeouts instead
        of being replayed. The ONE owner of redispatch accounting — both the
        failure path and the live-process reconnect path go through here.
        Returns how many entries the ledger held."""
        cause = self._CAUSES.get(cause, cause)
        drained = list(rep.inflight.values())
        rep.inflight.clear()
        for req in reversed(drained):         # appendleft x N keeps FIFO order
            if req.future.done():
                continue                      # already resolved: nothing to replay
            # The losing hop closes here (outcome="drained" — the interval the
            # critical path charges as failed_dispatch, unlike an "ok" dispatch
            # which merely overlaps the replica's own spans).
            self.tracer.span("dispatch", req.trace_id,
                             req.dispatch_by.get(rep.index, req.dispatch_s),
                             now, request_id=req.request_id,
                             replica=rep.index,
                             outcome="drained", hop=req.redispatches)
            if any(req.request_id in r.inflight
                   for r in self.replicas if r is not rep):
                # A hedged twin is still live on another replica: no replay
                # needed (it resolves there) and no redispatch counted — just
                # re-arm hedging for the surviving copy.
                req.hedged = False
                req.hedge_replica = None
                req.dispatch_by.pop(rep.index, None)
                continue
            if req.phase == "prefill":
                # Mid-handoff death: the prefill-tier replica (and whatever
                # planes it shipped) died with the work — latch the classic
                # path so the replay prefills locally. Zero requests lost.
                req.phase = None
                req.no_disagg = True
                req.decode_target = None
            if req.deadline_s is not None and now > req.deadline_s:
                self._expire(req, now)        # past deadline: expired, NOT a
            else:                             # redispatch — don't count one
                req.redispatches += 1
                self._counts["redispatches"] += 1
                # The hop marker: hop number of the attempt about to begin and
                # why the last one died — the span tree's crash/preempt/hang
                # evidence (a point span; the replay's own queue stint starts
                # now).
                self.tracer.span("redispatch", req.trace_id, now,
                                 request_id=req.request_id, replica=rep.index,
                                 cause=cause, hop=req.redispatches)
                req.enqueued_s = now
                self.queue.requeue(req)
        return len(drained)

    def _fail_replica(self, rep: _Replica, reason: str,
                      exit_code: int | None = None) -> None:
        """Drain a failed replica's in-flight ledger back into the queue front
        and schedule (or refuse) its restart."""
        with self._cond:
            if rep.state in ("dead", "restarting"):
                return
            rep.generation += 1               # io thread for old gen stands down
            sock, rep.sock, rep.wfile = rep.sock, None, None
            rep.exit_code = exit_code
            self._affinity.drop_replica(rep.index)
            now = time.monotonic()
            drained = self._drain_ledger(rep, now, cause=reason)
            if rep.restarts >= self._max_restarts:
                rep.state = "dead"
            else:
                rep.restarts += 1
                if self._backoff_s <= 0:
                    backoff = 0.0
                elif self._backoff_jitter and rep.restart_backoff is not None:
                    # Decorrelated jitter (serving/wire.py): a fleet-wide blip
                    # that kills every replica at once must not produce a
                    # synchronized restart storm N backoffs later. Seeded per
                    # replica — the schedule is pinned for tests, different
                    # across peers.
                    backoff = rep.restart_backoff.next()
                else:
                    backoff = min(self._backoff_s * (2 ** (rep.restarts - 1)),
                                  self._backoff_max_s)
                rep.restart_due = now + backoff
                rep.state = "restarting"
            state, backoff_s = rep.state, (rep.restart_due - now
                                           if rep.state == "restarting" else None)
            # Emit INSIDE the transaction: the moment another thread can see
            # the bumped restart count (a test, stop()'s summary), the event
            # must already be on disk — the blocking teardown below can lose a
            # race against stop() closing the writer.
            self._writer.emit({"event": "replica", "replica": rep.index,
                               "action": "dead" if state == "dead" else "fail",
                               "reason": reason, "exit_code": exit_code,
                               "restarts": rep.restarts,
                               "drained": drained, "backoff_s": backoff_s})
            self._cond.notify_all()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if rep.fleet is not None:
            rep.fleet.terminate(grace=2.0)
        print(f"[router] replica {rep.index} {reason}"
              + (f" (exit {exit_code})" if exit_code is not None else "")
              + f"; drained {drained} in-flight; "
              + ("giving up (restart budget exhausted)" if state == "dead"
                 else f"restart {rep.restarts}/{self._max_restarts} "
                      f"in {backoff_s:.2f}s"), flush=True)
        if state == "dead":
            with self._lock:
                all_dead = all(r.state == "dead" for r in self.replicas)
            if all_dead:
                self._abort_all()

    def _abort_all(self) -> None:
        """Every replica exhausted its restart budget: fail all outstanding
        work with the typed error instead of hanging submitters."""
        err = ServerStopped("router aborted: every replica is dead")
        self.queue.close()
        now = time.monotonic()
        with self._cond:
            self._aborted = True
            # Sweep the queue INSIDE the lock: the dispatch thread's
            # failed-dispatch path requeues its in-transit request under this
            # cond, so a sweep taken before acquiring it can race — the
            # request hops from _in_transit back into an already-swept queue
            # and its future hangs forever.
            leftovers, expired = self.queue.take(now, 1 << 30)
            if self._in_transit is not None:
                leftovers.append(self._in_transit)
            for rep in self.replicas:
                leftovers.extend(rep.inflight.values())
                rep.inflight.clear()
            self._cond.notify_all()
        for req in expired:         # past-deadline: resolve as timeouts — NEVER
            self._expire(req, now)        # drop them with their futures pending
        for req in leftovers:
            try:
                if not req.future.done():
                    req.future.set_exception(err)
                    # Terminal span: an aborted future is resolved, not
                    # stranded — its trace must not read as an orphan.
                    self.tracer.span("resolve", req.trace_id, now,
                                     time.monotonic(),
                                     request_id=req.request_id,
                                     finish="aborted")
            except concurrent.futures.InvalidStateError:
                pass      # lost a resolve race — must not kill the monitor thread

    def _stale(self, rep: _Replica) -> bool:
        # Degraded replicas stay under the hang watch: ejection means "slow,
        # stop feeding it", but a replica that then STOPS beating is a corpse
        # holding an in-flight ledger — that rides the hang drain, exactly
        # like a ready one. The two detectors stay orthogonal.
        if not (self._hb_dir and self._hb_timeout_s > 0
                and rep.state in ("ready", "degraded")):
            return False
        beat = hb.read_heartbeats(self._hb_dir).get(rep.index)
        t = (beat["time"] if beat and beat["time"] >= rep.started_wall
             else rep.started_wall)
        return time.time() - t > self._hb_timeout_s

    def _monitor_loop(self) -> None:
        next_hb = 0.0
        while True:
            with self._lock:
                if self._stopping:
                    return
                reps = list(self.replicas)
            now = time.monotonic()
            check_hb = now >= next_hb
            if check_hb:
                next_hb = now + max(self._poll_s,
                                    self._hb_timeout_s / 10 or self._poll_s)
            for rep in reps:
                # draining/retired replicas are owned by their retire/reload
                # thread (an expected exit 0 must never classify as a crash);
                # the drain deadline bounds a death there instead.
                if rep.state in ("starting", "warming", "ready", "degraded"):
                    if not rep.fleet.running:
                        rc = rep.fleet.poll()
                        reason = ("preempted" if rc == EXIT_PREEMPTED
                                  else "crash")
                        self._fail_replica(rep, reason, exit_code=rc)
                        continue
                    if (rep.state in ("ready", "degraded") and check_hb
                            and self._stale(rep)):
                        # Hung beats degraded: a silent heartbeat means the
                        # process is a corpse whatever its latency score said
                        # — drain + restart, the PR-6 path.
                        self._fail_replica(rep, "hung")
                        continue
                    if rep.state == "degraded" and now >= rep.degraded_until:
                        self._probe_replica(rep, now)
                        continue
                    if (rep.state in ("starting", "warming")
                            and now - rep.started_mono > self._connect_timeout_s):
                        self._fail_replica(rep, "connect_timeout")
                        continue
                elif rep.state == "draining":
                    # The drain has three exits, all landing in _finish_retire
                    # (state-guarded — whichever fires first wins): the drained
                    # ack (io thread), the process's own exit 0, and the drain
                    # deadline (a wedged replica cannot hold its in-flight work
                    # hostage — stragglers redispatch, the process is reaped).
                    if not rep.fleet.running:
                        self._finish_retire(rep, how="exited")
                    elif now > rep.drain_deadline:
                        self._finish_retire(rep, how="deadline")
                elif rep.state == "restarting" and now >= rep.restart_due:
                    self._writer.emit({"event": "replica", "replica": rep.index,
                                       "action": "restart",
                                       "restarts": rep.restarts})
                    with self._lock:
                        self._spawn(rep)
            if self._hedge:
                self._hedge_scan(now)
            time.sleep(self._poll_s)

    # ------------------------------------------------------------------ snapshot

    def _poke_stats(self) -> None:
        """Fire-and-forget ``stats`` requests to every live replica; the io
        threads fold the replies into ``rep.stats`` whenever they land. Unlike
        ``_collect_stats`` this never blocks — the snapshot loop reads whatever
        the LAST poke brought back (at most one interval stale, which the
        timeline consumer tolerates by construction: it is a trend signal)."""
        with self._lock:
            targets = [r for r in self.replicas
                       if r.state in ("ready", "degraded", "draining")
                       and r.wfile is not None]
        for rep in targets:
            try:
                rep.send({"op": "stats", "id": -1})
            except OSError:
                pass                  # dying replica: the monitor will classify

    def fleet_snapshot(self) -> dict:
        """One ``fleet_snapshot`` event: the router-side load state (queue
        depth/oldest-age, per-replica in-flight vs capacity, restart and
        redispatch counters, affinity rate) joined with each replica's last
        reported engine counters (slot occupancy, prefill backlog, prefix-cache
        hit rate, measured decode bytes/token). This is the scale-up/down
        signal the autoscaler consumes: queue
        depth + oldest-age rising while utilization is pinned at 1.0 means
        "grow"; utilization falling toward 0 with an empty queue means
        "shrink"."""
        now = time.monotonic()
        with self._lock:
            counts = dict(self._counts)
            target = self._target
            scale = dict(self._scale_counts)
            canary = ({"replica": self._canary,
                       "checkpoint": self._canary_checkpoint}
                      if self._canary is not None else None)
            per_replica = []
            for r in self.replicas:
                row = {"replica": r.index, "state": r.state,
                       "inflight": len(r.inflight), "capacity": r.capacity,
                       "restarts": r.restarts, "dispatched": r.dispatched,
                       "completed": r.completed,
                       "hedges": r.hedges, "ejections": r.ejections}
                if r.tier != "unified":
                    # Only on tiered fleets: untiered snapshots keep the
                    # pre-disaggregation row schema field-identical.
                    row["tier"] = r.tier
                    row["handoffs"] = r.handoffs
                if self._canary == r.index:
                    # Only while a canary is live: rows stay field-identical
                    # to the pre-promotion schema otherwise.
                    row["canary"] = True
                    row["canary_checkpoint"] = self._canary_checkpoint
                if self._slo_fleet is not None:
                    tracker = self._slo_by_replica.get(r.index)
                    row["slo"] = (tracker.window(now) if tracker is not None
                                  else {"attainment": None, "requests": 0})
                eng = (r.stats or {}).get("engine") or {}
                if eng:
                    row["occupancy"] = eng.get("slot_occupancy")
                    row["prefill_backlog"] = eng.get("prefill_backlog")
                    pc = eng.get("prefix_cache") or {}
                    if pc.get("queries"):
                        row["prefix_hit_rate"] = pc["hits"] / pc["queries"]
                    by = eng.get("bytes") or {}
                    if by:
                        row["decode_bytes_per_token"] = \
                            by.get("decode_bytes_per_token")
                    kp = eng.get("kv_pages") or {}
                    if kp:
                        # Paged replicas only (contiguous rows stay
                        # field-identical): pool pressure for the autoscaler
                        # and fleet_top's pages column — refusals rising with
                        # free pinned at 0 is KV pressure, not compute load.
                        row["kv_pages"] = {
                            k: kp.get(k) for k in
                            ("free", "in_use", "shared", "refusals",
                             "fragmentation")}
                    sp = eng.get("spec") or {}
                    if sp:
                        # Speculative decoding's load-relevant number: tokens
                        # each slot's cache read amortized over (1.0 = plain
                        # decode) — an acceptance collapse shows up here
                        # before it shows up as tokens/s.
                        row["spec_accepted_per_step"] = \
                            sp.get("accepted_tokens_per_step")
                per_replica.append(row)
        inflight = sum(r["inflight"] for r in per_replica)
        # Utilization is READY in-flight over READY capacity: a draining
        # replica's stragglers are not dispatchable load, and charging them
        # against the ready denominator made every graceful drain read as
        # overload (the autoscaler would scale up right after its own
        # scale-down — shrink/grow flapping).
        ready_inflight = sum(r["inflight"] for r in per_replica
                             if r["state"] == "ready")
        capacity = sum(r["capacity"] or 0 for r in per_replica
                       if r["state"] == "ready")
        routed = counts["requests"]
        queue_snap = self.queue.snapshot(now)
        extra = {"canary": canary} if canary else {}
        with self._lock:
            # Per-tenant fleet state: in-flight dispatches (summed over the
            # ledgers), the queue's lane counters, and the tenant's windowed
            # attainment — the row an SLO-driven autoscaler (slo_tenant=...)
            # and fleet_top read per tier.
            tenant_inflight = self._tenant_inflight_locked()
            tenant_names = set(tenant_inflight) | set(self._tenant_counts) \
                | set((queue_snap.get("tenants") or {}))
            if self.tenants is not None:
                tenant_names |= set(self.tenants.names())
            tenants = {}
            for name in sorted(tenant_names):
                lane = (queue_snap.get("tenants") or {}).get(name) or {}
                fleet_row = self._tenant_counts.get(name) or {}
                tracker = self._slo_by_tenant.get(name)
                tenants[name] = {
                    "inflight": tenant_inflight.get(name, 0),
                    "queued": lane.get("depth", 0),
                    "oldest_age_s": lane.get("oldest_age_s"),
                    # The queue's lane tally covers BOTH shed flavors
                    # (refused arrivals and displaced victims) — the
                    # completion-side count would double-charge the latter.
                    "quota_rejected": lane.get("quota_rejected", 0),
                    "shed": lane.get("shed", 0),
                    "requests": fleet_row.get("requests", 0),
                    "slo": (tracker.window(now) if tracker is not None
                            else None),
                }
        return {
            "event": "fleet_snapshot",
            "queue": queue_snap,
            "tenants": tenants or None,
            "inflight": inflight,
            "capacity_up": capacity,
            "utilization": ready_inflight / capacity if capacity else None,
            # The elasticity fields the autoscaler reads: the DESIRED count
            # (an in-flight spawn already counts, so the policy never stacks
            # spawns) vs what is actually serving right now.
            "target": target,
            "replicas_ready": sum(r["state"] == "ready" for r in per_replica),
            "scale": scale,
            "requests": routed,
            "ok": counts["ok"],
            "failed": counts["failed"],
            "redispatches": counts["redispatches"],
            "duplicates": counts["duplicates"],
            # Gray-failure live counters: how many replicas are currently
            # sitting out (degraded — excluded from ready capacity above, so
            # the autoscaler sees their absence, not their slowness), plus
            # cumulative ejection/hedge/wire-damage tallies.
            "replicas_degraded": sum(r["state"] == "degraded"
                                     for r in per_replica),
            "ejections": counts["ejections"],
            "hedges": counts["hedges"],
            "hedge_wins": counts["hedge_wins"],
            "wire_corrupt": counts["wire_corrupt"],
            "handoffs": counts["handoffs"],
            "handoff_bytes": counts["handoff_bytes"],
            "handoff_failures": counts["handoff_failures"],
            "affinity_rate": (counts["affinity_hits"] / routed
                              if routed else None),
            "restarts": sum(r["restarts"] for r in per_replica),
            # Fleet-level recent attainment: the autoscaler's SLO signal (read
            # it instead of raw utilization once scaling goes SLO-driven).
            "slo": (self._slo_fleet.window(now)
                    if self._slo_fleet is not None else None),
            "per_replica": per_replica,
            # Only while a canary is live: the pre-promotion snapshot schema
            # stays field-identical otherwise.
            **extra,
        }

    def _snapshot_loop(self) -> None:
        """The metrics timeline: every ``snapshot_interval_s``, poke the
        replicas for fresh engine counters and emit one ``fleet_snapshot``
        line. Emission stops with the writer (stop() closes it; emit on a
        closed writer is a guarded no-op). With an ``autoscale`` policy this
        loop is also the ACTUATOR: each snapshot is folded into the
        hysteresis state and a verdict immediately drives
        ``scale_up``/``scale_down`` — the signal and the decision share one
        clock, so the policy's sustain counts translate directly into
        reaction time."""
        interval = self._snapshot_interval_s
        while True:
            deadline = time.monotonic() + interval
            self._poke_stats()
            while time.monotonic() < deadline:
                with self._lock:
                    if self._stopping:
                        return
                time.sleep(min(self._poll_s, interval / 4))
            snap = self.fleet_snapshot()
            with self._lock:
                self._replica_series.append(snap["replicas_ready"])
            self._writer.emit(snap)
            if self._autoscaler is not None:
                verdict = self._autoscaler.observe(snap, time.monotonic())
                if verdict == "up":
                    self.scale_up(reason="autoscale")
                elif verdict == "down":
                    self.scale_down(reason="autoscale")

    # ------------------------------------------------------------------ stop

    def _collect_stats(self, wait_s: float = 3.0) -> None:
        """Ask every live replica for its engine/queue counters (best effort —
        a replica that died mid-run reports nothing; its pre-crash counters died
        with it, which the summary notes via per-replica restart counts)."""
        asked = []
        with self._lock:
            for rep in self.replicas:
                if (rep.state in ("ready", "degraded", "draining")
                        and rep.wfile is not None):
                    try:
                        rep.send({"op": "stats", "id": -1})
                        asked.append(rep)
                    except OSError:
                        pass
        deadline = time.monotonic() + wait_s
        with self._cond:
            self._cond.wait_for(
                lambda: all(r.stats is not None for r in asked),
                timeout=max(0.0, deadline - time.monotonic()))

    def stop(self, *, drain: bool = True, timeout: float | None = None) -> dict:
        """Drain (``drain=True``) or abandon outstanding work, collect replica
        stats, stop the fleet, emit ``router_summary``. Returns the summary
        dict (also kept as ``last_summary``). A drain that outlives ``timeout``
        fails the leftovers with ``ServerStopped`` and raises it — same
        contract as ``Server.stop``."""
        self.queue.close()
        leftover: list[RouterRequest] = []
        if drain and not self._aborted:
            deadline = None if timeout is None else time.monotonic() + timeout
            with self._cond:
                self._cond.wait_for(
                    self._drained,
                    timeout=None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
        if not self._drained():
            now = time.monotonic()
            taken, expired = self.queue.take(now, 1 << 30)
            for req in expired:     # past-deadline: resolve as timeouts — NEVER
                self._expire(req, now)    # drop them with their futures pending
            leftover.extend(taken)
            with self._cond:
                if self._in_transit is not None:
                    leftover.append(self._in_transit)
                    self._in_transit = None
                for rep in self.replicas:
                    leftover.extend(rep.inflight.values())
                    rep.inflight.clear()
        if leftover and not drain:
            # Abandoning work on purpose: resolve as timeouts (partial-free),
            # mirroring Server.stop(drain=False)'s expiry-sweep semantics.
            now = time.monotonic()
            for req in leftover:
                self._expire(req, now)
            leftover = []
        # Service ends HERE: stats collection and fleet teardown below can take
        # whole seconds of zero-token wall, which must not land in the
        # denominator of the summary's tokens_per_s (the value the report CLI
        # A/B-compares — and serve_loadgen deliberately computes its own wall
        # before calling stop() for the same reason).
        served_until_s = time.monotonic()
        self._collect_stats()
        with self._lock:
            self._stopping = True
            self._cond.notify_all()
            reps = list(self.replicas)
        for rep in reps:                      # graceful stop, then hard teardown
            if rep.wfile is not None:
                try:
                    rep.send({"op": "stop"})
                except OSError:
                    pass
        stop_deadline = time.monotonic() + 5.0
        for rep in reps:
            while (rep.fleet is not None and rep.fleet.running
                   and time.monotonic() < stop_deadline):
                time.sleep(0.02)
            if rep.fleet is not None:
                rep.fleet.terminate(grace=1.0)
            if rep.proxy is not None:
                rep.proxy.stop()
        err = None
        leftover = [r for r in leftover if not r.future.done()]
        if leftover:
            err = ServerStopped(
                f"router stopped with {len(leftover)} request(s) unfinished")
            sweep_s = time.monotonic()
            for req in leftover:
                try:
                    if not req.future.done():
                        req.future.set_exception(err)
                        # Terminal span, same contract as _expire/_abort_all:
                        # a swept future's trace must not read as an orphan.
                        self.tracer.span("resolve", req.trace_id, sweep_s,
                                         time.monotonic(),
                                         request_id=req.request_id,
                                         finish="stopped")
                except concurrent.futures.InvalidStateError:
                    pass          # lost a resolve race: already settled elsewhere
        if self._slo_fleet is not None:
            self._writer.emit(slo_event(
                self._slo_fleet, source="router",
                window=self._slo_fleet.window(time.monotonic())))
        for tenant, row in self.tenant_summaries().items():
            self._writer.emit({"event": "tenant_summary", "source": "router",
                               "tenant": tenant, **row})
        self.last_summary = self._summary(end_s=served_until_s)
        self._writer.emit(dict(self.last_summary))
        self._writer.close()
        self.tracer.close()
        if err is not None:
            raise err
        return self.last_summary

    def tenant_summaries(self) -> dict[str, dict]:
        """Per-tenant fleet-level ledgers: client-facing counts + ttft/e2e
        percentiles + run-level attainment against the tenant's own spec,
        plus the queue's admission tallies (quota refusals, sheds). The
        ``tenant_summary`` surface, mirrored into ``router_summary``."""
        lanes = (self.queue.snapshot().get("tenants") or {})
        with self._lock:
            names = (set(self._tenant_counts) | set(lanes)
                     | (set(self.tenants.names()) if self.tenants else set()))
            out = {}
            for name in sorted(names):
                row = dict(self._tenant_counts.get(name)
                           or {"requests": 0, "ok": 0, "timeout": 0,
                               "shed": 0, "new_tokens": 0})
                lane = lanes.get(name) or {}
                # Queue-side sheds cover refused arrivals too; use the lane
                # tally as THE shed count (displaced victims appear in both).
                row["shed"] = max(row["shed"], lane.get("shed", 0))
                row["quota_rejected"] = lane.get("quota_rejected", 0)
                series = self._tenant_series.get(name) or {}
                tracker = self._slo_by_tenant.get(name)
                row.update(
                    ttft_s=(series["ttft_s"].percentiles()
                            if "ttft_s" in series else None),
                    e2e_s=(series["e2e_s"].percentiles()
                           if "e2e_s" in series else None),
                    slo=tracker.summary() if tracker is not None else None)
                out[name] = row
            return out

    def _summary(self, end_s: float | None = None) -> dict:
        t0 = self._served_from_s or self._started_s
        end = time.monotonic() if end_s is None else end_s
        wall = end - t0 if t0 is not None else None
        with self._lock:
            counts = dict(self._counts)
            per_replica = [{
                "replica": r.index, "state": r.state, "restarts": r.restarts,
                "dispatched": r.dispatched, "completed": r.completed,
                "hedges": r.hedges, "ejections": r.ejections,
                "probes": r.probes,
                "exit_code": r.exit_code,
                "stats": r.stats,
                # Tier fields only when tiered (schema-stable untiered).
                **({"tier": r.tier, "handoffs": r.handoffs}
                   if r.tier != "unified" else {}),
            } for r in self.replicas]
            series = {k: LogHistogram(self._hist_rel_err).merge(v)
                      for k, v in self._series.items()}
            slo = (self._slo_fleet.summary() if self._slo_fleet is not None
                   else None)
        cache = {"queries": 0, "hits": 0, "hit_tokens": 0}
        have_cache = False
        # Replica-side latency sketches, merged across the fleet (obs/hist.py:
        # bucket-count addition — the merged quantiles keep the same relative
        # -error bound as one process seeing every sample). These are the
        # REPLICA-LOCAL latencies (admission -> completion inside one engine);
        # the router's own series above stay the client-facing truth.
        replica_hists: dict[str, LogHistogram] = {}
        # Fleet-wide speculative-decoding ledger: the per-replica engine spec
        # stats summed, with the derived rates recomputed over the sums (a
        # mean of per-replica rates would weight an idle replica like a busy
        # one).
        spec = {"steps": 0, "slot_steps": 0, "proposed": 0, "accepted": 0,
                "generated_tokens": 0}
        spec_mode = None
        for row in per_replica:
            for name, doc in ((row["stats"] or {}).get("latency_hist")
                              or {}).items():
                try:
                    base = replica_hists.setdefault(
                        name, LogHistogram(float(doc.get("rel_err", 0.01))))
                    base.merge(doc)
                except (ValueError, KeyError, TypeError):
                    pass          # mismatched/garbled sketch: skip, never crash
            eng = (row["stats"] or {}).get("engine") or {}
            pc = eng.get("prefix_cache")
            if pc:
                have_cache = True
                for k in cache:
                    cache[k] += pc.get(k) or 0
            sp = eng.get("spec")
            if sp:
                spec_mode = sp.get("mode")
                spec_k = sp.get("k")
                for k in ("steps", "slot_steps", "proposed", "accepted"):
                    spec[k] += sp.get(k) or 0
                spec["generated_tokens"] += eng.get("generated_tokens") or 0
        if spec_mode is not None:
            spec.update(
                mode=spec_mode, k=spec_k,
                acceptance_rate=(spec["accepted"] / spec["proposed"]
                                 if spec["proposed"] else None),
                accepted_tokens_per_step=(
                    spec["generated_tokens"] / spec["slot_steps"]
                    if spec["slot_steps"] else None))
        routed = counts["requests"]
        with self._lock:
            scale = dict(self._scale_counts)
            ready_series = list(self._replica_series)
        return {
            "event": "router_summary",
            "replicas": len(self.replicas),
            "target": self._target,
            "scale": scale,
            "scale_events": (scale["scale_ups"] + scale["scale_downs"]
                             + scale["reloads"]),
            "replicas_ready_p50": (percentiles(ready_series, qs=(50,))
                                   or {"p50": None})["p50"],
            "replicas_ready_max": max(ready_series) if ready_series else None,
            "replicas_ready_min": min(ready_series) if ready_series else None,
            "affinity": self._affinity_on,
            "wall_s": wall,
            **counts,
            "hedge_win_rate": (counts["hedge_wins"] / counts["hedges"]
                               if counts["hedges"] else None),
            "tokens_per_s": (counts["new_tokens"] / wall
                             if counts["new_tokens"] and wall else None),
            "affinity_rate": (counts["affinity_hits"] / routed
                              if routed else None),
            "replica_restarts": sum(r["restarts"] for r in per_replica),
            "per_replica": per_replica,
            "prefix_cache": cache if have_cache else None,
            "spec": spec if spec_mode is not None else None,
            "queue": self.queue.snapshot(),
            "slo": slo,
            "tenants": self.tenant_summaries() or None,
            "preemptions": sum(
                ((r["stats"] or {}).get("engine") or {}).get("preemptions") or 0
                for r in per_replica),
            "resumes": sum(
                ((r["stats"] or {}).get("engine") or {}).get("resumes") or 0
                for r in per_replica),
            "ttft_s": series["ttft_s"].percentiles(),
            "e2e_s": series["e2e_s"].percentiles(),
            "queue_wait_s": series["queue_wait_s"].percentiles(),
            "replica_latency": ({name: h.percentiles()
                                 for name, h in replica_hists.items()}
                                if replica_hists else None),
        }
