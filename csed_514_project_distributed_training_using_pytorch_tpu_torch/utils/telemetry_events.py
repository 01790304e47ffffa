"""The telemetry event-kind registry: every JSONL event kind the two packages emit.

The port's own copy of the JAX package's ``utils/telemetry_events.py`` (plain Python; the
port imports nothing of that package). Kinds map to a one-line producer note; the
field-level schemas live with the producers (``utils/telemetry.py``'s event functions).
The port emits a subset of these kinds: ``manifest``, ``compile``, ``epoch``, ``data``,
``health``, ``mfu``, ``checkpoint``, ``anomaly``, ``preempt`` from the trainers; ``serve``,
``serve_config``, ``serve_summary``, ``prefill``, ``spec``, ``shed``, ``tenant_summary``,
``kv_pages`` and ``slo`` from the server; ``route``, ``replica``, ``router_config``,
``router_summary``, ``fleet_snapshot``, ``scale``, ``eject``, ``hedge``, ``chaos``,
``tier``, ``kv_handoff``, ``shed``, ``tenant_summary`` and ``slo`` from the fleet's router
(``serving/router.py``, through ``utils/jsonl.py``); ``restart`` and ``supervise_summary``
from the supervisor; ``span`` from the tracers; ``plan`` and ``autotune`` from the
planned trainers (``plan/``); ``promote`` and ``canary`` from the promotion gate
(``deploy/promoter.py``). ``describe`` is the registry's one query.
"""

from __future__ import annotations

# kind -> producer (one line), the JAX package's registry as it stands.
EVENT_KINDS: dict[str, str] = {
    # -- training/bench telemetry (utils/telemetry.py helpers) ------------------
    "manifest": "once per run: config/mesh/device/version snapshot",
    "compile": "AOT compile timing + cost_analysis of one program",
    "epoch": "per-epoch wall/execute/eval/data split + losses",
    "data": "per-epoch streaming-loader ledger: batches/stall wall/cursor (data/stream.py)",
    "health": "per-epoch grad-norm/loss accumulators (train/step.py carry)",
    "mfu": "steady-state achieved FLOPs and HBM bytes vs chip peak",
    "bench": "one bench*.py measurement line",
    # -- serving: engine/server (utils/telemetry.py serve helpers) --------------
    "serve": "one served request: TTFT/TPOT/queue-wait/e2e (serving/server.py)",
    "serve_config": "once per serving run: engine/model knobs (serving/server.py)",
    "serve_summary": "once per serving run at drain: aggregates + percentiles",
    "prefill": "one completed prompt prefill: chunks/tokens/cache-hit/wall",
    "spec": "one speculative verify step: slots, proposed/accepted/emitted",
    "shed": "one overload-shed decision: tenant, quota/refused/displaced reason",
    "tenant_summary": "one tenant's drain ledger: counts/percentiles/preemptions/slo",
    "kv_pages": "paged-KV pool ledger at drain: in_use/shared/refusals/COW (serving/server.py)",
    # -- serving: fleet router (serving/router.py via utils/jsonl.py) -----------
    "route": "one routed request: replica, affinity, redispatches, finish",
    "replica": "replica lifecycle transition: start/fail/restart/dead",
    "router_config": "once per router run: fleet shape + knobs",
    "router_summary": "once per router run at drain: fleet-wide counts",
    "fleet_snapshot": "periodic load signal: queue depth/age, per-replica occupancy",
    "scale": "autoscaler action: up/down/reload (+reload_drain bookkeeping)",
    "eject": "straggler ejection lifecycle: eject (degraded) / probe (back to ready)",
    "hedge": "one speculative re-dispatch: request, second replica, deadline",
    "chaos": "one injected network fault (resilience/netfaults.py proxy schedule)",
    "tier": "replica tier membership at ready: role + handoff port (disaggregation)",
    "kv_handoff": "one prefill→decode KV plane handoff: bytes/wall/ok (serving/tiers.py)",
    # -- resilience (resilience/supervisor.py, utils/checkpoint.py) -------------
    "checkpoint": "one checkpoint save/restore: op/kind/bytes/wall",
    "restart": "supervisor restart: attempt, reason, backoff, resume cursor",
    "anomaly": "per-epoch --guard verdict: anomalies/skipped/EMA/fingerprint",
    "preempt": "cooperative SIGTERM stop at an epoch boundary (exit 75)",
    "supervise_summary": "once per supervised run: final status + attempts",
    # -- continuous deployment (deploy/promoter.py) -----------------------------
    "promote": "promotion-gate lifecycle: candidate seen/qualified/rejected/promoted/rolled_back",
    "canary": "one canary window verdict: attainment + sampled-token NLL vs fleet",
    # -- planner (plan/) --------------------------------------------------------
    "plan": "once per --plan run: chosen layout + predicted cost",
    "autotune": "one empirically trialed candidate: predicted vs measured",
    # -- run-level observability (obs/) -----------------------------------------
    "slo": "SLO attainment vs spec: serving drain (server/router via obs/slo.py)",
    "goodput": "exclusive wall-time decomposition of a training run (obs/goodput.py)",
    "bench_guard": "one perf-gate metric: median-of-N vs baseline (tools/bench_guard.py)",
    # -- distributed tracing (utils/trace.py) -----------------------------------
    "span": "one trace span (rendered by tools/trace_report.py, passed over here)",
    # -- loss-curve metrics.jsonl kinds (utils/metrics.py history rows) ---------
    "train": "per-epoch train loss row (reference-parity loss curve)",
    "test": "per-epoch test loss/accuracy row (reference-parity loss curve)",
}

# The derived set the report tools dispatch on.
KNOWN_EVENTS: frozenset[str] = frozenset(EVENT_KINDS)


def describe(kind: str) -> str | None:
    """Producer note for ``kind``, or None for an unregistered kind."""
    return EVENT_KINDS.get(kind)
