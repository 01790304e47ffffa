"""Render telemetry JSONL (utils/telemetry.py) as a run summary or A-vs-B comparison.

The port's counterpart of the JAX package's ``tools/telemetry_report.py``, with its flags,
printed text and summary keys: the same JSONL files give the same dicts and the same
lines, whichever package wrote them. It reads through the port's
``utils.metrics.load_metrics_jsonl``, its ``utils.jsonl.percentiles`` and its event
registry (``utils/telemetry_events.py``), and touches no device.

Input files are whatever the trainers' ``--telemetry PATH`` wrote (manifest /
compile / epoch / health / mfu / checkpoint / preempt events), ``bench*.py
--telemetry`` output (bench events), serving logs from ``serving/server.py`` /
``serve_loadgen.py`` (serve / prefill / serve_summary events — rendered as
a TTFT/TPOT/e2e latency-percentile table plus aggregate decode AND prefill
tokens/s with prefix-cache hit rates), fleet-router logs from
``serving/router.py`` (route / replica / router_summary events — rendered as a
per-replica request/token table with affinity hit rate, redispatch and restart
counts; ``affinity hit rate``/``redispatches`` become A-vs-B rows for the
affinity on/off comparison), supervisor logs
from ``fleet_supervise.py`` (restart events — rendered as a restart count
with reasons), the promotion gate's stream (``deploy/promoter.py``: promote / canary
events), or the loss-curve ``metrics.jsonl`` companions
(``kind`` rows) — all read through the one shared reader,
``utils.metrics.load_metrics_jsonl``, which passes unknown event types through.

Usage::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.telemetry_report \
        results/run.jsonl                                  # one-run summary
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.telemetry_report \
        a.jsonl b.jsonl                                    # A-vs-B table
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.telemetry_report \
        --goodput results/                                 # wall-time ledger
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.telemetry_report \
        --goodput faulted/ clean/                          # badput A-vs-B

One run prints its manifest line, phase-timing/throughput summary, grad-norm
trajectory, and any bench rows; two or more runs additionally print a side-by-side
comparison table (compile_s, execute_s/epoch, examples/s, MFU, final losses) with
the ratio of the last run against the first.
"""

from __future__ import annotations

import argparse
import os
import sys

from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
    percentiles as _percentiles,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.metrics import (
    load_metrics_jsonl,
)

# Every event kind this reporter understands (or deliberately passes over,
# like per-span trace lines — those render via trace_report.py). Anything
# outside this set is counted and surfaced in a footer: schema drift between a
# writer and this reporter must be visible, not silently dropped. DERIVED from
# the one registry of the kinds the writers emit (utils/telemetry_events.py),
# so this reporter cannot disagree with the writers.
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.telemetry_events import (
    KNOWN_EVENTS,
)

SERVE_SERIES = ("ttft_s", "tpot_s", "e2e_s", "queue_wait_s")
SERVE_QS = (50, 95, 99)


def _median(xs: list) -> float | None:
    xs = sorted(x for x in xs if x is not None)
    if not xs:
        return None
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def _fmt(x, digits: int = 4) -> str:
    if x is None:
        return "-"
    if isinstance(x, float):
        if x != 0 and (abs(x) >= 10000 or abs(x) < 0.001):
            return f"{x:.3g}"
        return f"{x:.{digits}g}" if abs(x) >= 1 else f"{x:.4f}"
    return str(x)


def summarize(path: str) -> dict:
    """Reduce one telemetry/metrics JSONL file to the report's summary fields."""
    rows = load_metrics_jsonl(path)
    by_event: dict[str, list] = {}
    for r in rows:
        by_event.setdefault(r.get("event", r.get("kind", "?")), []).append(r)

    s: dict = {"path": path, "label": os.path.basename(path), "events": len(rows)}
    unknown = {k: len(v) for k, v in by_event.items() if k not in KNOWN_EVENTS}
    if unknown:
        s["unknown_events"] = sum(unknown.values())
        s["unknown_kinds"] = sorted(unknown)

    man = (by_event.get("manifest") or [None])[0]
    if man:
        mesh = man.get("mesh")
        s["run"] = man.get("run_type") or "?"
        s["device"] = f"{man.get('device_kind')} x{man.get('device_count')}"
        s["processes"] = man.get("process_count")
        s["mesh"] = (",".join(f"{k}={v}" for k, v in mesh["shape"].items())
                     if mesh else None)
        s["jax"] = man.get("jax_version")

    epochs = by_event.get("epoch", [])
    if epochs:
        s["epochs"] = len(epochs)
        s["compile_s"] = next((e.get("compile_s") for e in epochs
                               if e.get("compile_s") is not None), None)
        s["execute_s_per_epoch"] = _median([e.get("execute_s") for e in epochs])
        s["examples_per_s"] = _median([e.get("examples_per_s") for e in epochs])
        s["flops_per_step"] = next((e.get("flops_per_step") for e in epochs
                                    if e.get("flops_per_step") is not None), None)
        s["final_train_loss"] = epochs[-1].get("train_loss")
        s["final_val_loss"] = epochs[-1].get("val_loss")
    compiles = by_event.get("compile", [])
    if compiles and s.get("compile_s") is None:
        c = compiles[0]
        if c.get("lower_s") is not None and c.get("compile_s") is not None:
            s["compile_s"] = c["lower_s"] + c["compile_s"]
        s.setdefault("flops_per_step", c.get("flops_per_step"))

    mfus = by_event.get("mfu", [])
    s["mfu"] = next((m.get("mfu") for m in reversed(mfus)
                     if m.get("mfu") is not None),
                    next((e.get("mfu") for e in reversed(epochs)
                          if e.get("mfu") is not None), None))

    health = by_event.get("health", [])
    if health:
        s["grad_norm_trajectory"] = [h.get("grad_norm") for h in health]
        s["grad_norm_max"] = max((h.get("grad_norm_max") for h in health
                                  if h.get("grad_norm_max") is not None),
                                 default=None)
        s["param_norm"] = health[-1].get("param_norm")

    s["bench"] = [{"metric": b.get("metric"), "value": b.get("value"),
                   "unit": b.get("unit"), "examples_per_s": b.get("examples_per_s"),
                   "mfu": b.get("mfu_vs_bf16_peak")}
                  for b in by_event.get("bench", [])]

    # Serving runs: per-request percentiles from the raw serve lines; aggregate
    # throughput/occupancy from the drain-time summary when present (a truncated
    # log still renders from whatever serve lines survived).
    serves = by_event.get("serve", [])
    summary = (by_event.get("serve_summary") or [None])[-1]
    if serves:
        s["serve_requests"] = len(serves)
        s["serve_ok"] = sum(r.get("finish") == "ok" for r in serves)
        s["serve_timeout"] = sum(r.get("finish") == "timeout" for r in serves)
        for name in SERVE_SERIES:
            # The one estimator (utils.telemetry.percentiles): report-side
            # percentiles from raw serve lines agree with the summary event's.
            pcts = _percentiles([r.get(name) for r in serves], qs=SERVE_QS) or {}
            for q in SERVE_QS:
                s[f"serve_{name}_p{q}"] = pcts.get(f"p{q}")
    # Chunked-prefill telemetry: per-prompt "prefill" events (chunks, tokens,
    # cache_hit_len, wall_s) aggregated; the serve_summary's engine-level
    # counters fill any gaps (e.g. a truncated per-event stream).
    prefills = by_event.get("prefill", [])
    if prefills:
        s["prefill_prompts"] = len(prefills)
        s["prefill_tokens"] = sum(r.get("tokens") or 0 for r in prefills)
        s["prefill_chunks"] = sum(r.get("chunks") or 0 for r in prefills)
        wall = sum(r.get("wall_s") or 0 for r in prefills)
        s["prefill_tokens_per_s"] = (s["prefill_tokens"] / wall
                                     if s["prefill_tokens"] and wall else None)
        hits = [r for r in prefills if (r.get("cache_hit_len") or 0) > 0]
        s["prefix_hits"] = len(hits)
        s["prefix_hit_tokens"] = sum(r.get("cache_hit_len") or 0
                                     for r in prefills)
        s["prefix_hit_rate"] = len(hits) / len(prefills)
    # Speculative-decoding accept stats: per-step "spec" events aggregated;
    # the serve_summary's engine-level spec ledger (below) overrides where it
    # exists so both sides of an A-vs-B row use the engine's own definitions.
    specs = by_event.get("spec", [])
    if specs:
        s["spec_steps"] = len(specs)
        proposed = sum(r.get("proposed") or 0 for r in specs)
        accepted = sum(r.get("accepted") or 0 for r in specs)
        slot_draws = sum(r.get("active") or 0 for r in specs)
        emitted = sum(r.get("emitted") or 0 for r in specs)
        s["spec_acceptance_rate"] = accepted / proposed if proposed else None
        s["accepted_tokens_per_step"] = (emitted / slot_draws
                                         if slot_draws else None)
    if summary:
        s.setdefault("serve_requests", summary.get("requests"))
        s.setdefault("serve_ok", summary.get("ok"))
        s.setdefault("serve_timeout", summary.get("timeout"))
        s["serve_tokens_per_s"] = summary.get("tokens_per_s")
        s["serve_occupancy"] = summary.get("slot_occupancy")
        # Program invocations vs generated tokens (separate counters since
        # speculative decoding made them diverge from 1:1 per slot).
        if summary.get("decode_invocations") is not None:
            s["decode_invocations"] = summary.get("decode_invocations")
            s["generated_tokens"] = summary.get("generated_tokens")
        sp = summary.get("spec") or {}
        if sp:
            s["spec_mode"] = sp.get("mode")
            s["spec_k"] = sp.get("k")
            s["spec_acceptance_rate"] = sp.get("acceptance_rate")
            s["accepted_tokens_per_step"] = sp.get("accepted_tokens_per_step")
        # The drain-time summary is the ENGINE's ledger (it also counts prompts
        # expired mid-prefill, which never emit a "prefill" event), so where it
        # exists it OVERRIDES the per-event estimates — both sides of an A-vs-B
        # row then use the same definitions (hit rate = hits / queries).
        for key in ("prefill_tokens", "prefill_chunks", "prefill_tokens_per_s"):
            if summary.get(key) is not None:
                s[key] = summary[key]
        pc = summary.get("prefix_cache") or {}
        if pc.get("queries"):
            s["prefix_hits"] = pc.get("hits")
            s["prefix_hit_tokens"] = pc.get("hit_tokens")
            s["prefix_hit_rate"] = pc["hits"] / pc["queries"]
        # Byte-true quantization ledger (engine.byte_accounting()): the A-vs-B
        # rows that prove a kv-dtype change moved fewer bytes and bought slots.
        by = summary.get("bytes") or {}
        if by:
            s["kv_dtype"] = by.get("kv_dtype")
            s["quant_policy"] = by.get("quant_policy")
            s["decode_bytes_per_token"] = by.get("decode_bytes_per_token")
            s["kv_bytes_per_slot"] = by.get("kv_bytes_per_slot")
            s["slots_at_budget"] = by.get("slots_at_budget")
            s["kv_layout"] = by.get("kv_layout")
        # Paged-KV pool ledger (paged engines only — the summary field and the
        # standalone kv_pages line carry the same page_stats() dict; prefer
        # the summary, fall back to the last standalone line on a killed run).
        kp = summary.get("kv_pages") \
            or (by_event.get("kv_pages") or [None])[-1] or {}
        if kp:
            s["kv_page_size"] = kp.get("page_size")
            s["kv_pages_in_use"] = kp.get("in_use")
            s["kv_pages_free"] = kp.get("free")
            s["kv_pages_shared"] = kp.get("shared")
            s["kv_page_refusals"] = kp.get("refusals")
            s["kv_page_fragmentation"] = kp.get("fragmentation")
            s["kv_cow_copies"] = kp.get("cow_copies")
        for name in SERVE_SERIES:          # summary percentiles fill any gaps
            pcts = summary.get(name) or {}
            for q in SERVE_QS:
                s.setdefault(f"serve_{name}_p{q}", pcts.get(f"p{q}"))
    elif serves:
        # No summary (killed run): aggregate tokens/s over the serve lines' span.
        toks = sum(r.get("new_tokens") or 0 for r in serves)
        ts = [r.get("t_s") for r in serves if r.get("t_s") is not None]
        starts = [r["t_s"] - r["e2e_s"] for r in serves
                  if r.get("t_s") is not None and r.get("e2e_s") is not None]
        span = max(ts) - min(starts) if ts and starts else None
        s["serve_tokens_per_s"] = toks / span if toks and span else None

    # Fleet-router runs (serving/router.py): per-request "route" lines give the
    # latency percentiles (reusing the serve table), the drain-time
    # router_summary the per-replica table, affinity hit rate, and redispatch/
    # restart counts; replica lifecycle events fill restart reasons when the
    # summary is missing (killed run).
    routes = by_event.get("route", [])
    rsum = (by_event.get("router_summary") or [None])[-1]
    if routes:
        s.setdefault("serve_requests", len(routes))
        s.setdefault("serve_ok", sum(r.get("finish") == "ok" for r in routes))
        s.setdefault("serve_timeout",
                     sum(r.get("finish") == "timeout" for r in routes))
        s["redispatches"] = sum(r.get("redispatches") or 0 for r in routes)
        hits = sum(bool(r.get("affinity_hit")) for r in routes)
        s["affinity_rate"] = hits / len(routes)
        for name in SERVE_SERIES:
            pcts = _percentiles([r.get(name) for r in routes], qs=SERVE_QS) or {}
            for q in SERVE_QS:
                s.setdefault(f"serve_{name}_p{q}", pcts.get(f"p{q}"))
    replica_evs = by_event.get("replica", [])
    if replica_evs:
        fails = [r for r in replica_evs if r.get("action") in ("fail", "dead")]
        s["replica_restarts"] = sum(r.get("action") == "restart"
                                    for r in replica_evs)
        s["replica_fail_reasons"] = [r.get("reason") for r in fails]
    if rsum:
        s.setdefault("serve_requests", rsum.get("requests"))
        s.setdefault("serve_ok", rsum.get("ok"))
        s.setdefault("serve_timeout", rsum.get("timeout"))
        s["serve_tokens_per_s"] = rsum.get("tokens_per_s")
        s["router_replicas"] = rsum.get("replicas")
        s["router_target"] = rsum.get("target")
        if rsum.get("scale_events") is not None:
            s.setdefault("scale_events", rsum.get("scale_events"))
        if rsum.get("replicas_ready_p50") is not None:
            s.setdefault("replicas_p50", rsum.get("replicas_ready_p50"))
            s.setdefault("replicas_max", rsum.get("replicas_ready_max"))
            s.setdefault("replicas_min", rsum.get("replicas_ready_min"))
        s["affinity_rate"] = rsum.get("affinity_rate")
        s["redispatches"] = rsum.get("redispatches")
        s["duplicate_completions"] = rsum.get("duplicates")
        s["replica_restarts"] = rsum.get("replica_restarts")
        s["replica_table"] = [
            {"replica": r.get("replica"), "state": r.get("state"),
             "restarts": r.get("restarts"), "dispatched": r.get("dispatched"),
             "completed": r.get("completed"), "tier": r.get("tier"),
             "handoffs": r.get("handoffs")}
            for r in rsum.get("per_replica") or []]
        pc = rsum.get("prefix_cache") or {}
        if pc.get("queries"):
            s["prefix_hits"] = pc.get("hits")
            s["prefix_hit_tokens"] = pc.get("hit_tokens")
            s["prefix_hit_rate"] = pc["hits"] / pc["queries"]
        sp = rsum.get("spec") or {}
        if sp:
            s["spec_mode"] = sp.get("mode")
            s["spec_k"] = sp.get("k")
            s["spec_acceptance_rate"] = sp.get("acceptance_rate")
            s["accepted_tokens_per_step"] = sp.get("accepted_tokens_per_step")
            s.setdefault("decode_invocations", sp.get("steps"))
            s.setdefault("generated_tokens", sp.get("generated_tokens"))
        for name in SERVE_SERIES:
            pcts = rsum.get(name) or {}
            for q in SERVE_QS:
                s.setdefault(f"serve_{name}_p{q}", pcts.get(f"p{q}"))

    # Metrics-timeline snapshots (serving/router.py --snapshot-interval-s): the
    # elasticity load signal. Reduce to the ranges a scale-up/down decision
    # reads — queue depth/age peaks vs fleet utilization.
    snaps = by_event.get("fleet_snapshot", [])
    if snaps:
        s["snapshots"] = len(snaps)
        depths = [(sn.get("queue") or {}).get("depth") or 0 for sn in snaps]
        ages = [(sn.get("queue") or {}).get("oldest_age_s") or 0 for sn in snaps]
        utils_ = [sn.get("utilization") for sn in snaps
                  if sn.get("utilization") is not None]
        s["snapshot_queue_depth_max"] = max(depths)
        s["snapshot_oldest_age_max_s"] = max(ages)
        s["snapshot_utilization_mean"] = (sum(utils_) / len(utils_)
                                          if utils_ else None)
        s["snapshot_utilization_max"] = max(utils_) if utils_ else None
        ready = [sn.get("replicas_ready") for sn in snaps
                 if sn.get("replicas_ready") is not None]
        if ready:
            s["replicas_p50"] = _median(ready)
            s["replicas_max"] = max(ready)
            s["replicas_min"] = min(ready)

    # Scale timeline (serving/router.py scale_up/scale_down/reload events):
    # each action joined against the nearest preceding fleet_snapshot, so the
    # rendered timeline shows WHAT the autoscaler saw when it acted.
    # Only realized transitions count (up/down/reload) — the stream also
    # carries reload_drain bookkeeping lines, and counting those would make
    # this disagree with router_summary's ups+downs+reloads in A-vs-B rows.
    scales = [e for e in by_event.get("scale", [])
              if e.get("action") in ("up", "down", "reload")]
    if scales:
        s["scale_events"] = len(scales)
        s["scale_ups"] = sum(e.get("action") == "up" for e in scales)
        s["scale_downs"] = sum(e.get("action") == "down" for e in scales)
        s["scale_reloads"] = sum(e.get("action") == "reload" for e in scales)
        timeline = []
        for e in scales:
            t = e.get("t_s")
            before = [sn for sn in snaps
                      if sn.get("t_s") is not None and t is not None
                      and sn["t_s"] <= t]
            sn = before[-1] if before else None
            timeline.append({
                "t_s": t, "action": e.get("action"),
                "replica": e.get("replica"), "target": e.get("target"),
                "reason": e.get("reason"),
                "queue_depth": ((sn.get("queue") or {}).get("depth")
                                if sn else None),
                "utilization": sn.get("utilization") if sn else None,
                "replicas_ready": sn.get("replicas_ready") if sn else None,
            })
        s["scale_timeline"] = timeline

    # Gray-failure tolerance (DESIGN.md §23): straggler ejections + probe
    # recoveries, hedged dispatches + win rate, typed wire-corruption events,
    # and the chaos harness's injected-fault ledger. The router_summary
    # counters win; the event stream fills in for a killed run.
    ejects = by_event.get("eject", [])
    if ejects:
        s["ejections"] = sum(e.get("action") == "eject" for e in ejects)
        s["probe_recoveries"] = sum(e.get("action") == "probe" for e in ejects)
    hedge_evs = by_event.get("hedge", [])
    if hedge_evs:
        s["hedges"] = len(hedge_evs)
    if rsum:
        for key in ("ejections", "probes", "hedges", "hedge_wins",
                    "hedge_win_rate", "wire_corrupt"):
            if rsum.get(key) is not None:
                s[key] = rsum[key]
    chaos_evs = by_event.get("chaos", [])
    if chaos_evs:
        s["chaos_faults"] = len(chaos_evs)
        by_kind: dict = {}
        for ev in chaos_evs:
            by_kind[ev.get("kind")] = by_kind.get(ev.get("kind"), 0) + 1
        s["chaos_by_kind"] = by_kind

    # Disaggregated serving (DESIGN.md §25): tier membership + the prefill→
    # decode KV handoff ledger. Per-event "kv_handoff" lines give the wall/TTFT
    # medians (the summary only carries counts); router_summary counters win
    # for the totals so both sides of an A-vs-B row use the router's ledger.
    tier_evs = by_event.get("tier", [])
    if tier_evs:
        tiers: dict = {}
        for ev in tier_evs:
            if ev.get("tier"):
                tiers[ev["tier"]] = tiers.get(ev["tier"], 0) + 1
        s["tier_replicas"] = tiers
    handoff_evs = by_event.get("kv_handoff", [])
    if handoff_evs:
        oks = [e for e in handoff_evs if e.get("ok")]
        s["handoffs"] = len(oks)
        s["handoff_failures"] = len(handoff_evs) - len(oks)
        s["handoff_bytes"] = sum(e.get("bytes") or 0 for e in oks)
        s["handoff_wall_s"] = _median([e.get("wall_s") for e in oks])
        s["tier_ttft_s"] = _median([e.get("prefill_ttft_s") for e in oks])
    if rsum:
        for key in ("handoffs", "handoff_bytes", "handoff_failures"):
            if rsum.get(key) is not None:
                s[key] = rsum[key]

    # Checkpoint traffic (utils/checkpoint.py savers + restores): how much resume
    # insurance the run paid for, and what it cost in wall time.
    ckpts = by_event.get("checkpoint", [])
    saves = [c for c in ckpts if c.get("op") == "save"]
    if saves:
        s["ckpt_saves"] = len(saves)
        s["ckpt_save_s"] = _median([c.get("wall_s") for c in saves])
        s["ckpt_bytes"] = next((c.get("bytes") for c in reversed(saves)
                                if c.get("bytes")), None)
        s["ckpt_coalesced"] = sum(c.get("coalesced") or 0 for c in saves)
    restores = [c for c in ckpts if c.get("op") == "restore"]
    if restores:
        s["ckpt_restores"] = len(restores)
        s["ckpt_restore_s"] = _median([c.get("wall_s") for c in restores])

    # SLO attainment (obs/slo.py): the drain-time "slo" events and/or the
    # summaries' embedded attainment dicts. Router (client-facing) wins over
    # server (replica-local) when a run carries both.
    slos = by_event.get("slo", [])
    slo = (next((e for e in reversed(slos) if e.get("source") == "router"),
                None) or (slos[-1] if slos else None))
    for doc in ((rsum or {}).get("slo"), (summary or {}).get("slo"), slo):
        if doc and doc.get("attainment") is not None:
            s["slo_attainment"] = doc.get("attainment")
            s["slo_met"] = doc.get("met")
            s["slo_requests"] = doc.get("requests")
            s["slo_spec"] = doc.get("spec")
            break

    # Multi-tenant serving (DESIGN.md §22): per-tenant drain ledgers (the
    # router's client-facing rows win over a replica's local ones), shed
    # decisions by reason, and fleet preemption counters.
    tsums = by_event.get("tenant_summary", [])
    tenants = {}
    for ev in tsums:                       # later rows (router) overwrite
        if ev.get("tenant"):
            tenants[ev["tenant"]] = ev
    if tenants:
        s["tenants"] = tenants
    sheds = by_event.get("shed", [])
    if sheds:
        s["shed_events"] = len(sheds)
        by_reason: dict = {}
        for ev in sheds:
            by_reason[ev.get("reason")] = by_reason.get(ev.get("reason"), 0) + 1
        s["shed_by_reason"] = by_reason
    for doc in (rsum, summary):
        if doc and (doc.get("preemptions") or doc.get("shed")):
            s["preemptions"] = doc.get("preemptions")
            s["resumes"] = doc.get("resumes")
            s["shed"] = doc.get("shed")
            break

    # Goodput ledger lines (obs/goodput.py via --goodput --emit): read the
    # decomposition back without re-joining the streams.
    gp = (by_event.get("goodput") or [None])[-1]
    if gp:
        s["goodput_frac"] = gp.get("goodput_frac")
        s["badput_frac"] = gp.get("badput_frac")
        s["compute_s"] = gp.get("compute_s")
        s["restart_badput_s"] = gp.get("restart_badput_s")
        s["rollback_badput_s"] = gp.get("rollback_badput_s")
        s["goodput_wall_s"] = gp.get("wall_s")
        s["epochs_replayed"] = gp.get("epochs_replayed")

    # Perf-gate lines (tools/bench_guard.py --telemetry): the bench
    # trajectory's per-metric medians, comparable across runs like any bench.
    guards = by_event.get("bench_guard", [])
    if guards:
        s["bench_guard"] = [
            {"metric": g.get("metric"), "median_s": g.get("median_s"),
             "ratio": g.get("ratio"), "pass": g.get("pass")}
            for g in guards]
        for g in guards:
            if g.get("metric"):
                s[f"guard_{g['metric']}"] = g.get("median_s")

    # Numerical-immune-system verdicts (train/step.py --guard): the last
    # anomaly event carries the attempt's cumulative counters; rollbacks are
    # the poisoned/desync restarts the supervisor performed in response.
    anomaly_evs = by_event.get("anomaly", [])
    if anomaly_evs:
        last = anomaly_evs[-1]
        s["anomalies"] = last.get("anomalies")
        s["anomaly_nonfinite"] = last.get("nonfinite")
        s["anomaly_spikes"] = last.get("spikes")
        s["skipped_steps"] = last.get("skipped")
        s["anomaly_fingerprint"] = last.get("fingerprint")
        s["anomaly_skip_windows"] = last.get("skip") or None

    # Resilience events: supervisor restarts (resilience/supervisor.py telemetry)
    # and cooperative preemption stops.
    restarts = by_event.get("restart", [])
    if restarts:
        s["restarts"] = len(restarts)
        s["restart_reasons"] = [r.get("reason") for r in restarts]
        rollbacks = sum(r.get("reason") in ("poisoned", "desync")
                        for r in restarts)
        if rollbacks:
            s["rollbacks"] = rollbacks
    preempts = by_event.get("preempt", [])
    if preempts:
        s["preempted_step"] = preempts[-1].get("step")
        s["preempted_ckpt"] = preempts[-1].get("checkpoint")

    # Streaming-loader ledger (data/stream.py per-epoch "data" events): how
    # many sequences the run consumed, the consumer's total stall behind the
    # prefetcher (the goodput ``data_wait`` input), and the per-epoch stream
    # CRCs the deterministic-resume tests pin across a kill/resume boundary.
    data_evs = by_event.get("data", [])
    if data_evs:
        s["data_epochs"] = len(data_evs)
        s["data_sequences"] = sum(e.get("sequences") or 0 for e in data_evs)
        s["data_wait_s"] = sum(e.get("wait_s") or 0.0 for e in data_evs)
        s["data_throttle_s"] = max((e.get("throttle_s") or 0.0)
                                   for e in data_evs)
        digests = [e.get("stream_digest") for e in data_evs]
        if any(d is not None for d in digests):
            s["stream_digests"] = digests

    # Continuous-deployment lifecycle (deploy/promoter.py "promote"/"canary"
    # events): verdict counts plus the ordered timeline — who was seen, who
    # failed which gate by what measured margin, who canaried on which
    # replica against what fleet evidence, and what the fleet rolled to.
    promos = by_event.get("promote", [])
    canary_evs = by_event.get("canary", [])
    if promos or canary_evs:
        by_action: dict = {}
        for ev in promos:
            by_action[ev.get("action")] = by_action.get(ev.get("action"), 0) + 1
        s["promote_actions"] = by_action
        s["promotions"] = by_action.get("promoted", 0)
        s["promote_rollbacks"] = by_action.get("rolled_back", 0)
        timeline = [
            {"t_s": ev.get("t_s"), "kind": "promote",
             "action": ev.get("action"),
             "candidate": os.path.basename(ev.get("candidate") or "?"),
             "reason": ev.get("reason"),
             "nll": ev.get("nll"), "incumbent_nll": ev.get("incumbent_nll")}
            for ev in promos
        ] + [
            {"t_s": ev.get("t_s"), "kind": "canary",
             "action": f"canary_{ev.get('verdict')}",
             "candidate": os.path.basename(ev.get("candidate") or "?"),
             "replica": ev.get("replica"), "reason": ev.get("reason"),
             "canary_attainment": ev.get("canary_attainment"),
             "fleet_attainment": ev.get("fleet_attainment"),
             "canary_nll": ev.get("canary_nll"),
             "fleet_nll": ev.get("fleet_nll")}
            for ev in canary_evs
        ]
        timeline.sort(key=lambda r: (r["t_s"] is None, r["t_s"] or 0.0))
        s["promotion_timeline"] = timeline

    # Loss-curve metrics.jsonl rows (the companion artifact) — final losses.
    for kind, key in (("train", "final_train_loss"), ("test", "final_val_loss")):
        pts = [r for r in by_event.get(kind, []) if "loss" in r]
        if pts and s.get(key) is None:
            s[key] = pts[-1]["loss"]
    return s


def print_summary(s: dict) -> None:
    print(f"== {s['label']} ({s['events']} events)")
    if s.get("run"):
        mesh = f", mesh {s['mesh']}" if s.get("mesh") else ""
        print(f"   {s['run']} run on {s['device']}{mesh}, "
              f"{s['processes']} process(es), jax {s['jax']}")
    if s.get("epochs"):
        print(f"   epochs {s['epochs']}  compile_s {_fmt(s.get('compile_s'))}  "
              f"execute_s/epoch {_fmt(s.get('execute_s_per_epoch'))}  "
              f"examples/s {_fmt(s.get('examples_per_s'))}")
        print(f"   flops/step {_fmt(s.get('flops_per_step'))}  "
              f"mfu {_fmt(s.get('mfu'))}  "
              f"train_loss {_fmt(s.get('final_train_loss'))}  "
              f"val_loss {_fmt(s.get('final_val_loss'))}")
    traj = s.get("grad_norm_trajectory")
    if traj:
        shown = " -> ".join(_fmt(g) for g in (traj if len(traj) <= 6
                                              else traj[:3] + traj[-3:]))
        print(f"   grad_norm {shown}  (max {_fmt(s.get('grad_norm_max'))}, "
              f"param_norm {_fmt(s.get('param_norm'))})")
    if s.get("ckpt_saves") or s.get("ckpt_restores"):
        parts = []
        if s.get("ckpt_saves"):
            co = (f", {s['ckpt_coalesced']} coalesced" if s.get("ckpt_coalesced")
                  else "")
            parts.append(f"{s['ckpt_saves']} save(s) "
                         f"(median {_fmt(s.get('ckpt_save_s'))}s, "
                         f"{_fmt(s.get('ckpt_bytes'))} bytes{co})")
        if s.get("ckpt_restores"):
            parts.append(f"{s['ckpt_restores']} restore(s) "
                         f"(median {_fmt(s.get('ckpt_restore_s'))}s)")
        print(f"   checkpoint: {', '.join(parts)}")
    if s.get("anomalies") is not None:
        # The immune-system line: what the guard saw, what it refused to
        # apply, and the replay windows in force.
        skip = (f"  skip windows {s['anomaly_skip_windows']}"
                if s.get("anomaly_skip_windows") else "")
        print(f"   anomaly guard: {_fmt(s['anomalies'])} anomalies "
              f"({_fmt(s.get('anomaly_nonfinite'))} nonfinite, "
              f"{_fmt(s.get('anomaly_spikes'))} spikes)  "
              f"{_fmt(s.get('skipped_steps'))} skipped step(s)  "
              f"fingerprint {_fmt(s.get('anomaly_fingerprint'))}{skip}")
    if s.get("restarts"):
        rb = (f", {s['rollbacks']} rollback(s)" if s.get("rollbacks") else "")
        print(f"   restarts: {s['restarts']} "
              f"({', '.join(s['restart_reasons'])}{rb})")
    if s.get("preempted_step") is not None:
        ck = f" -> {s['preempted_ckpt']}" if s.get("preempted_ckpt") else ""
        print(f"   preempted at step {s['preempted_step']}{ck}")
    if s.get("data_epochs"):
        thr = (f"  (throttled {_fmt(s['data_throttle_s'])}s/batch)"
               if s.get("data_throttle_s") else "")
        dig = ""
        if s.get("stream_digests"):
            shown = [d for d in s["stream_digests"] if d is not None]
            dig = (f"  digests {' '.join(f'{d:08x}' for d in shown[:4])}"
                   + (" ..." if len(shown) > 4 else ""))
        print(f"   data: {s['data_epochs']} streamed epoch(s), "
              f"{_fmt(s['data_sequences'])} sequences  "
              f"loader wait {_fmt(s['data_wait_s'])}s{thr}{dig}")
    if s.get("promotion_timeline"):
        acts = s.get("promote_actions") or {}
        print(f"   promotion: {s.get('promotions', 0)} promoted, "
              f"{acts.get('gate_fail', 0)} gate failure(s), "
              f"{s.get('promote_rollbacks', 0)} rollback(s)")
        for e in s["promotion_timeline"]:
            t = "-" if e["t_s"] is None else f"+{e['t_s']:.2f}s"
            if e["kind"] == "canary":
                ctx = (f"  replica {_fmt(e.get('replica'))}  attainment "
                       f"{_fmt(e.get('canary_attainment'))} vs fleet "
                       f"{_fmt(e.get('fleet_attainment'))}  nll "
                       f"{_fmt(e.get('canary_nll'))} vs fleet "
                       f"{_fmt(e.get('fleet_nll'))}")
            else:
                ctx = ("" if e.get("nll") is None else
                       f"  nll {_fmt(e['nll'])} vs incumbent "
                       f"{_fmt(e.get('incumbent_nll'))}")
            print(f"     {t.rjust(9)}  {(e['action'] or '?').ljust(14)} "
                  f"{e['candidate']}"
                  + (f" [{e['reason']}]" if e.get("reason") else "") + ctx)
    for b in s.get("bench", []):
        extra = "".join(f"  {k} {_fmt(b[k])}" for k in ("examples_per_s", "mfu")
                        if b.get(k) is not None)
        print(f"   bench: {b['metric']}: {_fmt(b['value'])} {b['unit'] or ''}{extra}")
    if s.get("serve_requests"):
        occ = (f"  occupancy {_fmt(s['serve_occupancy'])}"
               if s.get("serve_occupancy") is not None else "")
        print(f"   serve: {s['serve_requests']} requests "
              f"({_fmt(s.get('serve_ok'))} ok, {_fmt(s.get('serve_timeout'))} "
              f"timeout)  tokens/s {_fmt(s.get('serve_tokens_per_s'))}{occ}")
        if s.get("router_replicas"):
            reasons = s.get("replica_fail_reasons") or []
            print(f"   router: {s['router_replicas']} replicas  "
                  f"affinity rate {_fmt(s.get('affinity_rate'))}  "
                  f"redispatches {_fmt(s.get('redispatches'))}  "
                  f"restarts {_fmt(s.get('replica_restarts'))}"
                  + (f" ({', '.join(reasons)})" if reasons else ""))
            for r in s.get("replica_table") or []:
                tier = (f" [{r['tier']}, {_fmt(r.get('handoffs'))} handoffs]"
                        if r.get("tier") else "")
                print(f"     replica {r['replica']}: "
                      f"{_fmt(r.get('dispatched'))} dispatched, "
                      f"{_fmt(r.get('completed'))} completed, "
                      f"{_fmt(r.get('restarts'))} restart(s), "
                      f"{r.get('state')}{tier}")
            if (s.get("ejections") or s.get("hedges")
                    or s.get("wire_corrupt") or s.get("chaos_faults")):
                kinds = ", ".join(f"{k}: {v}" for k, v in
                                  sorted((s.get("chaos_by_kind") or {})
                                         .items()))
                probes = s.get("probe_recoveries") or s.get("probes") or 0
                print(f"   gray failures: {_fmt(s.get('ejections') or 0)} "
                      f"ejection(s) ({_fmt(probes)} probe recoveries)  "
                      f"hedges {_fmt(s.get('hedges') or 0)} "
                      f"(win rate {_fmt(s.get('hedge_win_rate'))})  "
                      f"wire corrupt {_fmt(s.get('wire_corrupt') or 0)}"
                      + (f"  chaos {s['chaos_faults']} ({kinds})"
                         if s.get("chaos_faults") else ""))
        if s.get("handoffs") is not None or s.get("handoff_failures"):
            tiers = ", ".join(f"{k}: {v}" for k, v in
                              sorted((s.get("tier_replicas") or {}).items()))
            print(f"   tiers: {_fmt(s.get('handoffs') or 0)} handoff(s) "
                  f"({_fmt(s.get('handoff_bytes') or 0)} bytes, "
                  f"{_fmt(s.get('handoff_failures') or 0)} failed)  "
                  f"handoff wall p50 {_fmt(s.get('handoff_wall_s'))}s  "
                  f"tier ttft p50 {_fmt(s.get('tier_ttft_s'))}s"
                  + (f"  [{tiers}]" if tiers else ""))
        if s.get("prefill_tokens") is not None:
            hit = ""
            if s.get("prefix_hit_rate") is not None:
                hit = (f"  prefix hits {_fmt(s.get('prefix_hits'))} "
                       f"(rate {_fmt(s['prefix_hit_rate'])}, "
                       f"{_fmt(s.get('prefix_hit_tokens'))} tokens reused)")
            print(f"   prefill: {_fmt(s['prefill_tokens'])} tokens in "
                  f"{_fmt(s.get('prefill_chunks'))} chunks  "
                  f"tokens/s {_fmt(s.get('prefill_tokens_per_s'))}{hit}")
        if s.get("spec_mode") or s.get("accepted_tokens_per_step") is not None:
            inv = ""
            if s.get("decode_invocations") is not None:
                inv = (f"  {_fmt(s.get('generated_tokens'))} tokens in "
                       f"{_fmt(s['decode_invocations'])} program invocations")
            print(f"   spec: {s.get('spec_mode') or '?'}"
                  + (f" k={s['spec_k']}" if s.get("spec_k") else "")
                  + f"  accepted tok/step {_fmt(s.get('accepted_tokens_per_step'))}"
                  + f"  acceptance rate {_fmt(s.get('spec_acceptance_rate'))}"
                  + inv)
        if s.get("decode_bytes_per_token") is not None:
            print(f"   bytes: kv {s.get('kv_dtype')} / weights "
                  f"{s.get('quant_policy')}  "
                  f"decode/token {_fmt(s['decode_bytes_per_token'])}  "
                  f"kv/slot {_fmt(s.get('kv_bytes_per_slot'))}  "
                  f"slots@budget {_fmt(s.get('slots_at_budget'))}")
        if s.get("kv_pages_in_use") is not None:
            print(f"   kv pages: {_fmt(s['kv_pages_in_use'])} in use / "
                  f"{_fmt(s.get('kv_pages_free'))} free "
                  f"(size {_fmt(s.get('kv_page_size'))} tok)  "
                  f"shared {_fmt(s.get('kv_pages_shared'))}  "
                  f"cow {_fmt(s.get('kv_cow_copies'))}  "
                  f"refusals {_fmt(s.get('kv_page_refusals'))}  "
                  f"frag {_fmt(s.get('kv_page_fragmentation'))}")
        head = "   " + "".ljust(14) + "".join(f"p{q}".rjust(12) for q in SERVE_QS)
        print(head)
        for name in SERVE_SERIES:
            vals = [s.get(f"serve_{name}_p{q}") for q in SERVE_QS]
            if all(v is None for v in vals):
                continue
            print("   " + name.ljust(14)
                  + "".join(_fmt(v).rjust(12) for v in vals))
    if s.get("snapshots"):
        reps = ""
        if s.get("replicas_p50") is not None:
            reps = (f"  replicas ready p50 {_fmt(s['replicas_p50'])} / "
                    f"min {_fmt(s.get('replicas_min'))} / "
                    f"max {_fmt(s.get('replicas_max'))}")
        print(f"   timeline: {s['snapshots']} fleet snapshots  "
              f"queue depth max {_fmt(s.get('snapshot_queue_depth_max'))}  "
              f"oldest age max {_fmt(s.get('snapshot_oldest_age_max_s'))}s  "
              f"utilization mean {_fmt(s.get('snapshot_utilization_mean'))} "
              f"/ max {_fmt(s.get('snapshot_utilization_max'))}{reps}")
    if s.get("scale_timeline"):
        print(f"   scale timeline: {s.get('scale_ups', 0)} up, "
              f"{s.get('scale_downs', 0)} down, "
              f"{s.get('scale_reloads', 0)} reload")
        for e in s["scale_timeline"]:
            t = "-" if e["t_s"] is None else f"+{e['t_s']:.2f}s"
            ctx = ""
            if e.get("queue_depth") is not None:
                ctx = (f"  (saw queue depth {e['queue_depth']}, "
                       f"util {_fmt(e.get('utilization'))}, "
                       f"{_fmt(e.get('replicas_ready'))} ready)")
            print(f"     {t.rjust(9)}  {(e['action'] or '?').ljust(12)} "
                  f"replica {e['replica']} -> target {e['target']}"
                  + (f" [{e['reason']}]" if e.get("reason") else "") + ctx)
    if s.get("slo_attainment") is not None:
        spec = s.get("slo_spec") or {}
        targets = ", ".join(f"{k}<={v}" for k, v in spec.items()
                            if k != "window_s" and v is not None)
        print(f"   slo: attainment {_fmt(s['slo_attainment'])} "
              f"({_fmt(s.get('slo_met'))}/{_fmt(s.get('slo_requests'))} met"
              + (f"; {targets}" if targets else "") + ")")
    if s.get("tenants"):
        # The multi-tenant ledger: one row per service class — who got
        # served, who absorbed the squeeze (shed/preemptions), and whether
        # each class kept its own promise.
        print(f"   {'tenant':<10} {'req':>5} {'ok':>5} {'shed':>5} "
              f"{'preempt':>7} {'ttft p95':>9} {'e2e p95':>9} {'slo':>7}")
        for name in sorted(s["tenants"]):
            row = s["tenants"][name]
            att = (row.get("slo") or {}).get("attainment")
            print(f"   {name:<10} {_fmt(row.get('requests')):>5} "
                  f"{_fmt(row.get('ok')):>5} {_fmt(row.get('shed')):>5} "
                  f"{_fmt(row.get('preemptions')):>7} "
                  f"{_fmt((row.get('ttft_s') or {}).get('p95')):>9} "
                  f"{_fmt((row.get('e2e_s') or {}).get('p95')):>9} "
                  f"{_fmt(att):>7}")
    if s.get("shed_events"):
        reasons = ", ".join(f"{k}: {v}" for k, v in
                            sorted((s.get("shed_by_reason") or {}).items()))
        print(f"   shed: {s['shed_events']} decision(s) ({reasons})")
    if s.get("preemptions"):
        print(f"   preemption: {_fmt(s['preemptions'])} park(s), "
              f"{_fmt(s.get('resumes'))} resume(s)")
    if s.get("goodput_frac") is not None:
        print(f"   goodput: {_fmt(s['goodput_frac'])} of "
              f"{_fmt(s.get('goodput_wall_s'))}s wall "
              f"(compute {_fmt(s.get('compute_s'))}s, restart badput "
              f"{_fmt(s.get('restart_badput_s'))}s, "
              f"{_fmt(s.get('epochs_replayed'))} epoch(s) replayed)")
    for g in s.get("bench_guard", []):
        verdict = "" if g.get("pass") is None else \
            ("  ok" if g["pass"] else "  REGRESSION")
        print(f"   bench_guard: {g['metric']}: {_fmt(g.get('median_s'))}s"
              + (f"  ratio {_fmt(g['ratio'])}x" if g.get("ratio") is not None
                 else "") + verdict)
    if s.get("unknown_events"):
        print(f"   {s['unknown_events']} unrecognized events "
              f"(kinds: {', '.join(s['unknown_kinds'])}) — writer/reporter "
              f"schema drift?")
    print()


COMPARE_ROWS = [
    ("compile_s", "compile_s"),
    ("execute_s/epoch", "execute_s_per_epoch"),
    ("examples/s", "examples_per_s"),
    ("flops/step", "flops_per_step"),
    ("mfu", "mfu"),
    ("train_loss", "final_train_loss"),
    ("val_loss", "final_val_loss"),
    ("ckpt_save_s", "ckpt_save_s"),
    ("restarts", "restarts"),
    ("anomalies", "anomalies"),
    ("skipped steps", "skipped_steps"),
    ("rollbacks", "rollbacks"),
    ("data wait s", "data_wait_s"),
    ("promotions", "promotions"),
    ("promote rollbacks", "promote_rollbacks"),
    ("goodput frac", "goodput_frac"),
    ("restart badput s", "restart_badput_s"),
    ("rollback badput s", "rollback_badput_s"),
    ("slo attainment", "slo_attainment"),
    ("shed", "shed"),
    ("preemptions", "preemptions"),
    ("serve tokens/s", "serve_tokens_per_s"),
    ("accepted tok/step", "accepted_tokens_per_step"),
    ("acceptance rate", "spec_acceptance_rate"),
    ("decode invocations", "decode_invocations"),
    ("prefill tok/s", "prefill_tokens_per_s"),
    ("decode bytes/tok", "decode_bytes_per_token"),
    ("kv bytes/slot", "kv_bytes_per_slot"),
    ("slots @ budget", "slots_at_budget"),
    ("kv pages in use", "kv_pages_in_use"),
    ("kv pages shared", "kv_pages_shared"),
    ("kv page refusals", "kv_page_refusals"),
    ("kv cow copies", "kv_cow_copies"),
    ("kv page frag", "kv_page_fragmentation"),
    ("prefix hit rate", "prefix_hit_rate"),
    ("affinity hit rate", "affinity_rate"),
    ("redispatches", "redispatches"),
    ("handoffs", "handoffs"),
    ("handoff bytes", "handoff_bytes"),
    ("handoff wall", "handoff_wall_s"),
    ("tier TTFT", "tier_ttft_s"),
    ("ejections", "ejections"),
    ("hedges", "hedges"),
    ("hedge win rate", "hedge_win_rate"),
    ("wire corrupt", "wire_corrupt"),
    ("replica restarts", "replica_restarts"),
    ("replicas p50", "replicas_p50"),
    ("replicas max", "replicas_max"),
    ("scale events", "scale_events"),
    ("ttft_s p50", "serve_ttft_s_p50"),
    ("ttft_s p99", "serve_ttft_s_p99"),
    ("tpot_s p50", "serve_tpot_s_p50"),
    ("e2e_s p95", "serve_e2e_s_p95"),
    ("queue_wait p95", "serve_queue_wait_s_p95"),
]


# ----------------------------------------------------------------- goodput mode

# The A-vs-B rows of a --goodput comparison (label, key into the flattened
# report) — the faulted-vs-clean run table the resilience story is judged by.
GOODPUT_ROWS = [
    ("wall_s", "wall_s"),
    ("init/compile s", "init_compile_s"),
    ("compute s", "compute_s"),
    ("data wait s", "data_wait_s"),
    ("ckpt stall s", "checkpoint_stall_s"),
    ("restart badput s", "restart_badput_s"),
    ("rollback badput s", "rollback_badput_s"),
    ("idle s", "idle_s"),
    ("goodput frac", "goodput_frac"),
    ("badput frac", "badput_frac"),
    ("attempts", "attempts"),
    ("restarts", "restarts"),
    ("rollbacks", "rollbacks"),
    ("epochs replayed", "epochs_replayed"),
    ("replayed steps", "replayed_steps"),
]


def _flat_goodput(report: dict, label: str) -> dict:
    return {"label": label, **report["segments"],
            **{k: v for k, v in report.items() if k != "segments"}}


def print_goodput(report: dict, label: str) -> None:
    """One run's decomposition: segments as seconds AND fractions of wall —
    the exclusive ledger sums to wall by construction, so the fractions sum
    to 1 (modulo the surfaced unaccounted residue)."""
    wall = report["wall_s"]
    print(f"== {label}  (goodput ledger over {_fmt(wall)}s wall)")
    print(f"   attempts {report['attempts']}  restarts {report['restarts']}"
          + (f" ({report['rollbacks']} rollback(s))"
             if report.get("rollbacks") else "")
          + f"  epochs {report['epochs']} "
          f"({report['epochs_replayed']} replayed, "
          f"{report['replayed_steps']} replayed step(s))"
          + ("  [preempted]" if report.get("preempted") else ""))
    for key, value in report["segments"].items():
        frac = value / wall if wall else None
        name = key[:-2].replace("_", " ")        # init_compile_s -> init compile
        print(f"   {name.ljust(16)} {_fmt(value).rjust(10)}s"
              f"  {_fmt(frac).rjust(8)}")
    print(f"   {'goodput frac'.ljust(16)} {''.rjust(10)} "
          f"{_fmt(report['goodput_frac']).rjust(8)}")
    if report.get("unaccounted_s"):
        print(f"   unaccounted residue: {_fmt(report['unaccounted_s'])}s "
              f"(clock skew / overlapping windows)")
    ck = report.get("checkpoint") or {}
    if ck.get("saves") or ck.get("restores"):
        print(f"   checkpoints: {ck.get('saves', 0)} save(s), "
              f"{ck.get('restores', 0)} restore(s) "
              f"({_fmt(ck.get('restore_s'))}s restoring)")
    st = report.get("streams") or {}
    print(f"   joined {st.get('files', '?')} file(s): {st.get('events', '?')} "
          f"events, {st.get('supervisor_events', 0)} supervisor, "
          f"{st.get('spans', 0)} span(s)")
    print()


def print_goodput_comparison(flats: list[dict]) -> None:
    labels = [f["label"] for f in flats]
    width = max(12, *(len(l) for l in labels)) + 2
    head = "metric".ljust(18) + "".join(l.rjust(width) for l in labels)
    ratio = len(flats) == 2
    if ratio:
        head += "B/A".rjust(10)
    print(head)
    print("-" * len(head))
    for name, key in GOODPUT_ROWS:
        vals = [f.get(key) for f in flats]
        if all(v is None for v in vals):
            continue
        line = name.ljust(18) + "".join(_fmt(v).rjust(width) for v in vals)
        if ratio and vals[0] and vals[1] is not None:
            line += f"{vals[1] / vals[0]:.3f}x".rjust(10)
        print(line)


def run_goodput(args) -> int:
    """--goodput: each positional arg is ONE RUN — a telemetry JSONL, or a
    directory whose *.jsonl files are joined (trainer telemetry + supervisor
    stream + trace spans self-classify by event kind)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.goodput import (
        decompose,
        goodput_event,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
        JsonlWriter,
    )

    flats = []
    for path in args.files:
        report = decompose([path])
        label = os.path.basename(os.path.normpath(path))
        print_goodput(report, label)
        flats.append(_flat_goodput(report, label))
        if args.emit:
            w = JsonlWriter(args.emit)
            w.emit(goodput_event(report))
            w.close()
    if len(flats) > 1:
        print_goodput_comparison(flats)
    return 0


def print_comparison(summaries: list[dict]) -> None:
    labels = [s["label"] for s in summaries]
    width = max(12, *(len(l) for l in labels)) + 2
    head = "metric".ljust(18) + "".join(l.rjust(width) for l in labels)
    ratio = len(summaries) == 2
    if ratio:
        head += "B/A".rjust(10)
    print(head)
    print("-" * len(head))
    for name, key in COMPARE_ROWS:
        vals = [s.get(key) for s in summaries]
        if all(v is None for v in vals):
            continue
        line = name.ljust(18) + "".join(_fmt(v).rjust(width) for v in vals)
        if ratio and vals[0] and vals[1] is not None:
            line += f"{vals[1] / vals[0]:.3f}x".rjust(10)
        print(line)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("files", nargs="+",
                   help="telemetry/metrics JSONL file(s); with --goodput, "
                        "one RUN each (a file, or a directory of JSONL "
                        "streams joined by obs/goodput.py)")
    p.add_argument("--goodput", action="store_true",
                   help="render each run's exclusive wall-time decomposition "
                        "(obs/goodput.py) instead of the event summary; two+ "
                        "runs add the faulted-vs-clean A-vs-B table")
    p.add_argument("--emit", default="",
                   help="--goodput only: append each run's ledger as a "
                        "{'event': 'goodput'} line to this JSONL")
    args = p.parse_args(argv)

    if args.goodput:
        return run_goodput(args)

    summaries = [summarize(f) for f in args.files]
    for s in summaries:
        print_summary(s)
    if len(summaries) > 1:
        print_comparison(summaries)
    return 0


if __name__ == "__main__":
    sys.exit(main())
