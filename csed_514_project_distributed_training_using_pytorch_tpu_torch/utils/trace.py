"""Distributed request tracing: spans from the load generator to the decode tick, one
schema.

The port's own copy of the JAX package's ``utils/trace.py`` (plain Python; the port imports
nothing of that package), with its span vocabulary, file layout and JSON keys, so either
package's ``trace_report`` reads either package's span files. The serve path is up to four
processes deep (load generator, router, replica over TCP, ``serving/server.py`` and
``engine.py``); this module answers where one request's milliseconds went:

- every request gets a ``trace_id`` at its origin (``serve_loadgen``, ``Server.submit``)
  and the id rides the replica's line protocol (``serving/replica.py``) into the engine,
  so spans from several processes join into one tree by id alone;
- each process emits **spans**, ``{"event": "span", "trace_id", "name", "proc", "ts",
  "dur_s", ...attrs}``, through its own :class:`Tracer` (a ``utils.jsonl.JsonlWriter``:
  no device is touched). The names are a fixed vocabulary: ``client`` (submit to the
  future's resolution), ``queue_wait`` (arrival to admission), ``route``, ``dispatch``,
  ``redispatch`` and ``hedge`` (the router's), ``prefill`` (per chunk, with
  ``cache_hit_len``), ``decode`` (decode-ready to done, with the first-token split),
  ``draft``/``verify`` (speculative decoding's children of the decode window, per verify
  tick), ``preempt_park``/``resume`` (priority preemption), ``resolve`` (completion to the
  future's resolution);
- **clock anchoring**: timestamps are ``time.monotonic()`` stamps shifted by a
  per-process anchor ``time.time() - time.monotonic()`` taken once per ``Tracer``.
  Durations keep the monotonic clock's fidelity; absolute positions compare across
  processes on one host, so cross-process spans order without a handshake (the residual
  is wall-versus-monotonic drift over a process's life, microseconds over a serving run).

Each process writes its own file (``<trace_dir>/server.jsonl``, ``replica<i>.jsonl``,
``loadgen.jsonl``): no cross-process locking, restarts append, and a killed process tears
at most its own last line, which ``utils.jsonl.read_jsonl`` skips. Assembly, the
critical-path accounting and the Chrome trace-event export live here too, so the port's
``trace_report`` and ``serve_loadgen --summary-json`` render from one implementation.
"""

from __future__ import annotations

import itertools
import math
import os
import time

from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
    JsonlWriter,
    percentiles,
    read_jsonl,
)

_counter = itertools.count()


def new_trace_id() -> str:
    """A process-unique id: pid + per-process counter + a coarse time salt (two
    processes can share a pid across restarts; same-second reuse does not)."""
    return f"{os.getpid():x}-{int(time.time()):x}-{next(_counter):x}"


class Tracer:
    """Span emitter for ONE process. ``path`` empty disables everything (every
    call is a no-op — tracing off costs a truthiness check); ``proc`` names this
    process's track (``"router"``, ``"replica0"``, ``"server"``, ``"loadgen"``).

    All public stamps are ``time.monotonic()`` values — the same clock every
    serving component already uses for deadlines — converted to anchored
    wall-comparable seconds only at emission.
    """

    def __init__(self, path: str, *, proc: str):
        self.proc = proc
        self._writer = JsonlWriter(path)
        # The per-process anchor: monotonic -> wall, captured once. See the
        # module docstring for the ordering argument.
        self._anchor = time.time() - time.monotonic()

    @property
    def enabled(self) -> bool:
        return self._writer.enabled

    def anchored(self, mono_s: float) -> float:
        """A monotonic stamp as wall-comparable absolute seconds."""
        return self._anchor + mono_s

    def span(self, name: str, trace_id: str | None, t0: float,
             t1: float | None = None, **attrs) -> None:
        """Emit one span: ``[t0, t1]`` monotonic stamps (``t1`` None = a point
        span, dur 0). Silently a no-op when disabled or the request carries no
        trace id (an untraced request through a traced server)."""
        if not self.enabled or trace_id is None:
            return
        dur = 0.0 if t1 is None else max(0.0, t1 - t0)
        ev = {"event": "span", "trace_id": trace_id, "name": name,
              "proc": self.proc, "ts": round(self.anchored(t0), 6),
              "dur_s": round(dur, 6)}
        for k, v in attrs.items():
            if v is not None:
                ev[k] = (round(self.anchored(v), 6) if k.endswith("_ts")
                         else v)
        self._writer.emit(ev)

    def close(self) -> None:
        self._writer.close()


# --------------------------------------------------------------------- reading


def span_files(paths) -> list[str]:
    """Expand files-or-directories into the JSONL files under them (sorted —
    deterministic assembly order)."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(os.path.join(p, f) for f in os.listdir(p)
                              if f.endswith(".jsonl")))
        else:
            out.append(p)
    return out


def read_spans(paths) -> tuple[list[dict], list[dict]]:
    """Load spans (and every non-span event, for reconciliation) from files or
    directories. Returns ``(spans, other_events)``; both use the shared guarded
    reader, so a crashed process's torn final line never blocks assembly."""
    spans, other = [], []
    for path in span_files(paths):
        for row in read_jsonl(path):
            (spans if row.get("event") == "span" else other).append(row)
    return spans, other


def assemble(spans) -> dict[str, list[dict]]:
    """Group spans by ``trace_id``, each trace sorted by anchored start time."""
    traces: dict[str, list[dict]] = {}
    for s in spans:
        tid = s.get("trace_id")
        if tid:
            traces.setdefault(tid, []).append(s)
    for tid in traces:
        traces[tid].sort(key=lambda s: (s.get("ts") or 0.0, s.get("dur_s") or 0))
    return traces


# The terminal span names: a trace holding none of these never resolved — its
# spans are ORPHANS (a future stranded, or a trace file lost). trace_report
# counts them; tests pin the count at zero.
TERMINAL_SPANS = ("resolve", "client")

# Fleet-lifecycle spans (the router's scale_up/scale_down/reload timeline
# annotations plus straggler eject/probe markers, all sharing one synthetic
# trace id): real spans on the Chrome timeline, but NOT requests —
# per-request accounting (summarize_traces, orphan counting) excludes them,
# or every elastic run would report one eternal "orphan" that is actually
# the fleet's own history.
LIFECYCLE_SPANS = ("scale", "reload", "eject")

# Critical-path segments, in pipeline order. ``dispatch`` spans OVERLAP the
# replica-side work they contain, so the breakdown uses the replica's own
# spans for the covered interior and charges only the remainder to overhead.
# ``draft``/``verify`` are the speculative-decoding children of the decode
# window (per verify tick: host drafting wall, then the batched verify
# program) — carved OUT of decode_first/decode_tail below so the segments
# stay exclusive and still sum to e2e. ``preempt_park`` is the decode stint a
# priority-preempted slot served before its eviction and ``resume`` the
# parked wait until re-admission (DESIGN.md §22) — the final ``decode`` span
# covers only the post-resume stint, so the three never overlap; the padding
# between park and resume that neither captures lands in ``overhead`` like
# any other scheduling gap.
SEGMENTS = ("router_queue_wait", "route", "failed_dispatch", "prefill_tier",
            "handoff", "replica_queue_wait",
            "prefill", "preempt_park", "resume", "draft", "verify",
            "decode_first", "decode_tail", "resolve", "overhead")


def trace_breakdown(spans: list[dict]) -> dict:
    """One trace's critical-path accounting: exclusive per-segment seconds that
    sum (with ``overhead`` absorbing scheduling/transport gaps) to the trace's
    end-to-end span. Exclusivity across hops: a losing (drained) dispatch is
    charged in FULL as ``failed_dispatch``, so replica-side spans that started
    inside its window — the dead replica's queue_wait/prefill/decode history, a
    hung zombie's late decode — stay visible in the span tree but are NOT
    summed into their segments (they would double-charge the same interval).
    Also surfaces redispatch hops, the span-derived TTFT, and the request ids
    seen at each tier (router vs replica — they differ: each tier numbers
    requests independently; the trace id is the join key)."""
    by_name: dict[str, list[dict]] = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)

    drained_windows = [(d["ts"], d["ts"] + (d.get("dur_s") or 0.0))
                       for d in by_name.get("dispatch", ())
                       if d.get("outcome") == "drained"]
    # Hedge-loser windows are SHADOWS, not failures: the losing copy ran
    # concurrently with the winner, so its wall clock is already covered by
    # the winning hop — its replica-side spans are excluded from the segment
    # sums (they would double-charge the interval), but the window itself is
    # NOT charged anywhere (unlike a drained hop, where the failed interval
    # was the only thing happening). Shadow exclusion is scoped to the LOSING
    # replica's own track: the winner's spans cover the same wall clock by
    # design and must keep counting.
    shadow_windows = [(d["ts"], d["ts"] + (d.get("dur_s") or 0.0),
                       f"replica{d.get('replica')}")
                      for d in by_name.get("dispatch", ())
                      if d.get("outcome") == "hedge_lost"]
    # Disaggregated prefill (DESIGN.md §25): the router's ``prefill_tier``
    # span covers the whole prefill-replica stint (dispatch → prefill_done),
    # so the prefill replica's own interior spans (its queue_wait/prefill)
    # are excluded from their segments — the tier window already charges
    # that wall, exclusively. The decode replica's spans start after the
    # window closes, so the decode-tier wall stays in decode_first/tail.
    tier_windows = [(d["ts"], d["ts"] + (d.get("dur_s") or 0.0))
                    for d in by_name.get("prefill_tier", ())]

    def losing(s):
        # Only replica-side spans can be "inside" a losing hop; the router's
        # own spans legitimately touch window boundaries (a route span at the
        # dispatch instant, the replay's queue_wait at the drain instant).
        # 2e-6 absorbs the independent 6-decimal rounding of ts and dur_s; the
        # winning hop's replica spans start a transport hop AFTER the drain.
        if s.get("proc") == "router":
            return False
        if any(a - 2e-6 <= s["ts"] <= b + 2e-6 for a, b in drained_windows):
            return True
        if any(a - 2e-6 <= s["ts"] <= b + 2e-6 for a, b in tier_windows):
            return True
        return any(a - 2e-6 <= s["ts"] <= b + 2e-6
                   for a, b, proc in shadow_windows
                   if s.get("proc") == proc)

    def total(name, pred=lambda s: True):
        return sum(s.get("dur_s") or 0.0 for s in by_name.get(name, ())
                   if pred(s) and not losing(s))

    start = min(s["ts"] for s in spans)
    end = max(s["ts"] + (s.get("dur_s") or 0.0) for s in spans)
    seg = dict.fromkeys(SEGMENTS, 0.0)
    seg["router_queue_wait"] = total("queue_wait",
                                     lambda s: s.get("proc") == "router")
    seg["replica_queue_wait"] = total("queue_wait",
                                      lambda s: s.get("proc") != "router")
    seg["route"] = total("route")
    seg["failed_dispatch"] = sum(b - a for a, b in drained_windows)
    # The handoff span lies INSIDE the prefill_tier window (the router closes
    # both at prefill_done): charge the shipping wall to its own segment and
    # carve the same seconds out of the tier window, so the sum stays e2e.
    seg["handoff"] = total("handoff")
    seg["prefill_tier"] = max(0.0, total("prefill_tier") - seg["handoff"])
    seg["prefill"] = total("prefill")
    # Priority preemption (DESIGN.md §22): the evicted decode stint and the
    # parked wait are their own segments — a preempted best-effort request's
    # e2e must show WHERE the squeeze landed, not smear it into overhead.
    seg["preempt_park"] = total("preempt_park")
    seg["resume"] = total("resume")
    decodes = [d for d in by_name.get("decode", ()) if not losing(d)]
    for d in decodes:
        first = d.get("first_token_s")
        dur = d.get("dur_s") or 0.0
        seg["decode_first"] += dur if first is None else min(first, dur)
        seg["decode_tail"] += 0.0 if first is None else max(0.0, dur - first)
    # Speculative decoding's draft/verify spans lie INSIDE the decode window:
    # charge them to their own segments and carve the same seconds out of the
    # decode split (tail first — drafting happens throughout, but the tail is
    # where the bulk of the window lives), so the sum stays exactly e2e.
    seg["draft"] = total("draft")
    seg["verify"] = total("verify")
    carve = seg["draft"] + seg["verify"]
    take = min(seg["decode_tail"], carve)
    seg["decode_tail"] -= take
    seg["decode_first"] = max(0.0, seg["decode_first"] - (carve - take))
    seg["resolve"] = total("resolve")
    e2e = end - start
    seg["overhead"] = max(0.0, e2e - sum(seg.values()))

    redispatches = sorted(by_name.get("redispatch", ()),
                          key=lambda s: s["ts"])
    # Span-derived TTFT: origin (trace start) -> the first token of the attempt
    # that actually resolved (the LAST decode span — a drained hop's decode
    # span, when it exists at all, precedes the replay's).
    ttft = None
    if decodes:
        d = max(decodes, key=lambda s: s["ts"])
        if d.get("first_token_ts") is not None:
            ttft = max(0.0, d["first_token_ts"] - start)
    return {
        "start": start, "end": end, "e2e_s": e2e, "segments": seg,
        "ttft_s": ttft,
        "hops": 1 + len(redispatches),
        "hedges": len(by_name.get("hedge", ())),
        "redispatch_causes": [s.get("cause") for s in redispatches],
        "resolved": any(s["name"] in TERMINAL_SPANS for s in spans),
        "request_ids": {s.get("proc"): s.get("request_id") for s in spans
                        if s.get("request_id") is not None},
        "finish": next((s.get("finish") for s in reversed(spans)
                        if s.get("finish") is not None), None),
    }


def lifecycle_timeline(spans) -> list[dict]:
    """The fleet-lifecycle spans (scale/reload), in time order — the scale
    timeline ``trace_report`` renders alongside per-request trees."""
    return sorted((s for s in spans if s.get("name") in LIFECYCLE_SPANS),
                  key=lambda s: s.get("ts") or 0.0)


def summarize_traces(spans) -> dict:
    """Fleet-level reduction of a span set: per-segment p50/p95 over all traces,
    span-derived TTFT percentiles, hop/orphan accounting, and the per-trace
    breakdowns (sorted slowest-first) for the slowest-N report. Fleet-lifecycle
    spans (``LIFECYCLE_SPANS``) are excluded — they are timeline annotations,
    not requests."""
    spans = [s for s in spans if s.get("name") not in LIFECYCLE_SPANS]
    traces = assemble(spans)
    downs = {tid: trace_breakdown(t) for tid, t in traces.items()}
    orphans = [tid for tid, d in downs.items() if not d["resolved"]]
    seg_pcts = {}
    for name in SEGMENTS:
        vals = [d["segments"][name] for d in downs.values()]
        pcts = percentiles(vals, qs=(50, 95))
        if pcts and any(v > 0 for v in vals):
            seg_pcts[name] = {**pcts, "mean": sum(vals) / len(vals)}
    ttfts = [d["ttft_s"] for d in downs.values() if d["ttft_s"] is not None]
    return {
        "traces": len(traces),
        "spans": len(list(spans)),
        "orphans": len(orphans),
        "orphan_ids": orphans,
        "redispatched": sum(d["hops"] > 1 for d in downs.values()),
        "hedged": sum(d.get("hedges", 0) > 0 for d in downs.values()),
        "segments": seg_pcts,
        "ttft_s": percentiles(ttfts, qs=(50, 95)),
        "e2e_s": percentiles([d["e2e_s"] for d in downs.values()], qs=(50, 95)),
        "by_trace": dict(sorted(downs.items(),
                                key=lambda kv: -kv[1]["e2e_s"])),
    }


def reconcile_ttft(summary: dict, events) -> dict | None:
    """Span-derived TTFT percentiles against the serve/route events' own —
    the cross-check that the tracing plane measures the same reality the
    latency telemetry reports. Returns p50/p95 for both sides plus the ratio;
    None when either side is empty. Route events win over serve events when
    both exist (fleet runs: the replica-local serve ids don't match the
    router's; route events are the client-facing truth)."""
    routes = [e for e in events if e.get("event") == "route"]
    serves = routes or [e for e in events if e.get("event") == "serve"]
    ev_ttft = percentiles([e.get("ttft_s") for e in serves], qs=(50, 95))
    span_ttft = summary.get("ttft_s")
    if not ev_ttft or not span_ttft:
        return None
    out = {"span": span_ttft, "events": ev_ttft, "source":
           "route" if routes else "serve"}
    for q in ("p50", "p95"):
        a, b = span_ttft.get(q), ev_ttft.get(q)
        out[f"{q}_ratio"] = (a / b if a and b else None)
    return out


# ------------------------------------------------------------- chrome export


def chrome_trace(spans) -> dict:
    """The span set as Chrome trace-event JSON (``chrome://tracing`` /
    Perfetto's legacy loader): one ``pid`` track per process (router, each
    replica, loadgen/server) named via ``process_name`` metadata, one ``tid``
    lane per trace within each track (requests overlap freely — a lane per
    request keeps concurrent spans from nesting into nonsense), ``ph: "X"``
    complete events with microsecond ``ts``/``dur`` and the span attrs under
    ``args`` (``trace_id`` included, so Perfetto's search finds a request by
    id)."""
    spans = sorted(spans, key=lambda s: (s.get("ts") or 0.0))
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(s["ts"] for s in spans)
    pids: dict[str, int] = {}
    lanes: dict[str, int] = {}
    events = []
    for s in spans:
        pid = pids.setdefault(s.get("proc") or "?", len(pids) + 1)
        tid = lanes.setdefault(s["trace_id"], len(lanes) + 1)
        args = {k: v for k, v in s.items()
                if k not in ("event", "name", "proc", "ts", "dur_s", "t_s")}
        events.append({
            "name": s["name"], "cat": "serve", "ph": "X",
            "pid": pid, "tid": tid,
            "ts": round((s["ts"] - base) * 1e6, 1),
            "dur": max(round((s.get("dur_s") or 0.0) * 1e6, 1), 1.0),
            "args": args,
        })
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": proc}} for proc, pid in sorted(pids.items())]
    # Sort index pins track order: router first, then replicas, then clients.
    order = {"router": 0, "loadgen": 90, "server": 91}
    meta += [{"name": "process_sort_index", "ph": "M", "pid": pid, "tid": 0,
              "args": {"sort_index": order.get(proc, 10)}}
             for proc, pid in sorted(pids.items())]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def validate_chrome(doc: dict) -> list[str]:
    """Schema check for the export (the CI trace-smoke gate): every ``X`` event
    carries numeric pid/tid/ts/dur, every pid resolves to a ``process_name``
    metadata record, and every event references a trace (a span that lost its
    ``trace_id`` would render as an unattributable box). Returns the problems
    (empty = valid)."""
    problems = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    named = {e.get("pid") for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    for i, e in enumerate(events):
        if e.get("ph") != "X":
            continue
        for key in ("pid", "tid", "ts", "dur"):
            v = e.get(key)
            if not isinstance(v, (int, float)) or not math.isfinite(v) or v < 0:
                problems.append(f"event {i} ({e.get('name')}): bad {key}={v!r}")
        if e.get("pid") not in named:
            problems.append(f"event {i} ({e.get('name')}): pid {e.get('pid')} "
                            f"has no process_name record")
        if not e.get("args", {}).get("trace_id"):
            problems.append(f"event {i} ({e.get('name')}): no trace_id arg")
    return problems
