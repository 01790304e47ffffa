"""Render distributed-tracing span JSONL: critical paths, slow traces, Chrome export.

The port's counterpart of the JAX package's ``tools/trace_report.py``, with its flags,
output and exit codes, over the port's ``utils/trace.py`` (either package's span files
read alike).

Input is whatever a traced serving run left behind — the span files under a
``--trace-dir`` (``loadgen.jsonl``, ``router.jsonl`` or ``server.jsonl``, one
``replica<i>.jsonl`` per replica; see ``utils/trace.py`` for the span schema)
plus, optionally, the run's serve/route telemetry JSONL. Pass files or
directories in any mix: span events are assembled into per-request trees by
``trace_id``, every non-span event feeds the TTFT reconciliation.

The report answers "where did request 1234's milliseconds go":

- **critical path**: per-segment exclusive seconds (router queue wait, routing,
  failed dispatch hops, replica queue wait, prefill, speculative draft/verify,
  first-token decode, decode tail, resolve, transport/scheduling overhead)
  reduced to p50/p95/mean across all traces;
- **slowest N**: the worst end-to-end traces with their full span trees —
  every span, time-offset and duration, in cross-process anchored order, with
  redispatch hops (and their crash/preempt/hang causes) called out;
- **reconciliation**: span-derived TTFT percentiles against the latency
  telemetry's own (route events for fleets, serve events for a single server)
  — the cross-check that the tracing plane measures the same reality the
  percentile tables report;
- **orphans**: traces with no terminal span (no ``resolve``/``client``) — a
  stranded future or a lost span file; zero in a healthy run;
- **Chrome export** (``--chrome out.json``): trace-event JSON loadable in
  ``chrome://tracing`` / Perfetto — one track per process (router first, then
  replicas, then clients), one lane per request, span attrs searchable under
  ``args``. ``--validate`` gates the export against the trace-event schema
  (every span has pid/tid/ts/dur, pids resolve to process names, every event
  carries its trace_id) and exits nonzero on problems or orphans — the CI
  trace-smoke contract.

Usage::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.trace_report \\
        results/trace/
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.trace_report \\
        results/trace/ results/serve.jsonl --slowest 3 --chrome results/chrome_trace.json \\
        --validate
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.trace import (
    SEGMENTS,
    chrome_trace,
    lifecycle_timeline,
    read_spans,
    reconcile_ttft,
    summarize_traces,
    validate_chrome,
)


def _ms(x) -> str:
    return "-" if x is None else f"{x * 1e3:.1f}"


def print_segments(summary: dict) -> None:
    seg = summary["segments"]
    if not seg:
        print("no segment time recorded")
        return
    head = "segment".ljust(20) + "".join(c.rjust(12)
                                         for c in ("p50 ms", "p95 ms", "mean ms"))
    print(head)
    print("-" * len(head))
    for name in SEGMENTS:
        if name not in seg:
            continue
        row = seg[name]
        print(name.ljust(20) + _ms(row.get("p50")).rjust(12)
              + _ms(row.get("p95")).rjust(12) + _ms(row.get("mean")).rjust(12))


def print_trace_tree(tid: str, spans: list[dict], down: dict) -> None:
    """One trace's spans in anchored order, offsets relative to trace start."""
    causes = ", ".join(c or "?" for c in down["redispatch_causes"])
    print(f"  trace {tid}: e2e {_ms(down['e2e_s'])}ms, "
          f"ttft {_ms(down['ttft_s'])}ms, finish {down['finish'] or '?'}, "
          f"{down['hops']} hop(s)" + (f" (redispatch: {causes})" if causes else ""))
    ids = ", ".join(f"{proc}#{rid}" for proc, rid
                    in sorted(down["request_ids"].items()))
    if ids:
        print(f"    request ids: {ids}")
    for s in spans:
        attrs = {k: v for k, v in s.items()
                 if k not in ("event", "trace_id", "name", "proc", "ts",
                              "dur_s", "t_s", "request_id")}
        extra = "".join(f" {k}={v}" for k, v in sorted(attrs.items()))
        print(f"    +{(s['ts'] - down['start']) * 1e3:8.1f}ms "
              f"{_ms(s.get('dur_s')).rjust(8)}ms  "
              f"{(s.get('proc') or '?').ljust(10)} {s['name']}{extra}")


def print_reconciliation(rec: dict | None) -> None:
    if rec is None:
        print("ttft reconciliation: no latency events alongside the spans "
              "(pass the run's --telemetry JSONL too)")
        return
    print(f"ttft reconciliation (span-derived vs '{rec['source']}' events):")
    for q in ("p50", "p95"):
        ratio = rec.get(f"{q}_ratio")
        print(f"  {q}: span {_ms(rec['span'].get(q))}ms vs "
              f"event {_ms(rec['events'].get(q))}ms"
              + (f"  ({ratio:.3f}x)" if ratio is not None else ""))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("paths", nargs="+",
                   help="span JSONL files/dirs, optionally mixed with the "
                        "run's telemetry JSONL (for TTFT reconciliation)")
    p.add_argument("--slowest", type=int, default=5,
                   help="how many worst-e2e traces get their full span tree "
                        "printed (0 = none)")
    p.add_argument("--chrome", default="",
                   help="write Chrome trace-event JSON here "
                        "(chrome://tracing / Perfetto)")
    p.add_argument("--validate", action="store_true",
                   help="exit nonzero on orphan traces or a Chrome export "
                        "that fails the trace-event schema check")
    args = p.parse_args(argv)

    spans, events = read_spans(args.paths)
    if not spans:
        print("no spans found (was the run traced? pass --trace-dir to "
              "serve_loadgen)")
        return 1
    summary = summarize_traces(spans)

    print(f"== {summary['traces']} traces, {summary['spans']} spans, "
          f"{summary['redispatched']} redispatched, "
          f"{summary['orphans']} orphan(s)")
    ttft, e2e = summary["ttft_s"], summary["e2e_s"]
    if e2e:
        print(f"   e2e p50 {_ms(e2e.get('p50'))}ms  p95 {_ms(e2e.get('p95'))}ms"
              + (f"   ttft p50 {_ms(ttft.get('p50'))}ms  "
                 f"p95 {_ms(ttft.get('p95'))}ms" if ttft else ""))
    print()
    print_segments(summary)
    print()
    print_reconciliation(reconcile_ttft(summary, events))

    lifecycle = lifecycle_timeline(spans)
    if lifecycle:
        # The fleet's own history (scale_up/scale_down/reload), excluded from
        # the per-request accounting above but rendered as its own timeline —
        # offsets relative to the earliest REQUEST span so the scale actions
        # line up with the traffic that caused them.
        base = min((s["ts"] for s in spans
                    if s.get("name") not in ("scale", "reload")),
                   default=lifecycle[0]["ts"])
        print(f"\nfleet lifecycle ({len(lifecycle)} scale/reload event(s)):")
        for s in lifecycle:
            attrs = "".join(f" {k}={s[k]}" for k in
                            ("action", "replica", "target", "reason",
                             "checkpoint") if s.get(k) not in (None, ""))
            print(f"  +{(s['ts'] - base) * 1e3:8.1f}ms  {s['name']}{attrs}")

    if args.slowest > 0:
        traces = summary["by_trace"]
        print(f"\nslowest {min(args.slowest, len(traces))} trace(s):")
        by_id = {}
        for s in spans:
            by_id.setdefault(s.get("trace_id"), []).append(s)
        for tid in list(traces)[:args.slowest]:
            print_trace_tree(
                tid, sorted(by_id[tid], key=lambda s: (s["ts"],
                                                       s.get("dur_s") or 0)),
                traces[tid])

    if summary["orphans"]:
        print(f"\nWARNING: {summary['orphans']} orphan trace(s) — no terminal "
              f"resolve/client span: {', '.join(summary['orphan_ids'][:8])}")

    problems = []
    if args.chrome:
        doc = chrome_trace(spans)
        problems = validate_chrome(doc)
        with open(args.chrome, "w") as f:
            json.dump(doc, f)
        n_x = sum(e.get("ph") == "X" for e in doc["traceEvents"])
        print(f"\nchrome trace -> {args.chrome} ({n_x} events, "
              f"{'valid' if not problems else f'{len(problems)} problem(s)'}) "
              f"— load in chrome://tracing or https://ui.perfetto.dev")
        for prob in problems[:10]:
            print(f"  {prob}")

    if args.validate and (problems or summary["orphans"]):
        return 1
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # `trace_report ... | head` closing the pipe mid-span-tree is normal
        # usage, not an error worth a traceback.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
