"""Goodput accounting: an EXCLUSIVE wall-time decomposition of a training run.

The port's own copy of the JAX package's ``obs/goodput.py`` (plain Python; the port imports
nothing of that package). It reads the port's telemetry streams (``utils/telemetry.py``) and
the supervisor's (``resilience/supervisor.py``) with the same rules, and either package's
``decompose`` reads either package's streams.

The headline artifact of the reference paper is time-to-train vs machines —
and on a preemptible fleet, time-to-train is dominated not by step time but by
everything around it: compiles and graph captures, checkpoint stalls, the teardown/backoff/
respawn of every restart, and the steps a resumed attempt re-executes because
the work they did the first time never became durable. The telemetry substrate
already records all of it (epoch/compile/checkpoint events per attempt,
supervisor restart events, trace spans); this module JOINS those streams into
one run-level ledger:

    wall_s == init_compile_s + compute_s + data_wait_s + checkpoint_stall_s
              + restart_badput_s + idle_s            (exclusive, by construction)

    goodput_frac == compute_s / wall_s

Segment rules (DESIGN.md §21 — the exclusive-decomposition rule):

- ``init_compile`` — fleet spawn + process init + kernel build and graph capture, only for
  the FIRST attempt (attempt start → first epoch start). The same window in a
  restarted attempt is recovery overhead and charged to ``restart_badput``.
- ``compute`` — device execution (``execute_s``) plus eval of every epoch
  executed for the FIRST time. This is the goodput numerator: the only
  seconds that moved the model forward.
- ``data_wait`` — the epochs' ``data_s`` (index-plan/feed construction): the
  classic way real fleets miss their MFU numbers.
- ``checkpoint_stall`` — synchronous checkpoint-save wall time (the
  write-behind saver's ``background`` saves overlap compute and charge
  nothing). Restore wall is NOT added here: a restore only exists inside an
  init window already charged to its attempt's segment.
- ``restart_badput`` — everything a restart costs: the crash→respawn gap
  (teardown, backoff, re-import), the restarted attempt's init/compile
  window, and the full wall of every REPLAYED epoch — an epoch whose index an
  earlier attempt already executed. Replayed step time is badput, not
  compute: those steps re-derive state a checkpoint should have kept. A run
  with zero restarts has ``restart_badput_s == 0.0`` exactly.
- ``rollback_badput`` — the same accounting for restarts the supervisor
  classified as ``poisoned`` or ``desync`` (the numerical-immune-system
  rollback-and-skip path, resilience/poison.py): the teardown gap, the
  recovery init, and the replayed window of an attempt whose PREDECESSOR
  tripped the anomaly policy. Split from ``restart_badput`` because the cure
  differs — process badput says buy better capacity, rollback badput says
  the detector/skip policy is paying for bad math — and a run with zero
  rollbacks has ``rollback_badput_s == 0.0`` exactly.
- ``idle`` — the residual: whatever the instrumented windows do not cover
  (host work between epochs, drain tails, supervisor polling). Computed as
  ``wall - everything_else`` and clamped at zero; a negative residual (clock
  skew, overlapping windows) is surfaced as ``unaccounted_s`` instead of
  silently distorting a named segment.

Stream joining: every input file is JSONL through the one guarded reader
(``utils.jsonl.read_jsonl`` — a killed writer tears at most the final line,
which is skipped). Rows self-classify by ``event`` kind: ``span`` rows are
trace spans (absolute ``ts``), ``restart``/``supervise_summary`` rows are the
supervisor stream (absolute ``unix_time`` + relative ``t_s``), everything
else is trainer telemetry — split into ATTEMPTS at each ``manifest`` row and
anchored to absolute time via ``manifest.unix_time - manifest.t_s`` (the
writer's birth). Multi-attempt histories exist because the non-stream
``TelemetryWriter`` preserves prior events on the same path (utils/telemetry
.py): a supervised restart APPENDS its attempt after the crashed one's.

Plain Python (stdlib + ``utils.jsonl``): a process that reads it touches no device.
"""

from __future__ import annotations

import os

from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
    read_jsonl,
)

#: Event kinds that belong to the supervisor stream (absolute ``unix_time``).
SUPERVISOR_KINDS = ("restart", "supervise_summary")

#: DERIVED ledger kinds: outputs of this module / the perf gate, not run
#: streams. ``--goodput --emit`` drops its line next to the run's other
#: files, and a later join of the same directory must skip it — a ledger
#: row carries no manifest and would otherwise masquerade as an unanchored
#: trainer attempt.
DERIVED_KINDS = ("goodput", "bench_guard")

#: The exclusive segments, in render order.
SEGMENTS = ("init_compile_s", "compute_s", "data_wait_s",
            "checkpoint_stall_s", "restart_badput_s", "rollback_badput_s",
            "idle_s")

#: Supervisor restart reasons whose recovery cost charges to
#: ``rollback_badput_s`` (the anomaly rollback-and-skip path).
ROLLBACK_REASONS = ("poisoned", "desync")


def _expand(paths) -> list[str]:
    """Files-or-directories -> the JSONL files under them (sorted)."""
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(os.path.join(p, f) for f in os.listdir(p)
                              if f.endswith(".jsonl")))
        else:
            out.append(p)
    return out


def read_streams(paths) -> dict:
    """Load + classify every row of every input file.

    Returns ``{"attempts": [...], "supervisor": [...], "spans": [...],
    "files": N, "events": N}``. Each attempt is ``{"anchor": unix-seconds or
    None, "rows": [...]}`` — one per ``manifest`` row per telemetry file, in
    file order (rows before a file's first manifest form an unanchored
    leading attempt, tolerated for hand-built streams)."""
    attempts: list[dict] = []
    supervisor: list[dict] = []
    spans: list[dict] = []
    files = _expand(paths)
    events = 0
    for path in files:
        current: dict | None = None
        for row in read_jsonl(path):
            events += 1
            kind = row.get("event")
            if kind == "span":
                spans.append(row)
                continue
            if kind in SUPERVISOR_KINDS:
                supervisor.append(row)
                continue
            if kind in DERIVED_KINDS:
                continue              # prior ledger output: never a stream
            if kind == "manifest":
                anchor = None
                if (row.get("unix_time") is not None
                        and row.get("t_s") is not None):
                    anchor = float(row["unix_time"]) - float(row["t_s"])
                current = {"anchor": anchor, "rows": [row]}
                attempts.append(current)
                continue
            if current is None:
                current = {"anchor": None, "rows": []}
                attempts.append(current)
            current["rows"].append(row)
    return {"attempts": attempts, "supervisor": supervisor, "spans": spans,
            "files": len(files), "events": events}


def _attempt_facts(attempt: dict) -> dict:
    """Reduce one attempt's rows to the decomposition's inputs, with absolute
    times where the attempt is anchored (relative ``t_s`` otherwise — a
    single unanchored stream still decomposes; only cross-stream joins need
    the anchor)."""
    anchor = attempt["anchor"] or 0.0
    rows = attempt["rows"]
    ts = [float(r["t_s"]) for r in rows if r.get("t_s") is not None]
    start = anchor
    end = anchor + (max(ts) if ts else 0.0)
    epochs = []
    for r in rows:
        if r.get("event") != "epoch":
            continue
        t_end = anchor + float(r.get("t_s") or 0.0)
        epochs.append({
            "epoch": int(r.get("epoch") or 0),
            "steps": int(r.get("steps") or 0),
            "wall_s": float(r.get("wall_s") or 0.0),
            "execute_s": float(r.get("execute_s") or 0.0),
            "eval_s": float(r.get("eval_s") or 0.0),
            "data_s": float(r.get("data_s") or 0.0),
            "end": t_end,
        })
    saves = [r for r in rows if r.get("event") == "checkpoint"
             and r.get("op") == "save"]
    restores = [r for r in rows if r.get("event") == "checkpoint"
                and r.get("op") == "restore"]
    return {
        "anchor": attempt["anchor"],
        "start": start,
        "end": end,
        "epochs": epochs,
        "save_stall_s": sum(float(r.get("wall_s") or 0.0) for r in saves
                            if not r.get("background")),
        "saves": len(saves),
        "restore_s": sum(float(r.get("wall_s") or 0.0) for r in restores),
        "restores": len(restores),
        "preempted": any(r.get("event") == "preempt" for r in rows),
    }


def decompose(paths) -> dict:
    """The run ledger: join the streams under ``paths`` (files and/or
    directories of JSONL) and return the exclusive decomposition.

    Raises ``ValueError`` when no attempt with epochs exists — there is no
    run to account for. Multi-attempt runs need anchors (each attempt's
    manifest carries one by construction); a hand-built single attempt
    without one decomposes in its own relative clock."""
    streams = read_streams(paths)
    attempts = [_attempt_facts(a) for a in streams["attempts"]]
    # A sidecar file of non-run events (a serving log, a drain summary) can
    # produce an anchored-or-not attempt with no epochs and no manifest
    # anchor; it contributes nothing and must not trip the multi-attempt
    # anchoring guard below.
    attempts = [a for a in attempts
                if a["epochs"] or a["anchor"] is not None]
    if not any(a["epochs"] for a in attempts):
        raise ValueError(
            f"no trainer epochs found in {list(paths)!r} — goodput needs at "
            f"least one telemetry stream with epoch events")
    if len(attempts) > 1 and any(a["anchor"] is None for a in attempts):
        raise ValueError(
            "multi-attempt run with an unanchored attempt (manifest without "
            "unix_time) — attempts cannot be ordered on one clock")
    attempts.sort(key=lambda a: a["start"])

    # Run span: trainer attempts, the supervisor's own stream (its writer is
    # born at supervise() entry and its summary lands after the final
    # teardown), and any trace spans, all on the shared unix clock.
    starts = [a["start"] for a in attempts]
    ends = [a["end"] for a in attempts]
    for row in streams["supervisor"]:
        if row.get("unix_time") is not None and row.get("t_s") is not None:
            anchor = float(row["unix_time"]) - float(row["t_s"])
            starts.append(anchor)
            ends.append(float(row["unix_time"]))
    for span in streams["spans"]:
        if span.get("ts") is not None:
            starts.append(float(span["ts"]))
            ends.append(float(span["ts"]) + float(span.get("dur_s") or 0.0))
    run_start, run_end = min(starts), max(ends)
    wall_s = max(0.0, run_end - run_start)

    # Attribute each restarted attempt's recovery cost by its CAUSE: the
    # supervisor restart event that spawned it — matched by TIME (the newest
    # restart stamped at or before the attempt's anchored start), not by
    # index, because an attempt that died before writing any telemetry leaves
    # no attempt entry and would shift an index-based join. Poisoned/desync
    # restarts are the anomaly rollback path and charge to rollback_badput;
    # everything else (crash, hung, timeout, or no supervisor stream at all)
    # stays restart_badput.
    restart_rows = sorted(
        (r for r in streams["supervisor"] if r.get("event") == "restart"),
        key=lambda r: float(r.get("unix_time") or 0.0))

    def badput_key(attempt_index: int) -> str:
        if not restart_rows or attempt_index <= 0:
            return "restart_badput_s"
        start = attempts[attempt_index]["start"]
        cause = None
        for r in restart_rows:
            stamp = r.get("unix_time")
            if stamp is None or float(stamp) <= start + 1e-6:
                cause = r
        if cause is None:               # clock skew: fall back to index order
            cause = restart_rows[min(attempt_index, len(restart_rows)) - 1]
        return ("rollback_badput_s" if cause.get("reason") in ROLLBACK_REASONS
                else "restart_badput_s")

    seg = dict.fromkeys(SEGMENTS, 0.0)
    seen_epochs: set[int] = set()
    epochs_total = epochs_replayed = replayed_steps = 0
    saves = restores = 0
    restore_s = 0.0
    prev_end: float | None = None
    for i, a in enumerate(attempts):
        first = i == 0
        if not first and prev_end is not None:
            # Crash -> respawn: teardown, supervisor backoff, the new
            # process's imports — none of it happens in an unfaulted run.
            seg[badput_key(i)] += max(0.0, a["start"] - prev_end)
        if a["epochs"]:
            first_epoch = a["epochs"][0]
            init = max(0.0, (first_epoch["end"] - first_epoch["wall_s"])
                       - a["start"])
            seg["init_compile_s" if first else badput_key(i)] += init
        for e in a["epochs"]:
            epochs_total += 1
            if e["epoch"] in seen_epochs:
                # A replay: an earlier attempt already executed this epoch.
                epochs_replayed += 1
                replayed_steps += e["steps"]
                seg[badput_key(i)] += e["wall_s"]
            else:
                seg["compute_s"] += e["execute_s"] + e["eval_s"]
                seg["data_wait_s"] += e["data_s"]
            seen_epochs.add(e["epoch"])
        seg["checkpoint_stall_s"] += a["save_stall_s"]
        saves += a["saves"]
        restores += a["restores"]
        restore_s += a["restore_s"]
        prev_end = a["end"]

    accounted = sum(seg.values())
    seg["idle_s"] = max(0.0, wall_s - accounted)
    unaccounted = max(0.0, accounted - wall_s)

    restarts = sum(r.get("event") == "restart"
                   for r in streams["supervisor"])
    rollbacks = sum(r.get("reason") in ROLLBACK_REASONS
                    for r in restart_rows)
    sup_summary = next((r for r in reversed(streams["supervisor"])
                        if r.get("event") == "supervise_summary"), None)
    return {
        "wall_s": wall_s,
        "start_unix": run_start,
        "end_unix": run_end,
        "segments": seg,
        "goodput_frac": seg["compute_s"] / wall_s if wall_s else None,
        "badput_frac": ((seg["restart_badput_s"] + seg["rollback_badput_s"])
                        / wall_s if wall_s else None),
        "attempts": len(attempts),
        "restarts": restarts if streams["supervisor"] else
        max(0, len(attempts) - 1),
        "rollbacks": rollbacks,
        "supervise_status": (sup_summary or {}).get("status"),
        "epochs": epochs_total,
        "epochs_replayed": epochs_replayed,
        "replayed_steps": replayed_steps,
        "checkpoint": {"saves": saves, "restores": restores,
                       "restore_s": restore_s},
        "preempted": any(a["preempted"] for a in attempts),
        "streams": {"files": streams["files"], "events": streams["events"],
                    "spans": len(streams["spans"]),
                    "supervisor_events": len(streams["supervisor"])},
        "unaccounted_s": unaccounted,
    }


def goodput_event(report: dict) -> dict:
    """The ledger as one ``{"event": "goodput", ...}`` telemetry line — what
    a report appends next to a run's
    other events, so A-vs-B comparisons can read the decomposition back
    without re-joining the streams."""
    return {
        "event": "goodput",
        "wall_s": report["wall_s"],
        **report["segments"],
        "goodput_frac": report["goodput_frac"],
        "badput_frac": report["badput_frac"],
        "attempts": report["attempts"],
        "restarts": report["restarts"],
        "rollbacks": report.get("rollbacks", 0),
        "epochs": report["epochs"],
        "epochs_replayed": report["epochs_replayed"],
        "replayed_steps": report["replayed_steps"],
        "unaccounted_s": report["unaccounted_s"],
    }
