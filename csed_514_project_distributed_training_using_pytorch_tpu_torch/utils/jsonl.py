"""Backend-free JSONL emission and the shared percentile estimator.

The port's own copy of the JAX package's ``utils/jsonl.py`` (which imports no JAX; the
port keeps a copy so that it imports nothing of that package):

- :class:`JsonlWriter`: append-per-emit, flushed-per-line JSONL, for writers that are not
  rank-gated. Same line schema and reader as ``utils.telemetry.TelemetryWriter``.
- :func:`percentiles`: nearest-rank percentiles, the one estimator every serving summary
  and the report CLI agree on (``utils.telemetry`` re-exports it).
- :func:`read_jsonl`: the one guarded line-parse. A torn FINAL line (an append-per-emit
  writer killed mid-line) is skipped; a malformed line anywhere earlier raises (an
  append-only writer cannot produce one, so that file is corrupt, not torn).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time


def _finite(x):
    """Strict-JSONL rule (same as ``metrics.save_metrics_jsonl``): non-finite → None."""
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else None


def read_jsonl(path: str) -> list[dict]:
    """Parse a JSONL file, one dict per non-blank line, tolerating a TORN FINAL line
    (skipped) and raising on a malformed line anywhere earlier."""
    rows = []
    with open(path) as f:
        lines = [l.strip() for l in f]
    for i, line in enumerate(lines):
        if not line:
            continue
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break
            raise
    return rows


def percentiles(xs, qs=(50, 95, 99)) -> dict | None:
    """Nearest-rank percentiles of the non-None values, as ``{"p50": ..., ...}`` —
    the serving events' latency-summary convention (shared with the report CLI so
    both sides agree on the estimator). None when no values survive."""
    xs = sorted(x for x in xs if x is not None)
    if not xs:
        return None
    return {f"p{q}": _finite(xs[max(0, math.ceil(q / 100 * len(xs)) - 1)])
            for q in qs}


class JsonlWriter:
    """Append-per-emit JSONL, flushed per line — fleet-side telemetry.

    Append (never truncate): a preempted/restarted run re-runs with the same
    telemetry path later, and its event history must survive into the resumed
    run's report. ``path`` empty disables everything (emit is a no-op)."""

    def __init__(self, path: str):
        self.path = path or ""
        self._fh = None
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "a")
        self._t0 = time.time()
        # The router emits from N replica io threads plus its dispatch/monitor
        # threads concurrently; interleaved write() fragments would corrupt the
        # JSONL, so every emit is serialized.
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def emit(self, event: dict) -> None:
        event.setdefault("t_s", round(time.time() - self._t0, 6))
        line = json.dumps(event) + "\n"
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line)
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
