"""Mergeable log-bucket streaming histograms with a fixed relative-error bound.

The serving summaries used to keep every request's TTFT/TPOT/e2e/queue-wait as
a float list so the drain-time percentiles could use the repo's one estimator,
nearest-rank (``utils.jsonl.percentiles``). That is O(requests) memory per
series per process — fine for a bench run, wrong for a long-lived server. This
module is the bounded replacement: a DDSketch-style histogram whose buckets are
geometric in the value, so

- a quantile estimate is within a CONFIGURED relative error ``rel_err`` of the
  exact nearest-rank answer (the bucket containing the q-th value spans
  ``[gamma^(i-1), gamma^i]`` with ``gamma = (1+rel_err)/(1-rel_err)``; the
  reported midpoint ``2*gamma^i/(gamma+1)`` is within ``rel_err`` of every
  value in the bucket);
- memory is O(buckets), independent of the request count — for latencies
  between 10 microseconds and 1 hour at 1% relative error that is ~1000
  int-keyed counts, and in practice a serving run touches a few dozen;
- two histograms MERGE by adding bucket counts — replicas can sketch locally
  and ship the sketch to the router (it rides the stats protocol as plain
  JSON), and the merged quantiles carry the same error bound as if one
  process had seen every sample.

Nearest-rank over the raw series stays the ORACLE estimator: tests pin this
sketch against it within ``rel_err``, and anything that still has the full
series (the report CLI reading per-request events) keeps using it.

Zeros and negatives: latencies are nonnegative, but a clock hiccup can produce
0.0 (and upstream code sometimes clamps); zeros get a dedicated count (exact,
not bucketed). Negative values raise — a negative latency is a bug to surface,
not data to sketch. None values are skipped, matching ``percentiles``.

Stdlib only: the port's own copy of the JAX package's ``obs/hist.py``
(its sketches serialize to the same JSON, so the two packages' histograms merge).
"""

from __future__ import annotations

import math


class LogHistogram:
    """A streaming histogram over nonnegative floats with relative-error
    quantiles, ``O(buckets)`` memory, and loss-free merge.

    ``rel_err`` is the guarantee: ``|estimate - exact| <= rel_err * exact``
    for any quantile of the values added (exact = the nearest-rank answer
    over the same multiset). JSON round-trip: :meth:`to_json` emits a plain
    dict (string bucket keys — JSON objects cannot key on ints), and
    :meth:`from_json` restores it; merge accepts either a ``LogHistogram``
    or such a dict, so a sketch can cross a process boundary as JSON and be
    merged without reconstruction.
    """

    def __init__(self, rel_err: float = 0.01):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.rel_err = float(rel_err)
        self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self._gamma)
        self._buckets: dict[int, int] = {}
        self._zeros = 0
        self._count = 0
        self._sum = 0.0
        self._min: float | None = None
        self._max: float | None = None

    # ------------------------------------------------------------------ write

    def add(self, x: float | None) -> None:
        """Record one value. None is skipped (the ``percentiles`` convention:
        an unmeasured latency contributes nothing, not a zero)."""
        if x is None:
            return
        x = float(x)
        if math.isnan(x):
            return
        if x < 0.0:
            raise ValueError(f"LogHistogram holds nonnegative values, got {x}")
        self._count += 1
        self._sum += x
        self._min = x if self._min is None else min(self._min, x)
        self._max = x if self._max is None else max(self._max, x)
        if x == 0.0:
            self._zeros += 1
            return
        idx = math.ceil(math.log(x) / self._log_gamma)
        self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def extend(self, xs) -> None:
        for x in xs:
            self.add(x)

    def merge(self, other: "LogHistogram | dict") -> "LogHistogram":
        """Fold ``other`` (a histogram or its :meth:`to_json` dict) into this
        one, in place. Gammas must match — merging sketches built at different
        error bounds would silently void the guarantee."""
        if isinstance(other, dict):
            other = LogHistogram.from_json(other)
        if abs(other.rel_err - self.rel_err) > 1e-12:
            raise ValueError(
                f"cannot merge histograms with different rel_err "
                f"({self.rel_err} vs {other.rel_err})")
        for idx, n in other._buckets.items():
            self._buckets[idx] = self._buckets.get(idx, 0) + n
        self._zeros += other._zeros
        self._count += other._count
        self._sum += other._sum
        for attr in ("_min", "_max"):
            a, b = getattr(self, attr), getattr(other, attr)
            if b is not None:
                red = min if attr == "_min" else max
                setattr(self, attr, b if a is None else red(a, b))
        return self

    # ------------------------------------------------------------------- read

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float | None:
        return self._sum / self._count if self._count else None

    @property
    def min(self) -> float | None:
        return self._min

    @property
    def max(self) -> float | None:
        return self._max

    @property
    def num_buckets(self) -> int:
        return len(self._buckets) + (1 if self._zeros else 0)

    def quantile(self, q: float) -> float | None:
        """The q-th percentile (``q`` in [0, 100]), nearest-rank semantics:
        the value whose rank is ``ceil(q/100 * count)`` — the same rank rule
        as ``utils.jsonl.percentiles``, so the two estimators disagree only
        by the bucket rounding the ``rel_err`` bound covers. None when empty.

        The estimate for a bucket ``i`` (covering ``(gamma^(i-1), gamma^i]``)
        is ``2*gamma^i / (gamma + 1)``: the value equidistant (in relative
        terms) from both bucket edges, which is what makes the bound
        symmetric: ``estimate/(1+rel_err) <= true <= estimate/(1-rel_err)``.
        The min/max are tracked exactly, so q=0/q=100 are exact and every
        estimate is clamped into ``[min, max]`` (the clamp can only shrink
        the error)."""
        if self._count == 0:
            return None
        rank = max(1, math.ceil(q / 100.0 * self._count))
        if rank <= self._zeros:
            return 0.0
        seen = self._zeros
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= rank:
                est = 2.0 * self._gamma ** idx / (self._gamma + 1.0)
                return min(max(est, self._min), self._max)
        return self._max          # float drift fallback: the top bucket

    def percentiles(self, qs=(50, 95, 99)) -> dict | None:
        """The serving-summary shape: ``{"p50": ..., "p95": ..., "p99": ...}``
        (None when the histogram is empty) — drop-in for
        ``utils.jsonl.percentiles`` on a sketched series."""
        if self._count == 0:
            return None
        return {f"p{q}": self.quantile(q) for q in qs}

    # ------------------------------------------------------------------- json

    def to_json(self) -> dict:
        """A plain-JSON snapshot (string bucket keys). Small by construction:
        one entry per occupied bucket."""
        return {
            "rel_err": self.rel_err,
            "count": self._count,
            "zeros": self._zeros,
            "sum": self._sum,
            "min": self._min,
            "max": self._max,
            "buckets": {str(i): n for i, n in sorted(self._buckets.items())},
        }

    @classmethod
    def from_json(cls, doc: dict) -> "LogHistogram":
        h = cls(rel_err=float(doc["rel_err"]))
        h._count = int(doc.get("count") or 0)
        h._zeros = int(doc.get("zeros") or 0)
        h._sum = float(doc.get("sum") or 0.0)
        h._min = None if doc.get("min") is None else float(doc["min"])
        h._max = None if doc.get("max") is None else float(doc["max"])
        h._buckets = {int(i): int(n)
                      for i, n in (doc.get("buckets") or {}).items()}
        return h

    def __len__(self) -> int:
        return self._count

    def __repr__(self) -> str:
        return (f"LogHistogram(rel_err={self.rel_err}, count={self._count}, "
                f"buckets={self.num_buckets})")


class WindowedLogHistogram:
    """Sliding-window quantiles over a latency stream, sketch-backed.

    The gray-failure detectors (straggler ejection, the hedge deadline —
    DESIGN.md §23) need *recent* dispatch-latency quantiles: a replica that
    was slow ten minutes ago and recovered must not read as a straggler now.
    This is the classic two-pane rotation: samples land in the CURRENT
    :class:`LogHistogram` pane; every ``window_s`` the panes rotate (current
    becomes previous, previous is dropped). A query merges both panes, so the
    answer always covers between one and two windows of history — bounded
    staleness with O(buckets) memory and no per-sample ring buffer, the same
    tradeoff the attainment tracker makes with its time-bucketed window.

    Not thread-safe by itself; the router calls it under its own lock.
    """

    def __init__(self, rel_err: float = 0.01, window_s: float = 30.0):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.rel_err = float(rel_err)
        self.window_s = float(window_s)
        self._cur = LogHistogram(rel_err)
        self._prev: LogHistogram | None = None
        self._cur_start: float | None = None

    def _rotate(self, now: float) -> None:
        if self._cur_start is None:
            self._cur_start = now
            return
        # Catch up over long idle gaps: more than two windows of silence
        # leaves NO recent evidence — both panes drop.
        while now - self._cur_start >= self.window_s:
            self._prev = self._cur if now - self._cur_start < 2 * self.window_s \
                else None
            self._cur = LogHistogram(self.rel_err)
            self._cur_start += self.window_s

    def add(self, x: float | None, now: float) -> None:
        self._rotate(now)
        self._cur.add(x)

    def count(self, now: float) -> int:
        self._rotate(now)
        return self._cur.count + (self._prev.count if self._prev else 0)

    def quantile(self, q: float, now: float) -> float | None:
        """The q-th percentile over the last one-to-two windows (None when
        empty) — merge is bucket addition, so the estimate keeps the panes'
        ``rel_err`` bound."""
        self._rotate(now)
        if self._prev is None or self._prev.count == 0:
            return self._cur.quantile(q)
        merged = LogHistogram(self.rel_err)
        merged.merge(self._cur)
        merged.merge(self._prev)
        return merged.quantile(q)

    def reset(self) -> None:
        """Drop all history — the post-probe fresh start: a recovered
        replica's score must come from post-recovery evidence only."""
        self._cur = LogHistogram(self.rel_err)
        self._prev = None
        self._cur_start = None
