"""SLO specs and attainment tracking for the serving path.

A latency percentile answers "how slow were we"; an SLO answers "did we keep
the promise". This module is the promise side: a spec names per-request
targets (TTFT, TPOT, e2e — any subset), and attainment is the fraction of
finished requests that met EVERY named target (a timed-out request never
attains — a missing latency on a request that never produced a first token is
a miss, not a free pass).

Two consumers, two shapes:

- **run-level** — ``Server``/``Router`` count met/total over the whole run and
  emit one ``{"event": "slo", ...}`` line at drain, plus the same dict inside
  ``serve_summary``/``router_summary`` (the A-vs-B surface);
- **windowed** — :class:`AttainmentTracker` also keeps a sliding window
  (``spec.window_s``) so the periodic ``fleet_snapshot`` can report RECENT
  attainment per replica and fleet-wide. That is the signal the autoscaler
  should eventually scale on (ROADMAP open item 5: attainment, not raw
  utilization — a fleet at 60% utilization that is missing its TTFT target
  needs capacity; one at 95% that is meeting it does not).

Stdlib only: the port's own copy of the JAX package's ``obs/slo.py``.
"""

from __future__ import annotations

import dataclasses
from collections import deque

#: The per-request latency fields a spec can bound, in report order.
TARGET_FIELDS = ("ttft_s", "tpot_s", "e2e_s")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-request latency targets (None = not part of the promise) plus the
    sliding-window width the snapshot-time attainment is computed over."""

    ttft_s: float | None = None
    tpot_s: float | None = None
    e2e_s: float | None = None
    window_s: float = 30.0

    def __post_init__(self):
        if all(getattr(self, f) is None for f in TARGET_FIELDS):
            raise ValueError("SLOSpec needs at least one of "
                             f"{'/'.join(TARGET_FIELDS)} set")
        if self.window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s}")

    @classmethod
    def parse(cls, text: str) -> "SLOSpec | None":
        """The CLI surface: ``"ttft=0.5,e2e=2.0,window=30"`` (keys are the
        target fields minus ``_s``, plus ``window``). Empty/``"off"`` = None —
        serving without a promise is the default."""
        text = (text or "").strip()
        if not text or text == "off":
            return None
        kw: dict = {}
        for part in text.split(","):
            key, _, value = part.partition("=")
            key = key.strip()
            field = "window_s" if key == "window" else f"{key}_s"
            if field not in TARGET_FIELDS + ("window_s",):
                raise ValueError(f"unknown SLO field {key!r} in {text!r}")
            kw[field] = float(value)
        return cls(**kw)

    def describe(self) -> dict:
        """The spec as it appears inside slo events/summaries."""
        return {f: getattr(self, f) for f in TARGET_FIELDS} | {
            "window_s": self.window_s}

    def meets(self, *, ok: bool = True, ttft_s: float | None = None,
              tpot_s: float | None = None, e2e_s: float | None = None) -> bool:
        """Did one finished request keep the promise? Every NAMED target must
        be measured and under target; an unnamed target is ignored. A request
        that did not finish ok (timeout, error) never attains."""
        if not ok:
            return False
        measured = {"ttft_s": ttft_s, "tpot_s": tpot_s, "e2e_s": e2e_s}
        for field in TARGET_FIELDS:
            target = getattr(self, field)
            if target is None:
                continue
            value = measured[field]
            if value is None or value > target:
                return False
        return True


class AttainmentTracker:
    """Run-level and sliding-window attainment for one spec.

    ``observe`` takes the completion's latencies plus ``now`` (the caller's
    ``time.monotonic()`` — the serving path's one clock); ``attainment()`` is
    the run-level fraction, ``window()`` the recent-window view the
    ``fleet_snapshot`` timeline reports. Not thread-safe on its own: the
    router already serializes completion recording under its lock, the server
    resolves from its single loop thread."""

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.requests = 0
        self.met = 0
        self._recent: deque[tuple[float, bool]] = deque()

    def observe(self, now: float, *, ok: bool = True,
                ttft_s: float | None = None, tpot_s: float | None = None,
                e2e_s: float | None = None) -> bool:
        hit = self.spec.meets(ok=ok, ttft_s=ttft_s, tpot_s=tpot_s,
                              e2e_s=e2e_s)
        self.requests += 1
        self.met += hit
        self._recent.append((now, hit))
        self._evict(now)
        return hit

    def _evict(self, now: float) -> None:
        horizon = now - self.spec.window_s
        while self._recent and self._recent[0][0] < horizon:
            self._recent.popleft()

    def attainment(self) -> float | None:
        """Run-level: met / finished, None before the first completion."""
        return self.met / self.requests if self.requests else None

    def window(self, now: float) -> dict:
        """The sliding-window view: ``{"attainment", "requests"}`` over the
        last ``window_s`` seconds (attainment None when the window is empty —
        an idle replica has no recent promise to have kept or broken)."""
        self._evict(now)
        n = len(self._recent)
        met = sum(hit for _, hit in self._recent)
        return {"attainment": met / n if n else None, "requests": n}

    def summary(self) -> dict:
        """The run-level dict embedded in serve_summary/router_summary."""
        return {
            "spec": self.spec.describe(),
            "requests": self.requests,
            "met": self.met,
            "attainment": self.attainment(),
        }


def slo_event(tracker: AttainmentTracker, *, source: str,
              window: dict | None = None) -> dict:
    """The drain-time (or snapshot-time) ``slo`` telemetry line: the spec,
    run-level attainment, and optionally the current window view. ``source``
    names the emitter (``"server"``, ``"router"``) — one run can carry both,
    and the report must not conflate the replica-local promise with the
    client-facing one."""
    ev = {"event": "slo", "source": source, **tracker.summary()}
    if window is not None:
        ev["window"] = window
    return ev
