"""Fleet autoscaling policy: hysteresis over the ``fleet_snapshot`` load signal.

The port's own copy of the JAX package's ``serving/autoscaler.py`` (which imports no JAX),
with its thresholds, streaks, cooldown and audit trail, so one sequence of snapshots gives
one list of decisions in both packages. The router's periodic ``fleet_snapshot`` event
(queue depth / oldest-age, per-replica occupancy and prefill backlog, fleet utilization)
is the input; this module is the decision function that consumes it, split from the
router so the policy is a pure, process-free object the tests drive with synthetic
snapshots:

- **scale up** when the fleet is *sustainedly* overloaded: work is queued AND
  (the queue head has waited longer than ``up_queue_age_s``, or utilization —
  in-flight over ready capacity — is at/above ``up_utilization``) for
  ``sustain_up`` consecutive snapshots;
- **scale down** when the fleet is *sustainedly* idle: the queue is empty AND
  utilization is at/below ``down_utilization`` for ``sustain_down`` consecutive
  snapshots;
- **SLO attainment**: with ``slo_floor`` set, a windowed attainment BELOW the floor —
  fleet-wide, or the named ``slo_tenant``'s own window from the snapshot's
  ``tenants`` section — counts as overloaded even when utilization looks fine
  (a fleet at 60% that is missing its TTFT target needs capacity), and a
  shrink is REFUSED while attainment sags (capacity may only leave when the
  promise is being kept; an empty window — no recent traffic — is no promise
  broken and does not block it). ``slo_min_requests`` guards the window
  against deciding off one request's noise;
- **hysteresis** is the sustain counters (one hot snapshot must not flap the
  fleet) plus a ``cooldown_s`` dead time after every action (a just-spawned
  replica needs a few intervals to absorb load before the signal is trusted
  again — without it, the queue built up during a cold start reads as "still
  overloaded, add another").

Bounds ride the policy (``min_replicas``/``max_replicas``); the router's
``target`` field in the snapshot is the desired replica count the decision is
checked against, so an in-flight spawn (``starting``/``warming``, not yet
``ready``) already counts toward the cap — the policy never stacks spawns.

**Degraded replicas** (straggler ejection) need no special casing here BY
CONSTRUCTION: the snapshot's ``utilization`` denominator and ``replicas_ready``
count cover ``ready`` replicas only, so an ejected replica reads as missing
capacity, not as idle capacity — a fleet squeezed by a straggler sees its
utilization RISE on the survivors and scales up on the same signal as any other
load spike; the ``replicas_degraded`` field is for dashboards, not for the
decision function.

The actuators — ``Router.scale_up()`` (spawn + prefix-cache warm-start) and
``Router.scale_down()`` (graceful drain-to-retire) — live in ``serving/router.py``.
This module is stdlib only: it imports no ``torch`` and touches no device.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Thresholds for :class:`FleetAutoscaler`. All times in seconds; sustain
    counts are CONSECUTIVE snapshots (so the effective reaction time is
    ``sustain * snapshot_interval_s``, the knob the router owns)."""

    min_replicas: int = 1
    max_replicas: int = 4
    up_queue_age_s: float = 0.5       # queue head older than this = overloaded
    up_utilization: float = 0.95      # in-flight / ready capacity
    down_utilization: float = 0.25
    sustain_up: int = 2
    sustain_down: int = 4
    cooldown_s: float = 3.0
    # The SLO-attainment objective: None = utilization/queue-age only (the
    # legacy policy). With a floor, windowed attainment below it is
    # "overloaded" and blocks every shrink; ``slo_tenant`` watches one
    # tenant's window (the high tier) instead of the fleet-wide one.
    slo_floor: float | None = None
    slo_tenant: str | None = None
    slo_min_requests: int = 5

    def validate(self) -> "AutoscalePolicy":
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")
        if self.sustain_up < 1 or self.sustain_down < 1:
            raise ValueError("sustain_up/sustain_down must be >= 1")
        if not 0.0 <= self.down_utilization < self.up_utilization:
            raise ValueError(
                f"need 0 <= down_utilization < up_utilization, got "
                f"{self.down_utilization} vs {self.up_utilization}")
        if self.slo_floor is not None and not 0.0 < self.slo_floor <= 1.0:
            raise ValueError(
                f"slo_floor must be in (0, 1], got {self.slo_floor}")
        if self.slo_min_requests < 1:
            raise ValueError("slo_min_requests must be >= 1")
        return self


class FleetAutoscaler:
    """Stateful hysteresis over a stream of ``fleet_snapshot`` dicts.

    ``observe(snapshot, now)`` returns ``"up"``, ``"down"``, or ``None`` —
    the router acts on the verdict; this object only decides. Counters reset
    whenever the condition breaks (sustain means CONSECUTIVE), and a verdict
    starts the cooldown window during which every observation returns None
    (the streaks keep accumulating underneath, so a still-hot fleet acts again
    the moment the cooldown expires)."""

    def __init__(self, policy: AutoscalePolicy):
        self.policy = policy.validate()
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_s: float | None = None
        self.decisions: list[dict] = []   # small audit trail (tests, summary)

    def _attainment(self, snapshot: dict) -> float | None:
        """The windowed attainment the policy watches: the named tenant's
        window (from the snapshot's per-tenant section) or the fleet-wide one.
        None when no floor is set, the window is empty, or it holds fewer than
        ``slo_min_requests`` completions (too noisy to act on)."""
        if self.policy.slo_floor is None:
            return None
        if self.policy.slo_tenant is not None:
            row = (snapshot.get("tenants") or {}).get(self.policy.slo_tenant)
            win = (row or {}).get("slo")
        else:
            win = snapshot.get("slo")
        if not win or (win.get("requests") or 0) < self.policy.slo_min_requests:
            return None
        return win.get("attainment")

    def _classify(self, snapshot: dict) -> str | None:
        q = snapshot.get("queue") or {}
        depth = q.get("depth") or 0
        age = q.get("oldest_age_s") or 0.0
        util = snapshot.get("utilization")
        att = self._attainment(snapshot)
        sagging = att is not None and att < self.policy.slo_floor
        if sagging:
            # The promise is being missed: that IS overload, whatever
            # utilization says (queue age catches saturation; attainment
            # catches a fleet meeting its queue but missing its latency).
            return "overloaded"
        if depth > 0 and (age >= self.policy.up_queue_age_s
                          or (util is not None
                              and util >= self.policy.up_utilization)):
            return "overloaded"
        # util None means no ready capacity at all (everything starting or
        # mid-restart) — not an idle fleet; never shrink on it. With an SLO
        # floor, idleness additionally requires the promise to HOLD (att
        # None — an empty window — is no promise broken and does not block).
        if depth == 0 and util is not None \
                and util <= self.policy.down_utilization:
            return "idle"
        return None

    def observe(self, snapshot: dict, now: float) -> str | None:
        """Fold one snapshot in; return the scale verdict (or None)."""
        state = self._classify(snapshot)
        self._up_streak = self._up_streak + 1 if state == "overloaded" else 0
        self._down_streak = self._down_streak + 1 if state == "idle" else 0
        if (self._last_action_s is not None
                and now - self._last_action_s < self.policy.cooldown_s):
            return None
        # Bounds check against the router's TARGET (desired count), not the
        # ready count: a spawn still compiling must block the next one.
        target = snapshot.get("target")
        if target is None:
            target = snapshot.get("replicas_ready") or 0
        verdict = None
        if (self._up_streak >= self.policy.sustain_up
                and target < self.policy.max_replicas):
            verdict = "up"
        elif (self._down_streak >= self.policy.sustain_down
              and target > self.policy.min_replicas):
            verdict = "down"
        if verdict is not None:
            self._last_action_s = now
            self._up_streak = 0
            self._down_streak = 0
            self.decisions.append({
                "verdict": verdict, "target": target,
                "queue_depth": (snapshot.get("queue") or {}).get("depth"),
                "utilization": snapshot.get("utilization"),
                "slo_attainment": self._attainment(snapshot),
            })
        return verdict
