"""Thread-safe request admission: tenant-aware quotas, weighted-fair dequeue, shedding.

The scheduler is deliberately small — slot placement is trivial (any free slot; all
slots are identical because shapes are fixed), so the scheduling problem reduces to
the queue discipline. What used to be one blind FIFO is now a **multi-tenant**
discipline (DESIGN.md §22): every request carries a tenant and a priority class,
and the queue keeps one FIFO lane per tenant:

- **admission quotas** — each tenant may carry a token-bucket quota
  (``rate`` req/s, ``burst`` capacity); ``submit`` on an empty bucket raises the
  typed ``QuotaExceeded`` — a *policy* refusal, distinct from capacity
  backpressure, so clients can tell "you are over your contract" from "the
  system is full";
- **overload shedding** — ``submit`` on a full queue is priority-ordered instead
  of blind: an arriving request of strictly higher priority DISPLACES the
  youngest queued request of the lowest priority class below it (the victims are
  returned to the caller, which resolves their futures as ``finish="shed"``);
  an arriving request refused *because* the queue is full of strictly
  higher-priority work gets the typed ``Shed`` (the system chose the paying
  tier over it); equal-priority saturation stays plain ``QueueFull``;
- **weighted-fair + deadline-aware dequeue** — ``take`` serves the highest
  priority tier first; within a tier, tenants share dequeues in proportion to
  their configured weights (start-time fair queuing over a per-tenant virtual
  work counter — the long-run share converges to the weights, pinned by a
  property test); and ANY tenant's head whose deadline is within
  ``edf_slack_s`` jumps the whole discipline, earliest deadline first — the
  anti-starvation escape hatch that keeps a best-effort request from dying in
  queue one poll short of its deadline while a saturating high tier holds the
  floor;
- **backpressure / deadlines / drain / redispatch / observability** — unchanged
  contracts from the FIFO era: ``QueueFull`` on capacity, queued-deadline expiry
  surfaced by ``take``, ``close()`` refuses new work while accepted work drains,
  ``requeue`` re-admits an already-accepted request at the FRONT of its tenant
  lane (never quota-charged twice), and ``snapshot()`` reports depth /
  oldest-ELIGIBLE-age / per-tenant lanes. (Oldest age is computed over the
  tenant-lane heads — the candidates the dequeue rule actually chooses among —
  because under weighted-fair reordering the globally oldest *arrival* may sit
  mid-lane and is not what is starving.)

A single implicit tenant (every ``Request`` defaults to ``tenant="default"``,
priority 0, no quota) degenerates to exactly the old bounded FIFO — the
single-tenant serving path is bitwise-unchanged by construction.

This module (home of the shared ``Request``/``SamplingParams``/``TenantSpec``
types and the ``Parked`` mid-decode preemption record) is the port's own copy of
the JAX package's ``serving/scheduler.py``, which imports no JAX: it touches no
device, and its queue discipline is pinned equal to the reference's on scripted
arrival sequences (``tests/test_torch_port_server.py``). The fleet (router, replicas)
that the comments below mention is the port's ``serving/router.py`` and
``serving/replica.py``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np

from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import (
    SLOSpec,
)


class QueueFull(RuntimeError):
    """Backpressure signal: the bounded request queue is at capacity (and no
    lower-priority work was available to shed)."""


class QuotaExceeded(RuntimeError):
    """Admission refused by the TENANT's token-bucket quota — a policy
    decision, not a capacity one: the system may be idle and still refuse a
    tenant that is over its contracted rate. Distinct from ``QueueFull`` so
    clients (and the load generator's accounting) can tell the two apart."""

    def __init__(self, message: str, tenant: str = "default"):
        super().__init__(message)
        self.tenant = tenant


class Shed(RuntimeError):
    """Overload shedding: this request was refused (or, for queued victims,
    evicted) so a strictly higher-priority class could be served. The typed
    signal that the system degraded *deliberately* — best-effort traffic
    absorbs the squeeze instead of everyone timing out together."""

    def __init__(self, message: str, tenant: str = "default"):
        super().__init__(message)
        self.tenant = tenant


class QueueClosed(RuntimeError):
    """Admission refused because the queue is draining (``close()`` was called).

    Subclasses ``RuntimeError`` because that is what ``submit`` historically
    raised; the typed subclass exists for the fleet's shrink path — a replica
    told to ``drain`` closes its queue, and a submit racing that close must be
    classifiable (the replica bounces it as ``error: draining`` so the router
    requeues it elsewhere) rather than treated as a hard failure."""


class ServerStopped(TimeoutError):
    """A serving front end (``Server`` or ``Router``) was stopped before this
    request could complete: pending futures are failed with this instead of
    hanging their waiters forever. Subclasses ``TimeoutError`` because the
    drain-timeout path is where it historically surfaced."""


# --------------------------------------------------------------------- tenants


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's service class. ``weight`` is its fair share within its
    priority tier; ``priority`` its tier (higher = more important — served
    first, shed last, never preempted by a lower tier); ``rate``/``burst`` its
    token-bucket admission quota (0 = unlimited); ``max_inflight`` its
    concurrent-dispatch cap at the front door (0 = uncapped);
    ``preemptible`` marks its mid-decode slots evictable when a higher tier is
    waiting (the park/resume path — DESIGN.md §22); ``slo`` an optional
    per-tenant promise (falls back to the front end's global spec)."""

    name: str
    weight: float = 1.0
    priority: int = 0
    rate: float = 0.0
    burst: float = 0.0
    max_inflight: int = 0
    preemptible: bool = False
    slo: SLOSpec | None = None

    def validate(self) -> "TenantSpec":
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name}: weight must be > 0, "
                             f"got {self.weight}")
        if self.rate < 0 or self.burst < 0 or self.max_inflight < 0:
            raise ValueError(f"tenant {self.name}: rate/burst/max_inflight "
                             f"must be >= 0")
        return self

    def describe(self) -> dict:
        return {
            "weight": self.weight, "priority": self.priority,
            "rate": self.rate or None, "burst": self.burst or None,
            "max_inflight": self.max_inflight or None,
            "preemptible": self.preemptible,
            "slo": self.slo.describe() if self.slo else None,
        }


#: The implicit service class for requests that name no tenant (and for
#: tenants a table does not know): weight 1, priority 0, no quota, not
#: preemptible — the pre-tenancy behavior.
DEFAULT_TENANT = TenantSpec(name="default")


def parse_tenants(text: str) -> "TenantTable | None":
    """The CLI grammar: ``'paid:w=4,prio=2,cap=6,slo=ttft:0.3+e2e:2;`` ``free:
    w=1,preempt=1,rate=50,burst=100'`` — ``;`` between tenants, ``name:`` then
    ``k=v`` pairs. Keys: ``w``/``weight``, ``prio``/``priority``, ``rate``
    (req/s quota), ``burst`` (bucket size, default = max(rate, 1) when a rate
    is set), ``cap``/``max_inflight``, ``preempt`` (0/1), ``slo`` (an
    ``obs.slo.SLOSpec`` with ``:`` for ``=`` and ``+`` for ``,`` — nesting
    inside the comma-separated pair list), ``share`` (accepted and ignored
    here: the load generator's traffic-mix key rides the same string).
    Empty/``"off"`` = None (no tenancy)."""
    text = (text or "").strip()
    if not text or text == "off":
        return None
    specs = []
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        name, _, body = chunk.partition(":")
        name = name.strip()
        kw: dict = {"name": name}
        for part in body.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, value = part.partition("=")
            key = key.strip()
            if key in ("w", "weight"):
                kw["weight"] = float(value)
            elif key in ("prio", "priority"):
                kw["priority"] = int(value)
            elif key == "rate":
                kw["rate"] = float(value)
            elif key == "burst":
                kw["burst"] = float(value)
            elif key in ("cap", "max_inflight"):
                kw["max_inflight"] = int(value)
            elif key == "preempt":
                kw["preemptible"] = bool(int(value))
            elif key == "slo":
                kw["slo"] = SLOSpec.parse(
                    value.replace(":", "=").replace("+", ","))
            elif key == "share":
                pass        # the load generator's traffic-mix key, not ours
            else:
                raise ValueError(f"unknown tenant key {key!r} in {chunk!r}")
        if kw.get("rate") and not kw.get("burst"):
            kw["burst"] = max(kw["rate"], 1.0)
        specs.append(TenantSpec(**kw).validate())
    if not specs:
        return None
    return TenantTable(specs)


class TenantTable:
    """The configured tenant set. ``spec_for`` never fails: an unknown tenant
    gets the implicit default class (weight 1, priority 0, no quota) so a
    misnamed tenant degrades to best-effort-ish service instead of an error —
    the front door stays available to strangers, it just promises them
    nothing."""

    def __init__(self, specs: list[TenantSpec]):
        if not specs:
            raise ValueError("TenantTable needs at least one TenantSpec")
        self.specs: dict[str, TenantSpec] = {}
        for spec in specs:
            if spec.name in self.specs:
                raise ValueError(f"duplicate tenant {spec.name!r}")
            self.specs[spec.name] = spec.validate()

    def spec_for(self, tenant: str) -> TenantSpec:
        return self.specs.get(tenant, DEFAULT_TENANT)

    def names(self) -> list[str]:
        return list(self.specs)

    def highest_priority(self) -> str:
        """The tenant of the top tier (ties broken by declaration order) —
        the default tier an SLO-driven autoscaler watches."""
        return max(self.specs.values(), key=lambda s: s.priority).name

    def describe(self) -> dict:
        return {name: spec.describe() for name, spec in self.specs.items()}


class TokenBucket:
    """The classic admission quota: ``capacity`` tokens, refilled at ``rate``
    per second, one token per admission. Time is an argument (the caller's
    ``time.monotonic()``), so tests drive it deterministically."""

    def __init__(self, rate: float, capacity: float):
        if rate <= 0 or capacity <= 0:
            raise ValueError("rate and capacity must be > 0")
        self.rate = float(rate)
        self.capacity = float(capacity)
        self._tokens = float(capacity)
        self._last = None            # first try_take anchors the clock

    def try_take(self, now: float) -> bool:
        if self._last is None:
            self._last = now
        self._tokens = min(self.capacity,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def refund(self) -> None:
        """Return one token (capped): the admission the token was charged
        for was refused downstream (capacity/shed) — capacity backpressure
        must not ALSO burn the tenant's contracted rate, or a retry against
        a momentarily full queue converts into a spurious quota refusal."""
        self._tokens = min(self.capacity, self._tokens + 1.0)


# --------------------------------------------------------------------- requests


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode policy. ``temperature <= 0`` decodes greedily; ``top_k = 0``
    / ``top_p = 1.0`` disable those filters (``models.lm.filter_logits`` semantics,
    applied after temperature scaling in the same compose order)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def validate(self, vocab_size: int) -> None:
        if not 0 <= self.top_k <= vocab_size:
            raise ValueError(f"top_k {self.top_k} outside [0, {vocab_size}]")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p {self.top_p} outside (0, 1]")


@dataclasses.dataclass
class Request:
    """One decode request. ``prompt`` is a ``[P]`` int32 slice of the TARGETS stream
    (``generate``'s prompt convention: output positions ``0..P-1`` are forced to it,
    its K/V populating the cache); ``max_new_tokens`` bounds the sampled suffix.
    ``deadline_s``/``arrival_s`` are ``time.monotonic()`` stamps (absolute), set by
    the server front end; both optional for direct engine use. ``trace_id`` is
    the distributed-tracing correlation id (``utils/trace.py``): assigned at
    origin, propagated verbatim — None means untraced (the default; no span is
    ever emitted for it). ``tenant``/``priority``/``preemptible`` are the
    service class (stamped by the front end from its ``TenantTable``; the
    defaults are the implicit single-tenant class)."""

    prompt: np.ndarray
    max_new_tokens: int
    sampling: SamplingParams = SamplingParams()
    request_id: int = 0
    deadline_s: float | None = None
    arrival_s: float | None = None
    trace_id: str | None = None
    tenant: str = "default"
    priority: int = 0
    preemptible: bool = False


@dataclasses.dataclass
class Parked:
    """A mid-decode request evicted from its slot by priority preemption
    (``engine.park``): the emitted stream so far (prompt prefix + generated
    tokens — exactly the token key its K/V planes sit under in the prefix
    cache) plus the latency stamps that must survive the park so the final
    completion stays honest. Queues like a ``Request`` (``RequestQueue``
    reads tenant/priority/deadline through the delegating properties) and
    re-admits through ``engine.admit_many`` — resume re-installs the planes
    from the prefix cache (or re-prefills them: rows are a pure function of
    the tokens) and continues decoding token-identically under greedy."""

    request: Request
    tokens: np.ndarray              # emitted stream at park time (len == t)
    first_tok_s: float | None       # original first-token stamp (TTFT survives)
    admit_s: float                  # original slot-admission stamp
    parked_s: float                 # when the eviction happened
    parks: int = 1                  # times this request has been parked

    @property
    def tenant(self) -> str:
        return self.request.tenant

    @property
    def priority(self) -> int:
        return self.request.priority

    @property
    def request_id(self) -> int:
        return self.request.request_id

    @property
    def arrival_s(self) -> float | None:
        return self.request.arrival_s

    @property
    def deadline_s(self) -> float | None:
        return self.request.deadline_s

    @deadline_s.setter
    def deadline_s(self, value: float | None) -> None:
        self.request.deadline_s = value


class RequestQueue:
    """Pending ``Request``s shared between submitter threads and the serving
    loop: one FIFO lane per tenant, dequeued priority-tier-first and
    weighted-fair within a tier (module docstring has the full discipline).
    ``max_pending = 0`` means unbounded (no backpressure); ``tenants`` is the
    optional ``TenantTable`` that activates quotas/weights/priorities. The
    router reuses it verbatim — anything with ``arrival_s``/``deadline_s``
    attributes queues."""

    def __init__(self, max_pending: int = 0,
                 tenants: TenantTable | None = None,
                 edf_slack_s: float = 0.25):
        if max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        self.max_pending = int(max_pending)
        self.tenants = tenants
        self.edf_slack_s = float(edf_slack_s)
        self._lanes: dict[str, collections.deque] = {}
        self._vwork: dict[str, float] = {}
        self._vtime = 0.0             # high-water of charged virtual work
        self._buckets: dict[str, TokenBucket] = {}
        if tenants is not None:
            for name, spec in tenants.specs.items():
                if spec.rate:
                    self._buckets[name] = TokenBucket(spec.rate, spec.burst)
        self._cond = threading.Condition()
        self._closed = False
        self._rejected = 0
        self._quota_rejected = 0
        self._shed = 0
        self._per_tenant: dict[str, dict] = {}

    # ------------------------------------------------------------------ helpers

    def _spec(self, tenant: str) -> TenantSpec:
        return (self.tenants.spec_for(tenant) if self.tenants is not None
                else DEFAULT_TENANT)

    def _lane(self, tenant: str) -> collections.deque:
        lane = self._lanes.get(tenant)
        if lane is None:
            lane = self._lanes[tenant] = collections.deque()
            self._vwork.setdefault(tenant, 0.0)
        return lane

    def _tally(self, tenant: str, key: str, n: int = 1) -> None:
        row = self._per_tenant.setdefault(
            tenant, {"submitted": 0, "quota_rejected": 0, "shed": 0})
        row[key] += n

    def _depth_locked(self) -> int:
        return sum(len(q) for q in self._lanes.values())

    def __len__(self) -> int:
        with self._cond:
            return self._depth_locked()

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    # ------------------------------------------------------------------ submit

    def _enqueue_locked(self, request) -> None:
        tenant = getattr(request, "tenant", "default")
        lane = self._lane(tenant)
        if not lane:
            # Virtual-time catch-up: a tenant returning from idle must not
            # replay the share it never used (its stale low vwork would let
            # it monopolize the queue until it "caught up").
            self._vwork[tenant] = max(self._vwork[tenant], self._vtime)
        lane.append(request)
        self._cond.notify_all()

    def _req_priority(self, tenant: str, request) -> int:
        """THE priority of one queued request: the per-request field when the
        front end stamped one (it also carries the class across the fleet
        wire, where the replica has no table), the lane spec's otherwise."""
        p = getattr(request, "priority", None)
        return p if p is not None else self._spec(tenant).priority

    def _shed_victim_locked(self, priority: int):
        """The displacement rule: among queued requests of STRICTLY lower
        priority than ``priority``, the youngest request of the lowest tier —
        it has waited least and matters least. Scans actual requests (a
        per-request priority override must protect exactly like a tier).
        None when nothing is below the incoming class."""
        best = None                   # (priority, -arrival, lane, index)
        for tenant, lane in self._lanes.items():
            for idx, req in enumerate(lane):
                p = self._req_priority(tenant, req)
                if p >= priority:
                    continue
                arr = getattr(req, "arrival_s", None)
                key = (p, -(arr if arr is not None else float("inf")))
                if best is None or key < best[0]:
                    best = (key, lane, idx)
        if best is None:
            return None
        _, lane, idx = best
        req = lane[idx]
        del lane[idx]
        return req

    def submit(self, request) -> list:
        """Enqueue or refuse — never blocks. Raises ``QuotaExceeded`` (the
        tenant's token bucket is empty), ``QueueFull`` (capacity, nothing
        shedable below this class), ``Shed`` (capacity held by strictly
        higher-priority work), or ``QueueClosed`` after ``close()``. Returns
        the list of queued victims this admission DISPLACED (empty in the
        common case) — the caller owns resolving their futures as shed."""
        tenant = getattr(request, "tenant", "default")
        with self._cond:
            if self._closed:
                raise QueueClosed("queue is closed (server draining)")
            bucket = self._buckets.get(tenant)
            if bucket is not None and not bucket.try_take(time.monotonic()):
                self._quota_rejected += 1
                self._tally(tenant, "quota_rejected")
                raise QuotaExceeded(
                    f"tenant {tenant!r} over its admission quota", tenant)
            self._tally(tenant, "submitted")
            shed: list = []
            if self.max_pending and self._depth_locked() >= self.max_pending:
                prio = getattr(request, "priority", 0)
                victim = self._shed_victim_locked(prio)
                if victim is None:
                    self._tally(tenant, "submitted", -1)
                    if bucket is not None:
                        # A capacity refusal must not ALSO burn the quota
                        # token charged above — retries against a full
                        # queue would convert backpressure into a spurious
                        # QuotaExceeded, the two signals this module
                        # promises to keep distinct.
                        bucket.refund()
                    if any(self._req_priority(t, r) > prio
                           for t, q in self._lanes.items() for r in q):
                        # Refused to protect a strictly higher tier: the
                        # typed "you were shed" signal, not plain capacity.
                        self._shed += 1
                        self._tally(tenant, "shed")
                        raise Shed(
                            f"request queue at capacity with higher-priority "
                            f"work queued — tenant {tenant!r} shed", tenant)
                    self._rejected += 1
                    raise QueueFull(
                        f"request queue at capacity ({self.max_pending} "
                        f"pending)")
                self._shed += 1
                self._tally(getattr(victim, "tenant", "default"), "shed")
                shed.append(victim)
            self._enqueue_locked(request)
            return shed

    def requeue(self, request) -> None:
        """Re-admit an ALREADY-ACCEPTED request (or a ``Parked`` record) at
        the FRONT of its tenant lane — the redispatch/preemption-resume path.
        Deliberately ignores ``close()`` (a drain must still replay what a
        dead replica dropped), ``max_pending`` (the request was admitted once;
        counting it against capacity twice would turn a replica crash into
        load shedding), and the quota bucket (same argument)."""
        tenant = getattr(request, "tenant", "default")
        with self._cond:
            lane = self._lane(tenant)
            if not lane:
                self._vwork[tenant] = max(self._vwork[tenant], self._vtime)
            lane.appendleft(request)
            self._cond.notify_all()

    # ------------------------------------------------------------------ dequeue

    def _pick_locked(self, now: float, skip: set | None,
                     budgets: dict | None):
        """The dequeue rule, one item: (1) any lane head whose deadline is
        within ``edf_slack_s`` goes earliest-deadline-first, regardless of
        tier — the anti-starvation escape; (2) otherwise the highest priority
        tier, and within it the tenant with the least weight-normalized
        virtual work (start-time fair queuing). Returns the tenant name or
        None when nothing is eligible."""
        heads = []
        for tenant, lane in self._lanes.items():
            if not lane or (skip is not None and tenant in skip):
                continue
            if budgets is not None and budgets.get(tenant, 1) <= 0:
                continue
            heads.append((tenant, lane[0]))
        if not heads:
            return None
        urgent = [(t, r) for t, r in heads
                  if getattr(r, "deadline_s", None) is not None
                  and r.deadline_s - now <= self.edf_slack_s]
        if urgent:
            return min(urgent, key=lambda tr: tr[1].deadline_s)[0]
        # Tier of a lane = its HEAD request's priority (per-request overrides
        # and the fleet-wire fields count; the spec is the stamped default).
        return min(heads,
                   key=lambda tr: (-self._req_priority(*tr),
                                   self._vwork[tr[0]], tr[0]))[0]

    def take(self, now: float, max_n: int,
             skip_tenants: set | None = None,
             tenant_budgets: dict | None = None) -> tuple[list, list]:
        """Pop up to ``max_n`` admittable requests under the tenant
        discipline. Returns ``(admitted, expired)`` — ``expired`` are requests
        whose deadline passed while queued (they consume no slot, no decode
        step, and no fair-share charge; the caller owns rejecting them to
        their submitters). ``skip_tenants`` excludes lanes outright;
        ``tenant_budgets`` caps how many THIS call may pop per tenant (the
        in-flight/slot-cap gate: the budget decrements as the batch fills, so
        one take can never overshoot a cap that was open when it started —
        tenants absent from the dict are unbudgeted)."""
        admitted: list = []
        expired: list = []
        budgets = dict(tenant_budgets) if tenant_budgets is not None else None
        with self._cond:
            while len(admitted) < max_n:
                tenant = self._pick_locked(now, skip_tenants, budgets)
                if tenant is None:
                    break
                req = self._lanes[tenant].popleft()
                if (getattr(req, "deadline_s", None) is not None
                        and now > req.deadline_s):
                    expired.append(req)
                    continue
                admitted.append(req)
                if budgets is not None and tenant in budgets:
                    budgets[tenant] -= 1
                self._vwork[tenant] += 1.0 / self._spec(tenant).weight
                self._vtime = max(self._vtime, self._vwork[tenant])
        return admitted, expired

    # ------------------------------------------------------------------ observe

    def waiting_priorities(self, skip_tenants: set | None = None,
                           now: float | None = None) -> list[int]:
        """Every queued request's priority, descending — the server's
        preemption-pressure input (how much higher-tier work is waiting).
        ``skip_tenants`` excludes lanes that could not be served anyway (a
        tenant at its slot cap must not trigger evictions it cannot use);
        ``now`` additionally excludes requests already past their deadline
        (the next take expires them without a slot — parking a victim for
        one would be a gratuitous evict/recompute cycle)."""
        with self._cond:
            out = [p for tenant, lane in self._lanes.items()
                   if skip_tenants is None or tenant not in skip_tenants
                   for r in lane
                   if now is None or getattr(r, "deadline_s", None) is None
                   or r.deadline_s >= now
                   for p in (self._req_priority(tenant, r),)]
        return sorted(out, reverse=True)

    def tenant_depths(self) -> dict[str, int]:
        with self._cond:
            return {t: len(q) for t, q in self._lanes.items() if q}

    def snapshot(self, now: float | None = None) -> dict:
        """The queue's health/backpressure signal, as one JSON-ready dict:
        ``depth`` (queued now), ``oldest_age_s`` (how long the oldest
        ELIGIBLE head has waited — the max over tenant-lane heads, the
        candidates the dequeue rule chooses among; under weighted-fair
        reordering the globally oldest arrival may sit mid-lane and is not
        what the next dequeue can relieve), ``rejected`` (cumulative
        ``QueueFull``), ``quota_rejected``/``shed`` (the tenancy refusals),
        plus capacity, drain state, and per-tenant lanes. This is what
        ``serve_summary`` reports and what the router reads off each replica
        before dispatching more work."""
        now = time.monotonic() if now is None else now

        def age(req) -> float | None:
            arr = getattr(req, "arrival_s", None)
            return max(0.0, now - arr) if arr is not None else None

        with self._cond:
            heads = [(t, q[0]) for t, q in self._lanes.items() if q]
            ages = [a for _, h in heads if (a := age(h)) is not None]
            tenants = {}
            for t, q in self._lanes.items():
                row = dict(self._per_tenant.get(t) or {})
                row["depth"] = len(q)
                row["oldest_age_s"] = age(q[0]) if q else None
                tenants[t] = row
            for t, counters in self._per_tenant.items():
                if t not in tenants:
                    tenants[t] = {**counters, "depth": 0, "oldest_age_s": None}
            return {
                "depth": self._depth_locked(),
                "oldest_age_s": max(ages) if ages else None,
                "rejected": self._rejected,
                "quota_rejected": self._quota_rejected,
                "shed": self._shed,
                "max_pending": self.max_pending,
                "closed": self._closed,
                "tenants": tenants or None,
            }

    def force_deadline(self, deadline_s: float) -> None:
        """Clamp every queued request's deadline (the server's ``drain=False``
        shutdown: a past-dated deadline turns the drain into an expiry sweep)."""
        with self._cond:
            for lane in self._lanes.values():
                for req in lane:
                    req.deadline_s = (deadline_s if req.deadline_s is None
                                      else min(req.deadline_s, deadline_s))

    def close(self) -> None:
        """Stop accepting new requests; queued ones still drain via ``take``."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def wait_for_work(self, timeout: float) -> bool:
        """Block until the queue is non-empty or closed (the serving loop's idle
        wait); returns True if there is queued work."""
        with self._cond:
            self._cond.wait_for(
                lambda: any(self._lanes.values()) or self._closed,
                timeout=timeout)
            return any(bool(q) for q in self._lanes.values())
