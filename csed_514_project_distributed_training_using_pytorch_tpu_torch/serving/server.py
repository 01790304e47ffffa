"""In-process serving front end: thread-safe ``submit() -> Future`` over the engine.

Counterpart of the JAX package's ``serving/server.py``. One background thread owns the
engine (single writer: no locking inside the decode loop), and the engine stays on its
device: the loop thread makes the engine's CUDA device current before its first step.
Submitter threads touch only the request queue and their futures. The loop:

1. resolve requests that expired while queued (``RequestQueue.take``) and in-flight
   requests past their deadline (``engine.expire``) with ``finish="timeout"``;
2. park preemptible lower-priority slots when higher-priority work waits and no slot is
   free (``_maybe_preempt``; the parked record requeues at the front of its lane);
3. admit queued requests into free slots under the tenants' slot caps, one batched
   prompt transfer; the paged engine's typed ``KVPagesExhausted`` requeues the refused;
4. run one engine step when any slot is live (budgeted prefill chunks, then the decode
   step), else wait on the queue;
5. on ``stop()`` (graceful drain) the queue closes — new ``submit``s fail fast — while
   everything already accepted decodes to completion, then the loop exits.

The in-process summaries are the server's output: ``latency_histograms`` (TTFT, TPOT,
e2e and queue-wait sketches, ``obs.hist.LogHistogram``), ``slo_summary`` (attainment
against the run's ``SLOSpec``) and ``tenant_summaries`` (per-tenant counts, percentiles
and attainment). ``telemetry`` (a path, or a ``utils.telemetry.TelemetryWriter``) writes
the JAX package's serving stream (stream mode, rank 0): ``manifest`` and ``serve_config``
at start, one ``serve`` event a request, ``shed`` events at submit, ``prefill`` and
``spec`` events after each step, and at drain ``kv_pages`` (paged engines), ``slo`` (with
a spec), one ``tenant_summary`` a tenant and the ``serve_summary``. ``trace`` (a span JSONL
path, or a ``utils.trace.Tracer``) turns distributed tracing on: the engine emits its
``queue_wait``/``prefill``/``decode`` (and spec, park) spans, the server the ``resolve``
span, and ``submit`` gives a request that arrives without a ``trace_id`` a new one (this
server is then the trace's origin).

On a serve mesh the server runs on rank 0 over a ``serving.shard.MeshLeader``, whose
calls the other ranks replay (``serving.shard.follow``).
"""

from __future__ import annotations

import concurrent.futures
import threading
import time

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.hist import (
    LogHistogram,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import (
    AttainmentTracker,
    SLOSpec,
    slo_event,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.engine import (
    Completion,
    ContinuousBatchingEngine,
    KVPagesExhausted,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
    Parked,
    QuotaExceeded,
    Request,
    RequestQueue,
    SamplingParams,
    ServerStopped,
    Shed,
    TenantTable,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import telemetry as T
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.trace import (
    Tracer,
    new_trace_id,
)

_SERIES = ("ttft_s", "tpot_s", "e2e_s", "queue_wait_s")


class Server:
    """Continuous-batching serving loop around a ``ContinuousBatchingEngine``.

    ``default_timeout_s`` applies to requests submitted without an explicit
    ``timeout_s``; ``slo`` declares a run-level promise; ``tenants`` activates the
    tenant discipline (quotas and weighted-fair, priority dequeue in the queue, slot caps
    and priority preemption in the loop). ``telemetry`` is a JSONL path (a stream-mode
    ``TelemetryWriter`` is made) or a writer; ``trace`` a span JSONL path or a ``Tracer``."""

    def __init__(self, engine: ContinuousBatchingEngine, *, max_pending: int = 0,
                 default_timeout_s: float | None = None,
                 telemetry: str | T.TelemetryWriter | None = None,
                 trace: str | Tracer | None = None,
                 slo: SLOSpec | None = None,
                 tenants: TenantTable | None = None,
                 hist_rel_err: float = 0.01,
                 idle_wait_s: float = 0.05):
        self.engine = engine
        self.tracer = (trace if isinstance(trace, Tracer)
                       else Tracer(trace or "", proc="server"))
        if self.tracer.enabled:
            engine.tracer = self.tracer
        self.tenants = tenants
        self.queue = RequestQueue(max_pending, tenants=tenants)
        self._default_timeout_s = default_timeout_s
        self._writer = (telemetry if isinstance(telemetry, T.TelemetryWriter)
                        else T.TelemetryWriter(telemetry, stream=True))
        self._started_s: float | None = None
        self._counts = {"requests": 0, "ok": 0, "timeout": 0, "shed": 0, "new_tokens": 0}
        self._idle_wait_s = idle_wait_s
        self._futures: dict[int, concurrent.futures.Future] = {}
        self._futures_lock = threading.Lock()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._abort = False           # stop(drain=False): loop-owned expiry sweep
        self._error: BaseException | None = None
        # Running aggregates only: a long-lived server keeps no per-request Completion.
        self._hist_rel_err = float(hist_rel_err)
        self._series = {name: LogHistogram(hist_rel_err) for name in _SERIES}
        self._slo_spec = slo
        self._slo = AttainmentTracker(slo) if slo is not None else None
        self._tenant_stats: dict[str, dict] = {}
        self._tenant_series: dict[str, dict[str, LogHistogram]] = {}
        self._slo_by_tenant: dict[str, AttainmentTracker] = {}
        # Shed victims resolve on the submitter's thread, completions on the loop's: both
        # sides of the aggregates take this lock.
        self._series_lock = threading.Lock()

    # ------------------------------------------------------------------ lifecycle

    def start(self) -> "Server":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._started_s = time.monotonic()
        eng = self.engine
        self._writer.emit(T.manifest_event(run_type="serve", device=eng.device))
        self._writer.emit({
            "event": "serve_config",
            "num_slots": eng.num_slots,
            "seq_len": eng.model.seq_len,
            "vocab_size": eng.model.vocab_size,
            "max_pending": self.queue.max_pending,
            "default_timeout_s": self._default_timeout_s,
            "prefill_chunk_sizes": list(eng.prefill_chunk_sizes),
            "prefill_chunk_budget": eng.prefill_chunk_budget,
            "prefix_cache_entries": eng.prefix_cache.capacity if eng.prefix_cache else 0,
            "kv_dtype": eng.quant.kv_dtype,
            "quant_policy": eng.quant.weights,
            "spec": eng.spec,
            "spec_k": eng.spec_k if eng.drafter is not None else None,
            "slo": self._slo.spec.describe() if self._slo else None,
            "tenants": self.tenants.describe() if self.tenants else None,
        })
        self._thread = threading.Thread(target=self._loop, daemon=True, name="serve-loop")
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float | None = None) -> None:
        """Graceful shutdown: refuse new requests, then (``drain=True``) decode everything
        already accepted to completion before the loop exits. ``drain=False`` expires all
        queued and in-flight requests at the next loop pass (their futures resolve as
        timeouts, with partial tokens).

        A drain that outlives ``timeout`` raises ``ServerStopped``, after failing every
        still-pending future with it, so no caller hangs on ``Future.result()``."""
        if not drain:
            self._abort = True        # the loop thread, which owns the engine, sweeps
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                err = ServerStopped(f"serving loop did not drain within {timeout}s; "
                                    f"pending requests failed with ServerStopped")
                with self._futures_lock:
                    futures = list(self._futures.values())
                    self._futures.clear()
                for fut in futures:
                    try:
                        if not fut.done():
                            fut.set_exception(err)
                    except concurrent.futures.InvalidStateError:
                        pass              # the caller cancelled between check and set
                # Past-date everything in flight so the loop exits after one more pass;
                # a loop wedged inside a device call stays a daemon thread.
                self._abort = True
                self._thread.join(timeout=10.0)
                if not self._thread.is_alive():
                    self._thread = None
                raise err
            self._thread = None
        if self._error is not None:
            raise RuntimeError("serving loop died") from self._error

    def __enter__(self) -> "Server":
        return self.start() if self._thread is None else self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ submit

    def submit(self, prompt, *, max_new_tokens: int,
               sampling: SamplingParams = SamplingParams(),
               timeout_s: float | None = None,
               trace_id: str | None = None,
               tenant: str = "default",
               priority: int | None = None,
               preemptible: bool | None = None,
               traced: bool = True) -> concurrent.futures.Future:
        """Thread-safe enqueue. Returns a Future resolving to a ``Completion``
        (``finish`` tells ok from timeout/shed). Raises ``QueueFull`` (backpressure),
        ``QuotaExceeded`` (the tenant's admission quota), ``Shed`` (the queue is full of
        strictly higher-priority work) or ``ValueError`` (admission control) at once, in
        the caller's thread. ``tenant`` names the service class: priority and
        preemptibility default to the tenant table's spec; an admission may displace
        queued lower-priority requests, whose futures resolve ``finish="shed"``.
        ``trace_id`` joins the request to an existing trace; with tracing on and no id
        given, this submit is the trace's origin and assigns one (``traced=False`` opts
        out: a replica's warm replay is set-up, not a request)."""
        now = time.monotonic()
        timeout_s = self._default_timeout_s if timeout_s is None else timeout_s
        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
        if trace_id is None and traced and self.tracer.enabled:
            trace_id = new_trace_id()
        spec = self.tenants.spec_for(tenant) if self.tenants is not None else None
        req = Request(
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens), sampling=sampling, request_id=rid,
            arrival_s=now, deadline_s=None if timeout_s is None else now + timeout_s,
            trace_id=trace_id, tenant=tenant,
            priority=(priority if priority is not None else spec.priority if spec else 0),
            preemptible=(preemptible if preemptible is not None
                         else spec.preemptible if spec else False))
        self.engine.validate(req)                # fail fast, before queueing
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._futures_lock:
            self._futures[rid] = fut
        try:
            shed = self.queue.submit(req)
        except BaseException as e:
            with self._futures_lock:
                self._futures.pop(rid, None)
            if isinstance(e, (Shed, QuotaExceeded)):
                self._writer.emit(T.shed_event(
                    tenant=tenant, reason="refused" if isinstance(e, Shed) else "quota",
                    request_id=rid, priority=req.priority))
            raise
        for victim in shed:
            # A queued lower-priority request was displaced to admit this one.
            self._writer.emit(T.shed_event(
                tenant=getattr(victim, "tenant", "default"), reason="displaced",
                request_id=victim.request_id, priority=getattr(victim, "priority", 0)))
            self._resolve(self._rejected_completion(victim, now, finish="shed"))
        return fut

    # ------------------------------------------------------------------ loop

    def _resolve(self, comp: Completion) -> None:
        t0 = time.monotonic()
        tenant = comp.request.tenant
        with self._series_lock:
            self._counts["requests"] += 1
            self._counts["ok"] += comp.ok
            self._counts["timeout"] += comp.finish == "timeout"
            self._counts["shed"] += comp.finish == "shed"
            self._counts["new_tokens"] += comp.new_tokens
            for name in _SERIES:
                self._series[name].add(getattr(comp, name))
            now = time.monotonic()
            if self._slo is not None:
                self._slo.observe(now, ok=comp.ok, ttft_s=comp.ttft_s, tpot_s=comp.tpot_s,
                                  e2e_s=comp.e2e_s)
            row = self._tenant_stats.setdefault(
                tenant, {"requests": 0, "ok": 0, "timeout": 0, "shed": 0,
                         "new_tokens": 0, "preemptions": 0})
            row["requests"] += 1
            row["ok"] += comp.ok
            row["timeout"] += comp.finish == "timeout"
            row["shed"] += comp.finish == "shed"
            row["new_tokens"] += comp.new_tokens
            row["preemptions"] += comp.preemptions
            series = self._tenant_series.setdefault(tenant, {
                "ttft_s": LogHistogram(self._hist_rel_err),
                "e2e_s": LogHistogram(self._hist_rel_err)})
            series["ttft_s"].add(comp.ttft_s)
            series["e2e_s"].add(comp.e2e_s)
            spec = (self.tenants.spec_for(tenant).slo
                    if self.tenants is not None else None) or self._slo_spec
            if spec is not None:
                tracker = self._slo_by_tenant.get(tenant)
                if tracker is None:
                    tracker = self._slo_by_tenant[tenant] = AttainmentTracker(spec)
                tracker.observe(now, ok=comp.ok, ttft_s=comp.ttft_s, tpot_s=comp.tpot_s,
                                e2e_s=comp.e2e_s)
        self._writer.emit(T.serve_event(
            request_id=comp.request.request_id, prompt_len=comp.prompt_len,
            new_tokens=comp.new_tokens, finish=comp.finish,
            queue_wait_s=comp.queue_wait_s, ttft_s=comp.ttft_s, tpot_s=comp.tpot_s,
            e2e_s=comp.e2e_s, tenant=tenant, preemptions=comp.preemptions))
        with self._futures_lock:
            fut = self._futures.pop(comp.request.request_id, None)
        if fut is not None:
            try:
                fut.set_result(comp)
            except concurrent.futures.InvalidStateError:
                pass                      # the caller cancelled: must not kill the loop
        self.tracer.span("resolve", comp.request.trace_id, t0, time.monotonic(),
                         request_id=comp.request.request_id, finish=comp.finish,
                         new_tokens=comp.new_tokens)

    @staticmethod
    def _rejected_completion(item, now: float, *, finish: str) -> Completion:
        """The completion of a request settled without a slot: a queued expiry
        (``"timeout"``) or a shed victim (``"shed"``). A displaced ``Parked`` record keeps
        its partial stream."""
        parked = item if isinstance(item, Parked) else None
        req = parked.request if parked is not None else item
        tokens = (np.asarray(parked.tokens, np.int32) if parked is not None
                  else np.zeros((0,), np.int32))
        plen = len(req.prompt)
        return Completion(
            request=req, tokens=tokens, finish=finish, prompt_len=plen,
            new_tokens=max(len(tokens) - plen, 0),
            ttft_s=(None if parked is None or parked.first_tok_s is None
                    or not req.arrival_s else parked.first_tok_s - req.arrival_s),
            queue_wait_s=now - req.arrival_s if req.arrival_s else None,
            e2e_s=now - req.arrival_s if req.arrival_s else None,
            preemptions=parked.parks if parked is not None else 0)

    def _loop(self) -> None:
        try:
            if self.engine.device.type == "cuda":
                torch.cuda.set_device(self.engine.device)
            self._loop_body()
        except BaseException as e:
            # The loop must never die silently: fail every outstanding future, refuse new
            # work, keep the error for stop() to raise.
            self._error = e
            self.queue.close()
            self.queue.take(time.monotonic(), 1 << 30)
            with self._futures_lock:
                futures = list(self._futures.values())
                self._futures.clear()
            for fut in futures:
                try:
                    if not fut.done():
                        fut.set_exception(e)
                except concurrent.futures.InvalidStateError:
                    pass
        finally:
            try:
                self._emit_summary()
            finally:
                self._writer.close()
                self.tracer.close()

    def _emit_summary(self) -> None:
        """The drain-time events: the page ledger, attainment, one ``tenant_summary`` a
        tenant, then the ``serve_summary`` (the engine's byte accounting included: under
        a serve mesh a collective, which the leader broadcasts)."""
        if not self._writer.enabled:
            return
        wall_s = (time.monotonic() - self._started_s
                  if self._started_s is not None else None)
        eng = self.engine
        pages = eng.page_stats()
        if pages is not None:
            self._writer.emit(T.kv_pages_event(source="server", stats=pages))
        if self._slo is not None:
            self._writer.emit(slo_event(self._slo, source="server",
                                        window=self._slo.window(time.monotonic())))
        tenants = self.tenant_summaries()
        for tenant, row in tenants.items():
            self._writer.emit(T.tenant_summary_event(
                tenant=tenant, source="server",
                **{k: row.get(k) for k in ("requests", "ok", "timeout", "shed",
                                           "new_tokens", "preemptions", "ttft_s",
                                           "e2e_s", "slo")}))
        self._writer.emit(T.serve_summary_event(
            **self._counts, wall_s=wall_s, steps=eng.steps, decode_invocations=eng.steps,
            generated_tokens=eng.generated_tokens, spec=eng.spec_stats(),
            slot_occupancy=eng.slot_occupancy, prefill_tokens=eng.prefill_tokens,
            prefill_chunks=eng.prefill_invocations, prefill_wall_s=None,
            prefix_cache=eng.prefix_cache.stats() if eng.prefix_cache else None,
            queue=self.queue.snapshot(), byte_accounting=eng.byte_accounting(),
            kv_pages=pages, slo=self.slo_summary(), preemptions=eng.preemptions,
            resumes=eng.resumes, tenants=tenants or None, **self._series))

    def _maybe_preempt(self, now: float) -> None:
        """Priority preemption: when higher-priority work waits and no slot is free, park
        preemptible lower-priority slots (lowest tier first); each parked record requeues
        at the front of its lane. One victim per waiting higher-priority request."""
        eng = self.engine
        if not eng.prefill_chunk_sizes:
            return
        # A capped tenant's waiting work (and work already past its deadline) must not
        # trigger evictions it could not use.
        waiting = self.queue.waiting_priorities(skip_tenants=self._capped_tenants(),
                                                now=now)              # descending
        if not waiting:
            return
        victims = eng.preemptible_slots()                              # lowest first
        if not victims:
            return
        free = len(eng.free_slots())
        vi = 0
        for wp in waiting:
            if free > 0:
                free -= 1              # a free slot serves it; no eviction
                continue
            if vi >= len(victims) or victims[vi][1] >= wp:
                break
            slot, _ = victims[vi]
            vi += 1
            self.queue.requeue(eng.park(slot, now=now))

    def _tenant_budgets(self) -> dict | None:
        """Per-tenant slot allowance for one admission pass (``max_inflight`` minus the
        slots a tenant holds); ``take`` decrements it as the batch fills."""
        if self.tenants is None:
            return None
        counts = self.engine.active_tenant_counts()
        budgets = {name: spec.max_inflight - counts.get(name, 0)
                   for name, spec in self.tenants.specs.items() if spec.max_inflight}
        return budgets or None

    def _capped_tenants(self) -> set | None:
        """Tenants whose slot budget is spent right now."""
        budgets = self._tenant_budgets()
        if not budgets:
            return None
        capped = {name for name, left in budgets.items() if left <= 0}
        return capped or None

    def _loop_body(self) -> None:
        eng = self.engine
        while True:
            now = time.monotonic()
            if self._abort:
                # stop(drain=False): past-date every accepted request, in flight and
                # queued; re-run each pass so nothing admitted in between escapes.
                for req in eng._requests:
                    if req is not None:
                        req.deadline_s = now - 1.0
                self.queue.force_deadline(now - 1.0)
            for comp in eng.expire(now):
                self._resolve(comp)
            self._maybe_preempt(now)
            admitted, expired = self.queue.take(now, len(eng.free_slots()),
                                                tenant_budgets=self._tenant_budgets())
            for req in expired:
                self._resolve(self._rejected_completion(req, now, finish="timeout"))
            try:
                eng.admit_many(list(zip(eng.free_slots(), admitted)), now=now)
            except KVPagesExhausted as exc:
                # The refusal is typed and partial: requeue the refused at their lanes'
                # front and let the drain free pages. With nothing running, only the
                # prefix cache's pages can be reclaimed.
                for req in exc.refused:
                    self.queue.requeue(req)
                if not exc.admitted and eng.num_active == 0:
                    if eng.prefix_cache is not None and len(eng.prefix_cache):
                        eng.drop_prefix_cache()
                    else:
                        raise
            if eng.num_active:
                for comp in eng.step():
                    self._resolve(comp)
                for rec in eng.take_prefill_records():
                    self._writer.emit(T.prefill_event(**rec))
                for rec in eng.take_spec_records():
                    self._writer.emit(T.spec_event(**rec))
            elif len(self.queue) == 0 and self.queue.closed:
                break
            else:
                self.queue.wait_for_work(self._idle_wait_s)

    # ------------------------------------------------------------------ summaries

    def latency_histograms(self) -> dict:
        """The four latency sketches, JSON-serialized (``LogHistogram.to_json``; they
        merge with the JAX package's). Thread-safe."""
        with self._series_lock:
            return {name: h.to_json() for name, h in self._series.items()}

    def slo_summary(self) -> dict | None:
        """Run-level SLO attainment (None when no spec was declared)."""
        with self._series_lock:
            return self._slo.summary() if self._slo is not None else None

    def tenant_summaries(self) -> dict[str, dict]:
        """Per-tenant ledgers: counts, ttft/e2e percentiles, preemptions, and attainment
        against the tenant's own SLO (the global spec as fallback). Thread-safe."""
        lanes = self.queue.snapshot().get("tenants") or {}
        with self._series_lock:
            now = time.monotonic()
            out = {}
            for tenant in set(self._tenant_stats) | set(lanes):
                row = dict(self._tenant_stats.get(tenant)
                           or {"requests": 0, "ok": 0, "timeout": 0, "shed": 0,
                               "new_tokens": 0, "preemptions": 0})
                lane = lanes.get(tenant) or {}
                # The queue's lane tally also counts refused arrivals (typed Shed at
                # submit, no completion); displaced victims appear in both: merge by max.
                row["shed"] = max(row["shed"], lane.get("shed", 0))
                row["quota_rejected"] = lane.get("quota_rejected", 0)
                series = self._tenant_series.get(tenant) or {}
                tracker = self._slo_by_tenant.get(tenant)
                out[tenant] = {
                    **row,
                    "ttft_s": (series["ttft_s"].percentiles() if "ttft_s" in series
                               else None),
                    "e2e_s": (series["e2e_s"].percentiles() if "e2e_s" in series
                              else None),
                    "slo": tracker.summary() if tracker is not None else None,
                    "slo_window": tracker.window(now) if tracker is not None else None,
                }
            return out


__all__ = ["Server"]
