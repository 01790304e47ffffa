"""PyTorch port, the serving front end against the JAX package's: the request queue and
its tenancy (``serving/scheduler.py``), the latency sketches and SLO attainment
(``obs/hist.py``, ``obs/slo.py``), park and resume (``serving/engine.py``) and ``Server``
(``serving/server.py``).

The queue, the sketches and the trackers are integer and float bookkeeping on the same
inputs with explicit clocks: equal results, no tolerance. Park/resume: the same scripted
drive (admit, park at fixed steps, requeue) through both engines gives the same greedy
streams, the same victims and the same prefix-cache ledger, and each stream equals the
port's unparked one. ``Server``: threaded submits resolve, their greedy streams equal
``engine.run``'s on the same requests, a forced park resumes, a drain finishes everything
accepted. Greedy streams are compared token for token.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.models import lm as jax_lm
from csed_514_project_distributed_training_using_pytorch_tpu.obs import hist as jax_hist
from csed_514_project_distributed_training_using_pytorch_tpu.obs import slo as jax_slo
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    engine as jax_engine,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    scheduler as jax_scheduler,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch import obs
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.lm import (
    params_from_jax,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    ContinuousBatchingEngine,
    KVPagesExhausted,
    Parked,
    QueueClosed,
    QuotaExceeded,
    Request,
    RequestQueue,
    Server,
    parse_tenants,
    scheduler,
)

SMALL = dict(vocab_size=9, seq_len=64, embed_dim=32, num_layers=2, num_heads=4)
TENANTS = "paid:w=3,prio=2,cap=2;free:w=1,preempt=1;capped:rate=0.0001,burst=2"
RESULT_TIMEOUT = 120.0


# -----------------------------------------------------------------------------------------
# The request queue and its tenancy
# -----------------------------------------------------------------------------------------


def _script():
    """A scripted arrival and clock sequence: (op, args). Submits carry explicit arrival
    and deadline stamps; takes an explicit ``now``, a batch size and tenant budgets."""
    rng = np.random.default_rng(1)
    ops, rid = [], 0
    for round_ in range(12):
        for _ in range(int(rng.integers(2, 7))):
            tenant = ["paid", "free", "capped", "stranger"][int(rng.integers(0, 4))]
            prio = None if rng.random() < 0.8 else int(rng.integers(0, 3))
            deadline = None if rng.random() < 0.7 else 100.0 + round_ + float(rng.random())
            ops.append(("submit", dict(rid=rid, tenant=tenant, prio=prio,
                                       arrival=100.0 + round_ + rid * 1e-3,
                                       deadline=deadline)))
            rid += 1
        if round_ % 4 == 3:
            ops.append(("requeue_front", dict(rid=rid, tenant="free", arrival=100.0)))
            rid += 1
        budgets = None if rng.random() < 0.5 else {"paid": int(rng.integers(0, 3))}
        ops.append(("take", dict(now=100.0 + round_ + 0.5, max_n=int(rng.integers(1, 3)),
                                 budgets=budgets)))
    return ops


def _replay(pkg, table):
    queue = pkg.RequestQueue(6, tenants=table)
    log = []
    for op, a in _script():
        if op == "take":
            admitted, expired = queue.take(a["now"], a["max_n"], tenant_budgets=a["budgets"])
            log.append(("take", [r.request_id for r in admitted],
                        [r.request_id for r in expired],
                        queue.waiting_priorities(now=a["now"]), queue.tenant_depths()))
            continue
        spec = table.spec_for(a["tenant"])
        req = pkg.Request(prompt=np.zeros(1, np.int32), max_new_tokens=1,
                          request_id=a["rid"], arrival_s=a.get("arrival"),
                          deadline_s=a.get("deadline"), tenant=a["tenant"],
                          priority=a["prio"] if a.get("prio") is not None else spec.priority)
        if op == "requeue_front":
            queue.requeue(req)
            log.append(("requeue", a["rid"]))
            continue
        try:
            shed = queue.submit(req)
            log.append(("ok", a["rid"], [v.request_id for v in shed]))
        except (pkg.QueueFull, pkg.QuotaExceeded, pkg.Shed) as err:
            log.append((type(err).__name__, a["rid"]))
    snap = queue.snapshot(now=120.0)
    return log, snap


def test_request_queue_orders_a_scripted_sequence_as_jax():
    """Weighted-fair within a tier, priority tiers, slot budgets, deadlines (EDF slack and
    queued expiry), front-of-lane requeues, token-bucket quotas, displacement and
    ``Shed``: every refusal, victim, take, waiting-priority list and the final snapshot."""
    jtable, ttable = jax_scheduler.parse_tenants(TENANTS), parse_tenants(TENANTS)
    assert ttable.describe() == jtable.describe()
    assert ttable.highest_priority() == jtable.highest_priority() == "paid"
    got, got_snap = _replay(scheduler, ttable)
    want, want_snap = _replay(jax_scheduler, jtable)
    assert got == want
    assert got_snap == want_snap
    kinds = {entry[0] for entry in got}
    assert {"ok", "QuotaExceeded", "Shed", "QueueFull", "take", "requeue"} <= kinds
    assert any(entry[0] == "ok" and entry[2] for entry in got)       # a displacement
    assert any(entry[0] == "take" and entry[2] for entry in got)     # a queued expiry


def test_token_bucket_and_tenant_parsing_match_jax():
    jb, tb = jax_scheduler.TokenBucket(2.0, 3.0), scheduler.TokenBucket(2.0, 3.0)
    clock = [0.0, 0.0, 0.0, 0.0, 0.1, 0.4, 0.5, 2.0, 2.0, 2.0, 2.0]
    assert [tb.try_take(t) for t in clock] == [jb.try_take(t) for t in clock]
    for text in ("", "off", "a:w=2,share=3;b:prio=1,preempt=1,slo=ttft:0.3+e2e:2"):
        j, t = jax_scheduler.parse_tenants(text), parse_tenants(text)
        assert (j is None) == (t is None)
        if t is not None:
            assert t.describe() == j.describe()
    for bad in ("a:zz=1", "a:w=0", ":w=1"):
        with pytest.raises(ValueError):
            jax_scheduler.parse_tenants(bad)
        with pytest.raises(ValueError):
            parse_tenants(bad)


def test_queue_close_and_quota_refusals():
    queue = RequestQueue(0, tenants=parse_tenants("q:rate=0.0001,burst=1"))
    queue.submit(Request(prompt=np.zeros(1, np.int32), max_new_tokens=1, tenant="q"))
    with pytest.raises(QuotaExceeded):
        queue.submit(Request(prompt=np.zeros(1, np.int32), max_new_tokens=1, tenant="q"))
    queue.close()
    with pytest.raises(QueueClosed):
        queue.submit(Request(prompt=np.zeros(1, np.int32), max_new_tokens=1))
    assert queue.snapshot(now=0.0)["quota_rejected"] == 1 and len(queue) == 1


# -----------------------------------------------------------------------------------------
# Latency sketches and SLO attainment
# -----------------------------------------------------------------------------------------


def test_log_histograms_match_jax():
    rng = np.random.default_rng(2)
    xs = [None, 0.0] + list(rng.lognormal(-3.0, 1.5, size=500))
    j, t = jax_hist.LogHistogram(0.01), obs.LogHistogram(0.01)
    j.extend(xs)
    t.extend(xs)
    assert t.to_json() == j.to_json()
    assert t.percentiles() == j.percentiles()
    for q in (0, 1, 17, 50, 95, 99, 100):
        assert t.quantile(q) == j.quantile(q)
    other = list(rng.lognormal(-2.0, 1.0, size=100))
    jo, to = jax_hist.LogHistogram(0.01), obs.LogHistogram(0.01)
    jo.extend(other)
    to.extend(other)
    assert t.merge(to.to_json()).to_json() == j.merge(jo).to_json()
    assert obs.LogHistogram.from_json(j.to_json()).to_json() == j.to_json()
    jw, tw = jax_hist.WindowedLogHistogram(0.02, 5.0), obs.WindowedLogHistogram(0.02, 5.0)
    for i, x in enumerate(xs[2:200]):
        jw.add(x, now=i * 0.1)
        tw.add(x, now=i * 0.1)
        if i % 37 == 0:
            assert tw.quantile(95, now=i * 0.1) == jw.quantile(95, now=i * 0.1)
            assert tw.count(now=i * 0.1) == jw.count(now=i * 0.1)
    with pytest.raises(ValueError):
        obs.LogHistogram(0.01).add(-1.0)


def test_attainment_trackers_match_jax():
    spec_text = "ttft=0.05,tpot=0.01,e2e=0.4,window=2"
    jspec, tspec = jax_slo.SLOSpec.parse(spec_text), obs.SLOSpec.parse(spec_text)
    assert tspec.describe() == jspec.describe()
    jt, tt = jax_slo.AttainmentTracker(jspec), obs.AttainmentTracker(tspec)
    rng = np.random.default_rng(3)
    for i in range(300):
        sample = dict(ok=bool(rng.random() < 0.9),
                      ttft_s=None if rng.random() < 0.05 else float(rng.exponential(0.04)),
                      tpot_s=float(rng.exponential(0.008)), e2e_s=float(rng.exponential(0.3)))
        jt.observe(i * 0.05, **sample)
        tt.observe(i * 0.05, **sample)
        if i % 50 == 0:
            assert tt.window(i * 0.05) == jt.window(i * 0.05)
    assert tt.summary() == jt.summary() and tt.attainment() == jt.attainment()
    assert obs.slo_event(tt, source="server", window=tt.window(15.0)) == jax_slo.slo_event(
        jt, source="server", window=jt.window(15.0))
    assert obs.SLOSpec.parse("off") is None
    with pytest.raises(ValueError):
        obs.SLOSpec.parse("latency=1")


# -----------------------------------------------------------------------------------------
# Park and resume in the engine
# -----------------------------------------------------------------------------------------


def _pair(cfg=None):
    cfg = cfg or {}
    jm = jax_lm.TransformerLM(**SMALL, **cfg)
    jp = jm.init({"params": jax.random.PRNGKey(0)},
                 jnp.zeros((1, SMALL["seq_len"]), jnp.int32))["params"]
    return jm, jp, lm.TransformerLM(**SMALL, **cfg), params_from_jax(jp)


def _requests(cls, n=5, seed=7, **kw):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, 8, size=int(rng.integers(2, 30))).astype(np.int32),
                max_new_tokens=int(rng.integers(8, 28)), request_id=i, preemptible=True,
                **kw) for i in range(n)]


def _drive_with_parks(engine, requests, park_steps):
    """Serve FIFO; at each step in ``park_steps`` park the first preemptible victim (a
    mid-prefill slot or the newest decoder of the lowest tier) and requeue what comes
    back at the front. Returns the streams, the victims' slots, and the parked kinds."""
    pending, out, victims, kinds, step = list(requests), {}, [], [], 0
    while pending or engine.num_active:
        batch = [(slot, pending.pop(0)) for slot in engine.free_slots()[:len(pending)]]
        try:
            engine.admit_many(batch)
        except (jax_engine.KVPagesExhausted, KVPagesExhausted) as exc:
            # run()'s rule: requeue the refused; with nothing in flight, drop the cache
            pending[:0] = exc.refused
            if not exc.admitted and engine.num_active == 0:
                engine.prefix_cache.clear()
                continue
        if step in park_steps and engine.preemptible_slots():
            slot = engine.preemptible_slots()[0][0]
            victims.append(slot)
            back = engine.park(slot)
            kinds.append(type(back).__name__)
            pending.insert(0, back)
        for comp in engine.step():
            out[comp.request.request_id] = (comp.tokens.tolist(), comp.preemptions)
        step += 1
    return out, victims, kinds


@pytest.mark.parametrize("cache", [0, 4], ids=["no_cache", "cache"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_park_resume_streams_equal_jax_and_the_unparked_run(layout, cache):
    """Two slots, parks at steps 1 (a mid-prefill victim: chunks of 8, budget 1), 6 and
    14: the same victims, record kinds, streams, park counts and prefix-cache ledger as
    the JAX engine; every stream equals the port's run without parks."""
    jm, jp, tm, params = _pair(dict(num_kv_heads=2))
    kw = dict(num_slots=2, kv_layout=layout, page_size=8, prefill_chunk_sizes=(8,),
              prefix_cache_entries=cache)
    parks = {1, 6, 14}
    je = jax_engine.ContinuousBatchingEngine(jm, jp, **kw)
    want = _drive_with_parks(je, _requests(jax_scheduler.Request), parks)
    te = ContinuousBatchingEngine(tm, params, device="cpu", **kw)
    got = _drive_with_parks(te, _requests(Request), parks)
    assert got == want
    streams, victims, kinds = got
    assert "Request" in kinds and "Parked" in kinds and len(victims) == 3
    assert sum(n for _, n in streams.values()) == kinds.count("Parked")
    assert (te.preemptions, te.resumes) == (je.preemptions, je.resumes)
    if cache:
        assert te.prefix_cache.stats() == je.prefix_cache.stats()
        assert te.prefix_cache.stats()["hits"] >= 1
    if layout == "paged":
        assert te.page_stats() == je.page_stats()
    plain = ContinuousBatchingEngine(tm, params, device="cpu", **kw)
    unparked = {c.request.request_id: c.tokens.tolist() for c in plain.run(_requests(Request))}
    assert {rid: toks for rid, (toks, _) in streams.items()} == unparked


def test_park_refusals_and_tenant_counts():
    tm = lm.TransformerLM(**SMALL)
    params = tm.init(torch.Generator().manual_seed(0))
    engine = ContinuousBatchingEngine(tm, params, num_slots=2, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        engine.park(0)
    engine.admit(0, Request(prompt=np.arange(3, dtype=np.int32), max_new_tokens=4,
                            tenant="a", preemptible=True))
    assert engine.active_tenant_counts() == {"a": 1}
    engine.step()
    parked = engine.park(0)
    assert isinstance(parked, Parked) and parked.tenant == "a" and parked.parks == 1
    assert engine.num_active == 0 and engine.preemptions == 1
    with pytest.raises(ValueError, match="parked stream"):
        engine.admit(1, Parked(request=parked.request, tokens=np.zeros(1, np.int32),
                               first_tok_s=None, admit_s=0.0, parked_s=0.0))
    legacy = ContinuousBatchingEngine(tm, params, num_slots=1, prefill_chunk_sizes=(),
                                      device="cpu")
    legacy.admit(0, Request(prompt=np.arange(3, dtype=np.int32), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="chunked-prefill"):
        legacy.park(0)


# -----------------------------------------------------------------------------------------
# Server
# -----------------------------------------------------------------------------------------


def _engine(tm, params, **kw):
    return ContinuousBatchingEngine(tm, params, num_slots=4, kv_layout="paged", page_size=8,
                                    device="cpu", **kw)


def test_server_threaded_submits_resolve_with_engine_run_streams():
    """16 requests from 4 submitter threads (int8 KV, prefix cache on): every future
    resolves ``ok``, each greedy stream equals ``engine.run``'s, and the summaries count
    them all."""
    _, _, tm, params = _pair()
    reqs = _requests(Request, n=16, seed=11)
    kw = dict(kv_dtype="int8", prefix_cache_entries=4)
    want = {c.request.request_id: c.tokens.tolist()
            for c in _engine(tm, params, **kw).run(_requests(Request, n=16, seed=11))}
    server = Server(_engine(tm, params, **kw), slo=obs.SLOSpec(e2e_s=60.0)).start()
    futures: dict[int, object] = {}
    lock = threading.Lock()

    def submitter(k):
        for req in reqs[k::4]:
            fut = server.submit(req.prompt, max_new_tokens=req.max_new_tokens)
            with lock:
                futures[req.request_id] = fut

    threads = [threading.Thread(target=submitter, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=RESULT_TIMEOUT)
        assert not th.is_alive()
    done = {rid: fut.result(timeout=RESULT_TIMEOUT) for rid, fut in futures.items()}
    server.stop(timeout=RESULT_TIMEOUT)
    assert len(done) == 16 and all(c.finish == "ok" for c in done.values())
    assert {rid: c.tokens.tolist() for rid, c in done.items()} == want
    hists = server.latency_histograms()
    assert hists["e2e_s"]["count"] == 16 and hists["ttft_s"]["count"] == 16
    assert server.slo_summary()["requests"] == 16
    assert server.tenant_summaries()["default"]["requests"] == 16


def test_server_parks_a_preemptible_tenant_and_resumes_it():
    """Two slots held by the preemptible tenant's long requests; two requests of the
    higher tier arrive: the loop parks both victims (their rows go to the prefix cache),
    serves the paid requests, and resumes the parked ones, whose streams equal their
    unparked ones."""
    _, _, tm, params = _pair()
    free = _requests(Request, n=2, seed=3)
    want = {c.request.request_id: c.tokens.tolist()
            for c in ContinuousBatchingEngine(tm, params, num_slots=2, device="cpu").run(
                _requests(Request, n=2, seed=3))}
    engine = ContinuousBatchingEngine(tm, params, num_slots=2, kv_layout="paged",
                                      page_size=8, prefix_cache_entries=4, device="cpu")
    server = Server(engine, tenants=parse_tenants(TENANTS))
    free_futs = [server.submit(r.prompt, max_new_tokens=r.max_new_tokens, tenant="free")
                 for r in free]
    server.start()
    deadline = time.monotonic() + RESULT_TIMEOUT
    while engine.steps < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    paid_futs = [server.submit(np.arange(6, dtype=np.int32) % 8, max_new_tokens=4,
                               tenant="paid") for _ in range(2)]
    paid = [f.result(timeout=RESULT_TIMEOUT) for f in paid_futs]
    resumed = [f.result(timeout=RESULT_TIMEOUT) for f in free_futs]
    server.stop(timeout=RESULT_TIMEOUT)
    assert all(c.finish == "ok" for c in paid + resumed)
    assert [c.tokens.tolist() for c in resumed] == [want[0], want[1]]
    assert sum(c.preemptions for c in resumed) >= 1
    assert engine.preemptions >= 1 and engine.resumes >= 1
    rows = server.tenant_summaries()
    assert rows["free"]["preemptions"] >= 1 and rows["paid"]["ok"] == 2


def test_server_drains_everything_accepted_and_then_refuses():
    _, _, tm, params = _pair()
    server = Server(_engine(tm, params)).start()
    futs = [server.submit(r.prompt, max_new_tokens=r.max_new_tokens)
            for r in _requests(Request, n=8, seed=5)]
    server.stop(drain=True, timeout=RESULT_TIMEOUT)
    assert all(f.done() and f.result().finish == "ok" for f in futs)
    with pytest.raises(QueueClosed):
        server.submit(np.arange(3, dtype=np.int32), max_new_tokens=2)
    # without a drain, everything accepted resolves as a timeout
    server = Server(_engine(tm, params))
    futs = [server.submit(r.prompt, max_new_tokens=r.max_new_tokens)
            for r in _requests(Request, n=6, seed=6)]
    server.start()
    server.stop(drain=False, timeout=RESULT_TIMEOUT)
    finishes = {f.result(timeout=1.0).finish for f in futs}
    assert "timeout" in finishes and finishes <= {"ok", "timeout"}
    with pytest.raises(ValueError, match="fills the model's seq_len"):
        server.submit(np.zeros(64, np.int32), max_new_tokens=1)


@pytest.mark.parametrize("kw", [dict(telemetry="serve.jsonl"), dict(trace="spans.jsonl")],
                         ids=["telemetry", "trace"])
def test_server_telemetry_and_trace_raise_naming_a11(kw, tmp_path):
    """Both are ported (the name is the refusal's they replaced): the telemetry stream,
    from the manifest to the drain's summary (its schema against the JAX package's:
    ``tests/test_torch_port_telemetry.py``), and the span file, a tree per request with
    ``queue_wait``, ``prefill``, ``decode`` and ``resolve`` (against the JAX ``Server``'s
    trees: ``tests/test_torch_port_trace.py``)."""
    _, _, tm, params = _pair()
    if "trace" in kw:
        path = tmp_path / kw["trace"]
        server = Server(_engine(tm, params), trace=str(path)).start()
        fut = server.submit(np.arange(3, dtype=np.int32), max_new_tokens=2)
        server.stop(timeout=RESULT_TIMEOUT)
        assert fut.result(timeout=1.0).ok
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        assert {r["event"] for r in rows} == {"span"}
        assert len({r["trace_id"] for r in rows}) == 1
        assert [r["name"] for r in rows] == ["queue_wait", "prefill", "decode", "resolve"]
        return
    path = tmp_path / kw["telemetry"]
    server = Server(_engine(tm, params), telemetry=str(path)).start()
    fut = server.submit(np.arange(3, dtype=np.int32), max_new_tokens=2)
    server.stop(timeout=RESULT_TIMEOUT)
    assert fut.result(timeout=1.0).ok
    kinds = [json.loads(line)["event"] for line in path.read_text().splitlines()]
    assert kinds[:2] == ["manifest", "serve_config"] and kinds[-1] == "serve_summary"
    assert "serve" in kinds


def test_server_loop_error_fails_pending_futures():
    _, _, tm, params = _pair()
    engine = _engine(tm, params)

    def broken():
        raise RuntimeError("device lost")

    engine.step = broken
    server = Server(engine)
    fut = server.submit(np.arange(3, dtype=np.int32), max_new_tokens=2)
    server.start()
    with pytest.raises(RuntimeError, match="device lost"):
        fut.result(timeout=RESULT_TIMEOUT)
    with pytest.raises(RuntimeError, match="serving loop died"):
        server.stop(timeout=RESULT_TIMEOUT)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
