"""PyTorch port, the fleet's router (``serving/router.py``) over the port's ``--echo``
replicas: the JAX package's router-fleet, tenancy and tier cases on model-free processes
(they import no ``torch``, so each starts in a fraction of a second).

- a replica killed mid-flight: its ledger drains back into the queue, every request
  completes with the echo's deterministic tokens, the replica restarts;
- a frozen heartbeat (the replica hung, not dead) is caught and restarted, and a late
  completion resolves nothing twice;
- backpressure: requests wait in the router's queue instead of being blind-fired into
  full replicas;
- every future resolves when every replica dies, the expired half included;
- the traced kill: one span tree a request, the hop visible (``dispatch`` drained ->
  ``redispatch`` cause crash -> ``resolve``), no orphan;
- tenants: dispatch caps, shed best-effort work, per-tenant rows and events;
- a ``prefill`` + ``decode`` echo pair hands every request off; a ChaosProxy damaging the
  first handoff's bytes sends that request to local prefill, zero lost.
"""

import os
import pathlib
import time

import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import Router
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
    QueueFull,
    ServerStopped,
    Shed,
    parse_tenants,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import trace
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
    read_jsonl,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"


@pytest.fixture(autouse=True)
def _child_pythonpath(monkeypatch):
    existing = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", f"{ROOT}:{existing}" if existing else str(ROOT))
    monkeypatch.delenv("RESILIENCE_FAULTS", raising=False)


def echo_cmd(*, num_slots=4, max_pending=8, delay=0.0):
    cmd = ["-m", f"{PKG}.serving.replica", "--echo", "--num-levels", "8", "--seq-len",
           "32", "--num-slots", str(num_slots), "--max-pending", str(max_pending)]
    return cmd + (["--echo-delay-s", str(delay)] if delay else [])


def echo_expected(prompt: np.ndarray, max_new: int, *, seq_len=32, levels=8):
    p = len(prompt)
    total = min(p + max_new, seq_len)
    base = int(prompt.sum()) if p else 0
    return np.asarray(list(prompt) + [(base + i) % levels for i in range(total - p)],
                      np.int32)


def make_router(tmp_path, cmd, n=2, **kw):
    kw.setdefault("heartbeat_dir", str(tmp_path / "hb"))
    kw.setdefault("heartbeat_timeout_s", 30.0)
    kw.setdefault("backoff_s", 0.2)
    kw.setdefault("telemetry", str(tmp_path / "router.jsonl"))
    return Router(cmd, num_replicas=n, **kw)


def wait_for(cond, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, msg
        time.sleep(0.05)


def workload(seed, n, max_new=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 7, size=1 + i % 5).astype(np.int32), max_new) for i in range(n)]


def test_kill_mid_flight_redispatches_with_zero_loss(tmp_path, monkeypatch):
    monkeypatch.setenv("RESILIENCE_FAULTS", f"kill:proc=1,step=5,flag={tmp_path / 'kill'}")
    router = make_router(tmp_path, echo_cmd(delay=0.05)).start()
    try:
        assert router.wait_ready(timeout=120)
        reqs = workload(3, 12)
        futs = [router.submit(p, max_new_tokens=n) for p, n in reqs]
        comps = [f.result(timeout=120) for f in futs]
        assert all(c.ok for c in comps)
        for (prompt, n), comp in zip(reqs, comps):
            np.testing.assert_array_equal(comp.tokens, echo_expected(prompt, n))
        assert any(c.redispatches > 0 for c in comps)
        wait_for(lambda: router.replicas[1].restarts >= 1, msg="no restart")
    finally:
        summ = router.stop(timeout=60)
    assert summ["ok"] == 12 and summ["timeout"] == 0 and summ["redispatches"] >= 1
    assert summ["replica_restarts"] >= 1
    rows = read_jsonl(str(tmp_path / "router.jsonl"))
    fails = [r for r in rows if r["event"] == "replica" and r.get("action") == "fail"]
    assert fails and fails[0]["reason"] == "crash" and fails[0]["replica"] == 1
    assert any(r["event"] == "route" and r.get("redispatches", 0) > 0 for r in rows)


def test_frozen_heartbeat_is_caught_and_restarted(tmp_path, monkeypatch):
    monkeypatch.setenv("RESILIENCE_FAULTS", "freeze:proc=1,step=2")
    router = make_router(tmp_path, echo_cmd(delay=0.25, max_pending=4),
                         heartbeat_timeout_s=2.0).start()
    try:
        assert router.wait_ready(timeout=120)
        reqs = workload(4, 6, max_new=8)
        futs = [router.submit(p, max_new_tokens=n) for p, n in reqs]
        comps = [f.result(timeout=120) for f in futs]
        assert all(c.ok for c in comps)
        for (prompt, n), comp in zip(reqs, comps):
            np.testing.assert_array_equal(comp.tokens, echo_expected(prompt, n))
        wait_for(lambda: router.replicas[1].restarts >= 1, msg="no restart")
    finally:
        summ = router.stop(timeout=60)
    rows = read_jsonl(str(tmp_path / "router.jsonl"))
    assert any(r["event"] == "replica" and r.get("action") in ("fail", "dead")
               and r.get("reason") == "hung" and r.get("replica") == 1 for r in rows)
    assert summ["requests"] == 6 == summ["ok"]


def test_backpressure_queues_instead_of_blind_firing(tmp_path):
    router = make_router(tmp_path, echo_cmd(num_slots=1, max_pending=1, delay=0.1)).start()
    try:
        assert router.wait_ready(timeout=60)
        futs = [router.submit(np.asarray([1, 2], np.int32), max_new_tokens=5)
                for _ in range(10)]
        assert router.queue.snapshot()["depth"] > 0        # held by the router
        comps = [f.result(timeout=120) for f in futs]
        assert all(c.ok for c in comps)
        with router._lock:
            assert all(not r.inflight for r in router.replicas)
    finally:
        summ = router.stop(timeout=60)
    assert summ["ok"] == 10
    assert all(r["dispatched"] > 0 for r in summ["per_replica"])


def test_every_future_resolves_when_every_replica_dies(tmp_path):
    trace_dir = str(tmp_path / "trace")
    router = make_router(tmp_path, ["-c", "import sys; sys.exit(3)"], max_restarts=0,
                         connect_timeout_s=5.0, trace_dir=trace_dir).start()
    outcomes, futs = [], []
    try:
        for i in range(6):
            try:
                futs.append(router.submit(np.asarray([1, 2], np.int32), max_new_tokens=2,
                                          timeout_s=0.01 if i % 2 == 0 else None))
            except ServerStopped:
                outcomes.append("stopped")
        for f in futs:
            try:
                outcomes.append(f.result(timeout=60).finish)
            except ServerStopped:
                outcomes.append("stopped")
    finally:
        router.stop(timeout=10)
    assert len(outcomes) == 6 and set(outcomes) <= {"timeout", "stopped"}
    spans, _ = trace.read_spans([trace_dir])
    summary = trace.summarize_traces(spans)
    assert summary["traces"] == len(futs) > 0 and summary["orphans"] == 0


def test_traced_kill_shows_the_hop_with_no_orphan(tmp_path, monkeypatch):
    monkeypatch.setenv("RESILIENCE_FAULTS", f"kill:proc=1,step=5,flag={tmp_path / 'kill'}")
    trace_dir = str(tmp_path / "trace")
    router = make_router(tmp_path, echo_cmd(delay=0.05), trace_dir=trace_dir,
                         snapshot_interval_s=0.2).start()
    try:
        assert router.wait_ready(timeout=120)
        futs = [router.submit(p, max_new_tokens=n) for p, n in workload(3, 12)]
        comps = [f.result(timeout=120) for f in futs]
        assert all(c.ok for c in comps) and any(c.redispatches for c in comps)
        wait_for(lambda: router.replicas[1].restarts >= 1, msg="no restart")
    finally:
        summ = router.stop(timeout=60)
    assert summ["ok"] == 12
    spans, _ = trace.read_spans([trace_dir])
    summary = trace.summarize_traces(spans)
    assert summary["traces"] == 12 and summary["orphans"] == 0, summary["orphan_ids"]
    assert {s["proc"] for s in spans} >= {"router", "replica0"}
    hopped = [tid for tid, d in summary["by_trace"].items() if d["hops"] > 1]
    assert hopped
    trees = trace.assemble(spans)
    for tid in hopped:
        tree = trees[tid]
        drained = [s for s in tree if s["name"] == "dispatch" and s.get("outcome") == "drained"]
        redis = [s for s in tree if s["name"] == "redispatch"]
        assert drained and redis and [s for s in tree if s["name"] == "resolve"]
        assert all(s["replica"] == 1 for s in drained)
        assert all(s["cause"] == "crash" for s in redis)
        assert all(a["ts"] <= b["ts"] + 1e-9 for a, b in zip(tree, tree[1:]))
        assert drained[0]["ts"] + drained[0]["dur_s"] == pytest.approx(redis[0]["ts"],
                                                                        abs=1e-5)
    snaps = [r for r in read_jsonl(str(tmp_path / "router.jsonl"))
             if r["event"] == "fleet_snapshot"]
    assert snaps and all(len(s["per_replica"]) == 2 for s in snaps)
    assert trace.validate_chrome(trace.chrome_trace(spans)) == []


def test_tenants_on_an_echo_fleet(tmp_path):
    tele = str(tmp_path / "router.jsonl")
    cmd = echo_cmd(num_slots=2, max_pending=2, delay=0.01)
    tt = parse_tenants("paid:w=4,prio=2,slo=e2e:30;free:w=1,preempt=1,cap=1")
    router = make_router(tmp_path, cmd, n=1, tenants=tt, max_pending=2,
                         snapshot_interval_s=0.1).start()
    assert router.wait_ready(timeout=60)
    try:
        free, free_refused = [], 0
        for i in range(4):
            try:
                free.append(router.submit(np.asarray([i], np.int32), max_new_tokens=8,
                                          tenant="free"))
            except (QueueFull, Shed):
                free_refused += 1
            time.sleep(0.01)
        paid = []
        for i in range(3):
            deadline = time.monotonic() + 30
            while True:
                try:
                    paid.append(router.submit(np.asarray([7, i], np.int32),
                                              max_new_tokens=8, tenant="paid"))
                    break
                except QueueFull:
                    assert time.monotonic() < deadline
                    time.sleep(0.02)
        comps = [f.result(timeout=60) for f in free + paid]
    finally:
        summary = router.stop(timeout=60)
    assert all(c.ok for c in comps[-len(paid):])
    assert all(c.tenant == "free" for c in comps if c.finish == "shed")
    assert all(c.ok or c.finish == "shed" for c in comps)
    tens = summary["tenants"]
    assert tens["paid"]["requests"] == 3 and tens["paid"]["shed"] == 0
    assert tens["paid"]["slo"]["attainment"] == 1.0
    assert tens["free"]["requests"] + tens["free"]["shed"] + free_refused >= 4
    events = read_jsonl(tele)
    routes = [e for e in events if e["event"] == "route"]
    assert {e.get("tenant") for e in routes} <= {"paid", "free"}
    snaps = [e for e in events if e["event"] == "fleet_snapshot"]
    assert snaps and set(snaps[-1]["tenants"]) >= {"paid", "free"}
    assert {e["tenant"] for e in events if e["event"] == "tenant_summary"} >= {"paid", "free"}


# The decode replica of the chaos case: the replica's main with its handoff listener
# behind a ChaosProxy of SPEC (the port the hello advertises is the proxy's).
CHAOS_REPLICA = (
    "import sys; from {pkg}.serving import replica; from {pkg}.resilience import netfaults; "
    "listen = replica._start_handoff_listener; "
    "replica._start_handoff_listener = lambda a, e, s, f: netfaults.ChaosProxy("
    "listen(a, e, s, f), {spec!r}, seed=3).start(); sys.exit(replica.main(sys.argv[1:]))")


@pytest.mark.parametrize("chaos", ["off", "corrupt"])
def test_tiered_echo_pair_hands_off_and_falls_back(tmp_path, chaos):
    cmd = echo_cmd()
    if chaos == "corrupt":
        cmd = ["-c", CHAOS_REPLICA.format(pkg=PKG, spec="corrupt:dir=c2s,conn=0")] + \
            cmd[2:] + ["--handoff-timeout-s", "5"]
    router = make_router(tmp_path, cmd, replica_extra_args=[["--tier", "prefill"],
                                                            ["--tier", "decode"]]).start()
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, 6, size=int(rng.integers(4, 12))).astype(np.int32), 4)
            for _ in range(6)]
    try:
        assert router.wait_ready(timeout=60)
        comps = [router.submit(p, max_new_tokens=n).result(timeout=60) for p, n in reqs]
        snap = router.fleet_snapshot()
    finally:
        summ = router.stop(timeout=60)
    for (prompt, n), comp in zip(reqs, comps):
        assert comp.ok
        np.testing.assert_array_equal(comp.tokens, echo_expected(prompt, n))
    assert {row["replica"]: row.get("tier") for row in snap["per_replica"]} == {
        0: "prefill", 1: "decode"}
    failures = 0 if chaos == "off" else 1
    assert [c.disagg for c in comps] == [False] * failures + [True] * (6 - failures)
    assert summ["ok"] == 6 and summ["failed"] == 0
    assert summ["handoffs"] == 6 - failures and summ["handoff_failures"] == failures
    rows = read_jsonl(str(tmp_path / "router.jsonl"))
    assert sum(r["event"] == "tier" for r in rows) >= 2
    handoffs = [r for r in rows if r["event"] == "kv_handoff"]
    assert [r["ok"] for r in handoffs] == [False] * failures + [True] * (6 - failures)
    # an echo handoff ships the prompt as int32: its bytes are 4 a token
    assert [r["bytes"] for r in handoffs if r["ok"]] == [4 * len(p) for p, _ in
                                                         reqs[failures:]]
