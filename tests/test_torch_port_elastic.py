"""PyTorch port, the fleet's elasticity and gray-failure paths (``serving/router.py`` with
``serving/autoscaler.py``) over the port's ``--echo`` replicas, as the JAX package's
elasticity, gray-failure and canary cases run them:

- the router's bounds; ``scale_up`` 2 -> 4 and ``scale_down`` 4 -> 1 with work in flight
  (zero lost, zero completed twice); ``scale_up``'s warm start from the affinity index;
- a rolling ``reload`` one replica at a time (capacity never below N - 1), and the canary
  trio: ``canary_reload`` (the override survives in the canary's argv),
  ``canary_report``, ``promote_canary`` (the fleet's command rewritten, the canary kept),
  ``rollback_canary``;
- the autoscaler driving a scale-up on a burst and a retire on the idle tail;
- straggler ejection: a replica slowed by a ChaosProxy's delay is ejected to
  ``degraded`` and probed back to ``ready`` with no restart;
- a hedge that wins over that straggler, token-identical, with no orphan trace.
"""

import os
import pathlib
import threading
import time

import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import SLOSpec
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.autoscaler import (
    AutoscalePolicy,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import Router
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


def echo_cmd(*, num_slots=4, max_pending=8, delay=0.0, checkpoint=""):
    cmd = ["-m", f"{PKG}.serving.replica", "--echo", "--num-levels", "8", "--seq-len",
           "32", "--num-slots", str(num_slots), "--max-pending", str(max_pending)]
    cmd += ["--echo-delay-s", str(delay)] if delay else []
    return cmd + (["--checkpoint", checkpoint] if checkpoint else [])


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


def events(tmp_path, kind):
    return [r for r in read_jsonl(str(tmp_path / "router.jsonl")) if r["event"] == kind]


def test_router_bounds():
    with pytest.raises(ValueError):
        Router(echo_cmd(), num_replicas=1, min_replicas=2)
    with pytest.raises(ValueError):
        Router(echo_cmd(), num_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        Router(echo_cmd(), num_replicas=1, min_replicas=0)
    with pytest.raises(ValueError, match="snapshot_interval_s"):
        Router(echo_cmd(), num_replicas=1, autoscale=AutoscalePolicy())


def test_scale_up_then_down_with_work_in_flight(tmp_path):
    router = make_router(tmp_path, echo_cmd(delay=0.02), min_replicas=1,
                         max_replicas=4).start()
    try:
        assert router.wait_ready(timeout=60)
        assert router.scale_up() == 2 and router.scale_up() == 3
        assert router.scale_up() is None                  # at max_replicas
        assert router.wait_ready(timeout=60)
        assert sum(r.state == "ready" for r in router.replicas) == 4
        rng = np.random.default_rng(7)
        reqs = [(rng.integers(0, 7, size=1 + i % 5).astype(np.int32), 5) for i in range(24)]
        futs = [router.submit(p, max_new_tokens=n) for p, n in reqs]
        assert all(router.scale_down() is not None for _ in range(3))
        assert router.scale_down() is None                # at min_replicas
        comps = [f.result(timeout=60) for f in futs]
        for (p, n), c in zip(reqs, comps):
            assert c.ok
            np.testing.assert_array_equal(c.tokens, echo_expected(p, n))
        wait_for(lambda: sum(r.state == "retired" for r in router.replicas) == 3,
                 msg="retires did not complete")
        assert router.wait_ready(timeout=10)              # the new target, 1
        assert router.submit(np.asarray([1, 2], np.int32), max_new_tokens=3).result(
            timeout=30).ok
    finally:
        summ = router.stop(timeout=60)
    assert summ["ok"] == summ["requests"] == 25 and summ["duplicates"] == 0
    assert summ["scale"] == {"scale_ups": 2, "scale_downs": 3, "retired": 3, "reloads": 0}
    scales = events(tmp_path, "scale")
    assert [e["action"] for e in scales] == ["up", "up", "down", "down", "down"]
    assert [e["target"] for e in scales] == [3, 4, 3, 2, 1]


def test_scale_up_warm_starts_from_the_affinity_index(tmp_path):
    router = make_router(tmp_path, echo_cmd(delay=0.01), n=1, max_replicas=2,
                         warm_prefixes=4).start()
    try:
        assert router.wait_ready(timeout=60)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 7, size=12).astype(np.int32) for _ in range(6)]
        [router.submit(p, max_new_tokens=3).result(timeout=60) for p in prompts]
        idx = router.scale_up()
        assert router.wait_ready(timeout=60)
        assert router.replicas[idx].state == "ready" and router.replicas[idx].warmed == 4
        with router._lock:
            homes = {r for _, r in router._affinity._entries.values()}
        assert idx in homes
        # a prompt whose prefix was warmed routes to the new replica, affine
        comp = router.submit(np.concatenate([prompts[-1], prompts[0][:3]]),
                             max_new_tokens=2).result(timeout=60)
        assert comp.ok and comp.replica == idx and comp.affinity_hit
    finally:
        router.stop(timeout=60)
    evs = [r for r in events(tmp_path, "replica") if r.get("replica") == idx]
    assert [e["action"] for e in evs][:2] == ["warming", "ready"]
    assert evs[0]["warm_prefixes"] == 4 and evs[1]["warmed"] == 4


def test_rolling_reload_keeps_n_minus_1_ready(tmp_path):
    router = make_router(tmp_path, echo_cmd(delay=0.02), snapshot_interval_s=0.1).start()
    futs, stop = [], threading.Event()
    try:
        assert router.wait_ready(timeout=60)

        def load():
            rng = np.random.default_rng(17)
            while not stop.is_set():
                futs.append(router.submit(rng.integers(0, 7, size=3).astype(np.int32),
                                          max_new_tokens=4))
                time.sleep(0.02)

        t = threading.Thread(target=load, daemon=True)
        t.start()
        time.sleep(0.3)
        out = router.reload("new_params.ckpt", timeout_s=120)
        stop.set()
        t.join(timeout=10)
        assert out["reloaded"] == [0, 1]
        comps = [f.result(timeout=60) for f in futs]
        assert comps and all(c.ok for c in comps)
        with router._lock:
            assert "new_params.ckpt" in list(router.replicas[0].fleet.procs[0].args)
    finally:
        summ = router.stop(timeout=60)
    assert summ["ok"] == summ["requests"] == len(comps) and summ["scale"]["reloads"] == 2
    ready = [s["replicas_ready"] for s in events(tmp_path, "fleet_snapshot")]
    first_full = next(i for i, v in enumerate(ready) if v == 2)
    assert min(ready[first_full:]) >= 1
    reloads = [r for r in events(tmp_path, "scale") if r.get("action") == "reload"]
    assert len(reloads) == 2 and all(r["checkpoint"] == "new_params.ckpt" for r in reloads)


def _burst(router, n, base=0):
    comps = [f.result(30.0) for f in [
        router.submit(np.arange(1, 5, dtype=np.int32) + (base + i) % 3, max_new_tokens=4,
                      timeout_s=30.0) for i in range(n)]]
    assert all(c.ok for c in comps), [c.finish for c in comps]


def test_canary_roll_promote_and_rollback(tmp_path):
    router = make_router(tmp_path, echo_cmd(checkpoint="ckptA"), n=3, affinity=False,
                         drain_timeout_s=15.0, slo=SLOSpec.parse("ttft=5,e2e=10,window=60"),
                         sample_completions=4).start()
    try:
        assert router.wait_ready(120.0)
        base_keys = set(router.fleet_snapshot())
        _burst(router, 9)
        roll = router.canary_reload("ckptB", timeout_s=120.0)
        rep = router.replicas[roll["replica"]]
        assert rep.checkpoint_override == "ckptB"
        assert "ckptB" in list(rep.fleet.procs[0].args)
        restarts = rep.restarts
        _burst(router, 12)
        report = router.canary_report()
        assert report["checkpoint"] == "ckptB"
        assert report["canary"]["requests"] >= 1 and report["fleet"]["requests"] >= 1
        assert report["canary_samples"] and report["fleet_samples"]
        snap = router.fleet_snapshot()
        assert snap["canary"] == {"replica": roll["replica"], "checkpoint": "ckptB"}
        promoted = router.promote_canary(timeout_s=240.0)
        assert sorted(promoted["promoted"] + [promoted["canary"]]) == [0, 1, 2]
        assert router._command[router._command.index("--checkpoint") + 1] == "ckptB"
        assert all(r.checkpoint_override is None for r in router.replicas)
        assert rep.restarts == restarts                   # the canary kept, not re-rolled
        assert set(router.fleet_snapshot()) == base_keys
        roll = router.canary_reload("ckptC", timeout_s=120.0)
        _burst(router, 6)
        router.rollback_canary(timeout_s=120.0)
        assert router._command[router._command.index("--checkpoint") + 1] == "ckptB"
        assert router.replicas[roll["replica"]].checkpoint_override is None
        assert "canary" not in router.fleet_snapshot()
        _burst(router, 6, base=1)
    finally:
        summ = router.stop()
    assert summ["failed"] == 0 and summ["ok"] == summ["requests"] == 33


def test_autoscaler_grows_on_a_burst_and_shrinks_on_idle(tmp_path):
    pol = AutoscalePolicy(min_replicas=1, max_replicas=3, up_queue_age_s=0.1,
                          up_utilization=0.95, down_utilization=0.3, sustain_up=2,
                          sustain_down=3, cooldown_s=0.5)
    router = make_router(tmp_path, echo_cmd(delay=0.05, num_slots=1, max_pending=1), n=1,
                         autoscale=pol, snapshot_interval_s=0.15).start()
    try:
        assert router.wait_ready(timeout=60)
        rng = np.random.default_rng(13)
        futs = [router.submit(rng.integers(0, 7, size=3).astype(np.int32), max_new_tokens=8)
                for _ in range(24)]
        assert all(f.result(timeout=120).ok for f in futs)
        wait_for(lambda: router._scale_counts["scale_ups"] >= 1, 30, "no scale-up")
        wait_for(lambda: router._scale_counts["retired"] >= 1, 30, "no retire on idle")
    finally:
        summ = router.stop(timeout=60)
    assert summ["ok"] == 24 == summ["requests"]
    snaps = events(tmp_path, "fleet_snapshot")
    assert snaps and max(s["replicas_ready"] for s in snaps) >= 2
    assert {r["reason"] for r in events(tmp_path, "scale")} == {"autoscale"}


def test_a_slow_replica_is_ejected_and_probed_back(tmp_path):
    router = make_router(tmp_path, echo_cmd(delay=0.02, max_pending=4), n=3,
                         heartbeat_timeout_s=2.0, straggler_k=3.0, eject_min_samples=4,
                         eject_cooldown_s=1.5,
                         chaos="delay:replica=1,dir=s2c,after=1,ms=600,count=8").start()
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, 7, size=3).astype(np.int32), 5) for _ in range(24)]
    try:
        assert router.wait_ready(timeout=120)
        comps = [f.result(timeout=120) for f in [router.submit(p, max_new_tokens=n)
                                                  for p, n in reqs]]
        for (p, n), c in zip(reqs, comps):
            assert c.ok
            np.testing.assert_array_equal(c.tokens, echo_expected(p, n))
        wait_for(lambda: router.replicas[1].probes >= 1, 30, "no probe")
        assert all(f.result(timeout=120).ok for f in [
            router.submit(p, max_new_tokens=n) for p, n in reqs[:6]])
    finally:
        summ = router.stop(timeout=60)
    ejects = events(tmp_path, "eject")
    per = {r["replica"]: r for r in summ["per_replica"]}
    assert summ["ejections"] >= 1 and summ["probes"] >= 1
    assert any(e["action"] == "eject" and e["replica"] == 1 for e in ejects)
    assert any(e["action"] == "probe" and e["replica"] == 1 for e in ejects)
    assert per[1]["restarts"] == 0 and per[1]["state"] == "ready"
    assert any(r["event"] == "chaos" for r in read_jsonl(str(tmp_path / "router.jsonl")))


def test_a_hedge_wins_over_the_straggler(tmp_path):
    trace_dir = str(tmp_path / "trace")
    router = make_router(tmp_path, echo_cmd(delay=0.02), n=3, hedge=True, hedge_after_s=0.3,
                         chaos="delay:replica=1,dir=s2c,after=1,ms=700,count=10",
                         trace_dir=trace_dir).start()
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, 7, size=3).astype(np.int32), 5) for _ in range(30)]
    try:
        assert router.wait_ready(timeout=120)
        comps = [f.result(timeout=120) for f in [router.submit(p, max_new_tokens=n)
                                                  for p, n in reqs]]
        for (p, n), c in zip(reqs, comps):
            assert c.ok
            np.testing.assert_array_equal(c.tokens, echo_expected(p, n))
        assert any(c.hedged for c in comps) and any(c.hedge_won for c in comps)
    finally:
        summ = router.stop(timeout=60)
    assert summ["requests"] == 30 == summ["ok"]
    assert summ["hedges"] >= 1 and summ["hedge_wins"] >= 1 and summ["hedge_win_rate"] > 0
    hedges = events(tmp_path, "hedge")
    assert len(hedges) == summ["hedges"]
    assert all(r["deadline_s"] == pytest.approx(0.3) for r in hedges)
    spans, _ = trace.read_spans([trace_dir])
    summary = trace.summarize_traces(spans)
    assert summary["traces"] == 30 and summary["orphans"] == 0 and summary["hedged"] >= 1
    assert trace.validate_chrome(trace.chrome_trace(spans)) == []
