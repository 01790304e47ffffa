"""PyTorch port, the fleet's router against the JAX package's on one seeded workload: the
JAX ``Router`` over the JAX package's ``--echo`` replicas and the port's over the port's.

The completions are token-identical request by request, and the two routers write the
same telemetry schema: the keys of ``router_config``, ``router_summary`` (and its
per-replica rows), ``fleet_snapshot`` (and its rows), ``route`` and ``replica`` events
(by action) are equal. Both fleets run at once, with a tenant table and an SLO.
"""

import os
import pathlib
import threading

import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu.obs.slo import SLOSpec as JaxSLO
from csed_514_project_distributed_training_using_pytorch_tpu.serving.router import (
    Router as JaxRouter,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving.scheduler import (
    parse_tenants as jax_parse_tenants,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import SLOSpec
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import Router
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
    parse_tenants,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
    read_jsonl,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
JAX_PKG = "csed_514_project_distributed_training_using_pytorch_tpu"
TENANTS = "paid:w=4,prio=2,slo=e2e:30;free:w=1"
SLO = "ttft=5,e2e=10,window=60"


@pytest.fixture(autouse=True)
def _child_pythonpath(monkeypatch):
    existing = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", f"{ROOT}:{existing}" if existing else str(ROOT))
    monkeypatch.delenv("RESILIENCE_FAULTS", raising=False)


def _workload(n: int = 16):
    rng = np.random.default_rng(20)
    stem = rng.integers(0, 7, size=10).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, 7, size=int(rng.integers(0, 6))).astype(np.int32)
        prompt = np.concatenate([stem, tail]) if i % 2 else tail
        out.append((prompt, int(rng.integers(1, 8)), "paid" if i % 3 == 0 else "free"))
    return out


def _run(router_cls, pkg: str, slo_cls, tenants_fn, tmp, out: dict):
    cmd = ["-m", f"{pkg}.serving.replica", "--echo", "--num-levels", "8", "--seq-len",
           "32", "--num-slots", "2", "--max-pending", "4", "--echo-delay-s", "0.01"]
    router = router_cls(cmd, num_replicas=2, heartbeat_dir=str(tmp / "hb"),
                        heartbeat_timeout_s=30.0, telemetry=str(tmp / "router.jsonl"),
                        snapshot_interval_s=0.1, slo=slo_cls.parse(SLO),
                        tenants=tenants_fn(TENANTS)).start()
    try:
        assert router.wait_ready(timeout=120)
        futs = [router.submit(p, max_new_tokens=n, tenant=t) for p, n, t in _workload()]
        out["comps"] = [f.result(timeout=120) for f in futs]
        out["snapshot"] = router.fleet_snapshot()
    finally:
        out["summary"] = router.stop(timeout=60)


def _keys(rows: list[dict]) -> set:
    return {k for r in rows for k in r}


def test_both_routers_serve_the_same_tokens_with_the_same_schema(tmp_path):
    runs = {"jax": {}, "port": {}}
    dirs = {name: tmp_path / name for name in runs}
    for d in dirs.values():
        d.mkdir()
    args = {"jax": (JaxRouter, JAX_PKG, JaxSLO, jax_parse_tenants),
            "port": (Router, PKG, SLOSpec, parse_tenants)}
    threads = [threading.Thread(target=_run, args=(*args[name], dirs[name], runs[name]))
               for name in runs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    ours, theirs = runs["port"], runs["jax"]
    assert len(ours["comps"]) == len(theirs["comps"]) == 16
    for a, b in zip(ours["comps"], theirs["comps"]):
        assert a.ok and b.ok and a.tenant == b.tenant
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (a.prompt_len, a.new_tokens) == (b.prompt_len, b.new_tokens)
    assert set(ours["summary"]) == set(theirs["summary"])
    assert _keys(ours["summary"]["per_replica"]) == _keys(theirs["summary"]["per_replica"])
    assert set(ours["snapshot"]) == set(theirs["snapshot"])
    assert _keys(ours["snapshot"]["per_replica"]) == _keys(theirs["snapshot"]["per_replica"])
    for field in ("requests", "ok", "new_tokens", "failed", "timeout", "shed"):
        assert ours["summary"][field] == theirs["summary"][field], field
    rows = {name: read_jsonl(str(dirs[name] / "router.jsonl")) for name in runs}
    kinds = {name: {r["event"] for r in rows[name]} for name in runs}
    assert kinds["port"] == kinds["jax"]
    assert {"router_config", "route", "replica", "fleet_snapshot", "router_summary",
            "tenant_summary", "slo"} <= kinds["port"]
    for kind in sorted(kinds["port"] - {"replica"}):
        assert _keys([r for r in rows["port"] if r["event"] == kind]) == _keys(
            [r for r in rows["jax"] if r["event"] == kind]), kind
    for action in {r.get("action") for r in rows["jax"] if r["event"] == "replica"}:
        assert _keys([r for r in rows["port"] if r["event"] == "replica"
                      and r.get("action") == action]) == _keys(
            [r for r in rows["jax"] if r["event"] == "replica"
             and r.get("action") == action]), action
    snaps = {name: [r for r in rows[name] if r["event"] == "fleet_snapshot"]
             for name in runs}
    assert _keys(snaps["port"]) == _keys(snaps["jax"])
