"""PyTorch port, the promotion gate (``deploy/promoter.py``) against the JAX package's.

- *Unit tier*: every case of ``tests/test_promote.py``'s unit tier (gate order, the NLL
  budget and perf tolerance with a lazily measured baseline, ``require_stamp``, newest
  wins and superseded, torn publishes, the ledger's torn tail, the canary verdicts), each
  run through BOTH packages' promoters on identical stores with the same injected probes:
  the same terminal actions, counts, incumbents, ledger rows (but their wall-clock ``t``)
  and ``promote``/``canary`` events; then the whole lifecycle against a scripted router
  (canary pass, fail, inconclusive), and a store the port's ``save_versioned`` wrote.
- *Echo tier*: the port's promoter over a live fleet of the port's ``--echo`` replicas
  (``serving/router.py``'s canary trio): a clean candidate canaries and promotes, a
  regressed one (its canary-side samples scored high) rolls back, traffic flowing
  throughout with every future ``ok``; the router's answers are recorded and replayed
  through the JAX package's promoter, which must write the same ledger and events.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu import deploy as jax_deploy
from csed_514_project_distributed_training_using_pytorch_tpu_torch import deploy
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
    transformer,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import SLOSpec
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import Router
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
    create_train_state,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import checkpoint
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.telemetry_events import (
    EVENT_KINDS,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
PACKAGES = {"port": deploy, "jax": jax_deploy}


@pytest.fixture(autouse=True)
def _child_pythonpath(monkeypatch):
    existing = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", f"{ROOT}:{existing}" if existing else ROOT)
    monkeypatch.delenv("RESILIENCE_FAULTS", raising=False)


def _store(path, entries):
    """A hand-built versioned store: dummy bytes and a manifest of ``(step, health)``
    pairs (the promoter trusts the manifest)."""
    os.makedirs(path, exist_ok=True)
    rows = []
    for step, health in entries:
        name = f"ckpt_{step:08d}.msgpack"
        with open(os.path.join(path, name), "wb") as f:
            f.write(b"x" * 8)
        rows.append({"file": name, "step": step, "sha256": "", "bytes": 8,
                     "unix_time": 0.0, "health": health})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"version": 1, "entries": rows}, f)
    return str(path)


def _add(store, step, health):
    name = f"ckpt_{step:08d}.msgpack"
    with open(os.path.join(store, name), "wb") as f:
        f.write(b"y" * 8)
    with open(os.path.join(store, "manifest.json")) as f:
        man = json.load(f)
    man["entries"].append({"file": name, "step": step, "sha256": "", "bytes": 8,
                           "unix_time": 0.0, "health": health})
    with open(os.path.join(store, "manifest.json"), "w") as f:
        json.dump(man, f)
    return name


def _key(path) -> str:
    return os.path.basename(path).split(".")[0]


def _ledger(path) -> list[dict]:
    """The ledger's rows without their wall-clock stamp, paths made store-relative."""
    rows = []
    for row in deploy.read_ledger(path):
        row = {k: v for k, v in row.items() if k != "t"}
        if row.get("incumbent"):
            row["incumbent"] = os.path.basename(row["incumbent"])
        rows.append(row)
    return rows


def _events(path) -> list[dict]:
    """The stream's events without the writer's wall-clock ``t_s``, paths made
    store-relative."""
    if not os.path.exists(path):
        return []
    rows = [{k: v for k, v in json.loads(line).items() if k != "t_s"}
            for line in open(path)]
    for row in rows:
        if row.get("incumbent"):
            row["incumbent"] = os.path.basename(row["incumbent"])
    return rows


# -- the unit tier: each case through both packages ----------------------------------------


def _case_unclean_stamp(pkg, base):
    store = _store(base / "s", [(10, {"clean": False})])
    probed = []
    p = pkg.Promoter(store, nll_fn=lambda path: probed.append(path) or 1.0,
                     ledger_path=str(base / "l.jsonl"), telemetry=str(base / "t.jsonl"))
    out = p.run_once()
    p.close()
    return out, probed, dict(p.counts)


def _case_budget_and_tolerance(pkg, base):
    store = _store(base / "s", [(10, {"clean": True}), (20, {"clean": True})])
    nlls = {"ckpt_00000010": 1.0, "ckpt_00000020": 1.2, "ckpt_00000030": 1.03}
    calls = []

    def nll_fn(path):
        calls.append(_key(path))
        return nlls[_key(path)]

    p = pkg.Promoter(store, nll_fn=nll_fn, gate=pkg.GateConfig(nll_budget=0.05),
                     incumbent=os.path.join(store, "ckpt_00000010.msgpack"),
                     ledger_path=str(base / "l.jsonl"), telemetry=str(base / "t.jsonl"))
    first = p.run_once()
    _add(store, 30, {"clean": True})
    second = p.run_once()
    p.close()
    store2 = _store(base / "s2", [(10, {"clean": True})])
    perfs = {"ckpt_00000010": 1.0, "ckpt_00000020": 1.8}
    p2 = pkg.Promoter(store2, perf_fn=lambda path: perfs[_key(path)],
                      gate=pkg.GateConfig(perf_tolerance=0.5),
                      incumbent=os.path.join(store2, "ckpt_00000010.msgpack"),
                      ledger_path=str(base / "l.jsonl"), telemetry=str(base / "t2.jsonl"))
    _add(store2, 20, {"clean": True})
    third = p2.run_once()
    p2.close()
    return (first, second, third, calls, os.path.basename(p.incumbent), p.incumbent_nll,
            p2.incumbent_perf_s, _events(str(base / "t2.jsonl")))


def _case_require_stamp(pkg, base):
    lenient = pkg.Promoter(_store(base / "a", [(10, None)]),
                           ledger_path=str(base / "l.jsonl")).run_once()
    strict = pkg.Promoter(_store(base / "b", [(10, None)]),
                          gate=pkg.GateConfig(require_stamp=True),
                          ledger_path=str(base / "l.jsonl")).run_once()
    return lenient, strict


def _case_newest_wins(pkg, base):
    store = _store(base / "s", [(10, {"clean": True}), (20, {"clean": True}),
                                (30, {"clean": True})])
    p = pkg.Promoter(store, ledger_path=str(base / "l.jsonl"),
                     telemetry=str(base / "t.jsonl"))
    out = (p.run_once(), p.run_once(), dict(p.counts), os.path.basename(p.incumbent))
    p.close()
    return out


def _case_torn_publish(pkg, base):
    store = _store(base / "s", [(10, {"clean": True})])
    os.remove(os.path.join(store, _add(store, 20, {"clean": True})))
    return [e["file"] for e in pkg.Promoter(store).candidates()]


def _case_torn_ledger(pkg, base):
    path = str(base / "l.jsonl")
    led = pkg.PromotionLedger(path)
    led.record("candidate_seen", "a", step=1)
    led.record("promoted", "a", step=1)
    with open(path, "a") as f:
        f.write('{"action": "gate_f')       # torn mid-append
    return [{k: v for k, v in r.items() if k != "t"} for r in pkg.read_ledger(path)]


def _case_judge(pkg, base):
    p = pkg.Promoter(".", canary=pkg.CanaryConfig(min_requests=3, attainment_margin=0.1,
                                                  nll_margin=0.1))

    def report(c_req, f_req, c_att=1.0, f_att=1.0):
        return {"canary": {"requests": c_req, "attainment": c_att},
                "fleet": {"requests": f_req, "attainment": f_att}}

    return [p.judge_canary(report(*args[:2], **args[2]), *args[3:]) for args in (
        (1, 50, {}, None, None), (50, 2, {}, None, None),
        (10, 10, dict(c_att=0.5, f_att=0.9), None, None), (10, 10, {}, 2.0, 1.0),
        (10, 10, dict(c_att=0.85, f_att=0.9), 1.05, 1.0), (10, 10, dict(c_att=None), 1.0,
                                                           None))]


class ScriptedRouter:
    """The canary trio with scripted reports: what a fleet answers, without one."""

    def __init__(self, reports):
        self.reports = list(reports)
        self.calls = []

    def canary_reload(self, path):
        self.calls.append(("canary_reload", os.path.basename(path)))
        return {"replica": 2, "checkpoint": path, "wall_s": 0.0}

    def canary_report(self):
        self.calls.append(("canary_report",))
        return self.reports.pop(0)

    def promote_canary(self):
        self.calls.append(("promote_canary",))
        return {}

    def rollback_canary(self):
        self.calls.append(("rollback_canary",))
        return {}


def _report(c_req, f_req, c_att, f_att, c_tokens, f_tokens):
    return {"replica": 2, "checkpoint": "",
            "canary": {"requests": c_req, "attainment": c_att},
            "fleet": {"requests": f_req, "attainment": f_att},
            "canary_samples": [{"prompt": [1], "tokens": t} for t in c_tokens],
            "fleet_samples": [{"prompt": [1], "tokens": t} for t in f_tokens]}


def _case_lifecycle(pkg, base):
    """Pass, fail on the sampled NLL, fail on attainment, inconclusive, gate failure."""
    store = _store(base / "s", [(10, {"clean": True})])
    router = ScriptedRouter([
        _report(5, 9, 1.0, 1.0, [[1, 2]], [[1, 2], [2, 3]]),
        _report(5, 9, 1.0, 1.0, [[9, 9]], [[1, 2]]),
        _report(5, 9, 0.5, 1.0, [[1, 2]], [[1, 2]]),
        _report(1, 9, 1.0, 1.0, [], [[1, 2]])])
    nlls = {"ckpt_00000010": 1.0, "ckpt_00000020": 0.9, "ckpt_00000030": 0.95,
            "ckpt_00000040": 0.95, "ckpt_00000050": 0.95, "ckpt_00000060": 2.0}
    p = pkg.Promoter(store, router=router, nll_fn=lambda path: nlls[_key(path)],
                     perf_fn=lambda path: 0.01 * (1 + len(_key(path)) % 3),
                     sample_nll_fn=lambda s: float(np.mean([sum(x["tokens"])
                                                            for x in s])) / 10,
                     canary=pkg.CanaryConfig(window_s=0.0, min_requests=3),
                     ledger_path=str(base / "l.jsonl"), telemetry=str(base / "t.jsonl"),
                     incumbent=os.path.join(store, "ckpt_00000010.msgpack"),
                     dwell_fn=lambda s: None)
    out = []
    for step in (20, 30, 40, 50, 60):
        _add(store, step, {"clean": True})
        out += p.run_once()
    p.close()
    return out, router.calls, dict(p.counts), os.path.basename(p.incumbent)


def _case_port_store(pkg, base):
    """A store the port's ``save_versioned`` wrote (real checkpoint files, checksummed,
    health-stamped, with the cursor): the newest clean candidate promotes (gate only)."""
    store = str(base / "store")
    model = transformer.TransformerClassifier(dropout_rate=0.0)
    state = create_train_state(model, torch.Generator().manual_seed(0))
    for step, clean in ((3, True), (6, True), (9, False)):
        checkpoint.save_versioned(
            store, state._replace(step=torch.tensor(step)), keep=5,
            health={"clean": clean, "anomalies": 0 if clean else 1, "skipped": 0,
                    "step": step, "fingerprint": 1.0},
            cursor={"version": 1, "kind": "epoch", "seed": 1, "epoch": step // 3,
                    "batch": 0, "step": step})
    p = pkg.Promoter(store, ledger_path=str(base / "l.jsonl"),
                     telemetry=str(base / "t.jsonl"))
    first = p.run_once()          # newest (9) is stamped unclean: the gate rejects it
    _meta = checkpoint.manifest_entry_for(os.path.join(store, checkpoint.versioned_name(9)))
    return first, dict(p.counts), _meta["health"]["clean"], p.incumbent


UNIT_CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
              if name.startswith("_case_")}


@pytest.mark.parametrize("case", list(UNIT_CASES))
def test_unit_tier_equals_jax(tmp_path, case):
    out = {}
    for name, pkg in PACKAGES.items():
        base = tmp_path / name
        base.mkdir()
        got = UNIT_CASES[case](pkg, base)
        out[name] = (got, _ledger(str(base / "l.jsonl")), _events(str(base / "t.jsonl")))
    assert out["port"] == out["jax"]
    got, ledger, events = out["port"]
    if case == "lifecycle":
        actions, calls, counts, incumbent = got
        assert actions == ["promoted", "rolled_back", "rolled_back", "rolled_back",
                           "gate_fail"]
        assert incumbent == "ckpt_00000020.msgpack" and counts["rolled_back"] == 3
        assert [e["verdict"] for e in events if e["event"] == "canary"] == [
            "pass", "fail", "fail", "inconclusive"]
    if case == "newest_wins":
        assert got[0] == ["promoted"] and got[1] == [] and got[2]["superseded"] == 2
        assert [r["action"] for r in ledger] == ["superseded", "superseded",
                                                 "candidate_seen", "gate_pass", "promoted"]
    if case == "unclean_stamp":
        assert got == (["gate_fail"], [], {"promoted": 0, "gate_fail": 1,
                                           "rolled_back": 0, "superseded": 0})
    if case == "port_store":
        assert got[0] == ["gate_fail"] and got[2] is False


def test_event_registry_has_the_deploy_kinds():
    for kind in ("data", "promote", "canary"):
        assert kind in EVENT_KINDS


# -- the echo tier: a live fleet ------------------------------------------------------------


def _echo_cmd(checkpoint):
    return ["-m", f"{PKG}.serving.replica", "--echo", "--num-levels", "8", "--seq-len",
            "32", "--num-slots", "4", "--max-pending", "8", "--checkpoint", checkpoint]


def _burst(router, n, base=0):
    futs = [router.submit(np.arange(1, 5, dtype=np.int32) + (base + i) % 3,
                          max_new_tokens=4, timeout_s=30.0) for i in range(n)]
    comps = [f.result(30.0) for f in futs]
    assert all(c.ok for c in comps), [c.finish for c in comps]
    return comps


class Recording:
    """The live router, its canary trio's answers recorded for the replay."""

    def __init__(self, router):
        self.router, self.answers = router, []

    def _call(self, name, *args):
        out = getattr(self.router, name)(*args)
        self.answers.append((name, out))
        return out

    def canary_reload(self, path):
        return self._call("canary_reload", path)

    def canary_report(self):
        return self._call("canary_report")

    def promote_canary(self):
        return self._call("promote_canary")

    def rollback_canary(self):
        return self._call("rollback_canary")


class Replay:
    """The recorded answers, in order, for the JAX package's promoter."""

    def __init__(self, answers):
        self.answers = list(answers)

    def __getattr__(self, name):
        def call(*args):
            got, out = self.answers.pop(0)
            assert got == name, (got, name)
            return out
        return call


def _promote_twice(pkg, store, router, base, *, dwell_fn=None):
    """A clean candidate (step 20, in the store), then a regressed one (step 30, published
    after the first verdict) whose canary-side samples the injected scorer reads high
    (the canary is scored first, the fleet second)."""
    state = {"bad": False, "calls": 0}

    def sample_nll_fn(samples):
        state["calls"] += 1
        return 3.0 if (state["bad"] and state["calls"] % 2 == 1) else 1.0

    p = pkg.Promoter(store, router=router, sample_nll_fn=sample_nll_fn,
                     canary=pkg.CanaryConfig(window_s=1.0, min_requests=2, nll_margin=0.5),
                     ledger_path=str(base / "ledger.jsonl"),
                     telemetry=str(base / "promote.jsonl"),
                     incumbent=os.path.join(store, "ckpt_00000010.msgpack"),
                     dwell_fn=dwell_fn)
    first = p.run_once()
    _add(store, 30, {"clean": True})
    state.update(bad=True, calls=0)
    second = p.run_once()
    p.close()
    return first + second, os.path.basename(p.incumbent)


def test_promoter_on_an_echo_fleet_and_its_replay_in_jax(tmp_path):
    store = _store(tmp_path / "ckpts", [(10, {"clean": True}), (20, {"clean": True})])
    inc = os.path.join(store, "ckpt_00000010.msgpack")
    router = Router(_echo_cmd(inc), num_replicas=3, affinity=False,
                    heartbeat_dir=str(tmp_path / "hb"), heartbeat_timeout_s=30.0,
                    backoff_s=0.2, drain_timeout_s=15.0,
                    telemetry=str(tmp_path / "router.jsonl"),
                    slo=SLOSpec.parse("ttft=5,e2e=10,window=60"),
                    sample_completions=4).start()
    stop = threading.Event()
    served = []

    def traffic():
        i = 0
        while not stop.is_set():
            try:
                served.extend(_burst(router, 3, base=i))
            except Exception:
                if not stop.is_set():
                    raise
            i += 1
            time.sleep(0.02)

    thread = threading.Thread(target=traffic, daemon=True)
    (tmp_path / "port").mkdir()
    recording = Recording(router)
    try:
        assert router.wait_ready(120.0)
        thread.start()
        time.sleep(0.5)
        actions, incumbent = _promote_twice(deploy, store, recording, tmp_path / "port")
        command = list(router._command)
    finally:
        stop.set()
        if thread.is_alive():
            thread.join(10.0)
        summ = router.stop()
    assert actions == ["promoted", "rolled_back"]
    assert incumbent == "ckpt_00000020.msgpack"
    assert command[command.index("--checkpoint") + 1].endswith("ckpt_00000020.msgpack")
    assert summ["failed"] == 0 and summ["ok"] == summ["requests"] == len(served)
    ledger = _ledger(str(tmp_path / "port" / "ledger.jsonl"))
    assert [r["action"] for r in ledger] == [
        "candidate_seen", "gate_pass", "canary_start", "canary_pass", "promoted",
        "candidate_seen", "gate_pass", "canary_start", "canary_fail", "rolled_back"]
    events = _events(str(tmp_path / "port" / "promote.jsonl"))
    kinds = [(e["event"], e.get("action") or e.get("verdict")) for e in events]
    assert ("promote", "promoted") in kinds and ("promote", "rolled_back") in kinds
    assert ("canary", "pass") in kinds and ("canary", "fail") in kinds
    # the same answers through the JAX package's promoter: the same ledger and events
    (tmp_path / "jax").mkdir()
    jax_store = _store(tmp_path / "jax_store", [(10, {"clean": True}),
                                                (20, {"clean": True})])
    got = _promote_twice(jax_deploy, jax_store, Replay(recording.answers),
                         tmp_path / "jax", dwell_fn=lambda s: None)
    assert got == (actions, incumbent)
    assert _ledger(str(tmp_path / "jax" / "ledger.jsonl")) == ledger
    assert _events(str(tmp_path / "jax" / "promote.jsonl")) == events
