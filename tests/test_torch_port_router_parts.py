"""PyTorch port, the fleet's pure parts against the JAX package's: the autoscaler
(``serving/autoscaler.py``), the router's affinity index, submit line and checkpoint
rewrite (``serving/router.py``), the router's API, the telemetry kinds it emits, and the
launcher's ``Fleet(process_id_base=)`` environment contract.

Seeded synthetic snapshot sequences (queue depth and age, utilization, SLO windows
fleet-wide and per tenant, degraded replicas, targets) give identical decision lists and
audit trails from both autoscalers, cooldown included; ``AutoscalePolicy.validate``
raises alike. A seeded sequence of insert/lookup/drop/rehome/hot_prefixes calls gives the
same results from both affinity indexes. No process is started here but the launcher's.
"""

import ast
import dataclasses
import inspect
import json
import os
import pathlib
import sys

import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    autoscaler as jax_autoscaler,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving import router as jax_router
from csed_514_project_distributed_training_using_pytorch_tpu.serving.scheduler import (
    SamplingParams as JaxSamplingParams,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import faults
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    autoscaler,
    router,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
    SamplingParams,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import launch
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    telemetry_events,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "csed_514_project_distributed_training_using_pytorch_tpu_torch"


# -- the autoscaler -------------------------------------------------------------------------


def _snapshots(seed: int, n: int = 60) -> list[tuple[dict, float]]:
    """A seeded stream of (fleet_snapshot, now): overload spells, idle spells, missing
    utilization (nothing ready), SLO windows fleet-wide and per tenant (some under
    ``slo_min_requests``, some empty), degraded replicas and moving targets."""
    rng = np.random.default_rng(seed)
    out, now, regime = [], 0.0, 0
    for _ in range(n):
        if rng.random() < 0.2:
            regime = int(rng.integers(0, 3))
        depth = int(rng.integers(1, 20)) if regime == 0 else (
            0 if regime == 1 else int(rng.integers(0, 3)))
        util = (None if rng.random() < 0.08 else
                float(rng.uniform(0.9, 1.0) if regime == 0 else
                      rng.uniform(0.0, 0.3) if regime == 1 else rng.uniform(0.2, 0.9)))
        snap = {"queue": {"depth": depth, "oldest_age_s": float(rng.uniform(0, 1.5))},
                "utilization": util, "replicas_ready": int(rng.integers(0, 4)),
                "replicas_degraded": int(rng.integers(0, 2))}
        if rng.random() < 0.8:
            snap["target"] = int(rng.integers(1, 5))
        if rng.random() < 0.7:
            snap["slo"] = {"requests": int(rng.integers(0, 12)),
                           "attainment": float(rng.uniform(0.5, 1.0))}
        if rng.random() < 0.7:
            snap["tenants"] = {"paid": {"slo": {"requests": int(rng.integers(0, 12)),
                                                "attainment": float(rng.uniform(0.6, 1))}},
                               "free": {"slo": None}}
        now += float(rng.uniform(0.1, 1.0))
        out.append((snap, now))
    return out


POLICIES = [
    dict(),
    dict(min_replicas=1, max_replicas=3, up_queue_age_s=0.2, sustain_up=1,
         sustain_down=2, cooldown_s=0.0),
    dict(min_replicas=2, max_replicas=4, cooldown_s=2.0, slo_floor=0.9),
    dict(min_replicas=1, max_replicas=4, cooldown_s=1.0, slo_floor=0.85,
         slo_tenant="paid", slo_min_requests=3),
    dict(min_replicas=1, max_replicas=2, up_utilization=0.5, down_utilization=0.4,
         sustain_up=3, sustain_down=1, cooldown_s=0.5),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", POLICIES, ids=[f"policy{i}" for i in range(len(POLICIES))])
def test_autoscaler_decisions_match_jax(kw, seed):
    ours = autoscaler.FleetAutoscaler(autoscaler.AutoscalePolicy(**kw))
    theirs = jax_autoscaler.FleetAutoscaler(jax_autoscaler.AutoscalePolicy(**kw))
    stream = _snapshots(seed)
    got = [ours.observe(dict(s), t) for s, t in stream]
    want = [theirs.observe(dict(s), t) for s, t in stream]
    assert got == want
    assert ours.decisions == theirs.decisions


@pytest.mark.parametrize("kw", [
    dict(min_replicas=0), dict(min_replicas=3, max_replicas=2), dict(sustain_up=0),
    dict(sustain_down=0), dict(down_utilization=0.95), dict(down_utilization=-0.1),
    dict(slo_floor=0.0), dict(slo_floor=1.5), dict(slo_min_requests=0), dict()])
def test_policy_validate_raises_alike(kw):
    def outcome(mod):
        try:
            return ("ok", dataclasses.asdict(mod.AutoscalePolicy(**kw).validate()))
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(autoscaler) == outcome(jax_autoscaler)


# -- the router's pure parts ----------------------------------------------------------------


def test_affinity_index_matches_jax_on_a_seeded_call_sequence():
    rng = np.random.default_rng(4)
    ours, theirs = router._AffinityIndex(12, max_tokens=20), jax_router._AffinityIndex(
        12, max_tokens=20)
    stems = [rng.integers(0, 6, size=int(rng.integers(0, 24))).astype(np.int32)
             for _ in range(8)]
    for step in range(400):
        op = rng.choice(["insert", "lookup", "lookup", "drop", "rehome", "hot"])
        stem = stems[int(rng.integers(len(stems)))]
        prompt = np.concatenate([stem, rng.integers(0, 6, size=int(rng.integers(0, 6)))
                                 ]).astype(np.int32)
        rep = int(rng.integers(0, 4))
        if op == "insert":
            results = [idx.insert(prompt, rep) for idx in (ours, theirs)]
        elif op == "lookup":
            alive = None if rng.random() < 0.3 else set(
                int(r) for r in rng.choice(4, size=int(rng.integers(0, 4)), replace=False))
            min_tokens = int(rng.integers(1, 10))
            results = [idx.lookup(prompt, min_tokens, alive) for idx in (ours, theirs)]
        elif op == "drop":
            results = [idx.drop_replica(rep) for idx in (ours, theirs)]
        elif op == "rehome":
            target = None if rng.random() < 0.2 else int(rng.integers(0, 4))
            results = [idx.rehome(rep, target) for idx in (ours, theirs)]
        else:
            n = int(rng.integers(0, 6))
            results = [[p.tolist() for p in idx.hot_prefixes(n)] for idx in (ours, theirs)]
        assert results[0] == results[1], (step, op)
    assert [(t.tolist(), r) for t, r in ours._entries.values()] == [
        (t.tolist(), r) for t, r in theirs._entries.values()]


def _router_request(mod, sampling_cls, **kw):
    import concurrent.futures

    base = dict(prompt=np.asarray([3, 1, 4, 1, 5], np.int32), max_new_tokens=7,
                sampling=sampling_cls(temperature=0.7, top_k=3, top_p=0.9), request_id=11,
                future=concurrent.futures.Future(), arrival_s=1.0)
    return mod.RouterRequest(**(base | kw))


@pytest.mark.parametrize("kw", [
    dict(), dict(deadline_s=4.25), dict(trace_id="t-1"), dict(tenant="paid", priority=2),
    dict(tenant="free", preemptible=True), dict(deadline_s=0.5, trace_id="x", tenant="a",
                                                priority=1, preemptible=True)])
def test_submit_msg_is_the_jax_line(kw):
    ours = router.Router._submit_msg(_router_request(router, SamplingParams, **kw), 2.0)
    theirs = jax_router.Router._submit_msg(
        _router_request(jax_router, JaxSamplingParams, **kw), 2.0)
    assert ours == theirs
    assert json.dumps(ours) == json.dumps(theirs)


@pytest.mark.parametrize("cmd", [["-m", "x", "--checkpoint", "a.ckpt", "--seed", "1"],
                                 ["-m", "x", "--checkpoint=a.ckpt"], ["-m", "x"],
                                 ["-m", "x", "--checkpoint"]])
def test_with_checkpoint_matches_jax(cmd):
    assert router._with_checkpoint(cmd, "b.ckpt") == jax_router._with_checkpoint(cmd, "b.ckpt")


def test_router_api_is_the_jax_api_with_device_for_platform():
    """Every public method and dataclass field of the JAX ``Router`` and its completion
    is here with the same parameters, but ``platform`` (``JAX_PLATFORMS``), which is
    ``device`` (the replicas' ``--device``) and defaults to the replicas' own default."""
    ours = inspect.signature(router.Router.__init__).parameters
    theirs = inspect.signature(jax_router.Router.__init__).parameters
    assert [p for p in ours if p != "device"] == [p for p in theirs if p != "platform"]
    assert ours["device"].default is None and theirs["platform"].default == "cpu"
    for name in ours:
        if name not in ("device", "self"):
            assert ours[name].default == theirs[name].default, name
    public = {n for n, v in vars(jax_router.Router).items()
              if callable(v) and not n.startswith("_")}
    assert public == {n for n, v in vars(router.Router).items()
                      if callable(v) and not n.startswith("_")}
    for name in public:
        assert inspect.signature(getattr(router.Router, name)).parameters.keys() == \
            inspect.signature(getattr(jax_router.Router, name)).parameters.keys(), name
    for cls in ("RouterCompletion", "RouterRequest"):
        assert [f.name for f in dataclasses.fields(getattr(router, cls))] == [
            f.name for f in dataclasses.fields(getattr(jax_router, cls))]


def test_the_router_emits_only_registered_kinds():
    """Every ``"event"`` literal of the router (and the SLO windows it emits through
    ``obs.slo.slo_event``) is a kind of the registry, which the docstring names as
    produced."""
    tree = ast.parse((PORT / "serving" / "router.py").read_text(encoding="utf-8"))
    kinds = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "event" and isinstance(
                        v, ast.Constant):
                    kinds.add(v.value)
    kinds.add("slo")
    assert kinds >= {"route", "replica", "router_summary", "fleet_snapshot", "scale",
                     "kv_handoff", "tier", "hedge", "eject", "chaos"}
    assert kinds <= set(telemetry_events.EVENT_KINDS)
    doc = telemetry_events.__doc__
    for kind in kinds:
        assert f"``{kind}``" in doc, kind


# -- the launcher's env contract ------------------------------------------------------------

CHILD = ("import json, os, sys; sys.path.insert(0, {root!r}); "
         "from {pkg}.resilience import faults; "
         "keys = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'FLEET_PROCESS_ID'); "
         "open(os.path.join({out!r}, os.environ['FLEET_PROCESS_ID'] + '.json'), 'w')"
         ".write(json.dumps({{k: os.environ.get(k) for k in keys}} | "
         "{{'proc': faults._proc_index()}}))")


def test_fleet_process_id_base_keeps_rank_and_world_its_own(tmp_path):
    """``Fleet(process_id_base=3)`` of one process: ``RANK`` 0 of ``WORLD_SIZE`` 1 (no
    child looks like a rank outside its world), ``FLEET_PROCESS_ID`` 3; a base of 0 is
    the launcher's world as before. The replica's fault ``proc`` comes from its
    ``--replica-id`` (``faults.set_process_index``), then ``RANK``, then
    ``JAX_PROCESS_ID``."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "RANK", "WORLD_SIZE", "LOCAL_RANK", "JAX_PROCESS_ID", "FLEET_PROCESS_ID")}
    code = CHILD.format(root=str(ROOT), pkg=PORT.name, out=str(tmp_path))
    for base, n in ((3, 1), (0, 2)):
        fleet = launch.Fleet(["-c", code], num_processes=n, env=env, process_id_base=base)
        try:
            assert [p.wait(timeout=60) for p in fleet.procs] == [0] * n
        finally:
            fleet.terminate()
    got = {p.stem: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert got == {
        "3": {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "FLEET_PROCESS_ID": "3",
              "proc": 0},
        "0": {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0", "FLEET_PROCESS_ID": "0",
              "proc": 0},
        "1": {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "FLEET_PROCESS_ID": "1",
              "proc": 1}}
    faults.set_process_index(3)
    try:
        assert faults._proc_index() == 3
    finally:
        faults.set_process_index(None)
