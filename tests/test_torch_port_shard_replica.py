"""PyTorch port, the sharded replica behind the router (``serving/replica.py --shard``):
a world of ``tp * dp`` gloo ranks on the CPU that ``serving.Router`` spawns through
``train.launch.Fleet(whole=True)`` and addresses as one replica.

- a ``Router`` over one ``--shard tp=2`` replica serves 8 greedy streams equal to the
  unsharded in-process engine's on the same seeded parameters, with contiguous and with
  paged KV; its ``stats`` carry both ranks' decode steps and B6 launches (0 on the CPU:
  the plain version launches nothing) and each rank's bytes, under the unsharded engine's;
- a follower rank SIGKILLed mid-decode ends its world whole: the router sees one death
  (the follower's exit code), restarts the world, loses nothing, and no process of the
  old world is left.
"""

import os
import pathlib
import signal
import time

import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    ContinuousBatchingEngine,
    Request,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import Router
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
    read_jsonl,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
WIDTHS = dict(seq_len=32, embed_dim=32, num_layers=1, num_heads=2)
SLOTS, CHUNKS, PAGE = 4, (4, 8), 8


def replica_cmd(kv_layout: str) -> list[str]:
    return ["-m", f"{PKG}.serving.replica", "--seq-len", "32", "--embed-dim", "32",
            "--num-layers", "1", "--num-heads", "2", "--num-slots", str(SLOTS),
            "--prefill-chunks", "4,8", "--kv-layout", kv_layout, "--page-size", str(PAGE),
            "--shard", "tp=2"]


def child_env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = f"{ROOT}:{env['PYTHONPATH']}" if env.get("PYTHONPATH") else str(ROOT)
    env.pop("RESILIENCE_FAULTS", None)
    return env


def workload(seed: int, n: int, max_new: int):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 16, size=int(rng.integers(0, 12))).astype(np.int32), max_new)
            for _ in range(n)]


def unsharded_streams(kv_layout: str, reqs) -> list[list[int]]:
    """The replica's model and seeded parameters (``--seed 0``) in one engine here."""
    model = lm.TransformerLM(vocab_size=17, **WIDTHS)
    params = model.init(torch.Generator().manual_seed(0))
    engine = ContinuousBatchingEngine(model, params, num_slots=SLOTS, seed=0,
                                      prefill_chunk_sizes=CHUNKS, kv_layout=kv_layout,
                                      page_size=PAGE, device="cpu")
    comps = engine.run([Request(prompt=p, max_new_tokens=n, request_id=i)
                        for i, (p, n) in enumerate(reqs)])
    by_id = {c.request.request_id: [int(t) for t in c.tokens] for c in comps}
    return [by_id[i] for i in range(len(reqs))], engine.byte_accounting()


@pytest.fixture(scope="module")
def routers(tmp_path_factory):
    """One router a KV layout, each over one ``--shard tp=2`` replica, started together
    (a world's start, ~4 s on the CPU, is most of a case's time)."""
    hb = tmp_path_factory.mktemp("hb")
    out = {kv: Router(replica_cmd(kv), num_replicas=1, device="cpu",
                      heartbeat_dir=str(hb / kv), heartbeat_timeout_s=30.0, backoff_s=0.2,
                      telemetry=str(hb / f"router_{kv}.jsonl"), env=child_env())
           for kv in ("contiguous", "paged")}
    for router in out.values():
        router.start()
    try:
        for router in out.values():
            assert router.wait_ready(timeout=120)
        yield out
    finally:
        for router in out.values():
            router.stop(drain=False, timeout=60)


@pytest.mark.parametrize("kv_layout", ["contiguous", "paged"])
def test_router_serves_a_sharded_replica_as_the_unsharded_engine(kv_layout, routers):
    reqs = workload(3, 8, 8)
    want, acct = unsharded_streams(kv_layout, reqs)
    router = routers[kv_layout]
    futs = [router.submit(p, max_new_tokens=n) for p, n in reqs]
    comps = [f.result(timeout=120) for f in futs]
    router._collect_stats()
    stats = router.replicas[0].stats["engine"]
    pids = [p.pid for p in router.replicas[0].fleet.procs]
    assert [c.finish for c in comps] == ["ok"] * 8
    assert [[int(t) for t in c.tokens] for c in comps] == want
    assert router.replicas[0].restarts == 0
    # one replica to the router, two ranks behind it: same steps, their own pids
    ranks = stats["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1] and [r["pid"] for r in ranks] == pids
    assert ranks[0]["steps"] == ranks[1]["steps"] > 0
    assert [r["b6_launches"] for r in ranks] == [0, 0]       # the CPU's plain version
    per_chip = stats["bytes"]["per_chip"]
    assert sorted(per_chip) == ["0", "1"]
    single = acct["params_bytes"] + acct["kv_bytes_resident"]
    assert all(row["params_bytes"] + row["kv_bytes"] < single for row in per_chip.values())


def test_a_killed_follower_restarts_the_world_whole(routers):
    reqs = workload(5, 8, 20)
    want, _ = unsharded_streams("paged", reqs)
    router = routers["paged"]
    rep = router.replicas[0]
    before = rep.restarts
    old = [p.pid for p in rep.fleet.procs]
    futs = [router.submit(p, max_new_tokens=n) for p, n in reqs]
    deadline = time.monotonic() + 60
    while not any(f.done() for f in futs) and time.monotonic() < deadline:
        time.sleep(0.02)                             # mid-decode: the first completion
    os.kill(old[1], signal.SIGKILL)
    comps = [f.result(timeout=120) for f in futs]
    new = [p.pid for p in rep.fleet.procs]
    assert [c.finish for c in comps] == ["ok"] * 8
    assert [[int(t) for t in c.tokens] for c in comps] == want
    assert rep.restarts == before + 1 and rep.fleet.first_exit is None
    deaths = [e for e in read_jsonl(router._writer.path)
              if e["event"] == "replica" and e["action"] == "fail"]
    assert [(e["reason"], e["exit_code"]) for e in deaths] == [("crash", -signal.SIGKILL)]
    assert not set(new) & set(old)
    for pid in old:                                  # the old world is gone, reaped
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
