"""PyTorch port, a hung rank of a sharded replica (``serving/replica.py --shard``, gloo on
the CPU): a follower that hangs (SIGSTOP) holds rank 0 inside a mesh call; rank 0 stops
beating, and the router's heartbeat timeout restarts the world whole within seconds, not
after a collective's 300 s, nothing lost and no process of the old world left.
"""

import json
import os
import signal
import time

import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import Router
from test_torch_port_shard_world import MODEL, PKG, child_env


def test_a_hung_rank_ends_its_world_within_the_heartbeat_timeout(tmp_path):
    router = Router(["-m", f"{PKG}.serving.replica", *MODEL], num_replicas=1, device="cpu",
                    heartbeat_dir=str(tmp_path / "hb"), heartbeat_timeout_s=3.0,
                    backoff_s=0.2, telemetry=str(tmp_path / "router.jsonl"),
                    env=child_env())
    router.start()
    try:
        assert router.wait_ready(timeout=120)
        rep = router.replicas[0]
        old = [p.pid for p in rep.fleet.procs]
        rng = np.random.default_rng(2)
        futs = [router.submit(rng.integers(0, 16, size=4).astype(np.int32),
                              max_new_tokens=20) for _ in range(8)]
        os.kill(old[1], signal.SIGSTOP)
        t0 = time.monotonic()
        comps = [f.result(timeout=120) for f in futs]
        assert [c.finish for c in comps] == ["ok"] * 8 and rep.restarts == 1
        fails = [json.loads(line) for line in open(tmp_path / "router.jsonl")]
        fails = [e for e in fails if e["event"] == "replica" and e["action"] == "fail"]
        assert [e["reason"] for e in fails] == ["hung"]
        assert time.monotonic() - t0 < 60.0             # not a collective's 300 s
        for pid in old:
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)
    finally:
        router.stop(drain=False, timeout=60)
