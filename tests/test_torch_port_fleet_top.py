"""PyTorch port, the fleet dashboard: the JAX package's ``tools/fleet_top.py`` (standard
library only, so the port needs no counterpart) renders a ``fleet_snapshot`` stream that the
port's ``serving.router.Router`` writes over two ``--echo`` replicas.

One fleet run: seeded traffic under an SLO spec, a scale-up to three replicas, then the
drain. A frame rendered while the run is live (``JsonlTail`` + ``FleetState`` + ``render``,
in process) shows the newest snapshot's counters; ``python tools/fleet_top.py PATH --once``
after the drain shows the drained fleet: the target, one row a replica with its SLO column,
the scale event and the drain line, with the numbers of the stream's last snapshot and its
``router_summary``.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import SLOSpec
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import (
    Router,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
TOOL = ROOT / "tools" / "fleet_top.py"


@pytest.fixture(autouse=True)
def _child_pythonpath(monkeypatch):
    existing = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", f"{ROOT}:{existing}" if existing else str(ROOT))
    monkeypatch.delenv("RESILIENCE_FAULTS", raising=False)


def _fleet_top():
    spec = importlib.util.spec_from_file_location("jax_fleet_top", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(path: pathlib.Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def test_fleet_top_renders_the_ports_router_stream(tmp_path):
    top = _fleet_top()
    path = tmp_path / "router.jsonl"
    router = Router(
        ["-m", f"{PKG}.serving.replica", "--echo", "--num-levels", "8", "--seq-len", "32",
         "--num-slots", "4", "--max-pending", "8", "--echo-delay-s", "0.01"],
        num_replicas=2, max_replicas=3, heartbeat_dir=str(tmp_path / "hb"),
        heartbeat_timeout_s=30.0, backoff_s=0.2, telemetry=str(path),
        snapshot_interval_s=0.1, slo=SLOSpec.parse("ttft=5,e2e=10,window=30")).start()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 8, 1 + i % 6).astype(np.int32) for i in range(16)]
    try:
        assert router.wait_ready(60.0)
        first = [router.submit(p, max_new_tokens=5) for p in prompts[:8]]
        assert all(f.result(60.0).ok for f in first)
        assert router.scale_up() == 2
        assert router.wait_ready(60.0)
        second = [router.submit(p, max_new_tokens=5) for p in prompts[8:]]
        assert all(f.result(60.0).ok for f in second)
        time.sleep(0.3)                        # a snapshot after the last completion
        # a live frame, as the dashboard tails a running fleet
        state = top.FleetState()
        state.feed(top.JsonlTail(str(path)).poll())
        live = top.render(state, str(path))
        assert state.snapshot is not None and state.summary is None
        assert "[DRAINED]" not in live and "target 3" in live and "ready 3" in live
        assert "scale up -> target 3" in live
    finally:
        router.stop()

    rows = _rows(path)
    snaps = [r for r in rows if r["event"] == "fleet_snapshot"]
    summary = next(r for r in rows if r["event"] == "router_summary")
    assert snaps and summary["requests"] == summary["ok"] == 16
    proc = subprocess.run([sys.executable, str(TOOL), str(path), "--once"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    last = snaps[-1]
    assert f"fleet_top — {path}  [DRAINED]" in out
    assert f"target {last['target']}" in out and last["target"] == 3
    assert f"requests {last['requests']}" in out and f"ok {last['ok']}" in out
    assert "SLO window: attainment" in out
    lines = out.splitlines()
    head = next(i for i, line in enumerate(lines) if line.split()[:2] == ["rep", "state"])
    table = [line.split() for line in lines[head + 1:head + 1 + len(last["per_replica"])]]
    assert [int(r[0]) for r in table] == [r["replica"] for r in last["per_replica"]] \
        == [0, 1, 2]
    assert "slo-att" in out
    assert "scale up -> target 3" in out
    assert f"drained: {summary['requests']} requests" in out
    assert f"{len(snaps)} snapshot(s) seen" in out
