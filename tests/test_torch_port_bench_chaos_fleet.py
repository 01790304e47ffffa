"""PyTorch port, ``bench_chaos_fleet`` (the port of ``tools/bench_chaos_fleet.py``): the
port's ``Router`` over three port ``--echo`` replicas through the chaos proxy.

- ``--quick`` runs whole — the oracle, the unhedged and the hedged chaos legs — and every
  gate is true (zero lost, token identity with the oracle, ejection and probe-recovery
  without a restart, typed wire faults, zero orphan traces, the hedge winning the tail),
  exit 0;
- its summary has the JAX tool's keys, nested: the JAX tool's ``main`` run here over
  stand-in legs writes the reference document (its legs' fleets are not what is
  compared; its document's shape is).
"""

import importlib.util
import json
import os
import pathlib
import types

import numpy as np

from csed_514_project_distributed_training_using_pytorch_tpu_torch import bench_chaos_fleet

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _key_tree(doc):
    """The document's nested keys (the leg names' own entries included)."""
    if isinstance(doc, dict):
        return {k: _key_tree(v) for k, v in doc.items()}
    return None


def _jax_doc(tmp_path) -> dict:
    """The JAX tool's summary over stand-in legs: every request ok with the oracle's
    tokens, one ejection, probe, hedge win and typed fault a chaos leg."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_chaos_fleet", ROOT / "tools" / "bench_chaos_fleet.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    def stand_in(args, reqs, name, *, chaos="", hedge=False, straggler_k=0.0,
                 out_dir="", trace=False):
        comps = [types.SimpleNamespace(request_id=i, tokens=np.arange(3), ok=True,
                                       ttft_s=0.01 if hedge else 0.02, e2e_s=0.03)
                 for i in range(len(reqs))]
        summary = {"ok": len(reqs), "ejections": 1, "probes": 1, "hedges": int(hedge),
                   "hedge_wins": int(hedge), "hedge_win_rate": 1.0 if hedge else None,
                   "wire_corrupt": 1, "redispatches": 0, "duplicates": 0,
                   "replica_restarts": 0,
                   "per_replica": [{"state": "ready"} for _ in range(args.replicas)]}
        trace_dir = os.path.join(out_dir, f"trace_{name}")
        os.makedirs(trace_dir, exist_ok=True)
        return comps, summary, trace_dir

    tool.run_leg = stand_in
    assert tool.main(["--quick", "--out-dir", str(tmp_path / "jax")]) == 0
    return json.loads((tmp_path / "jax" / "summary.json").read_text())


def test_quick_runs_whole_every_gate_true_with_the_jax_keys(tmp_path, monkeypatch):
    existing = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", f"{ROOT}:{existing}" if existing else str(ROOT))
    monkeypatch.delenv("RESILIENCE_FAULTS", raising=False)
    assert bench_chaos_fleet.main(["--quick", "--out-dir", str(tmp_path / "port")]) == 0
    doc = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert doc["pass"] is True
    assert {name: gate["pass"] for name, gate in doc["gates"].items()} == {
        name: True for name in ("zero_lost", "token_identity", "eject_and_recover",
                                "typed_wire_faults", "zero_orphans", "hedge_wins_the_tail")}
    assert doc["config"]["quick"] is True and doc["legs"]["hedged"]["hedge_wins"] >= 1
    assert _key_tree(doc) == _key_tree(_jax_doc(tmp_path))
