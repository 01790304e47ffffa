"""PyTorch port, ``bench_shard_serve`` (the port of ``tools/bench_shard_serve.py``).

- (c): the serve planner's candidate table — predictions, bytes a chip,
  ``slots_at_budget``, ``fits``, the order, the pick — equals the JAX tool's exactly on
  the JAX tool's topology (4 devices, ``cpu``, 16 GiB), both measured by one stand-in;
- (a): at a tiny width on the CPU the 2-rank world (gloo, through ``train.launch``) emits
  the one-device oracle's tokens, every rank's B6 calls equal layers x decode steps, and
  params + KV a rank are at most the one device's / 1.8; its document has the keys of the
  JAX tool's (a);
- the whole document (``shard_serve.json``) has the JAX tool's keys, both tools' ``main``
  run over stand-in parts.

The JAX tool sets ``XLA_FLAGS`` when it is imported, so it runs in a subprocess.
"""

import argparse
import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch import bench_shard_serve
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import checkpoint

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOL = ROOT / "tools" / "bench_shard_serve.py"

# Both tools' stand-in parts: the measure hook (tokens/s by mesh, so that measurement
# reorders the analytical ranking) and the parts main runs.
STAND_INS = textwrap.dedent("""
    def measure(tp, dp):
        return 1000.0 + 10.0 * tp + dp

    def stand_in_parts(tool, ckpt_module):
        tool.ensure_checkpoint = lambda args: "ckpt"
        ckpt_module.load_params_or_state = lambda path, init: init
        tool.run_shard_identity = lambda model, params, args: {
            "token_identical": 1.0, "per_chip_over_single_ratio": 0.5,
            "trace_pins_ok": True}
        tool.run_tier_leg = lambda args, loadgen, ckpt, *, name, telemetry, kill=False: {
            "ok": args.requests, "handoffs": 1, "handoff_bytes": 1, "handoff_failures": 0,
            "per_replica": [], "_trace_dir": "t"}
        tool.trace_segment_table = lambda trace_dir: {"traces": 0, "segments": {}}
        tool.run_plan_serve = lambda model, args: {"picked": "tp=1,dp=4",
                                                   "pick_is_measured_best": True}
""")
ARGS = dict(num_slots=8, measure_requests=3, max_new_tokens=12, seed=0, measure_top=2,
            requests=8)


def _start_jax_side(tmp_path) -> subprocess.Popen:
    """The JAX tool's (c) document over the stand-in measure, and its whole document over
    the stand-in parts, computed in a subprocess started now."""
    code = STAND_INS + textwrap.dedent(f"""
        import argparse, importlib.util, json, sys
        spec = importlib.util.spec_from_file_location("jax_bench_shard_serve", {str(TOOL)!r})
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        from csed_514_project_distributed_training_using_pytorch_tpu.models import lm
        from csed_514_project_distributed_training_using_pytorch_tpu.plan import scenarios
        from csed_514_project_distributed_training_using_pytorch_tpu.utils import checkpoint
        real = scenarios.for_serve
        scenarios.for_serve = lambda *a, **kw: real(*a, **{{**kw, "measure": measure}})
        plan = tool.run_plan_serve(lm.TransformerLM(), argparse.Namespace(**{ARGS!r}))
        stand_in_parts(tool, checkpoint)
        out = {str(tmp_path / "jax")!r}
        assert tool.main(["--quick", "--out-dir", out, "--work-dir", out + "_work"]) == 0
        print(json.dumps({{"plan": plan,
                          "doc": json.load(open(out + "/shard_serve.json"))}}))
    """)
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=str(ROOT)))


def _port_namespace(tmp_path, **extra) -> argparse.Namespace:
    return argparse.Namespace(**ARGS, device="cpu", work_dir=str(tmp_path / "work"),
                              **extra)


def _key_tree(doc):
    if isinstance(doc, dict):
        return {k: _key_tree(v) for k, v in doc.items()}
    return None


@pytest.fixture(scope="module", autouse=True)
def jax_side(tmp_path_factory):
    """The JAX side, started before the module's first case and read when a case needs
    it (the first case, (a), runs meanwhile)."""
    proc = _start_jax_side(tmp_path_factory.mktemp("jax_side"))
    done = {}

    def result() -> dict:
        if not done:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
            done.update(json.loads(out.strip().splitlines()[-1]))
        return done

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _jax_identity_keys() -> set[str]:
    """The keys of the document the JAX tool's ``run_shard_identity`` returns, read off
    its source."""
    tree = ast.parse(TOOL.read_text(encoding="utf-8"))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_shard_identity")
    doc = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "doc" for t in n.targets))
    return {k.value for k in doc.keys}


def test_shard_identity_gates_hold_at_a_tiny_width(tmp_path, monkeypatch):
    existing = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", f"{ROOT}:{existing}" if existing else str(ROOT))
    model = lm.TransformerLM(seq_len=128, embed_dim=32, num_layers=1, num_heads=2)
    params = model.init(torch.Generator().manual_seed(5))
    args = _port_namespace(tmp_path, shard="tp=2")
    doc = bench_shard_serve.run_shard_identity(model, params, args)
    assert doc["token_identical"] == 1.0 and doc["trace_pins_ok"] is True
    assert doc["per_chip_over_single_ratio"] <= 1 / 1.8
    assert doc["shard"]["tp"] == 2 and sorted(doc["per_chip"]) == ["0", "1"]
    assert doc["decode_compilations"] is None and doc["prefill_compilations"] is None
    assert set(doc) == _jax_identity_keys()


def test_plan_serve_table_equals_the_jax_tools(jax_side, tmp_path):
    stand_ins = {}
    exec(STAND_INS, stand_ins)
    doc = bench_shard_serve.run_plan_serve(lm.TransformerLM(), _port_namespace(tmp_path),
                                           measure=stand_ins["measure"])
    assert json.loads(json.dumps(doc)) == jax_side()["plan"]
    assert len(doc["candidates"]) == 3 and doc["pick_is_measured_best"] is True


def test_the_document_keys_equal_the_jax_tools(jax_side, tmp_path, monkeypatch):
    stand_ins = {}
    exec(STAND_INS, stand_ins)
    monkeypatch.setattr(checkpoint, "load_params_or_state", lambda path, init: init)
    for name in ("ensure_checkpoint", "run_shard_identity", "run_tier_leg",
                 "trace_segment_table", "run_plan_serve"):
        monkeypatch.setattr(bench_shard_serve, name, None)
    stand_ins["stand_in_parts"](bench_shard_serve, checkpoint)
    out = tmp_path / "port"
    assert bench_shard_serve.main(["--quick", "--device", "cpu", "--out-dir", str(out),
                                   "--work-dir", str(tmp_path / "work")]) == 0
    doc = json.loads((out / "shard_serve.json").read_text())
    assert _key_tree(doc) == _key_tree(jax_side()["doc"])
