"""PyTorch port, package boundary: the port and its chip scripts import neither JAX, flax,
msgpack nor the JAX package, and the port's top level stays a namespace package.

The top level has no ``__init__.py`` because the repository's linter (``tools/graftlint``)
expects exactly one top-level package directory with one — the JAX package.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "csed_514_project_distributed_training_using_pytorch_tpu_torch"
JAX_PACKAGE = "csed_514_project_distributed_training_using_pytorch_tpu"
# msgpack too: the card has none, and the port's checkpoints carry their own codec
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", JAX_PACKAGE)

SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "flash_probe.py", ROOT / "lm_probe.py"]
SOURCES = sorted(PORT.rglob("*.py")) + SCRIPTS


def _imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def test_sources_found():
    assert len(SOURCES) >= 28
    for kernel_source in ("fused_kernels.cu", "flash_attention.cu", "paged_attention.cu"):
        assert (PORT / "csrc" / kernel_source).is_file()
    # the native loader's own C++ source, never the JAX package's
    assert (PORT / "data" / "_native" / "loader.cc").is_file()
    for module in ("ops/attention.py", "ops/rotary.py", "ops/flash_attention.py",
                   "models/transformer.py", "parallel/mesh.py", "train/composed.py",
                   "ops/paged_attention.py", "models/lm.py", "serving/__init__.py",
                   "serving/engine.py", "serving/pagepool.py", "serving/scheduler.py",
                   "parallel/collectives.py", "parallel/data_parallel.py",
                   "train/distributed.py", "train/launch.py", "train/smoke.py",
                   "utils/benchmarks.py", "utils/determinism.py", "bench.py",
                   "parallel/ring_attention.py", "ops/optim.py", "train/step.py",
                   "train/guard.py", "resilience/__init__.py", "resilience/poison.py",
                   "utils/telemetry.py", "utils/_msgpack.py", "utils/checkpoint.py",
                   "utils/plotting.py", "utils/profiling.py", "resilience/heartbeat.py",
                   "resilience/preemption.py", "data/native.py", "data/download.py",
                   "data/loader.py", "data/_native/__init__.py", "data/_native/build.py",
                   "ops/quant.py", "serving/prefix_cache.py", "serving/server.py",
                   "obs/__init__.py", "obs/hist.py", "obs/slo.py", "data/stream.py",
                   "train/lm.py", "bench_lm.py", "serving/spec/__init__.py",
                   "serving/spec/drafter.py", "serving/spec/draft_lm.py",
                   "serving/replica.py", "serve_loadgen.py", "bench_spec_ab.py",
                   "parallel/ulysses.py", "bench_transformer.py", "models/__init__.py",
                   "models/cnn.py", "train/single.py", "parallel/tensor_parallel.py",
                   "parallel/fsdp.py", "parallel/expert_parallel.py",
                   "parallel/pipeline.py", "utils/trace.py", "obs/goodput.py",
                   "resilience/faults.py", "resilience/supervisor.py",
                   "resilience/netfaults.py", "serving/wire.py", "fleet_supervise.py",
                   "trace_report.py", "serving/router.py", "serving/tiers.py",
                   "serving/autoscaler.py", "plan/__init__.py", "plan/costs.py",
                   "plan/artifact.py", "plan/search.py", "plan/scenarios.py",
                   "plan/autotune.py", "plan_report.py", "deploy/__init__.py",
                   "deploy/promoter.py", "build_corpus.py", "train_serve_loop.py",
                   "telemetry_report.py", "bench_shard_serve.py", "bench_chaos_fleet.py"):
        assert PORT / module in SOURCES, module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


def test_top_level_is_a_namespace_package():
    assert not (PORT / "__init__.py").exists()
    for sub in ("data", "ops", "models", "obs", "parallel", "resilience", "serving",
                "serving/spec", "train", "utils", "plan", "deploy"):
        assert (PORT / sub / "__init__.py").is_file(), sub


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_chip_scripts_print_no_telemetry_events(path):
    """The linter checks every dict literal with an "event" key against the JAX package's
    registry; the chip scripts have none."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            assert "event" not in keys


@pytest.mark.parametrize("module", ["resilience.supervisor", "fleet_supervise",
                                    "serving.wire", "resilience.netfaults",
                                    "serving.scheduler", "utils.trace", "obs.goodput",
                                    "serving.router", "serving.tiers", "serving.autoscaler",
                                    "serving.replica", "serve_loadgen", "train.launch",
                                    "bench_chaos_fleet"])
def test_fleet_side_modules_import_no_torch(module):
    """A supervisor, the fleet's router, its tiers codec and autoscaler, an ``--echo``
    replica, the load generator's fleet parent and the trace and goodput readers touch no
    device: importing them loads neither ``torch`` nor, so, any CUDA state (the
    supervisor's checkpoint scan imports the checkpoint module only when it has a store
    to scan; a replica imports the engine only when it builds one, and the tiers codec
    ``torch`` only when it decodes planes). The chaos bench drives an echo fleet."""
    code = (f"import sys; import {PORT.name}.{module}; "
            f"sys.exit(1 if 'torch' in sys.modules else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, f"{module} imports torch: {out.stderr[-2000:]}"


def test_an_echo_fleet_runs_without_torch(tmp_path):
    """The port's router over two ``--echo`` replicas, a tiered pair, from a process that
    never imports ``torch``: every request is served, and neither the router's process
    nor the replicas (each writes whether it had loaded it when it stops) loaded it."""
    marks = tmp_path / "marks"
    marks.mkdir()
    replica = (f"import os, sys; from {PORT.name}.serving import replica; "
               f"code = replica.main(sys.argv[1:]); "
               f"open(os.path.join({str(marks)!r}, str(os.getpid())), 'w')"
               f".write(str('torch' in sys.modules)); sys.exit(code)")
    code = f"""
import sys
import numpy as np
from {PORT.name}.serving.router import Router
cmd = ["-c", {replica!r}, "--echo", "--num-levels", "8", "--seq-len", "32"]
r = Router(cmd, num_replicas=2, heartbeat_dir={str(tmp_path / "hb")!r},
           replica_extra_args=[["--tier", "prefill"], ["--tier", "decode"]]).start()
assert r.wait_ready(timeout=60)
comps = [r.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3).result(timeout=60)
         for _ in range(3)]
summ = r.stop(timeout=60)
assert all(c.ok and c.disagg for c in comps) and summ["handoffs"] == 3
sys.exit(1 if "torch" in sys.modules else 0)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=180, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert [p.read_text() for p in marks.iterdir()] == ["False", "False"]
