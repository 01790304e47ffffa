"""PyTorch port, the epoch bench: its protocol (``utils/benchmarks.py::time_epochs``) and its
one JSON line (``bench.py``), against the JAX package's bench and ``bench.py``'s schema.

Runs on the CPU at a functional size (512 train examples: 8 steps of 64 an epoch, 1-2
timed epochs); the world-2 run is 2 gloo processes through the port's launcher with a hard
``--timeout``.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    benchmarks as jax_benchmarks,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch import bench
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import mesh
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import benchmarks

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
RENDEZVOUS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT")


def _reference_keys() -> set[str]:
    """The keys of the dict the repository's ``bench.py::measure`` returns."""
    tree = ast.parse((ROOT / "bench.py").read_text(encoding="utf-8"))
    measure = next(n for n in tree.body
                   if isinstance(n, ast.FunctionDef) and n.name == "measure")
    ret = [n for n in ast.walk(measure) if isinstance(n, ast.Return)][-1]
    return {k.value for k in ret.value.keys}


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in RENDEZVOUS}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **extra)
    return env


def _train(n: int):
    x, y = mnist._synthesize_split(n, 300)
    return mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic")


def test_flop_constants_and_protocol_constants_equal_jax():
    for name in ("GLOBAL_BATCH", "LEARNING_RATE", "MOMENTUM", "FWD_FLOPS_PER_EXAMPLE",
                 "TRAIN_FLOPS_PER_EXAMPLE"):
        assert getattr(benchmarks, name) == getattr(jax_benchmarks, name), name
    assert bench.BASELINE_BEST == 7.6
    kind = "NVIDIA H100 80GB HBM3"
    assert benchmarks.peak_flops(kind) == 989e12
    assert benchmarks.lookup_by_kind(benchmarks.PEAK_F32_FLOPS_BY_KIND, kind) == 67e12
    assert benchmarks.lookup_by_kind(benchmarks.PEAK_HBM_BYTES_BY_KIND, kind) == 3.35e12
    assert benchmarks.lookup_by_kind(benchmarks.HBM_CAPACITY_BY_KIND, kind) == 80e9
    assert benchmarks.peak_flops("cpu") is None


def test_time_epochs_is_one_warmup_then_n_timed_epochs(monkeypatch):
    for key in RENDEZVOUS:
        monkeypatch.delenv(key, raising=False)
    with mesh.cluster("cpu") as info:
        result = benchmarks.time_epochs(info, _train(512), timed_epochs=2)
    assert result.devices == 1 and result.steps_per_epoch == 8
    assert len(result.epoch_seconds) == 2 and all(t > 0 for t in result.epoch_seconds)
    assert result.median_seconds == float(np.median(result.epoch_seconds))
    assert result.final_state.step == 3 * 8                 # warm-up + 2 timed epochs
    assert np.isfinite(result.final_train_loss)


def test_bench_line_has_the_reference_keys_and_says_it_is_truncated(monkeypatch, capsys,
                                                                   tmp_path):
    for key in RENDEZVOUS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("BENCH_MAX_TRAIN_EXAMPLES", "512")
    monkeypatch.setenv("BENCH_TIMED_EPOCHS", "1")
    assert bench.main(["--device", "cpu", "--data-dir", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    payload = json.loads(lines[0])
    want = (_reference_keys() - {"scan_unroll", "pregather"}) | {"collective_backend"}
    assert set(payload) == want
    assert "FUNCTIONAL TEST" in payload["metric"] and payload["vs_baseline"] is None
    assert (payload["platform"], payload["device_kind"], payload["devices"],
            payload["collective_backend"]) == ("cpu", "cpu", 1, "gloo")
    assert (payload["steps_per_epoch"], payload["train_examples"],
            payload["epochs_trained"]) == (8, 512, 2)
    assert payload["value"] == payload["min_epoch_seconds"] == payload["epoch_seconds_all"][0]
    assert payload["mfu_vs_bf16_peak"] is None and payload["data_source"] == "synthetic"
    assert 0.0 <= payload["test_accuracy_after_run"] <= 1.0


def test_bench_at_world_2_prints_one_line_from_rank_0(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.train.launch", "--num-processes", "2",
         "--timeout", "120", "--", "-m", f"{PKG}.bench", "--device", "cpu"],
        capture_output=True, text=True, timeout=180, cwd=str(tmp_path),
        env=_env(BENCH_MAX_TRAIN_EXAMPLES="512", BENCH_TIMED_EPOCHS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 1
    payload = json.loads(lines[0])
    assert (payload["devices"], payload["collective_backend"],
            payload["steps_per_epoch"]) == (2, "gloo", 8)


def test_bench_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.bench"], capture_output=True,
                          text=True, timeout=120, cwd=str(tmp_path), env=_env())
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
