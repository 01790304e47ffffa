"""PyTorch port, goodput accounting (``obs/goodput.py``), against the JAX package.

Each package's ``decompose`` runs on the other's streams and the reports are equal: a
two-attempt history with a restart (crash) and one with a rollback (poisoned), written
through the JAX package's telemetry writer and event functions and through the port's,
and a real port ``train.single`` run's stream. Each decomposition sums to its wall time
within 1e-6 s; restart and rollback badput land in their own segments, and a run without
restarts has exactly zero badput.
"""

import time

import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu.obs import goodput as jax_goodput
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    jsonl as jax_jsonl,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    telemetry as jax_telemetry,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs import goodput
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import single
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    config,
    jsonl,
    telemetry,
)

PAUSE = 0.02          # seconds between events: the streams' clock advances
EPOCH_S = 0.06        # each synthetic epoch's wall, slept before its event is written


def _write_history(T, J, path, sup_path, *, reason: str, manifest):
    """Two attempts of a 3-epoch run on one telemetry path (the second preserving the
    first, as a resumed trainer does) and the supervisor's stream between them: attempt 1
    runs epochs 1-2 and dies, attempt 2 resumes after epoch 1 and replays epoch 2."""
    sup = J.JsonlWriter(sup_path)

    def epoch(w, e):
        time.sleep(EPOCH_S)
        w.emit(T.epoch_event(e, examples=640, steps=10, wall_s=0.05, execute_s=0.03,
                             eval_s=0.01, data_s=0.005))

    w = T.TelemetryWriter(path)
    w.emit(manifest(T))
    time.sleep(PAUSE)
    epoch(w, 1)
    w.emit(T.checkpoint_event(op="save", path="ckpt_10", nbytes=100, wall_s=0.003, step=10))
    epoch(w, 2)
    w.emit(T.checkpoint_event(op="save", path="m.ckpt", nbytes=100, wall_s=0.02, step=20,
                              background=True))
    w.close()
    time.sleep(PAUSE)
    sup.emit({"event": "restart", "attempt": 1, "restart": 1, "reason": reason,
              "exit_code": 41 if reason == "crash" else 65, "resume_from": "ckpt_10",
              "cursor": None, "skip": "", "rollback": reason != "crash",
              "backoff_s": 0.0, "unix_time": time.time()})
    time.sleep(PAUSE)
    w = T.TelemetryWriter(path, preserve=True)
    w.emit(manifest(T))
    w.emit(T.checkpoint_event(op="restore", path="ckpt_10", nbytes=100, wall_s=0.01,
                              step=10))
    time.sleep(PAUSE)
    epoch(w, 2)
    epoch(w, 3)
    w.close()
    sup.emit({"event": "supervise_summary", "status": "ok", "exit_code": 0, "attempts": 2,
              "restarts": 1, "rollbacks": int(reason != "crash"), "skip": "",
              "unix_time": time.time()})
    sup.close()


WRITERS = {
    "jax": (jax_telemetry, jax_jsonl,
            lambda T: T.manifest_event(run_type="single")),
    "port": (telemetry, jsonl,
             lambda T: T.manifest_event(run_type="single", device="cpu")),
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("reason", ["crash", "poisoned"])
def test_decompose_is_the_same_on_either_packages_streams(writer, reason, tmp_path):
    T, J, manifest = WRITERS[writer]
    _write_history(T, J, str(tmp_path / "run.jsonl"), str(tmp_path / "sup.jsonl"),
                   reason=reason, manifest=manifest)
    ours = goodput.decompose([str(tmp_path)])
    assert ours == jax_goodput.decompose([str(tmp_path)])
    assert goodput.goodput_event(ours) == jax_goodput.goodput_event(ours)
    seg = ours["segments"]
    assert abs(sum(seg.values()) - ours["wall_s"]) < 1e-6
    assert (ours["attempts"], ours["restarts"], ours["epochs_replayed"]) == (2, 1, 1)
    badput, other = (("restart_badput_s", "rollback_badput_s") if reason == "crash"
                     else ("rollback_badput_s", "restart_badput_s"))
    assert seg[badput] > 0.0 and seg[other] == 0.0
    assert ours["rollbacks"] == int(reason != "crash")
    assert seg["compute_s"] == pytest.approx(3 * 0.04)
    assert seg["checkpoint_stall_s"] == pytest.approx(0.003)
    assert ours["unaccounted_s"] == 0.0


def test_a_port_trainer_stream_decomposes_alike(tmp_path):
    rng = np.random.default_rng(3)
    split = lambda n: mnist.Dataset(rng.random((n, 28, 28, 1), dtype=np.float32),
                                    rng.integers(0, 10, size=n).astype(np.int32), "synthetic")
    path = str(tmp_path / "run.jsonl")
    single.main(config.SingleProcessConfig(
        device="cpu", n_epochs=2, telemetry=path, keep_checkpoints=2,
        results_dir=str(tmp_path / "results"), images_dir=str(tmp_path / "images")),
        datasets=(split(256), split(1000)))
    ours = goodput.decompose([path])
    assert ours == jax_goodput.decompose([path])
    assert ours["epochs"] == 2 and ours["attempts"] == 1 and ours["restarts"] == 0
    assert ours["segments"]["restart_badput_s"] == 0.0
    assert ours["segments"]["rollback_badput_s"] == 0.0
    assert ours["checkpoint"]["saves"] >= 2
    # exclusive by construction: execute_s leaves out the plan and the log-tick saves
    # (their own segments), so nothing is counted twice and the residual is idle
    assert ours["unaccounted_s"] == 0.0
    assert abs(sum(ours["segments"].values()) - ours["wall_s"]) < 1e-6
    assert 0.0 < ours["goodput_frac"] <= 1.0


def test_no_epochs_and_unanchored_attempts_raise_alike(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text('{"event": "serve", "t_s": 1.0}\n')
    for mod in (goodput, jax_goodput):
        with pytest.raises(ValueError, match="no trainer epochs"):
            mod.decompose([str(empty)])
    two = tmp_path / "two.jsonl"
    two.write_text('{"event": "manifest", "t_s": 0.0}\n'
                   '{"event": "epoch", "epoch": 1, "t_s": 1.0}\n'
                   '{"event": "manifest", "t_s": 0.0, "unix_time": 5.0}\n'
                   '{"event": "epoch", "epoch": 1, "t_s": 1.0}\n')
    for mod in (goodput, jax_goodput):
        with pytest.raises(ValueError, match="unanchored"):
            mod.decompose([str(two)])
    assert goodput.SEGMENTS == jax_goodput.SEGMENTS
