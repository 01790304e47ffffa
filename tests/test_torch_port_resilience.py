"""PyTorch port, the run's hooks: heartbeats, cooperative preemption, the plots and the
profiler trace, against the JAX package where it has a counterpart.

The preemption test runs ``train.single`` as a subprocess on the CPU, sends it SIGTERM
once its heartbeat says epoch 2 has begun, and resumes from what it left. No tolerances:
the checks are exit codes, files, checksums and step counts.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.resilience import (
    heartbeat as jax_heartbeat,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    checkpoint as jax_checkpoint,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch import resilience
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
    heartbeat,
    preemption,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import step
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    checkpoint,
    metrics,
    plotting,
    profiling,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"


class _StepRaises:
    """A state whose step may not be read: the flag-off hooks must not fetch it."""

    @property
    def step(self):
        raise AssertionError("the hooks fetched the step with every flag off")


class _State:
    def __init__(self, step):
        self.step = torch.tensor(step)


def test_run_hooks_off_touch_no_state_and_install_no_handler():
    before = signal.getsignal(signal.SIGTERM)
    hooks = resilience.RunHooks()
    assert signal.getsignal(signal.SIGTERM) is before
    hooks.epoch_tick(_StepRaises(), 1, fingerprint=1.0)
    hooks.check_preempt(epoch=1, state=_StepRaises(), checkpoint="x",
                        save=lambda: pytest.fail("saved with preemption off"))
    hooks.uninstall()


def test_heartbeats_are_read_by_the_jax_supervisor(tmp_path):
    """The port's beats carry the JAX package's schema, and its readers see them."""
    hb = str(tmp_path / "hb")
    hooks = resilience.RunHooks(heartbeat_dir=hb, process_index=1)
    since = time.time() - 10.0                        # the fleet started 10 s ago
    hooks.epoch_tick(_State(40), 2, fingerprint=12.5)
    ours = json.load(open(heartbeat.heartbeat_path(hb, 1)))
    jax_heartbeat.HeartbeatWriter(str(tmp_path / "ref"), process_index=1).beat(
        step=40, epoch=2, fingerprint=12.5)
    theirs = json.load(open(jax_heartbeat.heartbeat_path(str(tmp_path / "ref"), 1)))
    assert list(ours) == list(theirs) == ["process_index", "pid", "step", "epoch", "status",
                                          "time", "fingerprint"]
    assert {k: ours[k] for k in ("process_index", "pid", "step", "epoch", "status",
                                 "fingerprint")} == {
        "process_index": 1, "pid": os.getpid(), "step": 40, "epoch": 2,
        "status": "running", "fingerprint": 12.5}
    assert jax_heartbeat.read_heartbeats(hb) == heartbeat.read_heartbeats(hb) == {1: ours}
    # process 0 never beat: stale from the fleet's start; process 1 is live
    now = time.time() + 1.0
    assert jax_heartbeat.stale_processes(hb, num_processes=2, timeout_s=5.0, since=since,
                                         now=now) == [0]
    assert heartbeat.stale_processes(hb, num_processes=2, timeout_s=5.0, since=since,
                                     now=now) == [0]
    hooks.epoch_tick(_State(50), 3)
    assert "fingerprint" not in jax_heartbeat.read_heartbeats(hb)[1]


def test_preemption_latch_saves_beats_and_raises_at_the_boundary(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    hb = str(tmp_path / "hb")
    hooks = resilience.RunHooks(heartbeat_dir=hb, handle_preemption=True)
    try:
        saved = []
        hooks.check_preempt(epoch=1, state=_StepRaises(), save=lambda: saved.append(1))
        assert not saved                                  # nothing requested yet
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 10
        while not hooks.preemption.requested and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hooks.preemption.requested and hooks.preemption.signum == signal.SIGTERM
        with pytest.raises(resilience.Preempted) as stop:
            hooks.check_preempt(epoch=3, state=_State(30), checkpoint="results/model.ckpt",
                                save=lambda: saved.append(1))
        assert (stop.value.step, stop.value.checkpoint, saved) == (
            30, "results/model.ckpt", [1])
        beat = jax_heartbeat.read_heartbeats(hb)[0]
        assert (beat["status"], beat["step"], beat["epoch"]) == ("preempted", 30, 3)
    finally:
        hooks.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before
    assert preemption.EXIT_PREEMPTED == resilience.EXIT_PREEMPTED == 75


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    return env


def _reference():
    return step.create_train_state(cnn.Net(), torch.Generator().manual_seed(0), guard=True)


TRAIN_ARGS = ["--device", "cpu", "--max-train-examples", "640", "--max-test-examples",
              "1000", "--use-pallas-kernels", "--guard"]


def test_sigterm_exits_75_with_its_checkpoint_durable_and_resumes(tmp_path):
    """``train.single --handle-preemption --keep-checkpoints 2 --guard`` (10 steps an
    epoch) is sent SIGTERM once epoch 2 has begun: it stops at that epoch's boundary, exits
    75, and leaves a manifest whose newest entry verifies with a clean health stamp and a
    ``model.ckpt`` at the same step; a resume from the newest entry then finishes."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.train.single", *TRAIN_ARGS, "--n-epochs", "30",
         "--handle-preemption", "--keep-checkpoints", "2", "--heartbeat-dir", "hb"],
        cwd=str(tmp_path), env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    beat_path = tmp_path / "hb" / "heartbeat_p0.json"
    deadline = time.monotonic() + 240
    try:
        while True:
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline, "no heartbeat of epoch 2 in 240 s"
            try:
                if json.loads(beat_path.read_text())["epoch"] >= 2:
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == resilience.EXIT_PREEMPTED, err[-3000:]
    store = str(tmp_path / "results" / "checkpoints")
    entries = jax_checkpoint.load_manifest(store)["entries"]
    newest = entries[-1]
    stopped = newest["step"]
    assert stopped % 10 == 0 and 20 <= stopped < 300
    assert checkpoint.newest_valid_checkpoint(store) == os.path.join(store, newest["file"])
    assert newest["health"]["clean"] is True and newest["health"]["anomalies"] == 0
    assert newest["cursor"]["epoch"] == stopped // 10 + 1
    assert f"preempted at step {stopped}" in out
    beat = heartbeat.read_heartbeats(str(tmp_path / "hb"))[0]
    assert (beat["status"], beat["step"]) == ("preempted", stopped)
    model = checkpoint.restore_train_state(str(tmp_path / "results" / "model.ckpt"),
                                           _reference())
    assert int(model.step) == stopped
    assert len(entries) <= 2

    resumed = subprocess.run(
        [sys.executable, "-m", f"{PKG}.train.single", *TRAIN_ARGS, "--n-epochs", "1",
         "--resume-from", os.path.join(store, newest["file"]), "--results-dir", "resumed"],
        cwd=str(tmp_path), env=_env(), capture_output=True, text=True, timeout=300)
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert f"Resumed from {os.path.join(store, newest['file'])} at step {stopped}" in \
        resumed.stdout
    assert "WARNING" not in resumed.stdout          # the cursor agrees
    final = checkpoint.restore_train_state(str(tmp_path / "resumed" / "model.ckpt"),
                                           _reference())
    assert int(final.step) == stopped + 10


# -- plots and profiling ----------------------------------------------------------------


def _history() -> metrics.MetricsHistory:
    h = metrics.MetricsHistory()
    for i, loss in enumerate((2.3, 1.1, 0.7)):
        h.record_train(640 * i, loss)
    h.record_test(0, 2.3)
    h.record_test(1920, 0.6)
    return h


def _images(n: int = 6):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, size=n).astype(np.int32))


def test_plots_return_their_paths(tmp_path):
    pytest.importorskip("matplotlib")
    images, labels = _images()
    grid = plotting.save_sample_grid(images, labels, str(tmp_path / "i" / "grid.png"))
    curve = plotting.save_loss_curves(_history(), str(tmp_path / "i" / "curve.png"))
    assert grid == str(tmp_path / "i" / "grid.png") and curve == str(tmp_path / "i" /
                                                                     "curve.png")
    for path in (grid, curve):
        assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_plots_return_none_without_matplotlib(tmp_path, monkeypatch, capsys):
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    images, labels = _images()
    assert plotting.save_sample_grid(images, labels, str(tmp_path / "grid.png")) is None
    assert plotting.save_loss_curves(_history(), str(tmp_path / "curve.png")) is None
    assert os.listdir(tmp_path) == []
    assert capsys.readouterr().out.count("matplotlib is not available") == 2


def test_plots_are_rank_0_gated(tmp_path, monkeypatch):
    monkeypatch.setenv("RANK", "1")
    assert plotting.save_loss_curves(_history(), str(tmp_path / "curve.png")) is None
    assert os.listdir(tmp_path) == []


def test_maybe_profile_writes_a_chrome_trace_with_the_annotations(tmp_path, capsys):
    log_dir = tmp_path / "profile"
    with profiling.maybe_profile(True, str(log_dir)):
        with profiling.annotate("train_epoch_1"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.load(open(log_dir / profiling.TRACE_NAME))
    assert any(e.get("name") == "train_epoch_1" for e in trace["traceEvents"])
    assert f"Saved profiler trace to {log_dir / profiling.TRACE_NAME}" in \
        capsys.readouterr().out
    with profiling.maybe_profile(False, str(tmp_path / "off")):
        with profiling.annotate("eval"):
            pass
    assert not (tmp_path / "off").exists()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
