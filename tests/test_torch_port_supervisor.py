"""PyTorch port, the supervisor (``resilience/supervisor.py``, ``fleet_supervise``) and the
heartbeat helpers it uses, against the JAX package.

The JAX package's ``supervise`` and the port's run the same scripted child, which exits 41,
65 (after writing a poison marker) or 75 by attempt: their ``SuperviseResult``s, the
flags each attempt was given and their ``restart`` events are equal, times aside. Then one
real port ``train.single --device cpu`` run at the size the port's resilience tests use
(640 examples, 10 steps an epoch), supervised under a ``kill`` fault at the top of epoch 2
with the epoch-1 checkpoint torn: one restart, the torn file skipped, and the final
parameters bitwise those of an unbroken run.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.resilience import (
    heartbeat as jax_heartbeat,
)
from csed_514_project_distributed_training_using_pytorch_tpu.resilience import (
    supervisor as jax_supervisor,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn
from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs import goodput
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
    heartbeat,
    supervisor,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import step
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"

CHILD = """
import json, os, sys
work = sys.argv[1]
codes = [int(c) for c in sys.argv[2].split(",")]
n = len([f for f in os.listdir(work) if f.startswith("argv")])
with open(os.path.join(work, f"argv{n}.json"), "w") as f:
    json.dump(sys.argv[3:], f)
code = codes[min(n, len(codes) - 1)]
if code == 65:
    with open(os.path.join(work, "store", "poison.json"), "w") as f:
        json.dump({"window": [6 + 2 * n, 7 + 2 * n], "step": 8, "anomalies": 1}, f)
sys.exit(code)
"""


@pytest.fixture(autouse=True)
def _child_pythonpath(monkeypatch):
    existing = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", f"{ROOT}:{existing}" if existing else ROOT)


def _store(path) -> str:
    store = str(path / "store")
    state = step.create_train_state(cnn.Net(), torch.Generator().manual_seed(0))
    checkpoint.save_versioned(store, state._replace(step=torch.tensor(4)), keep=3,
                              health={"clean": True})
    return store


def _events(path) -> list[dict]:
    rows = [json.loads(line) for line in open(path)]
    return [{k: v for k, v in r.items() if k not in ("unix_time", "t_s")} for r in rows]


@pytest.mark.parametrize("codes", ["41,65,65,0", "41,75", "1,1,1,1,1"])
def test_supervise_matches_jax_over_a_scripted_child(codes, tmp_path):
    runs = {}
    for name, mod, extra in (("port", supervisor, {}),
                             ("jax", jax_supervisor, {"platform": "cpu"})):
        work = tmp_path / name
        work.mkdir()
        store = _store(work)
        cfg = mod.SupervisorConfig(num_processes=1, max_restarts=3, backoff_s=0.0,
                                   checkpoint_dir=store, attempt_timeout_s=60,
                                   telemetry=str(work / "sup.jsonl"), **extra)
        res = mod.supervise(["-c", CHILD, str(work), codes, "--skip-steps", "2:3"], cfg)
        argv = [json.load(open(work / f"argv{i}.json")) for i in range(res.attempts)]
        argv = [[a.replace(str(work), "W") for a in row] for row in argv]
        events = _events(work / "sup.jsonl")
        for e in events:
            if e.get("resume_from"):
                e["resume_from"] = e["resume_from"].replace(str(work), "W")
        res.resume_history = [p.replace(str(work), "W") for p in res.resume_history]
        runs[name] = (vars(res), argv, events)
    assert runs["port"] == runs["jax"]
    res, argv, events = runs["port"]
    if codes.startswith("41,65"):
        assert res["status"] == "ok" and res["rollbacks"] == 2
        assert res["skip_windows"] == ((2, 3), (8, 9), (10, 11))
        assert [e["reason"] for e in events if e["event"] == "restart"] == [
            "crash", "poisoned", "poisoned"]
        assert argv[-1][-2:] == ["--skip-steps", "2:3,8:9,10:11"]
    elif codes == "41,75":
        assert (res["status"], res["exit_code"], res["restarts"]) == ("preempted", 75, 1)
    else:
        assert (res["status"], res["exit_code"], res["attempts"]) == ("failed", 1, 4)
    assert argv[0][-4:] == ["--resume-from", "W/store/ckpt_00000004.msgpack",
                            "--skip-steps", "2:3"]


def test_heartbeat_helpers_match_jax(tmp_path):
    """``fingerprint_mismatch`` and ``clear`` on beats written by either package."""
    d = str(tmp_path)
    heartbeat.HeartbeatWriter(d, process_index=0).beat(step=8, epoch=2, fingerprint=1.5)
    jax_heartbeat.HeartbeatWriter(d, process_index=1).beat(step=8, epoch=2,
                                                          fingerprint=1.5)
    assert heartbeat.fingerprint_mismatch(d) is None is jax_heartbeat.fingerprint_mismatch(d)
    heartbeat.HeartbeatWriter(d, process_index=2).beat(step=12, epoch=3, fingerprint=9.0)
    jax_heartbeat.HeartbeatWriter(d, process_index=1).beat(step=8, epoch=2,
                                                          fingerprint=2.5)
    assert heartbeat.fingerprint_mismatch(d) == jax_heartbeat.fingerprint_mismatch(d) == {
        "step": 8, "fingerprints": {0: 1.5, 1: 2.5}}
    open(os.path.join(d, "heartbeat_p1.json.tmp"), "w").close()
    heartbeat.clear(d, 1)
    assert sorted(heartbeat.read_heartbeats(d)) == [0, 2]
    heartbeat.clear(d)
    assert os.listdir(d) == []


TRAIN = ["-m", f"{PKG}.train.single", "--device", "cpu", "--n-epochs", "2",
         "--max-train-examples", "640", "--max-test-examples", "1000",
         "--use-pallas-kernels", "--keep-checkpoints", "2", "--images-dir", "images"]


def test_supervised_kill_with_a_torn_checkpoint_equals_an_unbroken_run(tmp_path):
    """``kill:step=10`` fires at the top of epoch 2 (exit 41) after the epoch-1 store write
    was torn: the supervisor skips the torn file (no healthy checkpoint is left, so the
    restart begins anew), and the finished run's ``model.ckpt`` is the unbroken run's,
    byte for byte; the unbroken run's goodput has no restart badput."""
    ref_dir, sup_dir = tmp_path / "unbroken", tmp_path / "supervised"
    ref_dir.mkdir(), sup_dir.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "RESILIENCE_FAULTS"}
    env["OMP_NUM_THREADS"] = "2"
    unbroken = subprocess.Popen([sys.executable, *TRAIN, "--telemetry", "run.jsonl"],
                                cwd=ref_dir, env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE)
    store = str(sup_dir / "results" / "checkpoints")
    env_sup = dict(env, RESILIENCE_FAULTS=(
        f"kill:step=10,flag={tmp_path / 'kill'};"
        f"torn:match=ckpt_00000010,flag={tmp_path / 'torn'}"))
    cfg = supervisor.SupervisorConfig(num_processes=1, max_restarts=2, backoff_s=0.0,
                                      checkpoint_dir=store, attempt_timeout_s=300,
                                      telemetry=str(sup_dir / "supervisor.jsonl"))
    cwd = os.getcwd()
    os.chdir(sup_dir)
    try:
        res = supervisor.supervise(TRAIN, cfg, env=env_sup)
    finally:
        os.chdir(cwd)
    assert unbroken.wait(timeout=300) == 0, unbroken.stderr.read().decode()[-3000:]
    assert (res.status, res.attempts, res.restarts) == ("ok", 2, 1)
    assert res.resume_history == [None, None]          # the torn epoch-1 file: skipped
    restarts = [e for e in _events(sup_dir / "supervisor.jsonl") if e["event"] == "restart"]
    assert [(e["reason"], e["exit_code"], e["resume_from"]) for e in restarts] == [
        ("crash", 41, "")]
    assert os.path.exists(f"{tmp_path / 'torn'}.p0")
    a = open(sup_dir / "results" / "model.ckpt", "rb").read()
    b = open(ref_dir / "results" / "model.ckpt", "rb").read()
    assert a == b
    clean = goodput.decompose([str(ref_dir / "run.jsonl")])
    assert clean["segments"]["restart_badput_s"] == 0.0 and clean["attempts"] == 1
    assert abs(sum(clean["segments"].values()) - clean["wall_s"]) < 1e-6


def test_fleet_supervise_cli(tmp_path):
    out = subprocess.run([sys.executable, "-m", f"{PKG}.fleet_supervise", "--num-processes",
                          "1", "--max-restarts", "1", "--backoff", "0", "--", "-c",
                          "import sys; sys.exit(7)"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert out.returncode == 7
    assert "[supervisor] failed: exit 7, 2 attempt(s), 1 restart(s)" in out.stdout
