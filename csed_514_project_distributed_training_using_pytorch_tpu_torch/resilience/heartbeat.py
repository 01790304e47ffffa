"""Per-process liveness files: how a supervisor tells "slow" from "hung".

A copy of the JAX package's ``resilience/heartbeat.py`` (not an import: the port imports
nothing of the JAX package), with its file names and its beat's JSON schema, so either
package's supervisor reads either package's beats. Every trainer process with
``--heartbeat-dir`` writes one small JSON file per epoch tick, ``heartbeat_p{i}.json``,
holding ``process_index``, ``pid``, ``step``, ``epoch``, ``status``, ``time`` and, under
``--guard``, the parameter ``fingerprint``, atomically (tmp + rename, so a reader never
sees a torn beat). A process whose last beat (or, before its first, the fleet's start) is
older than the staleness timeout is hung; a slow one keeps beating. The supervisor
(``resilience/supervisor.py``) reads the beats (``stale_processes``), compares their
fingerprints (``fingerprint_mismatch``) and clears them at each attempt (``clear``).
"""

from __future__ import annotations

import glob
import json
import os
import time

STATUS_RUNNING = "running"
STATUS_PREEMPTED = "preempted"


def heartbeat_path(dir_path: str, process_index: int) -> str:
    return os.path.join(dir_path, f"heartbeat_p{process_index}.json")


def _atomic_write_text(path: str, text: str) -> None:
    # the checkpoint writer's tmp + rename, kept here so that a supervisor reading beats
    # imports nothing that touches the device
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


class HeartbeatWriter:
    """One process's beat emitter. Construct once (per-process, NOT process-0 gated —
    every fleet member's liveness matters), call :meth:`beat` from the epoch loop."""

    def __init__(self, dir_path: str, *, process_index: int = 0):
        self.dir_path = dir_path
        self.process_index = int(process_index)
        self.path = heartbeat_path(dir_path, self.process_index)

    def beat(self, *, step: int, epoch: int, status: str = STATUS_RUNNING,
             fingerprint: float | None = None) -> None:
        doc = {
            "process_index": self.process_index,
            "pid": os.getpid(),
            "step": int(step),
            "epoch": int(epoch),
            "status": status,
            "time": time.time(),
        }
        if fingerprint is not None:
            # The cross-replica state fingerprint (--guard trainers): a cheap
            # host-local per-leaf float-sum of the params at this step. Every
            # process derives it from state that SPMD replication promises is
            # identical — the supervisor's fingerprint-verify mode compares
            # beats at the same step, and a mismatch is silent divergence
            # (SDC, desync): the fleet is torn down and rolled back strictly
            # past the mismatch step, so the diverged (already-durable)
            # checkpoint is never resumed as truth.
            doc["fingerprint"] = float(fingerprint)
        _atomic_write_text(self.path, json.dumps(doc))


def read_heartbeats(dir_path: str) -> dict[int, dict]:
    """All readable beats in ``dir_path``, keyed by process index. Torn/absent files
    are skipped (atomic writes make torn reads a non-event, but a dying writer can
    leave a stale ``.tmp`` behind — never counted)."""
    beats: dict[int, dict] = {}
    for path in glob.glob(os.path.join(dir_path, "heartbeat_p*.json")):
        try:
            with open(path) as f:
                b = json.load(f)
            beats[int(b["process_index"])] = b
        except (OSError, ValueError, KeyError):
            continue
    return beats


def stale_processes(dir_path: str, *, num_processes: int, timeout_s: float,
                    since: float, now: float | None = None) -> list[int]:
    """Process indices whose liveness signal is older than ``timeout_s``.

    ``since`` is the fleet's start wall-clock time (``time.time()`` domain — beats
    carry wall time, not the monotonic clock): a process that has not beaten *yet* is
    measured from fleet start, so slow startup gets the same grace as a slow epoch,
    and beats left by a previous attempt (cleared by the supervisor anyway) can never
    vouch for the current one."""
    now = time.time() if now is None else now
    beats = read_heartbeats(dir_path)
    stale = []
    for i in range(num_processes):
        t = beats[i]["time"] if i in beats and beats[i]["time"] >= since else since
        if now - t > timeout_s:
            stale.append(i)
    return stale


def fingerprint_mismatch(dir_path: str) -> dict | None:
    """Cross-replica state-divergence check over the latest beats: processes
    reporting a fingerprint AT THE SAME STEP must agree bitwise (the params
    they fingerprint are replicated by construction). Returns
    ``{"step": s, "fingerprints": {proc: fp, ...}}`` for the first step where
    two processes disagree, else None. Beats at different steps are never
    compared — an epoch-boundary skew between peers is normal pipelining, not
    divergence."""
    by_step: dict[int, dict[int, float]] = {}
    for i, b in read_heartbeats(dir_path).items():
        if b.get("fingerprint") is None or b.get("step") is None:
            continue
        by_step.setdefault(int(b["step"]), {})[i] = float(b["fingerprint"])
    for step in sorted(by_step):
        fps = by_step[step]
        if len(fps) >= 2 and len(set(fps.values())) > 1:
            return {"step": step, "fingerprints": fps}
    return None


def clear(dir_path: str, process_index: int | None = None) -> None:
    """Drop beat (and stray tmp) files — the supervisor calls this at attempt
    start so a restarted fleet is judged only on its own signals.
    ``process_index`` restricts the sweep to ONE process's files: the serving
    router restarts replicas individually, and wiping a healthy peer's beat
    would make it look newborn (or, worse, hung) to the next staleness check."""
    pattern = (f"heartbeat_p{process_index}.json*" if process_index is not None
               else "heartbeat_p*.json*")
    for path in glob.glob(os.path.join(dir_path, pattern)):
        try:
            os.remove(path)
        except OSError:
            pass
