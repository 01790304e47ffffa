"""Supervised fault-tolerant fleets: crash detection, checkpoint-restart, backoff, and
rollback-and-skip.

The port's counterpart of the JAX package's ``resilience/supervisor.py``, with its
configuration, result, classification, events and messages:

1. **spawn** the fleet (``train.launch.Fleet``: every child a ``subprocess`` running
   ``python <command>`` with the launcher's rendezvous environment);
2. **watch** it: the first nonzero child exit tears the fleet down at once (fail-fast),
   and heartbeat staleness (``resilience/heartbeat.py``) catches the hang that has no exit
   code;
3. **classify**: 0 done; ``EXIT_PREEMPTED`` (75) a cooperative stop, resumable, returned
   without spending a retry; ``EXIT_POISONED`` (65) the guard's ``--anomaly-exit``; a
   cross-replica fingerprint mismatch in the heartbeats (fingerprint-verify mode)
   "desync"; anything else a crash;
4. **restart** a crashed or hung fleet from the newest healthy checkpoint
   (``utils.checkpoint.newest_healthy_checkpoint``: health-stamped clean before merely
   valid, checksums verified against the manifest, so a torn write is skipped, never
   loaded), appending ``--resume-from``, with bounded retries and exponential backoff;
5. **rollback-and-skip** a poisoned fleet: read the trainer's poison marker
   (``resilience/poison.py``), fold its window into the skip set and restart with
   ``--skip-steps``; poison overlapping a skipped window widens it, and scattered poison
   arms fingerprint verification.

The supervisor never touches the card: it imports nothing that initialises CUDA (not even
``torch`` when it is imported; the checkpoint scan imports the port's checkpoint module
lazily, which imports ``torch`` and reads files only), and its children own the device.
Its telemetry is ``utils.jsonl.JsonlWriter``'s JSONL with the JAX package's ``restart``
and ``supervise_summary`` events, which ``obs.goodput`` joins with the trainers' streams.

CLI: ``python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.fleet_supervise``.
"""

from __future__ import annotations

import dataclasses
import signal
import time

from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
    heartbeat as hb,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
    poison as poison_mod,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience.poison import (
    EXIT_POISONED,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience.preemption import (
    EXIT_PREEMPTED, PreemptionHandler,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.launch import Fleet
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
    JsonlWriter,
)

#: SuperviseResult.exit_code when the fleet was torn down by the supervisor itself
#: (hang / attempt timeout): 128+SIGTERM, the shell's convention for a terminated
#: process — the children had no exit code of their own to report.
EXIT_TORN_DOWN = 143


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Supervision knobs (the fleet-shape fields mirror ``train.launch``)."""

    num_processes: int = 2
    port: int | None = None
    max_restarts: int = 3             # restarts, not attempts: N+1 runs max
    backoff_s: float = 1.0            # exponential: backoff_s * 2**restart, capped
    backoff_max_s: float = 30.0
    checkpoint_dir: str = ""          # versioned store (utils.checkpoint manifest) to
    #                                   resume from; "" = restart from scratch
    heartbeat_dir: str = ""           # fleet liveness files; auto-appended to the
    #                                   child command when set ("" = no hang watch)
    heartbeat_timeout_s: float = 0.0  # beat staleness that counts as hung; 0 off
    attempt_timeout_s: float = 0.0    # wall-clock bound per attempt; 0 = unbounded
    preempt_grace_s: float = 120.0    # drain window after a preemption before the
    #                                   teardown SIGKILL escalation: latched peers
    #                                   are finishing an epoch + final checkpoint,
    #                                   which dwarfs the crash-straggler grace
    telemetry: str = ""               # supervisor JSONL (restart events); "" off
    fingerprint_verify: bool = False  # compare cross-replica heartbeat param
    #                                   fingerprints (a mismatch at the same step
    #                                   is "desync" — silent state divergence);
    #                                   auto-armed when poison lands at scattered
    #                                   steps, settable up front for paranoia
    poll_s: float = 0.05


@dataclasses.dataclass
class SuperviseResult:
    status: str                       # "ok" | "preempted" | "failed"
    exit_code: int                    # 0 | EXIT_PREEMPTED | child rc | EXIT_TORN_DOWN
    attempts: int
    restarts: int
    resume_history: list              # checkpoint path (or None) each attempt resumed from
    skip_windows: tuple = ()          # accumulated rollback-and-skip step windows
    rollbacks: int = 0                # restarts caused by poison/desync (not crashes)


# The supervisor's telemetry writer is the plain JSONL appender, not
# utils.telemetry.TelemetryWriter (rank-gated, and it imports torch): same line schema.
_JsonlWriter = JsonlWriter


def _newest_healthy(checkpoint_dir: str,
                    before_step: int | None = None) -> str | None:
    """The ONE resume-scan owner for every supervised restart path: prefers a
    health-stamped-CLEAN checkpoint over a merely-valid one (the old
    ``_newest_valid`` trusted the newest decodable checkpoint even if the run
    that wrote it was already diverging — exactly the state a rollback must
    not land on; regression-pinned in tests/test_anomaly.py). ``before_step``
    is the desync bound: a fingerprint mismatch at step S indicts the step-S
    checkpoint — durable and clean-STAMPED, because per-process anomaly
    counters cannot see cross-replica divergence — so that rollback must land
    strictly before it."""
    if not checkpoint_dir:
        return None
    # Lazy: utils.checkpoint imports torch; the supervisor pays that (an import, never a
    # device) only when it has a checkpoint store to scan.
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.checkpoint import (
        newest_healthy_checkpoint,
    )
    return newest_healthy_checkpoint(checkpoint_dir, before_step=before_step)


def _cursor_for(path: str | None) -> dict | None:
    """The input-stream resume cursor the chosen checkpoint's manifest entry
    carries (``data/stream.py``-fed trainers key it in at save time): put it
    on the restart event so the stream alone answers WHERE the next attempt
    resumes in the data order, not just which file it restores."""
    if not path:
        return None
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.checkpoint import (
        cursor_for,
    )
    try:
        return cursor_for(path)
    except Exception:
        return None


def _sleep_interruptible(seconds: float, handler: PreemptionHandler) -> None:
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline and not handler.requested:
        time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))


def supervise(command: list[str], cfg: SupervisorConfig = SupervisorConfig(), *,
              env: dict | None = None) -> SuperviseResult:
    """Run ``python <command>`` as a supervised ``cfg.num_processes``-wide fleet until
    it completes, is preempted, or exhausts its restart budget. ``env`` is the children's
    base environment (default: this process's).

    The supervisor latches SIGTERM/SIGINT itself and forwards SIGTERM to the fleet:
    preempting the supervisor preempts the run (children with ``--handle-preemption``
    stop at their next epoch boundary and exit 75)."""
    tele = _JsonlWriter(cfg.telemetry) if cfg.telemetry else None
    handler = PreemptionHandler().install()
    attempts = restarts = rollbacks = 0
    resume_history: list = []
    status, exit_code = "failed", 1
    # Accumulated rollback-and-skip set — SEEDED from any --skip-steps the
    # caller already put on the command (argparse last-occurrence-wins means
    # the appended flag REPLACES the original: without the seed, the first
    # poisoned restart would silently drop the user's known-bad windows).
    skip_windows: tuple = ()
    for i, arg in enumerate(command):
        if arg == "--skip-steps" and i + 1 < len(command):
            skip_windows = poison_mod.parse_skip_steps(command[i + 1])
        elif arg.startswith("--skip-steps="):
            skip_windows = poison_mod.parse_skip_steps(
                arg.split("=", 1)[1])
    desync_bound: int | None = None       # mismatch step: that checkpoint is
    #                                       indicted; roll back strictly past it
    fingerprint_verify = cfg.fingerprint_verify
    scanned_resume: str | None = None     # restart path pre-scans for its log line;
    have_scanned = False                  # the next attempt reuses it (the store
    #                                       cannot change while the fleet is dead)
    try:
        while True:
            attempts += 1
            resume = (scanned_resume if have_scanned
                      else _newest_healthy(cfg.checkpoint_dir))
            have_scanned = False
            resume_history.append(resume)
            cmd = list(command)
            if resume:
                cmd += ["--resume-from", resume]     # last occurrence wins in argparse
            if skip_windows:
                cmd += ["--skip-steps",
                        poison_mod.format_skip_steps(skip_windows)]
            if cfg.heartbeat_dir:
                hb.clear(cfg.heartbeat_dir)
                if "--heartbeat-dir" not in cmd:
                    cmd += ["--heartbeat-dir", cfg.heartbeat_dir]
            started_mono, started_wall = time.monotonic(), time.time()
            fleet = Fleet(cmd, num_processes=cfg.num_processes, port=cfg.port, env=env)
            reason: str | None = None
            rc = 0
            forwarded = False
            # Staleness checks glob + JSON-parse every beat file — throttle them to
            # a fraction of the timeout instead of every poll_s iteration.
            hb_interval = max(1.0, cfg.heartbeat_timeout_s / 10)
            next_hb_check = started_mono
            try:
                while True:
                    first_rc = fleet.poll()
                    if handler.requested and not forwarded:
                        fleet.send_signal(signal.SIGTERM)
                        forwarded = True
                    if first_rc is not None:
                        rc = first_rc
                        reason = ("preempted" if rc == EXIT_PREEMPTED
                                  else "poisoned" if rc == EXIT_POISONED
                                  else "crash")
                        if reason == "preempted":
                            # Peers are latched and still finishing their epoch +
                            # final checkpoint; drain before teardown's SIGKILL
                            # escalation can cost them the durable checkpoint.
                            drain = time.monotonic() + cfg.preempt_grace_s
                            while fleet.running and time.monotonic() < drain:
                                time.sleep(cfg.poll_s)
                        break
                    if not fleet.running:
                        # Re-poll before declaring success: exits can land between
                        # the poll above and the running check (e.g. every worker
                        # crashing at the same fault step).
                        final_rc = fleet.poll()
                        if final_rc is not None:
                            rc = final_rc
                            reason = ("preempted" if rc == EXIT_PREEMPTED
                                      else "poisoned" if rc == EXIT_POISONED
                                      else "crash")
                        else:
                            reason = "ok"
                        break
                    if (cfg.heartbeat_dir
                            and (fingerprint_verify
                                 or cfg.heartbeat_timeout_s > 0)
                            and time.monotonic() >= next_hb_check):
                        next_hb_check = time.monotonic() + hb_interval
                        if fingerprint_verify:
                            # Fingerprint-verify mode: replicas reporting a
                            # param fingerprint at the SAME step must agree
                            # bitwise — disagreement is silent state
                            # divergence (SDC, desync), torn down BEFORE the
                            # diverged state can be checkpointed as truth.
                            # Shares the heartbeat throttle; armed even with
                            # the staleness timeout off.
                            mismatch = hb.fingerprint_mismatch(
                                cfg.heartbeat_dir)
                            if mismatch is not None:
                                print(f"[supervisor] fingerprint mismatch at "
                                      f"step {mismatch['step']}: "
                                      f"{mismatch['fingerprints']}", flush=True)
                                # The state AT the mismatch step is the
                                # diverged one — its checkpoint is already
                                # durable and clean-stamped (per-process
                                # counters cannot see divergence), so the
                                # rollback must land strictly before it.
                                desync_bound = int(mismatch["step"])
                                rc, reason = EXIT_TORN_DOWN, "desync"
                                break
                        if cfg.heartbeat_timeout_s > 0:
                            stale = hb.stale_processes(
                                cfg.heartbeat_dir,
                                num_processes=cfg.num_processes,
                                timeout_s=cfg.heartbeat_timeout_s,
                                since=started_wall)
                            if stale:
                                rc, reason = EXIT_TORN_DOWN, "hung"
                                break
                    if (cfg.attempt_timeout_s > 0
                            and time.monotonic() - started_mono > cfg.attempt_timeout_s):
                        rc, reason = EXIT_TORN_DOWN, "timeout"
                        break
                    time.sleep(cfg.poll_s)
            finally:
                fleet.terminate()     # fail-fast teardown: never leave peers hanging
            if reason == "ok":
                status, exit_code = "ok", 0
                break
            if reason == "preempted" or (handler.requested
                                         and reason in ("crash", "poisoned")):
                # A preemption signal can also surface as teardown collateral on
                # peers; the supervisor's own latch disambiguates.
                status, exit_code = "preempted", EXIT_PREEMPTED
                break
            if restarts >= cfg.max_restarts:
                status, exit_code = "failed", rc
                break
            backoff = (min(cfg.backoff_s * (2 ** restarts), cfg.backoff_max_s)
                       if cfg.backoff_s > 0 else 0.0)
            restarts += 1
            escalation = ""
            if reason in ("poisoned", "desync"):
                rollbacks += 1
            if reason == "poisoned":
                # Rollback-and-skip: fold the dying trainer's poison window
                # into the skip set. Overlap with an already-skipped window
                # means the skip was too narrow — auto-widen; a disjoint
                # window next to an existing set is SCATTERED poison, which
                # smells like silent corruption, not one bad batch —
                # escalate to cross-replica fingerprint verification.
                marker = poison_mod.read_marker(cfg.checkpoint_dir)
                if marker is not None:
                    had_windows = bool(skip_windows)
                    skip_windows, widened = poison_mod.merge_windows(
                        skip_windows, marker["window"])
                    if widened:
                        escalation = "widened skip"
                    elif had_windows and not fingerprint_verify:
                        # Scattered poison: escalate to cross-replica state
                        # verification — which needs the heartbeat channel to
                        # carry fingerprints. Without one the mode would be a
                        # silent no-op, so say so instead of claiming it.
                        if cfg.heartbeat_dir:
                            fingerprint_verify = True
                            escalation = "fingerprint-verify armed"
                        else:
                            escalation = ("fingerprint-verify unavailable "
                                          "(no heartbeat dir)")
            next_resume = _newest_healthy(
                cfg.checkpoint_dir,
                before_step=desync_bound if reason == "desync" else None)
            desync_bound = None
            scanned_resume, have_scanned = next_resume, True
            if tele:
                tele.emit({"event": "restart", "attempt": attempts,
                           "restart": restarts, "reason": reason, "exit_code": rc,
                           "resume_from": next_resume or "",
                           "cursor": _cursor_for(next_resume),
                           "skip":
                           poison_mod.format_skip_steps(skip_windows),
                           "rollback": reason in ("poisoned", "desync"),
                           "backoff_s": backoff, "unix_time": time.time()})
            print(f"[supervisor] attempt {attempts} {reason} (exit {rc}); "
                  f"restart {restarts}/{cfg.max_restarts} in {backoff:.1f}s"
                  + (f" from {next_resume}" if next_resume else " from scratch")
                  + (f" skipping {poison_mod.format_skip_steps(skip_windows)}"
                     if skip_windows else "")
                  + (f" [{escalation}]" if escalation else ""),
                  flush=True)
            _sleep_interruptible(backoff, handler)
            if handler.requested:
                status, exit_code = "preempted", EXIT_PREEMPTED
                break
    finally:
        handler.uninstall()
        if tele:
            tele.emit({"event": "supervise_summary", "status": status,
                       "exit_code": exit_code, "attempts": attempts,
                       "restarts": restarts, "rollbacks": rollbacks,
                       "skip": poison_mod.format_skip_steps(skip_windows),
                       "unix_time": time.time()})
            tele.close()
    return SuperviseResult(status=status, exit_code=exit_code, attempts=attempts,
                           restarts=restarts, resume_history=resume_history,
                           skip_windows=skip_windows, rollbacks=rollbacks)
