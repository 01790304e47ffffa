"""Resilience: supervised fleets, heartbeats, cooperative preemption, rollback-and-skip
and fault injection.

Counterpart of the JAX package's ``resilience/``: ``supervisor`` watches a fleet and
restarts it from the newest healthy checkpoint (or rolls it back past a poisoned window);
``heartbeat`` is the liveness signal that tells slow from hung; ``preemption`` turns
SIGTERM or SIGINT into a cooperative stop at an epoch boundary with a durable checkpoint
and a resumable exit status (75); ``poison`` is the guard's typed exit (65) and skip-window
grammar; ``faults`` injects each of those failures deterministically from
``RESILIENCE_FAULTS``, and ``netfaults`` the network's (``ChaosProxy``).

``RunHooks`` is the trainers' wiring: host-side epoch-boundary code only (a captured
segment is untouched), and with no heartbeat and no fault armed it reads nothing of the
state, so no step is fetched from the device.
"""

from __future__ import annotations

from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
    faults,
    heartbeat,
    poison,
    preemption,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience.poison import (
    EXIT_POISONED,
    Poisoned,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience.preemption import (
    EXIT_PREEMPTED,
    Preempted,
)

__all__ = ["EXIT_POISONED", "EXIT_PREEMPTED", "Poisoned", "Preempted", "RunHooks",
           "faults", "heartbeat", "poison", "preemption"]


class RunHooks:
    """One trainer's heartbeat ticks, fault ticks and preemption checks (the JAX package's
    ``RunHooks``). With ``heartbeat_dir`` empty, ``handle_preemption`` off and no
    ``RESILIENCE_FAULTS`` armed, every method returns without touching ``state``."""

    def __init__(self, *, heartbeat_dir: str = "", handle_preemption: bool = False,
                 process_index: int = 0):
        self.heartbeat = (heartbeat.HeartbeatWriter(heartbeat_dir,
                                                    process_index=process_index)
                          if heartbeat_dir else None)
        self.preemption = preemption.install() if handle_preemption else None

    def uninstall(self) -> None:
        """Restore the signal handlers (the trainers' teardown ``finally``), so that an
        in-process caller's SIGTERM and SIGINT outlive no run."""
        if self.preemption is not None:
            self.preemption.uninstall()

    @property
    def active(self) -> bool:
        return self.heartbeat is not None or faults.active()

    def epoch_tick(self, state, epoch: int, fingerprint: float | None = None) -> None:
        """At the top of each epoch: apply armed tick faults (``faults.on_tick``), then
        beat (with the previous boundary's parameter fingerprint under ``--guard``) unless
        a ``freeze`` fault holds. Fetches the step only when a heartbeat or a fault is
        armed."""
        if not self.active:
            return
        step = int(state.step)                  # one host sync, at the epoch boundary
        faults.on_tick(step=step, epoch=epoch)
        if self.heartbeat is not None and not faults.heartbeat_frozen(step=step,
                                                                      epoch=epoch):
            self.heartbeat.beat(step=step, epoch=epoch, fingerprint=fingerprint)

    def check_preempt(self, *, epoch: int, state, checkpoint: str = "", save=None,
                      tele=None) -> None:
        """Honour a pending preemption request at an epoch boundary: run ``save`` (for a
        trainer whose checkpoint is not already durable here), leave a final
        ``status=preempted`` beat, and raise ``Preempted``. A no-op when nothing was
        requested."""
        if self.preemption is None or not self.preemption.requested:
            return
        step = int(state.step)
        if save is not None:
            save()
        if self.heartbeat is not None:
            self.heartbeat.beat(step=step, epoch=epoch, status=heartbeat.STATUS_PREEMPTED)
        if tele is not None:            # a TelemetryWriter: the 'preempt' event
            from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
                telemetry,
            )
            tele.emit(telemetry.preempt_event(epoch=epoch, step=step, checkpoint=checkpoint))
        raise Preempted(step, checkpoint)
