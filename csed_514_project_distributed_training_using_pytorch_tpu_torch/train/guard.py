"""Host side of the numerical guard, shared by the trainers.

Counterpart of the JAX package's ``train/guard.py``. The guard itself lives in the step
(``train/step.py``: the verdict and the identity update are device tensor ops, no host
sync). What the host does, at each epoch boundary:

- fetch ``state.guard`` once (the epoch's sanctioned fetch) and compute this process's
  parameter fingerprint (``utils.telemetry.param_fingerprint``, host-local);
- build the health stamp (``epoch_end`` returns it), which the trainers write into the
  versioned store's manifest (``utils.checkpoint.save_versioned(health=...)``) under
  ``--keep-checkpoints``, and the 'anomaly' telemetry event when a writer is given;
- enforce ``--anomaly-exit``: once this attempt has detected that many anomalies, write
  the poison marker and raise ``resilience.poison.Poisoned`` with the step window to skip.
"""

from __future__ import annotations

import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
    poison,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
    GuardSpec,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    metrics as M,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    telemetry as T,
)


def _host(guard_state):
    """The guard's nine counters as Python numbers (one device fetch)."""
    values = torch.stack([t.double() for t in guard_state]).tolist()
    return type(guard_state)(*(v if t.is_floating_point() else int(v)
                               for v, t in zip(values, guard_state)))


class GuardRuntime:
    """One run's guard bookkeeping. Construct it unconditionally: with ``--guard`` off
    every method returns at once."""

    def __init__(self, config, *, store_dir: str = "", tele=None):
        self.enabled = bool(getattr(config, "guard", False))
        self.tele = tele                        # a TelemetryWriter: the 'anomaly' event
        self.skip = getattr(config, "skip_steps", "")
        self.spec = None
        if self.enabled:
            self.spec = GuardSpec(zscore=config.guard_zscore,
                                  skip=poison.parse_skip_steps(config.skip_steps))
        self.anomaly_exit = int(getattr(config, "anomaly_exit", 0))
        self.store_dir = store_dir
        self.fingerprint: float | None = None   # latest epoch-boundary value
        self.last = None                        # latest host GuardState
        self._base_anoms = 0                    # attempt-start anomaly counter
        self._base_first = -1                   # attempt-start first-anomaly step
        self._prev_anoms = 0                    # previous boundary's counter (stamp)
        self._attempt_lo: int | None = None     # first new anomaly's lower bound

    def baseline(self, state) -> None:
        """Call once before training: the state's counters are this attempt's zero
        point."""
        if not self.enabled:
            return
        gh = _host(state.guard)
        self._base_anoms = self._prev_anoms = int(gh.anomalies)
        self._base_first = int(gh.first_anomaly_step)

    def epoch_end(self, state, epoch: int, steps: int) -> dict | None:
        """The epoch boundary: fetch the counters, compute the fingerprint, and return the
        health stamp (None with the guard off)."""
        if not self.enabled:
            return None
        gh = _host(state.guard)
        self.last = gh
        self.fingerprint = T.param_fingerprint(state.params)
        step = int(state.step)
        anoms = int(gh.anomalies)
        if anoms > self._prev_anoms and self._attempt_lo is None:
            # the first epoch of this attempt with a fresh anomaly pins the window's lower
            # bound: first_anomaly_step when this attempt set it, else the epoch's first
            # step (a wider window, never a hole)
            first = int(gh.first_anomaly_step)
            if first >= 0 and first != self._base_first:
                self._attempt_lo = first
            else:
                self._attempt_lo = max(step - int(steps), 0)
        stamp = {"clean": anoms == self._prev_anoms, "anomalies": anoms,
                 "skipped": int(gh.skipped), "step": step, "fingerprint": self.fingerprint}
        if self.tele is not None:
            self.tele.emit(T.anomaly_event(epoch, gh, steps, fingerprint=self.fingerprint,
                                           skip=self.skip))
        self._prev_anoms = anoms
        return stamp

    def check_poisoned(self, state) -> None:
        """Enforce ``--anomaly-exit`` at the epoch boundary: write the poison marker (the
        logging process) naming this attempt's anomaly window and raise ``Poisoned``."""
        if not self.enabled or not self.anomaly_exit or self.last is None:
            return
        gh = self.last
        if int(gh.anomalies) - self._base_anoms < self.anomaly_exit:
            return
        last = int(gh.last_anomaly_step)
        first = last if self._attempt_lo is None else min(self._attempt_lo, last)
        window = (first, last + 1)
        if self.store_dir and M.is_logging_process():
            poison.write_marker(self.store_dir, window=window, step=int(state.step),
                                anomalies=int(gh.anomalies))
        raise poison.Poisoned(int(state.step), window)
