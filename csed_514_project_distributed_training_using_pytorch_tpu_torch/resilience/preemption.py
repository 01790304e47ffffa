"""Cooperative preemption: SIGTERM/SIGINT → stop at the next epoch boundary.

Preemptible capacity is reclaimed with a signal and a grace window, not a negotiation.
The wrong response is to die mid-epoch — that wastes the whole partial epoch and leaves
whatever the signal happened to interrupt. The right response is the one implemented here:
the handler only *records* the request; the trainer checks it at the next epoch boundary
(after the per-epoch checkpoint is durable), flushes its saver, and exits with a distinct
status — ``EXIT_PREEMPTED`` (75,
BSD's ``EX_TEMPFAIL``: "transient failure, retry later") — that the supervisor and any
outer scheduler treat as *resumable*, not failed.

The handler is flag-gated (``--handle-preemption``) and installs nothing by default:
a signal then keeps its normal kill semantics. A copy of the JAX package's
``resilience/preemption.py`` (not an import: the port imports nothing of the JAX
package), with its exit status.
"""

from __future__ import annotations

import signal
import threading

#: Exit status of a run that stopped cooperatively after a preemption signal
#: (EX_TEMPFAIL). Distinct from crash codes so the supervisor can classify without
#: parsing logs.
EXIT_PREEMPTED = 75

DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class Preempted(RuntimeError):
    """Raised by a trainer at the epoch boundary that honors a preemption request.

    Carries what the outer layer needs to hand off: the global step the run stopped
    at and the checkpoint that step is durable in. ``__main__`` entrypoints convert
    it to ``SystemExit(EXIT_PREEMPTED)``; in-process callers (tests, notebooks) can
    catch it and keep the partial result."""

    def __init__(self, step: int, checkpoint: str = ""):
        self.step = int(step)
        self.checkpoint = checkpoint
        super().__init__(f"preempted at step {step}"
                         + (f" (checkpoint {checkpoint})" if checkpoint else ""))


class PreemptionHandler:
    """Installable stop-request latch. ``requested`` flips on the first signal and
    stays set; a second SIGINT restores the default handler and re-raises, so an
    interactive Ctrl-C Ctrl-C still hard-exits instead of trapping the user."""

    def __init__(self, signals=DEFAULT_SIGNALS):
        self.signals = tuple(signals)
        self._requested = threading.Event()
        self.signum: int | None = None
        self._old: dict[int, object] = {}
        self._counts: dict[int, int] = {}

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def _handle(self, signum, frame):
        self._counts[signum] = self._counts.get(signum, 0) + 1
        self.signum = signum
        self._requested.set()
        if signum == signal.SIGINT and self._counts[signum] > 1:
            signal.signal(signal.SIGINT, signal.default_int_handler)
            raise KeyboardInterrupt

    def install(self) -> "PreemptionHandler":
        """Install handlers (idempotent; previous handlers saved for uninstall).
        Signal handlers can only live in the main thread — elsewhere the handler
        degrades to an inert latch (``requested`` stays False) rather than failing
        the run it is supposed to protect."""
        for sig in self.signals:
            if sig in self._old:
                continue
            try:
                self._old[sig] = signal.signal(sig, self._handle)
            except ValueError:      # not the main thread
                break
        return self

    def uninstall(self) -> None:
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old)
            except (ValueError, TypeError):
                pass
        self._old.clear()

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


def install(signals=DEFAULT_SIGNALS) -> PreemptionHandler:
    """Convenience: construct + install in one call (the trainers' entry point)."""
    return PreemptionHandler(signals).install()
