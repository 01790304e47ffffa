"""Metric history + stdout reporting, with the JAX package's line formats.

Counterpart of the JAX package's ``utils/metrics.py``: the loss trajectories, the
every-``log_interval`` train progress line, the post-eval test summary, the data-parallel
epoch summary, the ``metrics.jsonl`` artifact (and its reader, ``load_metrics_jsonl``) and
the host-fed loops' live progress bar.
The lines are character for character the JAX package's, and only rank 0 of a process
group prints them.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

import torch.distributed as dist


@dataclass
class MetricsHistory:
    """Loss trajectories, plus the wall seconds of each training epoch."""

    train_losses: list = field(default_factory=list)
    train_counter: list = field(default_factory=list)   # examples seen at each train point
    test_losses: list = field(default_factory=list)
    test_counter: list = field(default_factory=list)    # examples seen at each eval point
    epoch_seconds: list = field(default_factory=list)   # device-synced wall time per epoch
    data_wait_seconds: list = field(default_factory=list)  # host-fed epochs: seconds the
                                                        # loop waited on the loader

    def record_train(self, examples_seen: int, loss: float) -> None:
        self.train_counter.append(int(examples_seen))
        self.train_losses.append(float(loss))

    def record_test(self, examples_seen: int, loss: float) -> None:
        self.test_counter.append(int(examples_seen))
        self.test_losses.append(float(loss))


def _atomic_write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_metrics_jsonl(history: MetricsHistory, path: str) -> str:
    """One JSON line per recorded metric point
    (``{"kind": "train"|"test", "examples_seen": N, "loss": L}``), written atomically
    (tmp + rename). A non-finite loss is written as null (strict JSON)."""

    def finite(l):
        return l if math.isfinite(l) else None

    rows = ([{"kind": "train", "examples_seen": e, "loss": finite(l)}
             for e, l in zip(history.train_counter, history.train_losses)]
            + [{"kind": "test", "examples_seen": e, "loss": finite(l)}
               for e, l in zip(history.test_counter, history.test_losses)])
    payload = "".join(json.dumps(row, allow_nan=False) + "\n" for row in rows)
    _atomic_write(path, payload.encode())
    return path


def load_metrics_jsonl(path: str) -> list[dict]:
    """Read-side inverse of ``save_metrics_jsonl``, and the one reader of every JSONL this
    repo writes (the telemetry stream, the serving logs): one dict per non-blank line,
    unknown event kinds passed through, a torn final line skipped
    (``utils.jsonl.read_jsonl``)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
        read_jsonl,
    )

    return read_jsonl(path)


class Stopwatch:
    """Wall-clock since construction."""

    def __init__(self):
        self.t0 = time.time()

    def elapsed(self) -> float:
        return time.time() - self.t0


def is_logging_process() -> bool:
    """Output is rank-0 gated, so a world of N processes prints each line once: the rank
    of the process group when one is up, else the ``RANK`` a launcher handed this process
    (0 when there is none)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return int(os.environ.get("RANK", "0")) == 0


def log(msg: str) -> None:
    if is_logging_process():
        print(msg, flush=True)


class ProgressBar:
    """Live per-batch progress display: the reference's tqdm bars
    (``src/train_dist.py:76,96``) as a first-party, dependency-free counterpart of the JAX
    package's.

    Only the host-fed loops (``--use-host-pipeline``, ``--host-local-feed``) drive it, where
    a per-step dispatch already exists; it never forces a device sync. Rendering is
    rate-limited (``min_interval_s``), rank-0 gated and tty-gated: piped output gets
    nothing, so logs stay byte-identical to the JAX package's.
    """

    def __init__(self, total: int, desc: str = "", *, stream=None,
                 min_interval_s: float = 0.1, width: int = 24):
        self.total = max(1, int(total))
        self.desc = desc
        self.n = 0
        self._stream = sys.stderr if stream is None else stream
        self._min_interval = min_interval_s
        self._width = width
        self._last_render = 0.0
        self._t0 = time.time()
        self._enabled = (is_logging_process()
                         and bool(getattr(self._stream, "isatty", lambda: False)()))
        self._open_line = False
        self._last_len = 0

    def update(self, n: int = 1, loss: float | None = None) -> None:
        self.n += n
        if not self._enabled:
            return
        now = time.time()
        if self.n < self.total and now - self._last_render < self._min_interval:
            return
        self._last_render = now
        filled = self._width * self.n // self.total
        bar = "#" * filled + "-" * (self._width - filled)
        rate = self.n / max(now - self._t0, 1e-9)
        extra = f" loss={loss:.4f}" if loss is not None else ""
        line = f"{self.desc}[{bar}] {self.n}/{self.total} {rate:.1f}it/s{extra}"
        # pad to the previous render's length: a shorter line must not leave stale
        # characters behind on the terminal
        pad = " " * max(0, self._last_len - len(line))
        self._last_len = len(line)
        self._stream.write(f"\r{line}{pad}")
        self._stream.flush()
        self._open_line = True

    def close(self) -> None:
        """Finish the in-place line so that the next log line starts clean."""
        if self._enabled and self._open_line:
            self._stream.write("\n")
            self._stream.flush()
            self._open_line = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def train_progress_line(epoch: int, examples_seen: int, dataset_size: int,
                        loss: float) -> str:
    """Per-log-interval progress line."""
    pct = 100.0 * examples_seen / dataset_size
    return (f"Train Epoch: {epoch} [{examples_seen}/{dataset_size} ({pct:.0f}%)]"
            f"\tLoss: {loss:.6f}")


def test_summary_line(avg_loss: float, correct: int, total: int,
                      elapsed_s: float) -> str:
    """Post-eval summary: avg loss = summed NLL / split size, argmax accuracy, elapsed
    seconds."""
    pct = 100.0 * correct / total
    return (f"\nTest set: Avg. loss: {avg_loss:.4f}, "
            f"Accuracy: {correct}/{total} ({pct:.0f}%), "
            f"Time elapsed: {elapsed_s:.2f}s\n")


def dist_epoch_summary_line(epoch: int, train_loss: float, val_loss: float,
                            accuracy: float, elapsed_s: float) -> str:
    """The data-parallel trainer's per-epoch summary."""
    return (f"Epoch {epoch}: train_loss: {train_loss:.4f}, val_loss: {val_loss:.4f}, "
            f"accuracy: {accuracy:.4f}, time_elapsed: {elapsed_s:.2f}s")
