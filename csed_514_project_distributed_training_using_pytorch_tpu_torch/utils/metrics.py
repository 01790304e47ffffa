"""Metric history + stdout reporting, with the JAX package's line formats.

Counterpart of the JAX package's ``utils/metrics.py``: the loss trajectories, the
every-``log_interval`` train progress line, the post-eval test summary, and the
``metrics.jsonl`` artifact. The lines are character for character the JAX package's.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field


@dataclass
class MetricsHistory:
    """Loss trajectories, plus the wall seconds of each training epoch."""

    train_losses: list = field(default_factory=list)
    train_counter: list = field(default_factory=list)   # examples seen at each train point
    test_losses: list = field(default_factory=list)
    test_counter: list = field(default_factory=list)    # examples seen at each eval point
    epoch_seconds: list = field(default_factory=list)   # device-synced wall time per epoch

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


class Stopwatch:
    """Wall-clock since construction."""

    def __init__(self):
        self.t0 = time.time()

    def elapsed(self) -> float:
        return time.time() - self.t0


def log(msg: str) -> None:
    print(msg, flush=True)


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
