"""Rollback-and-skip vocabulary: the typed exit, the skip-window grammar, the marker.

A copy of the pure-Python pieces of the JAX package's ``resilience/poison.py`` (not an
import: the port imports nothing of the JAX package). A failure of the math itself — a
non-finite loss, a gradient spike — needs a recovery that does not replay the offending
*step window*, because replaying it reproduces the poison (the data order is a pure
function of seed and step). This module holds the contract both the trainers and a
supervisor agree on:

- ``EXIT_POISONED`` (65, BSD's ``EX_DATAERR``): the trainer's exit when its anomalies reach
  ``--anomaly-exit``;
- ``Poisoned``: the in-process form (the epoch loops raise it; ``__main__`` exits 65),
  carrying the step window to skip on replay;
- the ``--skip-steps`` grammar ``"a:b[,c:d...]"`` (half-open windows): ``parse_skip_steps``
  and ``format_skip_steps``, and ``merge_windows``, a supervisor's escalation arithmetic
  (an overlapping window widens the union by the new window's length; a disjoint one is
  appended);
- the marker ``poison.json`` in the checkpoint store: how the stopping trainer hands its
  window on, written by the logging process, read (and removed) by the supervisor.
"""

from __future__ import annotations

import json
import os
import time

#: Exit status of a trainer whose training-step anomalies reached its ``--anomaly-exit``
#: policy (EX_DATAERR).
EXIT_POISONED = 65

MARKER_NAME = "poison.json"


class Poisoned(RuntimeError):
    """Raised at the epoch boundary where the anomaly count reached ``--anomaly-exit``.
    Carries the global step the run stopped at and the half-open ``[lo, hi)`` step window
    its detector blames."""

    def __init__(self, step: int, window: tuple[int, int]):
        self.step = int(step)
        self.window = (int(window[0]), int(window[1]))
        super().__init__(f"training poisoned at step {step} "
                         f"(anomaly window {self.window[0]}:{self.window[1]})")


def parse_skip_steps(spec: str) -> tuple[tuple[int, int], ...]:
    """``"a:b[,c:d...]"`` -> sorted tuple of half-open ``(lo, hi)`` windows; ``""`` -> ``()``.
    A malformed window raises: a mistyped skip set must fail the restart loudly."""
    if not spec:
        return ()
    windows = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        lo, sep, hi = part.partition(":")
        if not sep:
            raise ValueError(f"skip window {part!r} is not of the form a:b")
        lo_i, hi_i = int(lo), int(hi)
        if lo_i < 0 or hi_i <= lo_i:
            raise ValueError(f"skip window {part!r} must satisfy 0 <= a < b")
        windows.append((lo_i, hi_i))
    return tuple(sorted(windows))


def format_skip_steps(windows) -> str:
    """Inverse of ``parse_skip_steps``."""
    return ",".join(f"{lo}:{hi}" for lo, hi in sorted(windows))


def merge_windows(existing, new: tuple[int, int]):
    """Fold a fresh poison window into the accumulated skip set; returns
    ``(windows, widened)``. Overlap with (or adjacency to) an existing window means the
    earlier skip missed the poison: the union is extended by the new window's length. A
    disjoint window is appended unchanged."""
    lo, hi = int(new[0]), int(new[1])
    merged = []
    widened = False
    for (elo, ehi) in existing:
        if ehi >= lo and elo <= hi:        # overlap or adjacency
            lo, hi = min(elo, lo), max(ehi, hi)
            widened = True
        else:
            merged.append((elo, ehi))
    if widened:
        hi += max(int(new[1]) - int(new[0]), 1)
    merged.append((lo, hi))
    return tuple(sorted(merged)), widened


def _atomic_write_text(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def write_marker(store_dir: str, *, window: tuple[int, int], step: int,
                 anomalies: int) -> str:
    """Write the poison marker into ``store_dir`` (temporary file, then rename). The
    caller gates it to the logging process."""
    path = os.path.join(store_dir, MARKER_NAME)
    _atomic_write_text(path, json.dumps({
        "window": [int(window[0]), int(window[1])],
        "step": int(step),
        "anomalies": int(anomalies),
        "unix_time": time.time(),
    }))
    return path


def read_marker(store_dir: str, *, consume: bool = True) -> dict | None:
    """Read (and by default remove: a marker vouches only for the exit that wrote it) the
    poison marker; None when it is absent or unreadable."""
    path = os.path.join(store_dir, MARKER_NAME)
    try:
        with open(path) as f:
            marker = json.load(f)
    except (OSError, ValueError):
        return None
    if consume:
        try:
            os.remove(path)
        except OSError:
            pass
    if not isinstance(marker.get("window"), list) or len(marker["window"]) != 2:
        return None
    marker["window"] = (int(marker["window"][0]), int(marker["window"][1]))
    return marker
