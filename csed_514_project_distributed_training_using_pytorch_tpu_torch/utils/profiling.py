"""Optional profiling: a ``torch.profiler`` trace of a run, and named regions in it.

Counterpart of the JAX package's ``utils/profiling.py`` (``jax.profiler`` there): an
opt-in trace behind ``--profile``, which costs nothing when off. On a CUDA device the trace
holds the card's kernels and the host's launch calls; it is written as a Chrome trace
(viewable in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import metrics

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def maybe_profile(enabled: bool, log_dir: str):
    """Trace the enclosed block into ``log_dir/trace.json`` when ``enabled``. Rank-0 gated
    (one trace per run), creates ``log_dir``, and logs the trace's path."""
    if not enabled or not metrics.is_logging_process():
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, TRACE_NAME)
    prof.export_chrome_trace(path)
    metrics.log(f"Saved profiler trace to {path}")


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the trace (``record_function``). Never opened while the current
    stream is capturing a CUDA graph: the region would be recorded once at capture and
    never for a replay, so there the block runs unannotated."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        yield
        return
    with record_function(name):
        yield
