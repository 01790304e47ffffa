"""Run-level observability: latency histograms, SLO attainment and goodput accounting.

The port's own copies of the JAX package's ``obs/hist.py`` (mergeable log-bucket
streaming histograms with a fixed relative error), ``obs/slo.py`` (SLO specs and the
attainment tracker), which the ``serving.Server`` front end reports through
``latency_histograms``, ``slo_summary`` and ``tenant_summaries``, and ``obs/goodput.py``
(the exclusive wall-time decomposition of a training run, joined from the trainers'
telemetry and the supervisor's restart events). Stdlib only.
"""

from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.hist import (
    LogHistogram,
    WindowedLogHistogram,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import (
    AttainmentTracker,
    SLOSpec,
    slo_event,
)

__all__ = ["AttainmentTracker", "LogHistogram", "SLOSpec", "WindowedLogHistogram",
           "slo_event"]
