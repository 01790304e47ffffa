"""Run-level observability for the serving path: latency histograms and SLO attainment.

The port's own copies of the JAX package's ``obs/hist.py`` (mergeable log-bucket
streaming histograms with a fixed relative error) and ``obs/slo.py`` (SLO specs and the
attainment tracker), which the ``serving.Server`` front end reports through
``latency_histograms``, ``slo_summary`` and ``tenant_summaries``. Stdlib only. The goodput
decomposition (``obs/goodput.py``) waits for ROADMAP A11.
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
