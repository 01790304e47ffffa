"""Continuous deployment: checkpoint promotion with canary rollout.

Counterpart of the JAX package's ``deploy/``. ``deploy/promoter.py`` closes the
train-to-serve loop: it watches a versioned checkpoint store (``utils/checkpoint.py``),
qualifies each new candidate at a gate (health stamp, accuracy budget, perf tolerance),
canaries survivors on ONE fleet replica through the router's rolling-reload path, and
promotes fleet-wide or rolls back on regression.
"""

from csed_514_project_distributed_training_using_pytorch_tpu_torch.deploy.promoter import (
    CanaryConfig,
    GateConfig,
    Promoter,
    PromotionLedger,
    read_ledger,
)

__all__ = [
    "CanaryConfig",
    "GateConfig",
    "Promoter",
    "PromotionLedger",
    "read_ledger",
]
