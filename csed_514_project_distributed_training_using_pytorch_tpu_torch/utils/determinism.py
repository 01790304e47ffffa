"""Replica-consistency check of the data-parallel trainer.

Counterpart of the JAX package's ``utils/determinism.py``: a cross-process parameter
fingerprint comparison, the desynced-replica detector the reference lacks. Every rank
applies the same all-reduced gradient to the same broadcast parameters, so the replicas
stay bitwise equal; a host-side fault (a rank seeded differently, a skipped reduce) is what
this catches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
)


def param_fingerprint(params: dict[str, torch.Tensor]) -> float:
    """Order-independent scalar digest of a parameter dict: the sum of |p| over every
    leaf, each leaf summed in float32."""
    total = sum(p.detach().float().abs().sum() for p in params.values())
    return float(total)


def assert_replicas_synced(params: dict[str, torch.Tensor], *, atol: float = 0.0) -> None:
    """Raise if any rank holds a different parameter fingerprint. A collective: every
    rank calls it. No-op without a group of more than one rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    device = next(iter(params.values())).device
    mine = torch.tensor([param_fingerprint(params)], dtype=torch.float64, device=device)
    everyone = collectives.all_gather(mine).reshape(-1).cpu()
    if not bool(((everyone - everyone[0]).abs() <= atol).all()):
        raise RuntimeError(
            f"replica parameter desync detected across processes: {everyone.tolist()}")
