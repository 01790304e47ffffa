"""SGD-momentum as plain functions on dicts of tensors (the reference's optimizer).

Counterpart of the JAX package's ``ops/optim.py`` for SGD. It reproduces
``torch.optim.SGD(lr, momentum)`` with no dampening, nesterov or weight decay:

    v <- momentum * v + g
    p <- p - lr * v

(Torch initializes the buffer to the first gradient; starting from v=0 gives the same
sequence since ``momentum*0 + g == g``.) ``sgd_update`` is functional — it returns new
tensors, as the JAX version returns new arrays. The fused in-place kernel for the same rule
is ``ops.fused_kernels.sgd_momentum_step``. AdamW, clipping and schedules are not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    """``(init, update, name, hyperparams)``: ``init(params) -> opt_state``;
    ``update(params, opt_state, grads) -> (new_params, new_opt_state)``.
    ``hyperparams`` records the constructor knobs — the fused kernel path reads them from
    here so it can never diverge from what ``update`` applies."""

    init: Callable
    update: Callable
    name: str
    hyperparams: dict


def sgd_init(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Zero velocity buffers, one per parameter (the torch momentum_buffer analog)."""
    return {k: torch.zeros_like(p) for k, p in params.items()}


@torch.no_grad()
def sgd_update(params: dict[str, torch.Tensor], velocity: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor], *, learning_rate: float,
               momentum: float) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """One SGD-momentum step; returns (new_params, new_velocity)."""
    new_velocity = {k: momentum * velocity[k] + grads[k] for k in params}
    new_params = {k: params[k] - learning_rate * new_velocity[k] for k in params}
    return new_params, new_velocity


def sgd(learning_rate: float, momentum: float) -> Optimizer:
    """The reference's optimizer as an ``Optimizer`` (state = velocity dict)."""

    def update(params, velocity, grads):
        return sgd_update(params, velocity, grads,
                          learning_rate=learning_rate, momentum=momentum)

    return Optimizer(init=sgd_init, update=update, name="sgd",
                     hyperparams={"learning_rate": learning_rate, "momentum": momentum})


def make_optimizer(name: str, *, learning_rate: float, momentum: float) -> Optimizer:
    """CLI-name → ``Optimizer`` (the trainer's ``--optimizer`` surface)."""
    if name == "sgd":
        return sgd(learning_rate, momentum)
    raise ValueError(f"unknown optimizer {name!r} — this port implements only 'sgd'")
