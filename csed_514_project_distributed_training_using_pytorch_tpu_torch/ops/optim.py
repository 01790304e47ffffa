"""Optimizers as plain functions on dicts of tensors: SGD-momentum (the reference's) and
AdamW, with global-norm clipping and learning-rate schedules.

Counterpart of the JAX package's ``ops/optim.py``. SGD reproduces
``torch.optim.SGD(lr, momentum)`` with no dampening, nesterov or weight decay:

    v <- momentum * v + g
    p <- p - lr * v

(Torch initializes the buffer to the first gradient; starting from v=0 gives the same
sequence since ``momentum*0 + g == g``.) AdamW reproduces ``torch.optim.AdamW`` (decoupled
weight decay, bias correction):

    t <- t + 1
    m <- b1*m + (1-b1)*g          v <- b2*v + (1-b2)*g²
    p <- p - lr*(m/(1-b1^t) / (sqrt(v/(1-b2^t)) + eps) + weight_decay*p)

Updates are functional: they return new tensors, as the JAX version returns new arrays.
The fused in-place kernel for the SGD rule is ``ops.fused_kernels.sgd_momentum_step``.

``update(..., lr_scale=s)`` multiplies the rate only (torch ``lr_scheduler`` semantics:
SGD's velocity gathers raw gradients, AdamW's decay is scaled with the rate). ``s`` may be
a 0-d tensor on the parameters' device, which is how a schedule evaluated from the
device-resident step count reaches the update without a host sync (a captured CUDA graph
needs it so). State layout, as in the JAX package: SGD's is a params-congruent velocity
dict; AdamW's is ``{"m": <params dict>, "v": <params dict>, "count": int64 0-d tensor}``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    """``(init, update, name, hyperparams)``: ``init(params) -> opt_state``;
    ``update(params, opt_state, grads, *, lr_scale=1.0) -> (new_params, new_opt_state)``.
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
               grads: dict[str, torch.Tensor], *, learning_rate,
               momentum: float) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """One SGD-momentum step; returns (new_params, new_velocity). ``learning_rate`` is a
    float or a 0-d tensor."""
    new_velocity = {k: momentum * velocity[k] + grads[k] for k in params}
    new_params = {k: params[k] - learning_rate * new_velocity[k] for k in params}
    return new_params, new_velocity


def sgd(learning_rate: float, momentum: float) -> Optimizer:
    """The reference's optimizer as an ``Optimizer`` (state = velocity dict)."""

    def update(params, velocity, grads, *, lr_scale=1.0):
        return sgd_update(params, velocity, grads, learning_rate=learning_rate * lr_scale,
                          momentum=momentum)

    return Optimizer(init=sgd_init, update=update, name="sgd",
                     hyperparams={"learning_rate": learning_rate, "momentum": momentum})


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    """Zero first and second moments and a zero step count (torch ``state['step']``) on
    the parameters' device."""
    device = next(iter(params.values())).device if params else "cpu"
    return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int64, device=device)}


def adamw(learning_rate: float, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with torch semantics (decoupled decay; bias-corrected moments). The bias
    corrections read the device-resident count, so the update makes no host sync."""

    @torch.no_grad()
    def update(params, opt_state, grads, *, lr_scale=1.0):
        count = opt_state["count"] + 1
        c = count.float()
        m = {k: b1 * opt_state["m"][k] + (1.0 - b1) * grads[k] for k in params}
        v = {k: b2 * opt_state["v"][k] + (1.0 - b2) * grads[k] * grads[k] for k in params}
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)
        rate = learning_rate * lr_scale
        new_params = {}
        for k, p in params.items():
            step_dir = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
            # the scheduled rate multiplies the decoupled decay too (torch AdamW under an
            # lr_scheduler: p -= lr_t * weight_decay * p)
            new_params[k] = p - rate * (step_dir + weight_decay * p)
        return new_params, {"m": m, "v": v, "count": count}

    return Optimizer(init=adamw_init, update=update, name="adamw",
                     hyperparams={"learning_rate": learning_rate, "b1": b1, "b2": b2,
                                  "eps": eps, "weight_decay": weight_decay})


def make_optimizer(name: str, *, learning_rate: float, momentum: float,
                   weight_decay: float = 0.0) -> Optimizer:
    """CLI-name → ``Optimizer`` (the trainers' ``--optimizer`` surface)."""
    if name == "sgd":
        if weight_decay:
            raise ValueError("--weight-decay is an AdamW knob — the reference-parity "
                             "SGD has none (reference src/train.py:60-61)")
        return sgd(learning_rate, momentum)
    if name == "adamw":
        return adamw(learning_rate, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r} — choose 'sgd' or 'adamw'")


def global_l2_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """Global L2 norm of a dict of tensors in f32 (torch ``clip_grad_norm_``'s norm), as a
    0-d device tensor: the clip below and the step's health and guard norms all reduce
    through it."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float, *,
                        eps: float = 1e-6, norm_fn: Callable | None = None
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Global-norm clipping with ``torch.nn.utils.clip_grad_norm_``'s semantics (its
    ``eps`` in the denominator): returns ``(clipped_grads, global_norm)``, the grads scaled
    by ``min(1, max_norm / (norm + eps))`` — a no-op whenever the norm is within bounds.
    No host sync: the scale stays on the device. ``norm_fn`` replaces ``global_l2_norm``
    (a sharded layout's norm sums its shards over their groups)."""
    gnorm = (norm_fn or global_l2_norm)(grads)
    scale = torch.clamp(max_norm / (gnorm + eps), max=1.0)
    return {k: g * scale for k, g in grads.items()}, gnorm


def make_lr_schedule(name: str, *, warmup_steps: int = 0,
                     total_steps: int = 0) -> Callable | None:
    """Step → learning-rate multiplier in (0, 1], evaluated on the step-count tensor (a
    0-d int tensor on the device; the result is a 0-d f32 tensor there, no host sync).

    - ``"constant"``: 1.0, with an optional linear warmup ramp over the first
      ``warmup_steps`` updates (scale ``(step+1)/warmup_steps``: step 0 trains at
      ``1/warmup_steps``, torch LambdaLR's convention for a ramp that never multiplies by
      zero).
    - ``"cosine"``: the warmup ramp, then cosine decay from 1 → 0 across the remaining
      ``total_steps - warmup_steps`` updates; requires ``total_steps > warmup_steps``.

    Returns ``None`` for a warmup-free constant schedule, so callers skip the multiply.
    """
    if warmup_steps < 0:
        raise ValueError(f"warmup_steps must be >= 0, got {warmup_steps}")

    def ramp(step: torch.Tensor) -> torch.Tensor:
        return torch.clamp((step.float() + 1.0) / warmup_steps, max=1.0)

    if name == "constant":
        return ramp if warmup_steps > 0 else None
    if name == "cosine":
        if total_steps <= warmup_steps:
            raise ValueError(f"cosine schedule needs total_steps > warmup_steps, got "
                             f"{total_steps} <= {warmup_steps}")

        def sched(step: torch.Tensor) -> torch.Tensor:
            t = torch.clamp((step.float() - warmup_steps) / (total_steps - warmup_steps),
                            0.0, 1.0)
            cos = 0.5 * (1.0 + torch.cos(math.pi * t))
            return ramp(step) * cos if warmup_steps > 0 else cos

        return sched
    raise ValueError(f"unknown lr schedule {name!r} — choose 'constant' or 'cosine'")


def is_adam_state(opt_state) -> bool:
    """True for the AdamW moment-state layout (see the module docstring)."""
    return isinstance(opt_state, dict) and set(opt_state) == {"m", "v", "count"}


def map_param_trees(opt_state, fn: Callable, scalar_fn: Callable | None = None):
    """Apply ``fn`` to every params-congruent dict of an optimizer state: SGD's state is
    one (``fn(state)``); AdamW's maps ``fn`` over the two moment dicts and ``scalar_fn``
    (default: identity) over the count."""
    if is_adam_state(opt_state):
        keep = scalar_fn if scalar_fn is not None else (lambda x: x)
        return {"m": fn(opt_state["m"]), "v": fn(opt_state["v"]),
                "count": keep(opt_state["count"])}
    return fn(opt_state)
