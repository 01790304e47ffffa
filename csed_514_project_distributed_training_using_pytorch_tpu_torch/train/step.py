"""The training and evaluation step: forward, backward and update on tensors.

Counterpart of the JAX package's ``train/step.py``. PyTorch runs eagerly, so where the JAX
package compiles a step and scans it over a segment, this module builds a Python step and
loops it:

- ``make_train_step``: one optimizer step, ``step(state, images, labels, seed) ->
  (state, loss)``; the loss comes back as a device scalar (no host sync);
- ``make_segment_fn``: runs the step over the rows of a ``[steps, batch]`` index plan,
  gathering each batch from the device-resident split, and returns the segment's losses as
  one device tensor — the caller syncs once per log tick;
- ``make_eval_fn``: full-split evaluation (sum-NLL + correct count) in batches.

Dropout masks come from a generator on the batch's device, seeded from ``(seed, step)`` —
the counterpart of ``fold_in(rng, state.step)`` — so a step's masks depend on nothing but
the run's seed and the step number.

Data-parallel steps (``grad_reduce``, ``rank``): each rank draws the masks of its own rows
from ``(seed, step, rank)``. Rank 0's are the single process's masks (numpy's
``SeedSequence`` pads its entropy with zeros, so ``[seed, step, 0]`` is ``[seed, step]``)
and no two ranks share a mask. The JAX package draws the masks of the whole global batch
at once instead, so with dropout on a world of N ranks trains on other masks than a world
of 1; with dropout off the two agree up to the order of the gradient sums.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from csed_514_project_distributed_training_using_pytorch_tpu_torch import ops
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import fused_kernels
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.optim import (
    Optimizer,
    sgd,
    sgd_init,
)


class TrainState(NamedTuple):
    """Parameters, optimizer state (the SGD velocity) and the global step count."""

    params: dict[str, torch.Tensor]
    velocity: dict[str, torch.Tensor]
    step: int


def create_train_state(model, generator: torch.Generator, *,
                       optimizer: Optimizer | None = None,
                       device: torch.device | str = "cpu") -> TrainState:
    """Draw parameters from ``generator`` (PyTorch-default distributions) onto ``device``
    and zero the optimizer state."""
    params = model.init(generator, device=device)
    opt_init = optimizer.init if optimizer is not None else sgd_init
    return TrainState(params=params, velocity=opt_init(params), step=0)


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """The dropout seed of one step on one rank: a 64-bit mix of ``(seed, step, rank)``;
    rank 0's is the mix of ``(seed, step)``."""
    return int(np.random.SeedSequence([seed, step, rank]).generate_state(1, np.uint64)[0])


def make_train_step(model, *, learning_rate: float, momentum: float,
                    use_pallas: bool = False,
                    optimizer: Optimizer | None = None,
                    grad_reduce: Callable | None = None, rank: int = 0) -> Callable:
    """Build ``step(state, images, labels, seed) -> (state, loss)``.

    The loss is ``nll(log_probs)``. ``use_pallas=True`` routes it through the fused kernel
    ``fused_kernels.nll_from_logits`` applied to the log-probs (log_softmax is idempotent,
    so the objective and its gradients are unchanged), and routes the update through the
    fused in-place ``fused_kernels.sgd_momentum_step`` with the hyperparameters taken from
    ``optimizer``. The flag keeps the JAX package's name for the kernels it selects.

    ``grad_reduce(grads, loss)``, when given, runs between the backward and the update and
    replaces both, in place, by their mean over the data-parallel ranks
    (``parallel.data_parallel.GradReducer``); the step then returns the global batch's
    loss. ``rank`` keys this rank's dropout masks. The single-process trainer passes
    neither.
    """
    if optimizer is None:
        optimizer = sgd(learning_rate, momentum)
    if use_pallas and optimizer.name != "sgd":
        raise ValueError("use_pallas fuses the SGD-momentum update kernel — "
                         f"optimizer {optimizer.name!r} is not supported there")
    generators: dict[torch.device, torch.Generator] = {}

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
             seed: int) -> tuple[TrainState, torch.Tensor]:
        gen = generators.get(images.device)
        if gen is None:
            gen = generators[images.device] = torch.Generator(device=images.device)
        gen.manual_seed(step_seed(seed, state.step, rank))
        leaves = {k: p.detach().requires_grad_() for k, p in state.params.items()}
        log_probs = functional_call(model, leaves, (images,),
                                    {"deterministic": False, "generator": gen})
        if use_pallas:
            loss = fused_kernels.nll_from_logits(log_probs, labels)
        else:
            loss = ops.nll_loss(log_probs, labels)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        loss = loss.detach()
        if grad_reduce is not None:
            grad_reduce(grads, loss)
        if use_pallas:
            params, velocity = fused_kernels.sgd_momentum_step(
                state.params, state.velocity, grads,
                learning_rate=optimizer.hyperparams["learning_rate"],
                momentum=optimizer.hyperparams["momentum"])
        else:
            params, velocity = optimizer.update(state.params, state.velocity, grads)
        return TrainState(params, velocity, state.step + 1), loss

    return step


def make_segment_fn(train_step: Callable) -> Callable:
    """Build ``segment(state, images, labels, idx_matrix, seed) -> (state, losses)``.

    ``images``/``labels`` are the whole device-resident split and ``idx_matrix`` a
    ``[steps, batch]`` int64 index plan on the same device (from
    ``BatchLoader.epoch_index_matrix``). Each row is one step on the gathered batch. The
    losses come back as one ``[steps]`` device tensor, with no host sync inside."""

    def segment(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                idx_matrix: torch.Tensor, seed: int) -> tuple[TrainState, torch.Tensor]:
        losses = []
        for idx in idx_matrix:
            state, loss = train_step(state, images.index_select(0, idx),
                                     labels.index_select(0, idx), seed)
            losses.append(loss)
        return state, torch.stack(losses)

    return segment


def make_eval_fn(model, *, batch_size: int = 1000) -> Callable:
    """Build ``evaluate(params, images, labels) -> (sum_nll, num_correct)`` as device
    scalars: deterministic forward, NLL summed over the split (the caller divides by its
    size), argmax accuracy. The split size must divide by ``batch_size``."""

    @torch.no_grad()
    def evaluate(params, images, labels):
        n = images.shape[0]
        if n % batch_size:
            raise ValueError(f"eval split size {n} not divisible by eval batch "
                             f"{batch_size} — the tail would be silently dropped while "
                             f"callers divide by the full split size")
        sum_nll = torch.zeros((), dtype=torch.float32, device=images.device)
        correct = torch.zeros((), dtype=torch.int64, device=images.device)
        for start in range(0, n, batch_size):
            x = images[start:start + batch_size]
            y = labels[start:start + batch_size]
            log_probs = functional_call(model, params, (x,))
            sum_nll += ops.nll_loss(log_probs, y, reduction="sum")
            correct += (log_probs.argmax(dim=-1) == y).sum()
        return sum_nll, correct

    return evaluate
