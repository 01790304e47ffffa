"""The training and evaluation step: forward, backward and update on tensors, and the
one-program epoch as a captured CUDA graph.

Counterpart of the JAX package's ``train/step.py``. Where the JAX package compiles a step
and scans it over a segment as one XLA program, this module builds a Python step and
either loops it (eager) or captures the loop once as a ``torch.cuda.CUDAGraph`` and
replays it (the captured program):

- ``make_train_step``: one optimizer step, ``step(state, images, labels, seed) ->
  (state, loss)``: grad accumulation, AdamW or SGD, LR schedules, global-norm clipping,
  label smoothing, the EMA and the numerical guard, all as device tensor ops (no host
  sync: the step count, the schedule, the EMA's first-step copy, the guard's verdict and
  skip windows read the device-resident ``state.step``);
- ``make_segment_fn``: the eager loop of the step over the rows of a ``[steps, batch]``
  index plan, gathering each batch from the device-resident split — the CPU path, and the
  plain version the captured program is held against;
- ``CapturedSegment``: the same loop captured once per segment shape on a CUDA device and
  replayed; ``make_epoch_fn`` / ``make_epoch_from_step`` choose between the two by a rule
  (``segment_program``), never by a flag: a CUDA graph on a CUDA device unless the
  gradient reducer crosses through host memory (a gloo group), eager otherwise;
- ``HostFedStep``: one step a host batch for the host-fed loops, by the same rule: eager,
  or a one-step ``CapturedSegment`` over static input buffers that each batch is copied
  into;
- ``make_eval_fn``: full-split evaluation (sum-NLL + correct count) in batches.

Dropout: the masks are a function of ``(seed, step, rank)`` only. The step derives a 32-bit
key from them on the device (``dropout_key``; ``step_seed`` is its host mirror) and the
model's dropout layers draw counter-based uniforms from it (``ops.nn.DropoutStream``), by
integer tensor ops. A generator reseeded from the host at each step, as this module did
before, cannot be replayed by a graph; this way the eager and the captured path draw the
same masks, on the card and on the CPU alike. Data-parallel steps key their masks on
their rank as well, so no two ranks share a mask; the JAX package draws the whole global
batch's masks at once instead, so with dropout on a world of N ranks trains on other
masks than a world of 1, and with dropout off the two agree up to the order of the
gradient sums.

In place and functional: the plain update returns new tensors, as the JAX package's; the
fused kernel path (``use_pallas``) updates the parameters and the velocity in place. The
captured program keeps its state in static buffers that each replay updates in place.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from csed_514_project_distributed_training_using_pytorch_tpu_torch import ops
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    flash_attention,
    fused_kernels,
    paged_attention,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.nn import (
    DropoutStream,
    mix32,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.optim import (
    Optimizer,
    clip_by_global_norm,
    global_l2_norm,
    sgd,
    sgd_init,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
    check_scan_unroll,
)

_M32 = 0xFFFFFFFF


class HealthStats(NamedTuple):
    """Training-health accumulators threaded through a segment: five f32 0-d device
    tensors, fetched by the caller once per segment with the losses. Gradient norms are
    PRE-clip: the explosion detector must see what clipping would hide."""

    loss_min: torch.Tensor
    loss_max: torch.Tensor
    loss_sum: torch.Tensor
    grad_norm_sum: torch.Tensor
    grad_norm_max: torch.Tensor


def init_health(device: torch.device | str = "cpu") -> HealthStats:
    """Identity element for ``update_health`` (min over inf, max over -inf, sums over 0),
    made by fills on ``device`` (capturable)."""
    full = lambda v: torch.full((), v, dtype=torch.float32, device=device)
    return HealthStats(full(float("inf")), full(float("-inf")), full(0.0), full(0.0),
                       full(0.0))


def update_health(h: HealthStats, loss: torch.Tensor, grad_norm: torch.Tensor) -> HealthStats:
    """Fold one step's (loss, pre-clip global grad norm) into the accumulators."""
    loss, grad_norm = loss.float(), grad_norm.float()
    return HealthStats(torch.minimum(h.loss_min, loss), torch.maximum(h.loss_max, loss),
                       h.loss_sum + loss, h.grad_norm_sum + grad_norm,
                       torch.maximum(h.grad_norm_max, grad_norm))


def merge_health(a: HealthStats, b: HealthStats) -> HealthStats:
    """Combine the accumulators of two segments of the same epoch."""
    return HealthStats(torch.minimum(a.loss_min, b.loss_min),
                       torch.maximum(a.loss_max, b.loss_max),
                       a.loss_sum + b.loss_sum, a.grad_norm_sum + b.grad_norm_sum,
                       torch.maximum(a.grad_norm_max, b.grad_norm_max))


class GuardSpec(NamedTuple):
    """Static knobs of the numerical guard (``--guard``), as in the JAX package.

    A step whose pre-clip global grad norm exceeds ``ema_mean + zscore * max(ema_std,
    rel_floor * ema_mean)`` is a spike, once ``warmup_steps`` clean steps armed the test
    (non-finite detection is always armed); ``ema_decay`` is the detector's window;
    ``skip`` the half-open ``(lo, hi)`` step windows replayed as identity updates
    (``--skip-steps``)."""

    zscore: float = 8.0
    warmup_steps: int = 4
    ema_decay: float = 0.9
    rel_floor: float = 0.5
    skip: tuple = ()


class GuardState(NamedTuple):
    """The guard's accumulators: nine 0-d device tensors riding ``TrainState.guard``."""

    ema_mean: torch.Tensor            # EMA of clean pre-clip grad norms (f32)
    ema_sq: torch.Tensor              # EMA of their squares (f32)
    count: torch.Tensor               # clean steps folded into the EMA (i32)
    anomalies: torch.Tensor           # detected anomalies (nonfinite + spikes)
    nonfinite: torch.Tensor           # non-finite loss/grad verdicts
    spikes: torch.Tensor              # z-score verdicts
    skipped: torch.Tensor             # identity updates applied (anomaly + window)
    first_anomaly_step: torch.Tensor  # -1 until the first anomaly
    last_anomaly_step: torch.Tensor   # -1 until the first anomaly


def init_guard(device: torch.device | str = "cpu") -> GuardState:
    f0 = lambda: torch.zeros((), dtype=torch.float32, device=device)
    i0 = lambda: torch.zeros((), dtype=torch.int32, device=device)
    none = lambda: torch.full((), -1, dtype=torch.int32, device=device)
    return GuardState(f0(), f0(), i0(), i0(), i0(), i0(), i0(), none(), none())


class TrainState(NamedTuple):
    """Parameters, optimizer state, the global step count (a 0-d int64 tensor on the
    parameters' device; a Python int is taken as its value), and the optional ``ema``
    (params-shaped, ``--ema-decay``) and ``guard`` (``GuardState``, ``--guard``)."""

    params: dict[str, torch.Tensor]
    velocity: dict
    step: torch.Tensor
    ema: dict[str, torch.Tensor] | None = None
    guard: GuardState | None = None


def create_train_state(model, generator: torch.Generator, *,
                       optimizer: Optimizer | None = None,
                       device: torch.device | str = "cpu", ema: bool = False,
                       guard: bool = False) -> TrainState:
    """Draw parameters from ``generator`` (PyTorch-default distributions) onto ``device``
    and zero the optimizer state. ``ema=True`` seeds the EMA as a copy of the initial
    parameters (torch ``AveragedModel``'s construction-time copy); ``guard=True``
    attaches a fresh ``GuardState``."""
    params = model.init(generator, device=device)
    opt_init = optimizer.init if optimizer is not None else sgd_init
    return TrainState(params=params, velocity=opt_init(params),
                      step=torch.zeros((), dtype=torch.int64, device=device),
                      ema={k: p.clone() for k, p in params.items()} if ema else None,
                      guard=init_guard(device) if guard else None)


# -- dropout keys ---------------------------------------------------------------------


@functools.cache
def _key_words(seed: int, rank: int) -> tuple[int, int]:
    return tuple(int(w) for w in
                 np.random.SeedSequence([seed, rank]).generate_state(2, np.uint32))


def dropout_key(seed: int, step: torch.Tensor, rank: int = 0) -> torch.Tensor:
    """The 32-bit dropout key of ``step`` (an int64 tensor) on ``rank``, computed on the
    step's device: ``mix32(((step + b) mod 2^32) ^ a)`` with ``(a, b)`` drawn from
    ``SeedSequence([seed, rank])``."""
    a, b = _key_words(seed, rank)
    return mix32(((step + b) & _M32) ^ a)


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """Host mirror of ``dropout_key``: the same 32-bit key from Python ints."""
    a, b = _key_words(seed, rank)
    return mix32(((step + b) & _M32) ^ a)


# The CNN's leaves by their JAX names (models.cnn.params_to_jax); every other model's
# dotted leaf names are the JAX package's nested tree paths.
_CNN_JAX_NAMES = {"conv1.weight": "conv1_kernel", "conv1.bias": "conv1_bias",
                  "conv2.weight": "conv2_kernel", "conv2.bias": "conv2_bias",
                  "fc1.weight": "fc1_kernel", "fc1.bias": "fc1_bias",
                  "fc2.weight": "fc2_kernel", "fc2.bias": "fc2_bias"}


def jax_leaf_path(name: str) -> str:
    """The JAX package's ``jax.tree_util.keystr`` of the leaf this parameter maps to:
    ``conv1.weight`` -> ``['conv1_kernel']``, ``block_0.attn.qkv_kernel`` ->
    ``['block_0']['attn']['qkv_kernel']`` (what a ``bitflip`` fault's ``leaf=`` matches)."""
    parts = [_CNN_JAX_NAMES[name]] if name in _CNN_JAX_NAMES else name.split(".")
    return "".join(f"[{p!r}]" for p in parts)


def _grad_poison_fn():
    """The armed grad-poison faults (``resilience.faults``: ``nan``, ``spike``,
    ``bitflip``) as one function ``poison(grads, step_t) -> grads``, or None (no operation
    added) unless ``RESILIENCE_FAULTS`` arms one for this process. Each fires at exact
    equality with the device-resident step, by ``torch.where``, so a captured segment
    replays it at the same step. ``bitflip`` plants its value in each leaf whose JAX path
    contains ``leaf=``, at element 0: the element that is ``flat[0]`` of the JAX leaf (the
    CNN's OIHW kernels, ``[out, in]`` dense kernels and (C, H, W) fc1 rows all put JAX's
    first element first). On a sharded layout (FSDP, tensor parallel) element 0 is that of
    each rank's own shard."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
        faults,
    )

    specs = faults.grad_poisons()
    if not specs:
        return None

    def poison(grads: dict, step_t: torch.Tensor) -> dict:
        for f in specs:
            hit = step_t == f.step
            if f.kind == "nan":
                grads = {k: torch.where(hit, torch.full_like(g, float("nan")), g)
                         for k, g in grads.items()}
            elif f.kind == "spike":
                grads = {k: torch.where(hit, (g.float() * f.scale).to(g.dtype), g)
                         for k, g in grads.items()}
            else:                          # bitflip: element 0 of each matching leaf
                out = {}
                for k, g in grads.items():
                    if f.leaf in jax_leaf_path(k):
                        flat = g.reshape(-1).clone()
                        flat[:1] = torch.where(hit, torch.full_like(flat[:1], f.scale),
                                               flat[:1])
                        g = flat.view(g.shape)
                    out[k] = g
                grads = out
        return grads

    return poison


def _step_tensor(step, device: torch.device) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step
    return torch.tensor(int(step), dtype=torch.int64, device=device)


# -- state trees ----------------------------------------------------------------------


def _tree_map(fn: Callable, *trees):
    """Map ``fn`` over the tensors of equally-shaped trees (dicts, tuples and NamedTuples
    of tensors; None stays None)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple):
        items = [_tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*items) if hasattr(first, "_fields") else tuple(items)
    raise TypeError(f"not a tensor tree: {type(first).__name__}")


def _tree_leaves(tree) -> list[torch.Tensor]:
    leaves = []
    _tree_map(lambda t: leaves.append(t) or t, tree)
    return leaves


# -- the step -------------------------------------------------------------------------


def apply_model(model, params: dict[str, torch.Tensor], x: torch.Tensor, *,
                deterministic: bool = True, generator=None, with_aux: bool = False):
    """``model``'s log-probs on ``x`` under ``params`` (``torch.func.functional_call``;
    a model that lays its parameters out its own way, the pipeline's, runs through its
    ``apply_params``). ``with_aux`` also returns an MoE model's summed auxiliary."""
    kwargs = {"deterministic": deterministic, "generator": generator}
    if with_aux:
        kwargs["with_aux"] = True
    if hasattr(model, "apply_params"):
        return model.apply_params(params, x, **kwargs)
    return functional_call(model, params, (x,), kwargs)



def make_train_step(model, *, learning_rate: float, momentum: float,
                    use_pallas: bool = False, grad_accum: int = 1,
                    optimizer: Optimizer | None = None,
                    lr_schedule: Callable | None = None,
                    clip_grad_norm: float = 0.0,
                    ema_decay: float = 0.0,
                    label_smoothing: float = 0.0,
                    loss_fn: Callable | None = None,
                    with_metrics: bool = False,
                    guard: GuardSpec | None = None,
                    grad_reduce: Callable | None = None, rank: int = 0,
                    aux_loss_weight: float = 0.01,
                    dropout_rows: tuple[int, int] | None = None,
                    param_view: Callable | None = None,
                    norm_fn: Callable | None = None) -> Callable:
    """Build ``step(state, images, labels, seed) -> (state, loss)``.

    The loss is ``nll(log_probs)``. ``use_pallas=True`` routes it through the fused kernel
    ``fused_kernels.nll_from_logits`` applied to the log-probs (log_softmax is idempotent,
    so the objective and its gradients are unchanged), and routes the update through the
    fused in-place ``fused_kernels.sgd_momentum_step`` with the hyperparameters taken from
    ``optimizer``. The flag keeps the JAX package's name for the kernels it selects, and
    raises where the JAX package raises: with AdamW, a schedule, label smoothing or a
    custom ``loss_fn``.

    ``grad_accum=N`` splits the batch into N equal microbatches, sums their gradients and
    applies one update on the mean (each microbatch draws its own dropout masks).
    ``optimizer`` swaps the update rule (``None``: SGD from ``learning_rate`` /
    ``momentum``); the state must come from ``create_train_state(..., optimizer=...)``.
    ``lr_schedule`` (``optim.make_lr_schedule``) maps ``state.step`` to a rate multiplier
    on the device. ``clip_grad_norm > 0`` clips the (averaged, reduced) gradients to that
    global norm. ``ema_decay > 0`` keeps ``state.ema`` with torch ``AveragedModel``
    semantics (the first update copies the params, later ones apply ``ema ← decay·ema +
    (1−decay)·params``); the state must come from ``create_train_state(..., ema=True)``.
    ``label_smoothing`` smooths the NLL's target. ``loss_fn(params, images, labels, rng)
    -> scalar`` replaces the objective (``rng`` is the step's ``DropoutStream``).

    ``with_metrics=True`` returns ``(state, (loss, grad_norm))`` with the PRE-clip global
    grad norm. ``guard`` (a ``GuardSpec``) computes the anomaly verdict (non-finite loss or
    norm; a z-score spike against the EMA in ``state.guard``) and applies the IDENTITY
    update on a poisoned step or inside a skip window: params, optimizer state and EMA
    unchanged (``torch.where`` selects exactly), counters bumped, ``step`` advanced. A
    guard whose verdict never fires selects the computed update bitwise.

    ``grad_reduce(grads, loss)``, when given, runs between the backward and the update and
    replaces both, in place, by their mean over the data-parallel ranks
    (``parallel.data_parallel.GradReducer``); the step then returns the global batch's
    loss. ``rank`` keys this rank's dropout masks.

    The mesh's hooks: a model with MoE blocks (``num_experts > 0``) returns its
    load-balance auxiliaries, and ``aux_loss_weight · Σ aux`` joins the objective (the JAX
    package's ``aux_loss_weight``; every other model's loss is unchanged bitwise).
    ``dropout_rows=(offset, total)`` draws this rank's rows of a ``total``-row
    microbatch's masks (``ops.nn.DropoutStream``). ``param_view(params)`` maps the state's
    leaves to what the forward uses, differentiably (FSDP's gathers). ``norm_fn(grads)``
    replaces the global L2 norm of the clip, the guard and the metrics (a sharded layout
    sums its shards over their groups).
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if optimizer is None:
        optimizer = sgd(learning_rate, momentum)
    if use_pallas and optimizer.name != "sgd":
        raise ValueError("use_pallas fuses the SGD-momentum update kernel — "
                         f"optimizer {optimizer.name!r} is not supported there")
    if use_pallas and lr_schedule is not None:
        raise ValueError("use_pallas bakes the learning rate into the fused kernel — "
                         "lr_schedule is not supported there")
    if use_pallas and label_smoothing:
        raise ValueError("use_pallas fuses the plain NLL loss kernel — "
                         "label_smoothing is not supported there")
    if use_pallas and loss_fn is not None:
        raise ValueError("use_pallas fuses the standard NLL loss kernel — a custom "
                         "loss_fn is not supported there")

    has_aux = getattr(model, "num_experts", 0) > 0

    def default_loss_fn(params, images, labels, rng):
        out = apply_model(model, params, images, deterministic=False, generator=rng,
                          with_aux=has_aux)
        log_probs, aux = out if has_aux else (out, None)
        if use_pallas:
            loss = fused_kernels.nll_from_logits(log_probs, labels)
        else:
            loss = ops.nll_loss(log_probs, labels, label_smoothing=label_smoothing)
        return loss + aux_loss_weight * aux if has_aux else loss

    if loss_fn is None:
        loss_fn = default_loss_fn
    # the guard's EMA factors as the JAX package rounds them: d and 1 - d in f32
    guard_d = float(np.float32(guard.ema_decay)) if guard is not None else 0.0
    guard_1md = float(np.float32(1.0) - np.float32(guard_d))

    def value_and_grad(params, images, labels, rng):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = loss_fn(param_view(leaves) if param_view is not None else leaves,
                       images, labels, rng)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    poison = _grad_poison_fn()

    def apply_update(state: TrainState, step_t: torch.Tensor, grads, loss):
        if poison is not None:
            # armed grad poison, before the norm: the guard sees what the update applies
            grads = poison(grads, step_t)
        gnorm = None
        if clip_grad_norm > 0.0:
            grads, gnorm = clip_by_global_norm(grads, clip_grad_norm, norm_fn=norm_fn)
        elif with_metrics or guard is not None:
            gnorm = (norm_fn or global_l2_norm)(grads)
        if guard is not None and state.guard is None:
            raise ValueError("a guarded step needs create_train_state(..., guard=True)")
        if ema_decay > 0.0 and state.ema is None:
            raise ValueError("ema_decay needs create_train_state(..., ema=True)")
        if use_pallas:
            old = ((_tree_map(torch.clone, state.params),
                    _tree_map(torch.clone, state.velocity)) if guard is not None else None)
            # hyperparameters from the Optimizer, so that an explicit optim.sgd(...) can
            # never diverge from what the kernel applies
            params, velocity = fused_kernels.sgd_momentum_step(
                state.params, state.velocity, grads,
                learning_rate=optimizer.hyperparams["learning_rate"],
                momentum=optimizer.hyperparams["momentum"])
        else:
            old = (state.params, state.velocity)
            scale = lr_schedule(step_t) if lr_schedule is not None else 1.0
            params, velocity = optimizer.update(state.params, state.velocity, grads,
                                                lr_scale=scale)
        ema = state.ema
        if ema_decay > 0.0:
            # torch AveragedModel.update_parameters: the first call copies the params;
            # the pre-increment step count doubles as n_averaged
            first = step_t == 0
            ema = {k: torch.where(first, p, ema_decay * ema[k] + (1.0 - ema_decay) * p)
                   for k, p in params.items()}
        new_guard = state.guard
        if guard is not None:
            g = state.guard
            loss32, gnorm32 = loss.float(), gnorm.float()
            finite = torch.isfinite(loss32) & torch.isfinite(gnorm32)
            std = torch.sqrt(torch.clamp(g.ema_sq - g.ema_mean * g.ema_mean, min=0.0))
            threshold = g.ema_mean + guard.zscore * torch.maximum(
                std, guard.rel_floor * g.ema_mean)
            spike = (g.count >= guard.warmup_steps) & finite & (gnorm32 > threshold)
            in_window = torch.zeros_like(finite)
            for lo, hi in guard.skip:
                in_window = in_window | ((step_t >= lo) & (step_t < hi))
            # replay-window steps are deliberate skips, never anomalies
            nonfinite = ~finite & ~in_window
            spike = spike & ~in_window
            anomaly = nonfinite | spike
            skip = anomaly | in_window
            keep = lambda new, prev: torch.where(skip, prev, new)
            if use_pallas:          # the kernel updated in place: restore in place
                for new, prev in zip(_tree_leaves((params, velocity)), _tree_leaves(old)):
                    new.copy_(keep(new, prev))
            else:
                params = _tree_map(keep, params, old[0])
                velocity = _tree_map(keep, velocity, old[1])
            if ema_decay > 0.0:
                ema = _tree_map(keep, ema, state.ema)
            clean = ~skip
            gsafe = torch.where(finite, gnorm32, 0.0)
            seeded = g.count > 0           # the first clean sample seeds the EMA
            new_mean = torch.where(clean, torch.where(
                seeded, guard_d * g.ema_mean + guard_1md * gsafe, gsafe), g.ema_mean)
            new_sq = torch.where(clean, torch.where(
                seeded, guard_d * g.ema_sq + guard_1md * gsafe * gsafe, gsafe * gsafe),
                g.ema_sq)
            step32 = step_t.to(torch.int32)
            new_guard = GuardState(
                ema_mean=new_mean, ema_sq=new_sq, count=g.count + clean.int(),
                anomalies=g.anomalies + anomaly.int(),
                nonfinite=g.nonfinite + nonfinite.int(),
                spikes=g.spikes + spike.int(), skipped=g.skipped + skip.int(),
                first_anomaly_step=torch.where(anomaly & (g.first_anomaly_step < 0),
                                               step32, g.first_anomaly_step),
                last_anomaly_step=torch.where(anomaly, step32, g.last_anomaly_step))
        new_state = TrainState(params, velocity, step_t + 1, ema, new_guard)
        return new_state, ((loss, gnorm) if with_metrics else loss)

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor, seed: int):
        step_t = _step_tensor(state.step, images.device)
        rng = DropoutStream(lambda: dropout_key(seed, step_t, rank), dropout_rows)
        if grad_accum == 1:
            loss, grads = value_and_grad(state.params, images, labels, rng)
        else:
            b = images.shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} not divisible by grad_accum {grad_accum}")
            micro = b // grad_accum
            loss, grads = value_and_grad(state.params, images[:micro], labels[:micro], rng)
            for i in range(1, grad_accum):
                rows = slice(i * micro, (i + 1) * micro)
                loss_i, grads_i = value_and_grad(state.params, images[rows], labels[rows],
                                                 rng)
                loss = loss + loss_i
                grads = {k: grads[k] + grads_i[k] for k in grads}
            grads = {k: g / grad_accum for k, g in grads.items()}
            loss = loss / grad_accum
        if grad_reduce is not None:
            grad_reduce(grads, loss)
        return apply_update(state, step_t, grads, loss)

    return step


# -- segments: eager and captured -------------------------------------------------------


def _gather_batches(images, labels, idx_matrix, pregather: bool):
    """The segment's batches: one ``index_select`` a step, or with ``pregather`` the whole
    segment's in one ``index_select`` (semantics unchanged)."""
    if not pregather:
        return [(images.index_select(0, idx), labels.index_select(0, idx))
                for idx in idx_matrix]
    flat = idx_matrix.reshape(-1)
    xs = images.index_select(0, flat).view(*idx_matrix.shape, *images.shape[1:])
    ys = labels.index_select(0, flat).view(idx_matrix.shape)
    return list(zip(xs, ys))


def _run_segment(train_step, state, images, labels, idx_matrix, seed, *, pregather,
                 health):
    h = init_health(images.device) if health else None
    losses = []
    for x, y in _gather_batches(images, labels, idx_matrix, pregather):
        state, out = train_step(state, x, y, seed)
        if health:
            out, gnorm = out
            h = update_health(h, out, gnorm)
        losses.append(out)
    losses = torch.stack(losses)
    return state, ((losses, h) if health else losses)


def make_segment_fn(train_step: Callable, *, pregather: bool = False,
                    health: bool = False) -> Callable:
    """Build the eager ``segment(state, images, labels, idx_matrix, seed) -> (state,
    losses)``.

    ``images``/``labels`` are the whole device-resident split and ``idx_matrix`` a
    ``[steps, batch]`` int64 index plan on the same device (from
    ``BatchLoader.epoch_index_matrix``). Each row is one step on the gathered batch. The
    losses come back as one ``[steps]`` device tensor, with no host sync inside.
    ``health=True`` expects a step built with ``with_metrics=True`` and returns ``(state,
    (losses, HealthStats))``."""

    def segment(state, images, labels, idx_matrix, seed):
        return _run_segment(train_step, state, images, labels, idx_matrix, seed,
                            pregather=pregather, health=health)

    return segment


def segment_program(device: torch.device, grad_reduce=None) -> str:
    """The rule that picks the segment's program: ``"cuda-graph"`` on a CUDA device unless
    the gradient reducer stages its bucket through host memory (a gloo group, which a
    graph cannot capture), ``"eager"`` otherwise.

    The host-fed step (``HostFedStep``: one step a host batch) follows the same rule: its
    captured program is a one-step graph over static input buffers that each batch is
    copied into. Both host-fed programs were measured on the card before the rule was
    kept (``chip_smoke.py`` [23], PERF.md): a full epoch of ``train.single
    --use-host-pipeline --use-pallas-kernels`` took 3.6-3.8 s eager and 0.50-0.66 s
    captured on an NVIDIA H100 80GB HBM3 at 700 W, where the eager step is host-bound by
    its 102 launch calls and the replay makes one."""
    if torch.device(device).type != "cuda":
        return "eager"
    if grad_reduce is not None and grad_reduce.host_staged:
        return "eager"
    return "cuda-graph"


_UNCOUNTED = (flash_attention, paged_attention)   # kernels whose replays nothing counts


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    state: TrainState            # static buffers: read by each replay, written at its end
    idx: torch.Tensor            # static [steps, batch] index plan
    out: tuple                   # (losses,) or (losses, HealthStats), in the graph's pool
    counts: list[dict]           # launches of each counted owner in one replay


class CapturedSegment:
    """The segment as CUDA graphs: ``segment(state, images, labels, idx_matrix, seed)``
    with ``make_segment_fn``'s contract, on a CUDA device.

    The first call of each segment shape (steps, batch, split, seed) captures the eager
    loop once into a ``torch.cuda.CUDAGraph``: one warm-up of two steps on a side stream
    from a copy of the state (cuDNN and cuBLAS handles, the kernel libraries, the NCCL
    communicator come up there), then the capture from the caller's state. The graph reads
    its state from static buffers and the plan from a static ``[steps, batch]`` index
    buffer, and at its end writes the final state back into the static buffers. Every call
    copies the caller's state into the buffers (a tensor that already is one is skipped)
    and the plan into the index buffer, replays, and returns the buffers as the new state
    and a copy of the losses. A capture or a replay that fails raises; nothing retries
    eagerly.

    Addresses and Python values are frozen at capture: the split (its tensors must stay
    the same), the seed, the fused SGD kernel's pointer tables and its rate (hence no
    schedule with ``use_pallas``). The launch counters of the fused kernels
    (``fused_kernels.launch_counts``) and the reducer's ``calls`` count at capture what
    one replay launches, and each replay adds that count, so a run's counts equal the
    eager path's; a step that launches a kernel counted elsewhere (flash, paged) raises.
    """

    def __init__(self, train_step: Callable, *, pregather: bool = False,
                 health: bool = False, grad_reduce=None):
        self.train_step = train_step
        self.pregather, self.health = pregather, health
        self.grad_reduce = grad_reduce
        self.counted = [fused_kernels] + ([grad_reduce] if grad_reduce is not None else [])
        self.graphs: dict[tuple, _Graph] = {}
        self.replays = 0

    def __call__(self, state, images, labels, idx_matrix, seed):
        key = (tuple(idx_matrix.shape), int(seed), images.data_ptr(), labels.data_ptr(),
               tuple(images.shape), images.device)
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(state, images, labels, idx_matrix,
                                                     seed)
        self._load(entry, state, idx_matrix)
        entry.graph.replay()
        self.replays += 1
        for owner, counts in zip(self.counted, entry.counts):
            owner.add_launch_counts(counts)
        out = _tree_map(torch.clone, entry.out)
        return entry.state, (out if self.health else out[0])

    @staticmethod
    def _load(entry: _Graph, state: TrainState, idx_matrix: torch.Tensor) -> None:
        state = state._replace(step=_step_tensor(state.step, entry.idx.device))
        for static, given in zip(_tree_leaves(entry.state), _tree_leaves(state),
                                 strict=True):
            if static is not given:
                static.copy_(given)
        entry.idx.copy_(idx_matrix)

    def _capture(self, state, images, labels, idx_matrix, seed) -> _Graph:
        device = images.device
        if segment_program(device, self.grad_reduce) != "cuda-graph":
            raise ValueError(f"a captured segment runs on a CUDA device with a reduce "
                             f"that stays on it, not on {device} (segment_program's rule)")
        static = _tree_map(torch.clone,
                           state._replace(step=_step_tensor(state.step, device)))
        idx = idx_matrix.clone()
        before = [owner.launch_counts() for owner in self.counted]
        uncounted = [owner.launch_counts() for owner in _UNCOUNTED]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):       # warm-up: two steps from a copy of the state
            _run_segment(self.train_step, static, images, labels, idx[:2], seed,
                         pregather=self.pregather, health=self.health)
        torch.cuda.current_stream(device).wait_stream(side)
        entry = _Graph(torch.cuda.CUDAGraph(), static, idx, (), [])
        self._load(entry, state, idx_matrix)
        torch.cuda.synchronize(device)
        warmed = [owner.launch_counts() for owner in self.counted]
        with torch.cuda.graph(entry.graph):
            final, out = _run_segment(self.train_step, static, images, labels, idx, seed,
                                      pregather=self.pregather, health=self.health)
            for dst, src in zip(_tree_leaves(static), _tree_leaves(final), strict=True):
                if dst is not src:
                    dst.copy_(src)
        captured = [owner.launch_counts() for owner in self.counted]
        if [owner.launch_counts() for owner in _UNCOUNTED] != uncounted:
            raise RuntimeError("the captured step launched flash or paged-attention "
                               "kernels, whose counters do not count graph replays")
        for owner, b, c in zip(self.counted, before, captured):
            owner.add_launch_counts({k: b[k] - c[k] for k in b})   # undo warm-up, capture
        counts = [{k: c[k] - w[k] for k in c} for w, c in zip(warmed, captured)]
        return entry._replace(out=out if self.health else (out,), counts=counts)


class HostFedStep:
    """``step(state, images, labels, seed) -> (state, loss)`` on a host batch (numpy
    ``images`` ``[B, 28, 28, 1]`` float32 and integer ``labels`` ``[B]``): the host-fed
    loops' step (``train.single --use-host-pipeline``, ``train.distributed
    --host-local-feed``), on ``device``, by the program ``segment_program`` picks.

    On the CPU the batch is wrapped as tensors and stepped eagerly: the same step on the
    same values as the device-resident segment's, so the two epochs agree bitwise. On a
    CUDA device the batch is staged into pinned memory and copied without blocking into
    static device buffers (one images/labels pair per batch shape, allocated at the first
    batch of that shape) on the current stream, so the copy is ordered before the step that
    reads it, and the next batch's copy after it. Then ``"eager"`` runs the step on the
    buffers; ``"cuda-graph"`` replays a one-step ``CapturedSegment`` over them, whose graph
    gathers the batch from the buffers by the identity plan, as the device-resident segment
    gathers it from the split. The buffers' addresses are the graph's key, so there is one
    graph per batch shape however many batches are fed; the launch counters count replays
    as ``CapturedSegment`` does, and a failed capture or replay raises.

    ``program`` overrides the rule (measurements that compare the two programs).
    """

    def __init__(self, train_step: Callable, device: torch.device | str, *,
                 grad_reduce=None, program: str | None = None):
        self.device = torch.device(device)
        self.program = program or segment_program(self.device, grad_reduce)
        if self.program not in ("eager", "cuda-graph"):
            raise ValueError(f"unknown host-fed program {self.program!r}")
        self.train_step = train_step
        self.captured = (CapturedSegment(train_step, grad_reduce=grad_reduce)
                         if self.program == "cuda-graph" else None)
        self.buffers: dict[tuple, tuple] = {}

    def _inputs(self, images: np.ndarray, labels: np.ndarray):
        """The batch as the step's tensors: ``(images, labels, identity plan)`` (the plan
        None on the CPU)."""
        x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
        y = torch.from_numpy(np.asarray(labels, dtype=np.int64))
        if self.device.type != "cuda":
            return x, y, None
        key = (tuple(x.shape), tuple(y.shape))
        if key not in self.buffers:
            self.buffers[key] = (torch.empty(x.shape, dtype=x.dtype, device=self.device),
                                 torch.empty(y.shape, dtype=y.dtype, device=self.device),
                                 torch.arange(len(y), device=self.device).view(1, -1))
        x_buf, y_buf, ident = self.buffers[key]
        # pinned blocks come from torch's caching host allocator, which hands one out
        # again only after the copy that reads it has finished
        x_buf.copy_(x.pin_memory(), non_blocking=True)
        y_buf.copy_(y.pin_memory(), non_blocking=True)
        return x_buf, y_buf, ident

    def __call__(self, state, images: np.ndarray, labels: np.ndarray, seed: int):
        x, y, ident = self._inputs(images, labels)
        if self.captured is None:
            return self.train_step(state, x, y, seed)
        state, losses = self.captured(state, x, y, ident, seed)
        return state, losses[0]


def make_epoch_from_step(train_step: Callable, *, unroll: int = 1, pregather: bool = False,
                         health: bool = False, grad_reduce=None) -> Callable:
    """Wrap a ``step(state, images, labels, seed)`` into the segment program with
    ``make_segment_fn``'s contract: captured (``CapturedSegment``) or eager, by the rule
    ``segment_program(images.device, grad_reduce)`` applied at each call.

    ``unroll`` is the JAX package's scan unroll; only 1 is accepted: a captured segment has
    no loop body to unroll (every step is already laid out in the graph). ``grad_reduce``
    is the reducer the step calls: the rule reads its staging, and the captured program
    counts its calls at each replay."""
    check_scan_unroll(unroll)
    eager = make_segment_fn(train_step, pregather=pregather, health=health)
    captured = CapturedSegment(train_step, pregather=pregather, health=health,
                               grad_reduce=grad_reduce)

    def epoch(state, images, labels, idx_matrix, seed):
        if segment_program(images.device, grad_reduce) == "cuda-graph":
            return captured(state, images, labels, idx_matrix, seed)
        return eager(state, images, labels, idx_matrix, seed)

    return epoch


def make_epoch_fn(model, *, learning_rate: float, momentum: float,
                  use_pallas: bool = False, unroll: int = 1,
                  pregather: bool = False, grad_accum: int = 1,
                  optimizer: Optimizer | None = None,
                  lr_schedule: Callable | None = None,
                  clip_grad_norm: float = 0.0,
                  ema_decay: float = 0.0,
                  label_smoothing: float = 0.0,
                  health: bool = False,
                  guard: GuardSpec | None = None,
                  grad_reduce: Callable | None = None, rank: int = 0,
                  **step_kwargs) -> Callable:
    """Build ``epoch(state, images, labels, idx_matrix, seed) -> (state, losses)``: the
    step of ``make_train_step`` (same options, ``step_kwargs`` its mesh hooks) over a
    ``[steps, batch]`` index plan, as
    the segment program ``make_epoch_from_step`` picks. ``health=True`` builds the step
    with ``with_metrics`` and returns ``(state, (losses, HealthStats))``."""
    train_step = make_train_step(model, learning_rate=learning_rate, momentum=momentum,
                                 use_pallas=use_pallas, grad_accum=grad_accum,
                                 optimizer=optimizer, lr_schedule=lr_schedule,
                                 clip_grad_norm=clip_grad_norm, ema_decay=ema_decay,
                                 label_smoothing=label_smoothing, with_metrics=health,
                                 guard=guard, grad_reduce=grad_reduce, rank=rank,
                                 **step_kwargs)
    return make_epoch_from_step(train_step, unroll=unroll, pregather=pregather,
                                health=health, grad_reduce=grad_reduce)


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
            log_probs = apply_model(model, params, x)
            sum_nll += ops.nll_loss(log_probs, y, reduction="sum")
            correct += (log_probs.argmax(dim=-1) == y).sum()
        return sum_nll, correct

    return evaluate
