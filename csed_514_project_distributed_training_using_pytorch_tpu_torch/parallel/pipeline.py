"""Pipeline parallelism: the transformer's block stack split over the ``stage`` axis, with
microbatches streaming through the stage ranks.

Counterpart of the JAX package's ``parallel/pipeline.py``:

- the bridge: ``stack_stage_params`` stacks per-stage parameter dicts on a new leading
  dim; ``stack_transformer_blocks`` turns a classifier's ``block_i.*`` leaves into one
  ``[num_layers, ...]`` stack per leaf name (``attn.qkv_kernel``, ...) beside the rest
  (embeddings, final LayerNorm, head); ``unstack_transformer_blocks`` is its inverse.
  ``to_stacked_layout``/``from_stacked_layout`` are the trainer's flat form of it
  (``blocks.<leaf>``, ``rest.<name>``): a stage run trains in the stacked layout, each
  stage rank holding its ``num_layers / S`` layers, and its checkpoints go back through
  the bridge to the standard per-name layout, so they interchange with every mesh;
- ``pipeline_apply``: ``M`` microbatches through ``S`` stages. Stage ``s`` applies its
  layers to microbatch ``w`` at tick ``w + s`` (``M + S − 1`` ticks, ``S − 1`` of them fill
  and drain on each stage: the bubble ``(S − 1)/(M + S − 1)``); the activations move to
  the next stage rank by ``collectives.send``/``recv``, and the last stage's outputs are
  broadcast over the stage group, so the loss and the logits come out the same on every
  rank (the JAX package's masked ``psum``). ``SCHEDULES`` picks the backward:
  ``"gpipe"`` keeps every microbatch's autograd graph and runs their backwards after the
  forward, last microbatch first (the transposed scan's order); ``"1f1b"`` keeps only each
  microbatch's stage input and recomputes the stage in its backward, microbatch ``u`` at
  tick ``u + (S − 1 − s)`` on stage ``s``, first microbatch first, so activation memory is
  one stage input a microbatch whatever the stage's depth. The gradient of each
  microbatch's stage input goes to the previous stage rank by send/recv, and stage 0's
  input gradients are broadcast over the stage group, so the embedding's gradient is the
  same on every rank. Every rank posts its sends and receives in the one order the
  schedule fixes, so gloo's blocking point-to-point cannot deadlock;
- ``PipelinedClassifier``: the classifier's forward with the block stack pipelined, over
  the stacked layout, with the step's ``apply_params`` call contract (the train step and
  the eval run it unchanged). The eval engine pipelines the replicated eval batch.

Dropout is refused, as in the JAX package (the microbatch ticks thread no dropout keys).
``last_timing()`` reports the stage's busy and idle time of its latest call and the
bubble formula beside them.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
from torch.func import functional_call

from csed_514_project_distributed_training_using_pytorch_tpu_torch import ops
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    Axis,
)

SCHEDULES = ("gpipe", "1f1b")
_TIMING: dict = {}


def last_timing() -> dict:
    """The latest ``pipeline_apply`` forward on this rank: ``stages``, ``microbatches``,
    ``bubble`` (the formula ``(S−1)/(M+S−1)``), ``busy_s`` (time in the stage's layers),
    ``wall_s`` (the whole schedule, waits included) and ``idle_share``."""
    return dict(_TIMING)


def stack_stage_params(stage_param_list: list[dict]) -> dict[str, torch.Tensor]:
    """Per-stage parameter dicts of one structure -> one dict whose leaves carry a leading
    ``[num_stages, ...]`` dim."""
    return {k: torch.stack([p[k] for p in stage_param_list]) for k in stage_param_list[0]}


def stack_transformer_blocks(params: dict[str, torch.Tensor], num_layers: int):
    """A classifier's parameter dict (``block_i.*`` leaves: the checkpoint layout) ->
    ``(stacked, rest)``: one ``[num_layers, ...]`` stack per block leaf name, and every
    other leaf. Inverse: ``unstack_transformer_blocks``."""
    expected = {f"block_{i}" for i in range(num_layers)}
    have = {k.split(".", 1)[0] for k in params if k.startswith("block_")}
    missing = sorted(expected - have)
    if missing:
        raise ValueError(f"params tree lacks block subtrees {missing}")
    extra = sorted(have - expected)
    if extra:
        raise ValueError(
            f"params tree has block subtrees beyond num_layers={num_layers}: {extra} "
            f"— silently dropping layers would corrupt the round-trip")
    per_layer = [{k[len(f"block_{i}."):]: v for k, v in params.items()
                  if k.startswith(f"block_{i}.")} for i in range(num_layers)]
    stacked = stack_stage_params(per_layer)
    rest = {k: v for k, v in params.items() if not k.startswith("block_")}
    return stacked, rest


def unstack_transformer_blocks(stacked: dict[str, torch.Tensor], rest: dict) -> dict:
    """The per-name checkpoint layout from ``(stacked, rest)``."""
    num_layers = next(iter(stacked.values())).shape[0]
    out = dict(rest)
    for i in range(num_layers):
        for k, v in stacked.items():
            out[f"block_{i}.{k}"] = v[i]
    return out


def to_stacked_layout(params: dict[str, torch.Tensor], num_layers: int) -> dict:
    """The stage trainer's flat stacked layout: ``blocks.<leaf>`` and ``rest.<name>``."""
    stacked, rest = stack_transformer_blocks(params, num_layers)
    return {**{f"blocks.{k}": v.contiguous() for k, v in stacked.items()},
            **{f"rest.{k}": v for k, v in rest.items()}}


def from_stacked_layout(flat: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The standard per-name layout from ``to_stacked_layout``'s (all layers present)."""
    stacked = {k[len("blocks."):]: v for k, v in flat.items() if k.startswith("blocks.")}
    rest = {k[len("rest."):]: v for k, v in flat.items() if k.startswith("rest.")}
    return unstack_transformer_blocks(stacked, rest)


def stacked_partition_specs(flat: dict[str, torch.Tensor], names, *,
                            axis_name: str = "stage", model_axis: str = "model"
                            ) -> dict[str, tuple]:
    """The JAX package's ``stacked_state_shardings`` as specs: every ``blocks`` leaf split
    on its layer stack over ``stage`` and, when the mesh has a model axis, on its Megatron
    dim over ``model`` too (``tensor_parallel``'s rules one dim right); ``rest``
    replicates."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
        tensor_parallel as tp,
    )
    has_model = model_axis in set(names)
    specs = {}
    for k, p in flat.items():
        if k.startswith("blocks."):
            spec = tp.spec_for(k, p.dim(), axis_name=model_axis, shift=1)
            specs[k] = (axis_name,) + tuple(a if has_model and a == model_axis else None
                                            for a in spec[1:])
        else:
            specs[k] = (None,) * p.dim()
    return specs


class _Pipeline(torch.autograd.Function):
    """The schedule on one stage rank: inputs ``xs [M, mb, ...]`` (read on stage 0) and
    this stage's parameter leaves; output the banked ``[M, mb, ...]`` outputs (real on the
    last stage, zeros elsewhere). ``keep_graph``: gpipe under autograd keeps each
    microbatch's graph from the forward (the function's forward runs with grad off, so
    it builds them under ``enable_grad`` on leaves of its own)."""

    @staticmethod
    def forward(ctx, run, keep_graph: bool, xs, *leaves):
        stage_fn, names, axis, schedule = run
        s, n = axis.index, axis.size
        m = xs.shape[0]
        params = dict(zip(names, leaves))
        if keep_graph:
            params = {k: p.detach().requires_grad_() for k, p in params.items()}
        bank = torch.zeros_like(xs)
        saved, busy, t0 = [], 0.0, time.perf_counter()
        for w in range(m):
            x_in = xs[w] if s == 0 else collectives.recv(xs[0], s - 1, group=axis.group)
            t = time.perf_counter()
            if keep_graph:
                x_leaf = x_in.detach().requires_grad_()
                with torch.enable_grad():
                    y = stage_fn(params, x_leaf)
                saved.append((x_leaf, y))
            else:
                y = stage_fn(params, x_in)
                saved.append(x_in)
            busy += time.perf_counter() - t
            if s < n - 1:
                collectives.send(y.detach(), s + 1, group=axis.group)
            else:
                bank[w] = y.detach()
        wall = time.perf_counter() - t0
        _TIMING.clear()
        _TIMING.update(stages=n, microbatches=m, bubble=(n - 1) / (m + n - 1),
                       busy_s=busy, wall_s=wall,
                       idle_share=1.0 - busy / wall if wall else 0.0, schedule=schedule)
        ctx.run, ctx.saved, ctx.params, ctx.keep_graph = run, saved, params, keep_graph
        ctx.like = xs[0]
        return bank

    @staticmethod
    def backward(ctx, d_bank):
        stage_fn, names, axis, schedule = ctx.run
        s, n = axis.index, axis.size
        m = d_bank.shape[0]
        dxs = torch.zeros_like(d_bank)
        params = ctx.params
        if not ctx.keep_graph:
            params = {k: p.detach().requires_grad_() for k, p in params.items()}
        inputs = [params[k] for k in names]
        totals = [torch.zeros_like(p) for p in inputs]
        order = range(m - 1, -1, -1) if schedule == "gpipe" else range(m)
        for w in order:
            g = d_bank[w] if s == n - 1 else collectives.recv(ctx.like, s + 1,
                                                              group=axis.group)
            if ctx.keep_graph:
                x_leaf, y = ctx.saved[w]
            else:                       # 1F1B: recompute the stage at its saved input
                x_leaf = ctx.saved[w].detach().requires_grad_()
                with torch.enable_grad():
                    y = stage_fn(params, x_leaf)
            grads = torch.autograd.grad(y, [x_leaf] + inputs, g, allow_unused=True)
            for total, gp in zip(totals, grads[1:]):
                if gp is not None:
                    total.add_(gp)
            if s > 0:
                collectives.send(grads[0], s - 1, group=axis.group)
            else:
                dxs[w] = grads[0]
        ctx.saved = ctx.params = None
        collectives.broadcast_(dxs, src=0, group=axis.group)   # the input's gradient
        return (None, None, dxs, *totals)


class _FromLastStage(torch.autograd.Function):
    """The last stage's banked outputs on every stage rank; in backward the last stage
    keeps its gradient (every rank computes the same loss from the same outputs) and the
    others pass zeros to their schedule, which ignores them."""

    @staticmethod
    def forward(ctx, bank, axis):
        ctx.axis = axis
        out = bank.clone()
        collectives.broadcast_(out, src=axis.size - 1, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.axis.index == ctx.axis.size - 1:
            return g, None
        return torch.zeros_like(g), None


def pipeline_apply(stage_fn: Callable, stage_params: dict[str, torch.Tensor],
                   microbatches: torch.Tensor, *, stage: Axis,
                   schedule: str = "gpipe") -> torch.Tensor:
    """Run ``microbatches [M, mb, ...]`` (the same on every stage rank) through the stage
    pipeline: ``stage_fn(stage_params, x) -> y`` is this rank's stage (``y`` shaped like
    ``x``), ``stage_params`` its layers. Returns the ``[M, mb, ...]`` outputs on every
    stage rank, differentiable in both the inputs and the parameters."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r} — one of {SCHEDULES}")
    names = list(stage_params)
    leaves = [stage_params[k] for k in names]
    differentiable = torch.is_grad_enabled() and (
        microbatches.requires_grad or any(p.requires_grad for p in leaves))
    bank = _Pipeline.apply((stage_fn, names, stage, schedule),
                           differentiable and schedule == "gpipe", microbatches, *leaves)
    return _FromLastStage.apply(bank, stage)


class PipelinedClassifier:
    """``TransformerClassifier``'s forward with its block stack pipelined over the stage
    axis: the composed trainer's ``--mesh ...,stage=S`` engine. It runs on the stacked
    layout (``to_stacked_layout``: each stage rank's ``blocks.*`` leaves hold its
    ``num_layers / S`` layers) through ``apply_params``, the call ``train.step`` makes of
    a model that lays its parameters out its own way. The embedding and head math is the
    classifier's; each stage applies the classifier's own block module to its layers in
    stack order, so every attention-shaping field carries over. ``num_microbatches``
    splits the batch it is given (this data rank's; the eval's whole batch)."""

    num_experts = 0

    def __init__(self, model, stage: Axis, *, num_microbatches: int = 4,
                 schedule: str = "gpipe"):
        if model.num_layers % stage.size:
            raise ValueError(f"num_layers {model.num_layers} not divisible by stage axis "
                             f"{stage.size}")
        if model.num_experts:
            raise ValueError("stage pipelining of MoE blocks is unsupported")
        if model.dropout_rate:
            raise ValueError(
                "stage pipelining requires dropout_rate == 0 — the microbatch ring "
                "does not thread dropout keys, so a nonzero rate would silently "
                "train without dropout")
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r} — one of {SCHEDULES}")
        self.model, self.stage = model, stage
        self.num_microbatches, self.schedule = num_microbatches, schedule
        self.layers_per_stage = model.num_layers // stage.size
        self.block = model.block_0

    def stage_fn(self, params: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """This stage's layers on ``x``, in stack order."""
        for layer in range(self.layers_per_stage):
            x = functional_call(self.block, {k: p[layer] for k, p in params.items()},
                                (x, True, None))
        return x

    def apply_params(self, params: dict[str, torch.Tensor], x: torch.Tensor, *,
                     deterministic: bool = True, generator=None, with_aux: bool = False):
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
            tokenize_images,   # lazy: models.transformer imports parallel/ at load
        )
        model = self.model
        rest = {k[len("rest."):]: v for k, v in params.items() if k.startswith("rest.")}
        blocks = {k[len("blocks."):]: v for k, v in params.items()
                  if k.startswith("blocks.")}
        if x.dim() == 4:
            x = tokenize_images(x, model.seq_len)
        cast = lambda w: w.to(model.dtype)
        h = ops.dense(x.to(model.dtype), cast(rest["embed_kernel"]),
                      cast(rest["embed_bias"]))
        h = h + cast(rest["pos_embed"])[None]
        b = h.shape[0]
        m = self.num_microbatches
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        ys = pipeline_apply(self.stage_fn, blocks, h.reshape((m, b // m) + h.shape[1:]),
                            stage=self.stage, schedule=self.schedule)
        h = ys.reshape(h.shape)
        h = ops.layer_norm(h, rest["ln_f_scale"], rest["ln_f_bias"]).mean(dim=1)
        logits = ops.dense(h, cast(rest["head_kernel"]), cast(rest["head_bias"]))
        out = ops.log_softmax(logits.float())
        return (out, torch.zeros((), device=out.device)) if with_aux else out


__all__ = ["PipelinedClassifier", "SCHEDULES", "from_stacked_layout", "last_timing",
           "pipeline_apply", "stack_stage_params", "stack_transformer_blocks",
           "stacked_partition_specs", "to_stacked_layout", "unstack_transformer_blocks"]
