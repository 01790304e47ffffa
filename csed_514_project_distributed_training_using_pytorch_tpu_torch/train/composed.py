"""Composed trainer for the transformer classifier over any mesh of the five axes.

Counterpart of the JAX package's ``train/composed.py``: the ``TransformerClassifier`` at the
trainer's widths (embed 64, 2 layers, 4 heads), ``epochs`` of ``n_train // batch_size``
steps over the ``(seed, epoch)`` permutation (bitwise the JAX package's), the eval after
each epoch, the ``Epoch N: train_loss ...`` line and ``results/metrics.jsonl``. Per-step
losses stay on the device; the host reads them once per epoch.

``--mesh`` lays the process group out as a grid (``parallel.mesh.ProcessGrid``: the
spec's product of ranks, started by ``train.launch`` or ``torchrun``; without them a world
of one), as the JAX package lays its devices out, default ``data=2,seq=2,model=2``:

- ``data``: each data coordinate steps on its block of every global batch (of every
  microbatch, under ``--grad-accum`` and the pipeline's microbatches), drawing its rows
  of the global batch's dropout masks; the gradient and the loss are averaged over the
  data group (``data_parallel.GradReducer``), as the JAX program's gradient all-reduce;
- ``seq``: attention shards the sequence over the seq group: the ring (``--seq-impl
  ring``, the default: the einsum ring or zig-zag, of flash with ``--flash-attention``)
  or Ulysses (``--seq-impl ulysses``);
- ``model``: Megatron TP (``parallel.tensor_parallel``): each rank runs its local heads
  and hidden units;
- ``expert``: every block's feed-forward is the routed MoE with one expert a rank
  (``--moe-top-k`` 1 or 2; ``parallel.expert_parallel``), its load-balance auxiliary in
  the objective;
- ``stage``: the block stack in ``S`` stages (``parallel.pipeline``,
  ``--pipeline-microbatches``, ``--pipeline-schedule gpipe|1f1b``), trained in the stacked
  layout;
- ``--fsdp``: params and optimizer state also split over ``data`` (``parallel.fsdp``'s
  hybrid rule), gathered where the blocks use them.

Each rank holds its shards of the state; the update runs on them. Every refusal the JAX
package makes is made here with its words. A world of more than one rank on the one H100
runs gloo, every rank on ``cuda:0`` time-slicing the card and every collective staged
through host memory: such runs check correctness, they are not scaling points.

``--flash-attention`` routes attention through ``ops.flash_attention.dispatch_attention``
without a seq axis (the CUDA flash kernels at ``seq_len >= 2048``, the JAX package's
predicate; the dense core below), through the ring-of-flash or Ulysses of flash with one;
``--attention-window`` binds the band into each. Run the default mesh on the card with::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.launch \\
        --num-processes 8 -- \\
        -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.composed

The step's options are ``train.single``'s (``utils.config.StepOptions``: AdamW, LR
schedules, clipping, label smoothing, EMA, gradient accumulation, the guard and its
``--anomaly-exit``; a sharded layout's clip and guard norms sum its shards over their
groups), with ``--remat``/``--remat-policy`` (each block recomputed in the backward, its
collectives and FSDP gathers with it). The segment stays the eager loop on every device:
the f32 step at seq 2048 is device-bound, and gloo's collectives cannot be captured
(ROADMAP B, "composed data=1 under the graph").

The run options are the JAX package's (``utils.config.ResilienceOptions``): each epoch
every rank joins in unsharding the state to the standard per-name layout (the stage
layout back through the bridge) and rank 0 writes ``results/model_composed.ckpt`` in the
JAX byte layout (the versioned store too under ``--keep-checkpoints``;
``--async-checkpoint`` writes behind the loop); ``--sharded-checkpoint`` also writes
``model_composed.ckpt.sharded/``, every rank its own blocks; ``--resume-from`` takes
either, from any mesh or trainer of the same widths, and skips the epochs it holds;
``--heartbeat-dir`` beats each epoch; ``--handle-preemption`` turns SIGTERM into a stop at
the next epoch boundary, and ``__main__`` exits 75; ``--profile`` traces the run with
``torch.profiler``.

``--dcn-data N`` lays the grid out as the JAX package's ``make_hybrid_mesh`` does for N
slices (``parallel.mesh.hybrid_rank_order``): the data axis's leading factor strides over N
contiguous granules of ranks, every other axis stays inside a granule. It moves ranks, not
math: the trajectory is the same mesh's without it, up to the order of the data
all-reduce. ``--telemetry PATH`` (rank 0 writes) records the manifest with the grid's axes,
the first epoch call's seconds and one step's flops as the ``compile`` event, one
``epoch`` event an epoch and the ``mfu`` event; ``--health-stats`` adds one ``health``
event an epoch from the segment's accumulators (the grad norm is the grid's
``sharded_norm_fn``, as the step's clip reads it).

``--plan auto|tune|<path>`` picks the layout instead of ``--mesh`` (``plan/``: the mesh,
``--fsdp``, ``--grad-accum`` and ``--pipeline-microbatches`` over the launched world's
devices; ``tune`` trials the top three one-device candidates first, at a world of one),
saves ``<results_dir>/plan_composed.json`` and emits the ``plan`` (and ``autotune``)
telemetry events; without it nothing changes.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch import resilience
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
    download_mnist,
    load_mnist,
    truncate,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import build_model
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
    NUM_HEADS,
    TransformerClassifier,
    validate_remat_policy,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    attention,
    flash_attention,
    optim,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    data_parallel as dp,
    fsdp,
    pipeline,
    ring_attention,
    tensor_parallel as tp,
    ulysses,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    NO_SHARDING,
    ProcessGrid,
    ShardContext,
    cluster,
    hybrid_rank_order,
    mesh_axes,
    parse_mesh_spec,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.guard import (
    GuardRuntime,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
    resolve_device,
    run_cli,
    step_options,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
    GuardSpec,
    TrainState,
    create_train_state,
    make_eval_fn,
    make_segment_fn,
    make_train_step,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import checkpoint
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import metrics as M
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import telemetry as T
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
    ComposedConfig,
    check_step_options,
    model_options,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.determinism import (
    assert_replicas_synced,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.profiling import (
    maybe_profile,
)

AXES = ("data", "seq", "model", "expert", "stage")


def epoch_plan(seed: int, epoch: int, n_train: int, steps: int, batch: int) -> np.ndarray:
    """The epoch's ``[steps, batch]`` index plan: the first ``steps·batch`` entries of the
    ``(seed, epoch)``-keyed permutation, the JAX package's expression."""
    perm = np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(n_train)
    return perm[:steps * batch].astype(np.int64).reshape(steps, batch)


def local_columns(plan: np.ndarray, data_size: int, data_index: int,
                  pieces: int) -> np.ndarray:
    """This data rank's columns of a ``[steps, batch]`` plan: its ``1/data_size`` of each
    of the ``pieces`` microbatches a step splits into (``grad_accum`` × the pipeline's
    microbatches), in order, so that its ``i``-th local microbatch is its block of the
    global ``i``-th, as the JAX program shards each microbatch over ``data``."""
    steps, batch = plan.shape
    per = batch // (pieces * data_size)
    return plan.reshape(steps, pieces, data_size, per)[:, :, data_index].reshape(steps, -1)


def validate_config(config: ComposedConfig) -> dict[str, int]:
    """The flag checks, before any data work, with the JAX package's messages where it has
    them; returns the mesh's axis sizes (every axis, 1 where the spec lacks it)."""
    axes = {name: 1 for name in AXES}
    axes.update(mesh_axes(config.mesh))
    data, seq, model, expert, stage = (axes[n] for n in AXES)
    check_step_options(config)
    validate_remat_policy(config.remat, config.remat_policy)
    if config.dcn_data and "data" not in mesh_axes(config.mesh):
        raise ValueError("--dcn-data needs a data axis in --mesh (it is the axis whose "
                         "leading factor spans slices)")
    if config.kv_heads and (config.kv_heads < 0 or NUM_HEADS % config.kv_heads):
        raise ValueError(f"--kv-heads {config.kv_heads} must be a positive divisor of the "
                         f"transformer's {NUM_HEADS} heads")
    if config.attention_window:
        attention.validate_window(config.attention_window)
    if config.batch_size % data:
        raise ValueError(f"batch {config.batch_size} not divisible by data axis {data}")
    if config.batch_size % config.grad_accum:
        raise ValueError(f"batch {config.batch_size} not divisible by grad_accum "
                         f"{config.grad_accum}")
    if config.grad_accum > 1 and (config.batch_size // config.grad_accum) % data:
        raise ValueError(
            f"microbatch {config.batch_size // config.grad_accum} (batch/grad_accum) not "
            f"divisible by data axis {data} — each microbatch must still shard evenly")
    if stage > 1:
        if seq > 1 or expert > 1:
            raise ValueError(
                "a stage axis composes with data and model only — seq/expert "
                "inside a pipeline stage would need nested shard_maps")
        if config.dropout_rate:
            raise ValueError("stage pipelining requires dropout_rate == 0 "
                             "(microbatch ticks do not thread dropout keys)")
        if config.remat:
            raise ValueError("--remat has no effect under a stage axis (the pipeline "
                             "engine applies blocks itself) — drop it")
        if config.zigzag_attention:
            raise ValueError("--zigzag-attention needs a seq axis, which does not compose "
                             "with a stage axis")
        if config.fsdp:
            raise ValueError(
                "--fsdp does not compose with a stage axis: the pipeline's shard_map "
                "keeps the data axis MANUAL, which conflicts with ZeRO's data-axis "
                "weight sharding")
        if config.flash_attention and model > 1:
            raise ValueError(
                "--flash-attention under stage x model is unsupported: the flash "
                "pallas_call cannot be partitioned by the AUTO model axis inside the "
                "pipeline body (drop model or flash)")
        if config.sharded_checkpoint:
            raise ValueError(
                "--sharded-checkpoint saves the device state's own layout, and the stage "
                "axis trains in the stacked layout — its shard keys would not "
                "interchange; use the default full-state checkpoint with stages")
        step_batch = config.batch_size // config.grad_accum
        if step_batch % config.pipeline_microbatches:
            raise ValueError(f"per-call batch {step_batch} (batch/grad_accum) not divisible "
                             f"by {config.pipeline_microbatches} pipeline microbatches")
        if (step_batch // config.pipeline_microbatches) % data:
            raise ValueError(f"pipeline microbatch {step_batch // config.pipeline_microbatches}"
                             f" not divisible by data axis {data}")
        if config.batch_size_test % config.pipeline_microbatches:
            raise ValueError(f"test batch {config.batch_size_test} not divisible by "
                             f"{config.pipeline_microbatches} pipeline microbatches")
        if config.pipeline_schedule not in pipeline.SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {config.pipeline_schedule!r} — "
                             f"one of {pipeline.SCHEDULES}")
    if config.seq_impl not in ("ring", "ulysses"):
        raise ValueError(
            f"--seq-impl must be 'ring' or 'ulysses', got {config.seq_impl!r}")
    if config.seq_impl == "ulysses" and config.zigzag_attention:
        raise ValueError("--zigzag-attention is a ring schedule — it does not "
                         "compose with --seq-impl ulysses")
    block = flash_attention.BLOCK
    if config.seq_impl == "ulysses" and seq > 1:
        ulysses.check_shapes(config.seq_len, NUM_HEADS // model if NUM_HEADS % model == 0
                             else NUM_HEADS, seq, config.flash_attention)
    elif config.zigzag_attention:
        if not config.causal:
            raise ValueError("--zigzag-attention is causal-only — add --causal")
        if "seq" not in mesh_axes(config.mesh):
            raise ValueError("--zigzag-attention needs a seq axis in --mesh")
        if config.flash_attention and config.seq_len % (2 * seq * block):
            raise ValueError(
                f"--zigzag-attention --flash-attention needs seq_len divisible "
                f"by 2·seq_axis·BLOCK = {2 * seq * block}, got {config.seq_len} "
                f"(e.g. --seq-len {2 * seq * block})")
        if not config.flash_attention and config.seq_len % (2 * seq):
            raise ValueError(
                f"--zigzag-attention needs seq_len divisible by 2·seq_axis = "
                f"{2 * seq}, got {config.seq_len}")
    elif config.flash_attention:
        if config.seq_len % (seq * block):
            raise ValueError(
                f"--flash-attention needs seq_len divisible by "
                f"seq_axis·BLOCK = {seq}·{block}, got "
                f"{config.seq_len} (e.g. --seq-len {seq * block})")
    if not 1 <= config.moe_top_k <= max(expert, 1):
        raise ValueError(f"--moe-top-k must be in [1, expert axis size], got "
                         f"{config.moe_top_k} with expert={expert}")
    if seq > 1 and config.seq_len % seq:
        raise ValueError(f"model seq_len {config.seq_len} not divisible by seq axis {seq}")
    kv = config.kv_heads or NUM_HEADS
    if NUM_HEADS % model or kv % model:
        raise ValueError(f"the model axis {model} must divide the transformer's "
                         f"{NUM_HEADS} query heads and {kv} K/V heads (each rank runs its "
                         f"local heads)")
    return axes


def attention_core(config: ComposedConfig, seq: int, group=None):
    """The attention core the flags choose, as the JAX package chooses it: Ulysses (dense
    or of flash) or the ring family (einsum or of flash, plain or zig-zag) over the seq
    ``group`` under a seq axis; else one device's flash dispatch, windowed core or dense
    core."""
    window = config.attention_window
    if config.seq_impl == "ulysses" and seq > 1:
        return ulysses.make_ulysses_attention_fn(use_flash=config.flash_attention,
                                                 window=window, group=group)
    if config.zigzag_attention or seq > 1:
        return ring_attention.make_ring_attention_fn(
            use_flash=config.flash_attention, use_zigzag=config.zigzag_attention,
            window=window, group=group)
    if config.flash_attention:
        return functools.partial(flash_attention.dispatch_attention, window=window or None)
    if window:
        return attention.windowed_attention_fn(window)
    return attention.full_attention


def build_classifier(config: ComposedConfig, *, shard: ShardContext = NO_SHARDING,
                     grid: ProcessGrid | None = None) -> TransformerClassifier:
    """The model the trainer runs: ``models.build_model`` maps the knobs, the attention
    core is chosen from the flags (``attention_core``, which binds the window itself), an
    expert axis makes every block an MoE with one expert a rank, and ``shard`` places it
    on the grid (``NO_SHARDING``: one device)."""
    axes = {name: 1 for name in AXES}
    axes.update(mesh_axes(config.mesh))
    seq_group = grid.axis("seq").group if grid is not None else None
    moe = {}
    if axes["expert"] > 1:
        moe = {"num_experts": axes["expert"], "expert_top_k": config.moe_top_k}
    return build_model("transformer", **{**model_options(config), "attention_window": 0},
                       seq_len=config.seq_len, dropout_rate=config.dropout_rate,
                       attention_fn=attention_core(config, axes["seq"], seq_group),
                       shard=shard, **moe)


def build_segment_fn(config: ComposedConfig, model, *, total_steps: int = 0,
                     guard: GuardSpec | None = None, **hooks):
    """The optimizer and the eager segment function ``main`` trains with (one call per
    epoch over the epoch's index plan), from the flags (``total_steps``: the cosine
    schedule's horizon; ``guard``: the guard's spec; ``hooks``: the mesh's step hooks,
    ``grad_reduce``, ``dropout_rows``, ``norm_fn``): one definition, so that a caller
    timing the trainer's steps runs the same ones."""
    optimizer = optim.make_optimizer(config.optimizer, learning_rate=config.learning_rate,
                                     momentum=config.momentum,
                                     weight_decay=config.weight_decay)
    lr_schedule = optim.make_lr_schedule(config.lr_schedule,
                                         warmup_steps=config.warmup_steps,
                                         total_steps=total_steps)
    step = make_train_step(model, **step_options(config, optimizer, lr_schedule, guard),
                           grad_accum=config.grad_accum, with_metrics=config.health_stats,
                           **hooks)
    return optimizer, make_segment_fn(step, pregather=config.pregather,
                                      health=config.health_stats)


def main(config: ComposedConfig = ComposedConfig(), *, datasets=None,
         init_params: dict[str, torch.Tensor] | None = None,
         ) -> tuple[TrainState, M.MetricsHistory]:
    """Run composed training as this process's rank (every rank of the grid calls it);
    returns the final state in the standard per-name layout (the same on every rank) and
    the history.

    ``datasets`` optionally injects a ``(train, test)`` Dataset pair; ``init_params``
    optionally replaces the drawn initial parameters (both for tests: the JAX package's
    initial parameters carried across with ``models.transformer.params_from_jax``).

    ``--plan`` is resolved inside the process group, before the grid is laid out: the
    plan rewrites the mesh, FSDP, the gradient accumulation and the pipeline's
    microbatches (``plan.apply_plan``), and the planned config is validated as any
    other."""
    if not config.plan:
        validate_config(config)
    resolve_device(config.device)                     # fail fast, before any data work
    with cluster(config.device) as info:
        run_plan, plan_events = None, []
        if config.plan:
            # trial events buffer until the telemetry writer exists (_train)
            from csed_514_project_distributed_training_using_pytorch_tpu_torch import (
                plan as plan_mod,
            )
            config, run_plan = plan_mod.apply_plan(config, "composed",
                                                   emit=plan_events.append,
                                                   device=info.device)
            validate_config(config)
        order = None
        if config.dcn_data:
            names, sizes = parse_mesh_spec(config.mesh)
            order = hybrid_rank_order(names, sizes, num_slices=config.dcn_data)
        grid = ProcessGrid(config.mesh, order=order)
        return _train(config, info, grid, datasets, init_params, run_plan, plan_events)


def _train(config: ComposedConfig, info, grid: ProcessGrid, datasets, init_params,
           run_plan=None, plan_events=()):
    watch = M.Stopwatch()
    device = info.device
    data, stage = grid.axis("data"), grid.axis("stage")
    store_dir = os.path.join(config.results_dir, "checkpoints") if config.results_dir else ""
    tele = T.TrainerTelemetry(config.telemetry, config, run_type="composed", device=device,
                              axes=mesh_axes(config.mesh), preserve=bool(config.resume_from))
    if run_plan is not None:
        tele.plan(run_plan, plan_events)
    grt = GuardRuntime(config, store_dir=store_dir, tele=tele.writer)
    if config.download_data and datasets is None:
        download_mnist(config.data_dir)
    train_ds, test_ds = datasets if datasets is not None else load_mnist(config.data_dir)
    train_ds = truncate(train_ds, config.max_train_examples)
    test_ds = truncate(test_ds, config.max_test_examples)
    n_train, n_test = len(train_ds), len(test_ds)
    batch = config.batch_size
    steps_per_epoch = n_train // batch
    if steps_per_epoch == 0:
        raise ValueError(f"batch {batch} larger than the train split ({n_train} examples) "
                         f"— nothing to step")
    M.log(f"Composed training: mesh {mesh_axes(config.mesh)} over {grid.world} devices on "
          f"{info.process_count} process(es) ({info.backend}), batch {batch}, data "
          f"source: {train_ds.source}")

    # the standard-layout state, the same on every rank (seeded), then this rank's shards
    plain = build_classifier(config)
    optimizer = optim.make_optimizer(config.optimizer, learning_rate=config.learning_rate,
                                     momentum=config.momentum,
                                     weight_decay=config.weight_decay)
    state = create_train_state(plain, torch.Generator().manual_seed(config.seed),
                               optimizer=optimizer, device=device,
                               ema=config.ema_decay > 0, guard=config.guard)
    if init_params is not None:
        params = {k: p.to(device) for k, p in init_params.items()}
        state = state._replace(params=params, velocity=optimizer.init(params),
                               ema=(None if state.ema is None
                                    else {k: p.clone() for k, p in params.items()}))
    start_epoch = 0
    if config.resume_from:
        # checkpoints are in the one standard layout whatever mesh or trainer wrote them
        state, start_epoch, warning = checkpoint.restore_for_resume(
            config.resume_from, state, process_index=info.process_index,
            process_count=info.process_count, steps_per_epoch=steps_per_epoch,
            tele=tele.writer)
        if warning:
            M.log(f"WARNING: {warning}")
        M.log(f"Resumed from {config.resume_from} at step {int(state.step)} "
              f"(starting epoch {start_epoch})")
        note = checkpoint.check_cursor_resume(config.resume_from, seed=config.seed,
                                              step=int(state.step), start_epoch=start_epoch)
        if note:
            M.log(f"WARNING: {note}")
    if stage.size > 1:
        layout = lambda tree: pipeline.to_stacked_layout(tree, plain.num_layers)
        state = tp.map_state(state, layout)
        specs = pipeline.stacked_partition_specs(state.params, grid.names)
    elif config.fsdp:
        specs = fsdp.hybrid_partition_specs(state.params, grid.names, data.size)
    else:
        specs = tp.filter_to_grid(tp.param_partition_specs(state.params), grid.names)
    state = tp.shard_train_state(state, specs, grid)
    shard = ShardContext.of(grid, fsdp=fsdp.data_dims(specs) if config.fsdp else None)
    model = build_classifier(config, shard=shard, grid=grid)
    eval_model = build_classifier(config, shard=shard.replicated_batch(), grid=grid)
    if stage.size > 1:
        engines = [pipeline.PipelinedClassifier(
            m, stage, num_microbatches=config.pipeline_microbatches,
            schedule=config.pipeline_schedule) for m in (model, eval_model)]
        model, eval_model = engines

    # this data rank's block of every microbatch, and its rows of their dropout masks
    pieces = config.grad_accum * (config.pipeline_microbatches if stage.size > 1 else 1)
    micro = batch // config.grad_accum // data.size
    hooks = {"norm_fn": tp.sharded_norm_fn(specs, grid),
             "dropout_rows": (data.index * micro, micro * data.size) if data.size > 1
             else None}
    if data.size > 1:
        hooks["grad_reduce"] = (fsdp.FsdpReducer(state.params, fsdp.data_dims(specs),
                                                 group=data.group)
                                if config.fsdp else
                                dp.GradReducer(state.params, group=data.group))
    grt.baseline(state)
    _, segment_fn = build_segment_fn(
        config, model, total_steps=config.epochs * steps_per_epoch, guard=grt.spec,
        **hooks)
    eval_fn = make_eval_fn(eval_model, batch_size=config.batch_size_test)

    def to_standard(state: TrainState) -> TrainState:
        """The standard per-name layout of the whole state, on every rank."""
        full = tp.unshard_train_state(state, specs, grid)
        if stage.size > 1:
            full = tp.map_state(full, pipeline.from_stacked_layout)
        return full

    # Device-resident splits: the one host->device transfer.
    to_device = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    train_x, test_x = to_device(train_ds.images), to_device(test_ds.images)
    train_y = to_device(train_ds.labels.astype(np.int64))
    test_y = to_device(test_ds.labels.astype(np.int64))
    health = config.health_stats
    if tele.on:
        first = to_device(local_columns(np.arange(batch)[None] % n_train, data.size,
                                        data.index, pieces)[0])
        step = make_train_step(model, **step_options(config, optimizer, None, None),
                               grad_accum=config.grad_accum, norm_fn=hooks["norm_fn"],
                               dropout_rows=hooks["dropout_rows"])
        tele.flops_per_step = T.train_step_flops(step, state, train_x[first],
                                                 train_y[first], config.seed + 1)
    history = M.MetricsHistory()
    ckpt_path = (os.path.join(config.results_dir, "model_composed.ckpt")
                 if config.results_dir else "")
    saver = checkpoint.make_saver(config.async_checkpoint, tele=tele.writer)
    # host-side hooks at epoch boundaries; with both flags off they touch no state
    rt = resilience.RunHooks(heartbeat_dir=config.heartbeat_dir,
                             handle_preemption=config.handle_preemption,
                             process_index=info.process_index)
    host_state = None
    try:
        with maybe_profile(config.profile, config.profile_dir):
            for epoch in range(start_epoch, config.epochs):
                # the heartbeat, with the previous boundary's fingerprint; no-op off
                rt.epoch_tick(state, epoch, fingerprint=grt.fingerprint)
                t_epoch = time.perf_counter()
                plan = epoch_plan(config.seed, epoch, n_train, steps_per_epoch, batch)
                plan = to_device(local_columns(plan, data.size, data.index, pieces))
                t_exec = time.perf_counter()
                state, out = tele.first_call(segment_fn, state, train_x, train_y, plan,
                                             config.seed + 1, steps_per_call=steps_per_epoch,
                                             name="epoch")
                losses, epoch_health = out if health else (out, None)
                epoch_loss = losses.mean().item()               # the epoch's one host sync
                history.epoch_seconds.append(time.perf_counter() - t_epoch)
                t_eval = time.perf_counter()
                sum_nll, correct = eval_fn(
                    state.ema if state.ema is not None else state.params, test_x, test_y)
                val_loss = sum_nll.item() / n_test
                if health:
                    # every rank: the norm of a split state is a collective
                    health_host = T.host_health(epoch_health)
                    param_norm = T.global_l2_norm(state.params, hooks["norm_fn"])
                tele.epoch(epoch, examples=steps_per_epoch * batch, steps=steps_per_epoch,
                           wall_s=time.perf_counter() - t_epoch,
                           execute_s=t_eval - t_exec, eval_s=time.perf_counter() - t_eval,
                           data_s=t_exec - t_epoch, train_loss=epoch_loss,
                           val_loss=val_loss, health=health_host if health else None,
                           param_norm=param_norm if health else None)
                examples_trained = (epoch + 1) * steps_per_epoch * batch
                history.record_train(examples_trained, epoch_loss)
                history.record_test(examples_trained, val_loss)
                M.log(f"Epoch {epoch}: train_loss: {epoch_loss:.4f}, val_loss: "
                      f"{val_loss:.4f}, accuracy: {int(correct.item()) / n_test:.4f}, "
                      f"time_elapsed: {watch.elapsed():.2f}s")
                if stage.size > 1:
                    t = pipeline.last_timing()
                    M.log(f"Pipeline ({config.pipeline_schedule}): {t['stages']} stages, "
                          f"{t['microbatches']} microbatches, bubble (S-1)/(M+S-1) = "
                          f"{t['bubble']:.4f}; rank 0's stage busy {t['busy_s']:.4f} s of "
                          f"{t['wall_s']:.4f} s in its last eval call (idle share "
                          f"{t['idle_share']:.4f})")
                stamp = grt.epoch_end(state, epoch, steps=steps_per_epoch)
                if ckpt_path:
                    if config.sharded_checkpoint:
                        # every rank writes its own blocks, straight from its shards (the
                        # standard layout: a stage axis refuses the flag)
                        checkpoint.save_train_state_sharded(ckpt_path + ".sharded", state,
                                                            specs, grid)
                    host_state = to_standard(state)
                    saver.save_train_state(ckpt_path, host_state)
                    if store_dir and config.keep_checkpoints:
                        checkpoint.save_versioned(
                            store_dir, host_state, keep=config.keep_checkpoints,
                            health=stamp, tele=tele.writer,
                            cursor={"version": 1, "kind": "epoch", "seed": config.seed,
                                    "epoch": epoch + 1, "batch": 0,
                                    "step": int(host_state.step)})
                grt.check_poisoned(state)           # raises Poisoned; __main__ exits 65
                # preemption with this epoch's checkpoint written (raises Preempted;
                # __main__ exits 75)
                rt.check_preempt(epoch=epoch, state=state, checkpoint=ckpt_path,
                                 tele=tele.writer)
        tele.close()
        if host_state is None or not ckpt_path:
            host_state = to_standard(state)
            if ckpt_path and start_epoch >= config.epochs:
                saver.save_train_state(ckpt_path, host_state)   # nothing left to run
    finally:
        # drain the write-behind queue however the loop ended; give the signals back
        rt.uninstall()
        saver.flush()
    assert_replicas_synced(host_state.params)      # a collective; no-op at one rank
    if ckpt_path:
        M.log(f"Saved {ckpt_path}")
    if config.results_dir and info.is_coordinator:
        M.save_metrics_jsonl(history, os.path.join(config.results_dir, "metrics.jsonl"))
    return host_state, history


if __name__ == "__main__":
    run_cli(ComposedConfig, main)
