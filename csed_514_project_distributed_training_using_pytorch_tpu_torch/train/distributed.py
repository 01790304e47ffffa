"""Data-parallel trainer — the reference ``train_dist.py`` workflow on ``torch.distributed``.

Counterpart of the JAX package's ``train/distributed.py``. Every rank runs this same
module; its coordinates come from the launcher's environment (``train.launch``,
``torchrun``), and without one it trains as a world of one. In order: rendezvous
(``parallel.mesh.cluster``: NCCL when each rank has a card of its own, else gloo), the
per-rank batch ``global_batch_size // world``, one ``ShardedSampler`` per rank, rank 0's
parameters broadcast to all, the resume (``--resume-from``), then ``epochs`` rounds of
(train, evaluate, print the epoch summary, the checkpoint ``results/model_dist.ckpt``,
the versioned store under ``--keep-checkpoints``, the guard's exit, the preemption check),
the replica-sync check, and rank 0's loss curve (``images/train_test_curve_dist.png``),
``results/metrics.jsonl`` and final export ``results/model_dist.msgpack``: the EMA
weights under ``--ema-decay``, the parameters otherwise.

The whole split lives on each rank's device. Every rank builds the same global
``[steps, global_batch]`` plan (``epoch_index_plan``) and trains on its own column block
(``_host_local_columns``),
so each step's global batch is the one the JAX package trains on; the gradient and the
loss are averaged over the ranks by one all-reduce a step (``GradReducer``). The final
sub-global-batch remainder of each epoch is dropped, as in the JAX package. Training runs
in ``log_interval``-step segments through ``train.step.make_epoch_fn``; the host syncs once
a segment, for the progress line's global-mean loss. On NCCL (each rank on a card of its
own: world 1 on the one H100) each segment shape is captured once as a CUDA graph with the
reducer's all-reduce inside it and replayed; a gloo group stages the reduce through host
memory, which a graph cannot capture, so it runs the eager loop, as the CPU does. The
trainer prints the rule's choice. The step's options are ``train.single``'s; the guard's
verdict reads the reduced loss and gradient norm, so every rank skips the same steps.

``--host-local-feed`` is the multi-host input path: the split stays in host memory and
each rank gathers only its own columns of every global batch (``iter_plan_batches``: the
native C++ prefetcher, or numpy's gather where it is not built; the trainer's line names
which), one step a batch through ``train.step.HostFedStep`` (on NCCL a one-step CUDA graph
over static input buffers, the all-reduce inside it; eager on gloo), with the same plan,
the same dropout keys and the reducer's one all-reduce a step. ``--download-data`` fetches
the IDX archives first, on every rank (each installs whole files atomically).

Checkpoints are the JAX package's files, byte for byte (``utils.checkpoint``), written by
rank 0 at each epoch end after its host copy of the state. ``--resume-from`` skips the
completed epochs (``checkpoint.restore_for_resume``: rank 0 restores and broadcasts the
state to every rank), so a resumed run trains the epochs the unbroken run would have, on
the same plans, with the same dropout masks (a device function of seed, step and rank).
``--async-checkpoint``, ``--heartbeat-dir``, ``--handle-preemption`` (exit 75) and
``--profile`` are ``train.single``'s.

Run it with (a world of 2 on the CPU; ``--device cuda``, the default, on the card)::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.launch \\
        --num-processes 2 -- \\
        -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.distributed \\
        --device cpu --epochs 1

``--model transformer`` and its knobs (``utils.config.ModelOptions``) are
``train.single``'s: at world 1 on NCCL the segments are captured on the card, at world 2
they run on gloo.

``--fsdp`` is ZeRO/FSDP over the world (``parallel.fsdp``): each leaf of at least 2,048
elements is split over the ranks on its largest divisible dim (the JAX package's rule), its
optimizer state and EMA with it, so the update runs on the local shard; the forward
gathers each split leaf (``fsdp.gather_params``, whose backward reduce-scatters the
gradient) and ``fsdp.FsdpReducer`` finishes the reduction. The trajectory is plain DP's.
At world 1 every split is the whole leaf and no collective runs: on the card the segment
is still captured, with no new host sync. The eval, the checkpoints and the export read
the gathered state.

Telemetry (``--telemetry PATH``, rank 0 writes): the manifest with the ``data`` axis, the
first segment call's seconds and one step's flops (the step without its gradient reduce:
one rank's share) as the ``compile`` event, one ``epoch`` event an epoch, the ``mfu``
event at the end; ``--health-stats`` one ``health`` event an epoch from the segment's
accumulators (not on the ``--host-local-feed`` path, as in the JAX package).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch import resilience
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
    download_mnist,
    iter_plan_batches,
    load_mnist,
    truncate,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
    build_model,
    validate_model_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import optim
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    fsdp,
    tensor_parallel as tp,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    ProcessGrid,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    data_parallel as dp,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    cluster,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.sampler import (
    ShardedSampler,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.guard import (
    GuardRuntime,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
    describe_host_fed,
    describe_program,
    resolve_device,
    run_cli,
    step_options,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
    HostFedStep,
    TrainState,
    create_train_state,
    init_health,
    make_epoch_fn,
    make_eval_fn,
    make_train_step,
    merge_health,
    segment_program,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    checkpoint,
    plotting,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import telemetry as T
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import metrics as M
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
    DistributedConfig,
    check_step_options,
    model_options,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.determinism import (
    assert_replicas_synced,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.profiling import (
    maybe_profile,
)


def epoch_index_plan(samplers: list[ShardedSampler], epoch: int,
                     per_replica_batch: int) -> np.ndarray:
    """Build the ``[steps, world * per_replica_batch]`` index plan for one epoch.

    Column block ``r`` holds replica ``r``'s examples in its sampler order, so rank ``r``'s
    columns are exactly its DistributedSampler shard."""
    per = [s.epoch_indices(epoch) for s in samplers]
    steps = len(per[0]) // per_replica_batch
    blocks = [p[:steps * per_replica_batch].reshape(steps, per_replica_batch) for p in per]
    return np.concatenate(blocks, axis=1)


def _host_local_columns(rank: int, per_replica_batch: int) -> tuple[int, int]:
    """Rank ``rank``'s contiguous column block ``[r·B, (r+1)·B)`` of the ``[steps,
    global_batch]`` plan: its DistributedSampler shard, the rows it feeds and steps on."""
    return rank * per_replica_batch, (rank + 1) * per_replica_batch


def main(config: DistributedConfig = DistributedConfig(), *,
         datasets=None) -> tuple[TrainState, M.MetricsHistory]:
    """Run data-parallel training as this process's rank; every rank calls it. Returns the
    rank's final state (the same on every rank) and the metric history.

    ``datasets`` optionally injects a ``(train, test)`` Dataset pair (tests, notebooks); by
    default MNIST is loaded from ``config.data_dir``."""
    watch = M.Stopwatch()
    device = resolve_device(config.device)            # fail fast, before the rendezvous
    validate_model_config(config.model, remat=config.remat,
                          remat_policy=config.remat_policy, causal=config.causal,
                          attention_window=config.attention_window,
                          kv_heads=config.kv_heads, rope=config.rope)
    if config.health_stats and config.host_local_feed:
        raise ValueError("--health-stats rides the compiled scan carry "
                         "(train/step.py::HealthStats) — it is not available on the "
                         "per-batch --host-local-feed path")
    check_step_options(config)
    optimizer = optim.make_optimizer(config.optimizer, learning_rate=config.learning_rate,
                                     momentum=config.momentum,
                                     weight_decay=config.weight_decay)
    grt = GuardRuntime(config, store_dir=os.path.join(config.results_dir, "checkpoints"))
    with cluster(device) as info:
        world, rank = info.process_count, info.process_index
        if config.global_batch_size % world:
            raise ValueError(f"global batch {config.global_batch_size} not divisible by "
                             f"world size {world}")
        per_replica_batch = config.global_batch_size // world
        if config.grad_accum > 1 and per_replica_batch % config.grad_accum:
            raise ValueError(
                f"per-replica batch {per_replica_batch} not divisible by grad_accum "
                f"{config.grad_accum} — each microbatch must still shard evenly")

        if config.download_data and datasets is None:
            download_mnist(config.data_dir)   # download=True, src/train_dist.py:22-30
        train_ds, test_ds = (datasets if datasets is not None
                             else load_mnist(config.data_dir))
        train_ds = truncate(train_ds, config.max_train_examples)
        test_ds = truncate(test_ds, config.max_test_examples)
        n_train, n_test = len(train_ds), len(test_ds)
        M.log(f"Distributed training: {world} devices on {world} process(es), "
              f"global batch {config.global_batch_size} "
              f"(per-replica {per_replica_batch}), data source: {train_ds.source}")
        M.log(f"Collective backend: {info.backend} (device {info.device.type}, "
              f"{world} rank(s))")
        tele = T.TrainerTelemetry(config.telemetry, config, run_type="distributed",
                                  device=info.device, axes={"data": world},
                                  preserve=bool(config.resume_from))
        health = config.health_stats
        grt.tele = tele.writer

        samplers = [ShardedSampler(n_train, num_replicas=world, rank=r,
                                   seed=config.sampler_seed) for r in range(world)]
        model = build_model(config.model, **model_options(config)).to(info.device)
        state = create_train_state(model, torch.Generator().manual_seed(config.seed),
                                   optimizer=optimizer, device=info.device,
                                   ema=config.ema_decay > 0, guard=config.guard)
        dp.broadcast_params_(state.params)
        steps_per_epoch = samplers[0].num_samples // per_replica_batch
        start_epoch = 0
        if config.resume_from:
            state, start_epoch, warning = checkpoint.restore_for_resume(
                config.resume_from, state, process_index=rank, process_count=world,
                steps_per_epoch=steps_per_epoch, tele=tele.writer)
            if warning:
                M.log(f"WARNING: {warning}")
            M.log(f"Resumed from {config.resume_from} at step {int(state.step)} "
                  f"(starting epoch {start_epoch})")
            note = checkpoint.check_cursor_resume(config.resume_from, seed=config.seed,
                                                  step=int(state.step),
                                                  start_epoch=start_epoch)
            if note:
                M.log(f"WARNING: {note}")
        grt.baseline(state)
        lr_schedule = optim.make_lr_schedule(config.lr_schedule,
                                             warmup_steps=config.warmup_steps,
                                             total_steps=config.epochs * steps_per_epoch)
        full_state = lambda st: st                  # the state as eval and saves read it
        if config.fsdp:
            grid = ProcessGrid(f"data={world}")
            specs = fsdp.fsdp_partition_specs(state.params, world)
            dims = fsdp.data_dims(specs)
            state = tp.shard_train_state(state, specs, grid)
            reducer = fsdp.FsdpReducer(state.params, dims)
            options = step_options(config, optimizer, lr_schedule, grt.spec)
            options["param_view"] = lambda p: fsdp.gather_params(p, dims, grid.axis("data"))
            full_state = lambda st: tp.unshard_train_state(st, specs, grid)
            M.log(f"FSDP: {len(dims)} of {len(specs)} leaves split over {world} rank(s)")
        else:
            reducer = dp.GradReducer(state.params)
            options = step_options(config, optimizer, lr_schedule, grt.spec)
        col_lo, col_hi = _host_local_columns(rank, per_replica_batch)
        if config.host_local_feed:
            host_step = HostFedStep(
                make_train_step(model, **options, grad_accum=config.grad_accum,
                                grad_reduce=reducer, rank=rank),
                info.device, grad_reduce=reducer)
            M.log(f"Host-local feed: this process feeds global-batch columns "
                  f"[{col_lo}:{col_hi}]")
            M.log(describe_host_fed(host_step.program, info.device))
        else:
            segment_fn = make_epoch_fn(
                model, **options, grad_accum=config.grad_accum, pregather=config.pregather,
                unroll=config.scan_unroll, grad_reduce=reducer, rank=rank, health=health)
            M.log(describe_program(segment_program(info.device, reducer), info.device))
        eval_fn = make_eval_fn(model, batch_size=config.batch_size_test)

        to_device = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(info.device)
        test_x = to_device(test_ds.images)
        test_y = to_device(test_ds.labels.astype(np.int64))
        if not config.host_local_feed:        # the host-local feed keeps it on the host
            train_x = to_device(train_ds.images)
            train_y = to_device(train_ds.labels.astype(np.int64))
            if tele.on:
                first = np.arange(per_replica_batch) % n_train
                tele.flops_per_step = T.train_step_flops(
                    make_train_step(model, **options, grad_accum=config.grad_accum,
                                    rank=rank),
                    state, train_x[first], train_y[first], config.seed)

        history = M.MetricsHistory()
        li = config.log_interval
        ckpt_path = os.path.join(config.results_dir, "model_dist.ckpt")
        ckpt_store = os.path.join(config.results_dir, "checkpoints")
        saver = checkpoint.make_saver(config.async_checkpoint, tele=tele.writer)
        # host-side hooks at epoch boundaries; with both flags off they touch no state
        rt = resilience.RunHooks(heartbeat_dir=config.heartbeat_dir,
                                 handle_preemption=config.handle_preemption,
                                 process_index=rank)

        def tick(epoch: int, done_steps: int, loss: torch.Tensor) -> None:
            """The progress line of a log tick: the tick's one host sync."""
            M.log(M.train_progress_line(epoch, done_steps * config.global_batch_size,
                                        n_train, loss.item()))

        def run_epoch_device_resident(state, plan, epoch):
            """``log_interval``-step segments over the device-resident split."""
            idx = to_device(plan[:, col_lo:col_hi])
            steps, segments = plan.shape[0], []
            for seg_start in range(0, steps, li):
                state, out = tele.first_call(segment_fn, state, train_x, train_y,
                                             idx[seg_start:seg_start + li], config.seed,
                                             steps_per_call=li)
                losses = out[0] if health else out
                if health:
                    ledger["health"] = merge_health(ledger["health"], out[1])
                segments.append(losses)
                tick(epoch, min(seg_start + li, steps), losses[-1])
            return state, torch.cat(segments)

        def run_epoch_host_local(state, plan, epoch):
            """The multi-host input path: each step this rank gathers only its own columns
            of the global batch on the host (the native prefetcher's workers gather step
            s+1's while step s runs) and steps on them; the reducer joins the ranks."""
            steps, losses = plan.shape[0], []
            # the live bar (the reference's tqdm) draws only on a rank-0 terminal
            with M.ProgressBar(steps, desc="train ") as bar:
                for s, (bx, by) in enumerate(
                        iter_plan_batches(train_ds, plan[:, col_lo:col_hi]), start=1):
                    bx, by = dp.global_batch_from_host_local(
                        bx, by, columns=(col_lo, col_hi), global_batch=plan.shape[1])
                    state, loss = host_step(state, bx, by, config.seed)
                    losses.append(loss)
                    if s % li == 0 or s == steps:
                        bar.close()
                        tick(epoch, s, loss)
                    bar.update(1)
            return state, torch.stack(losses)

        try:
            with maybe_profile(config.profile, config.profile_dir):
                for epoch in range(start_epoch, config.epochs):
                    # the heartbeat, with the previous boundary's fingerprint; no-op off
                    rt.epoch_tick(state, epoch, fingerprint=grt.fingerprint)
                    t_epoch = time.perf_counter()
                    plan = epoch_index_plan(samplers, epoch, per_replica_batch)
                    ledger = {"data_s": time.perf_counter() - t_epoch,
                              "health": init_health(info.device) if health else None}
                    steps = plan.shape[0]
                    run_epoch = (run_epoch_host_local if config.host_local_feed
                                 else run_epoch_device_resident)
                    state, losses = run_epoch(state, plan, epoch)
                    if info.device.type == "cuda":
                        torch.cuda.synchronize(info.device)   # honest wall-clock
                    history.epoch_seconds.append(time.perf_counter() - t_epoch)
                    losses = losses.cpu().numpy()
                    train_loss = float(losses.mean())     # mean of per-step global means
                    for i, loss in enumerate(losses[::li]):
                        history.record_train(epoch * plan.size + i * li * plan.shape[1],
                                             float(loss))

                    host_state = full_state(state)
                    eval_params = (host_state.ema if host_state.ema is not None
                                   else host_state.params)
                    sum_nll, correct = dp.evaluate(eval_fn, eval_params, test_x, test_y,
                                                   shard=config.shard_eval)
                    val_loss, accuracy = sum_nll / n_test, correct / n_test
                    history.record_test((epoch + 1) * plan.size, val_loss)
                    M.log(M.dist_epoch_summary_line(epoch, train_loss, val_loss, accuracy,
                                                    watch.elapsed()))
                    if tele.on:
                        h = ledger["health"]
                        tele.epoch(epoch, examples=n_train, steps=steps,
                                   wall_s=time.perf_counter() - t_epoch,
                                   execute_s=history.epoch_seconds[-1] - ledger["data_s"],
                                   data_s=ledger["data_s"], train_loss=train_loss,
                                   val_loss=val_loss,
                                   health=T.host_health(h) if h is not None else None,
                                   param_norm=(T.global_l2_norm(host_state.params)
                                               if h is not None else None))
                    stamp = grt.epoch_end(state, epoch, steps=steps)
                    # the per-epoch full-state checkpoint (rank 0), for --resume-from
                    saver.save_train_state(ckpt_path, host_state)
                    if config.keep_checkpoints:
                        checkpoint.save_versioned(
                            ckpt_store, host_state, keep=config.keep_checkpoints,
                            health=stamp, tele=tele.writer,
                            cursor={"version": 1, "kind": "epoch", "seed": config.seed,
                                    "epoch": epoch + 1, "batch": 0,
                                    "step": int(state.step)})
                    # the guard's exit after the stamped checkpoint is durable (raises
                    # Poisoned; __main__ exits 65)
                    grt.check_poisoned(state)
                    # preemption with this epoch's checkpoint written (raises Preempted;
                    # __main__ exits 75)
                    rt.check_preempt(epoch=epoch, state=state, checkpoint=ckpt_path,
                                     tele=tele.writer)

            tele.close()
            state = full_state(state)
            assert_replicas_synced(state.params)
            plotting.save_loss_curves(
                history, os.path.join(config.images_dir, "train_test_curve_dist.png"))
            if info.is_coordinator:
                M.save_metrics_jsonl(history,
                                     os.path.join(config.results_dir, "metrics.jsonl"))
            # the export is the weights the reported metrics came from
            checkpoint.save_params(os.path.join(config.results_dir, "model_dist.msgpack"),
                                   state.ema if state.ema is not None else state.params)
        finally:
            # drain the write-behind queue however the loop ended; give the signals back
            rt.uninstall()
            saver.flush()
    return state, history


if __name__ == "__main__":
    run_cli(DistributedConfig, main)
