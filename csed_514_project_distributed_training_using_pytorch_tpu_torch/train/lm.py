"""Pixel-LM trainer: next-token training of ``models.lm.TransformerLM``, its test NLL, its
checkpoints, and the digits it samples.

Counterpart of the JAX package's ``train/lm.py``. In order: rendezvous
(``parallel.mesh.cluster``, the process group laid out as the ``--mesh`` grid, by default
a data axis over every rank), the data (MNIST images
tokenized once into ``[N, 784]`` gray-level streams, or a token corpus, ``--corpus``,
through ``data.stream.StreamLoader``), the model and its state, the
resume (``--resume-from``, with the manifest cursor's rules), then ``epochs`` rounds of
(train one epoch, the test NLL per token and its perplexity, the checkpoint
``results/model_lm.ckpt``, the versioned store under ``--keep-checkpoints`` with the data
cursor, the guard's exit, the preemption check), and last the sample grids
(``images/lm_samples.png``; ``lm_completions.png``, the bottom halves of test digits
completed from their top halves), the loss curve and ``results/metrics.jsonl``.

The step is ``train.step.make_train_step`` with the LM's loss (``models.lm.next_token_loss``):
the token batch is its ``images`` argument and a zero vector its ``labels``, as in the JAX
package. The whole token split lives on the device and each epoch gathers its batches by
the ``(seed, epoch)`` permutation (a corpus epoch: its stream order, refilled into the same
device tensor). The epoch runs in ``SEGMENT_STEPS``-step segments of
``train.step.make_epoch_from_step`` (the last one shorter): on the card each segment shape
is a CUDA graph captured once and replayed (the JAX package's one-program epoch; a graph of
the whole 937-step epoch costs a capture of every step at each run's first epoch, one of 64
steps a fifteenth of it), on the CPU and on a gloo world the eager loop; the trainer prints
the rule's choice. The host syncs once an epoch, for its mean loss. Each step's
gradient and loss are averaged over the ranks by one all-reduce (``GradReducer``: NCCL at
world 1 on the card, gloo otherwise), so a world of N trains on the global batch the JAX
package's data axis shards.

``--mesh`` lays the process group out as a grid (``parallel.mesh.ProcessGrid``) of ``data``,
``seq`` and ``model`` axes, as the JAX package's LM trainer does. A ``seq`` axis is context
parallelism: each attention call shards the pixel stream over the seq group through the
einsum ring (``parallel.ring_attention.ring_attention``), or with ``--zigzag-attention``
the einsum zig-zag; ``--attention-window`` binds the band into the schedule, and the
decode model keeps the window as its own field, as in the JAX package. A ``model`` axis is
Megatron TP over the blocks (``parallel.tensor_parallel``: local heads and hidden units;
the embeddings and the head replicate). Each data coordinate steps on its block of the
batch, and the gradient and the loss are averaged over the data group. The checkpoints
and the decode read the unsharded parameters (decode runs on one device, from the host
parameters, as in the JAX package). gloo collectives stage through host memory, which a
CUDA graph cannot capture, so a mesh with a seq or model axis runs eager segments on the
card too; a world of more than one rank on the one H100 is a correctness run.

The LM runs no port kernel: its loss takes ``gather`` over ``log_softmax`` and its attention
is the dense core, as the JAX package's LM training runs no Pallas kernel.

Checkpoints are the JAX package's files, byte for byte (``utils.checkpoint``): either package
resumes from the other's. The trainer runs on the card (``--device cuda``, the default) and
raises when none is present; the CPU is used only when asked for::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.lm \\
        --device cpu --epochs 1 --max-train-examples 256 --max-test-examples 100 \\
        --eval-batch 100 --embed-dim 32 --num-layers 1 --num-heads 2

Telemetry (``--telemetry PATH``, rank 0 writes): the manifest with the grid's axes, the
first segment call's seconds and one step's flops as the ``compile`` event, one ``epoch``
event an epoch (and one ``data`` event on a corpus: batches, loader wait, the next
epoch's cursor and the epoch's token CRC), the ``mfu`` event at the end;
``--health-stats`` one ``health`` event an epoch from the segment's accumulators.

``--plan auto|tune|<path>`` picks the mesh (data × model) and the gradient accumulation
instead of ``--mesh``/``--grad-accum`` (``plan.apply_plan``, inside the process group,
before the grid), saves ``<results_dir>/plan_lm.json`` and emits the ``plan`` (and
``autotune``) telemetry events; without it nothing changes.
"""

from __future__ import annotations

import math
import os
import time
import zlib

import numpy as np
import torch
from torch.func import functional_call

from csed_514_project_distributed_training_using_pytorch_tpu_torch import resilience
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
    download_mnist,
    load_mnist,
    truncate,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
    stream as stream_mod,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm as lm_mod
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
    validate_remat_policy,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import optim
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
    validate_window,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    data_parallel as dp,
    ring_attention,
    tensor_parallel as tp,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    NO_SHARDING,
    ProcessGrid,
    ShardContext,
    cluster,
    mesh_axes,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.guard import (
    GuardRuntime,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
    describe_program,
    resolve_device,
    run_cli,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    init_health,
    make_epoch_from_step,
    make_segment_fn,
    make_train_step,
    merge_health,
    segment_program,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    checkpoint,
    plotting,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import metrics as M
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import telemetry as T
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
    LMConfig,
    check_lm_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.determinism import (
    assert_replicas_synced,
)


SEGMENT_STEPS = 64      # steps a captured segment: the graphs are captured at the first
                        # epoch of a run, so their length is what a run's start costs


def make_eval_nll_fn(model: lm_mod.TransformerLM, *, batch_size: int):
    """``evaluate(params, tokens) -> sum_nll``: the summed next-token NLL over the split as
    a 0-d f32 device tensor (divide by ``N·S`` for the mean; its ``exp`` is the
    perplexity), deterministic forwards of ``batch_size`` rows. The split size must divide
    by ``batch_size``."""

    @torch.no_grad()
    def evaluate(params, tokens: torch.Tensor) -> torch.Tensor:
        n = tokens.shape[0]
        if n % batch_size:
            raise ValueError(f"eval split size {n} not divisible by eval batch "
                             f"{batch_size}")
        total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for start in range(0, n, batch_size):
            batch = tokens[start:start + batch_size].long()
            log_probs = functional_call(model, params, (model.shift_right(batch),))
            total += -torch.gather(log_probs, -1, batch[..., None]).sum()
        return total

    return evaluate


def lm_optimizer(config: LMConfig) -> optim.Optimizer:
    """The trainer's optimizer from ``config`` (AdamW at the defaults)."""
    return optim.make_optimizer(config.optimizer, learning_rate=config.learning_rate,
                                momentum=config.momentum, weight_decay=config.weight_decay)


def lm_model(config: LMConfig, *, vocab: int, seq_len: int, seq_world: int = 1,
             seq_group=None, shard: ShardContext = NO_SHARDING) -> lm_mod.TransformerLM:
    """The trainer's model from ``config``: ``vocab`` token levels plus BOS (built on the
    CPU; the caller moves it). Under a seq axis of more than one rank (``seq_group``) its
    attention is the einsum ring (or zig-zag) with the window bound into the schedule, and
    the model's own ``attention_window`` stays 0; ``shard`` places its blocks on a model
    axis. The decode model is the one of one device."""
    ring = {}
    if seq_world > 1:
        ring = dict(attention_fn=ring_attention.make_ring_attention_fn(
            use_zigzag=config.zigzag_attention, window=config.attention_window,
            group=seq_group))
    return lm_mod.TransformerLM(
        vocab_size=vocab + 1, seq_len=seq_len, embed_dim=config.embed_dim,
        num_layers=config.num_layers, num_heads=config.num_heads,
        num_kv_heads=config.kv_heads or None, dropout_rate=config.dropout_rate,
        attention_window=0 if ring else config.attention_window, rope=config.rope,
        dtype=torch.bfloat16 if config.bf16 else torch.float32, remat=config.remat,
        remat_policy=config.remat_policy, shard=shard, **ring)


def make_lm_step(model: lm_mod.TransformerLM, config: LMConfig, *,
                 optimizer: optim.Optimizer, steps_per_epoch: int, grad_reduce=None,
                 guard=None, rank: int = 0, norm_fn=None, with_metrics: bool = False):
    """The trainer's step: ``train.step.make_train_step`` with the LM's next-token loss
    (label smoothing from ``config``, dropout on when ``config.dropout_rate`` is not 0) and
    ``config``'s clip, EMA, gradient accumulation and learning-rate schedule over
    ``config.epochs * steps_per_epoch`` updates. Called as ``step(state, tokens, zeros,
    seed)``: the labels argument is unread. ``with_metrics`` returns ``(loss, grad
    norm)`` for the health accumulators."""
    deterministic = config.dropout_rate == 0.0

    def lm_loss(params, xs, ys, rng):
        del ys      # the target stream is the input stream, shifted inside the loss
        return lm_mod.next_token_loss(model, params, xs, rng, deterministic=deterministic,
                                      label_smoothing=config.label_smoothing)

    lr_schedule = optim.make_lr_schedule(config.lr_schedule,
                                         warmup_steps=config.warmup_steps,
                                         total_steps=config.epochs * steps_per_epoch)
    return make_train_step(model, learning_rate=config.learning_rate,
                           momentum=config.momentum, grad_accum=config.grad_accum,
                           optimizer=optimizer, lr_schedule=lr_schedule,
                           clip_grad_norm=config.clip_grad_norm, ema_decay=config.ema_decay,
                           loss_fn=lm_loss, guard=guard, grad_reduce=grad_reduce, rank=rank,
                           norm_fn=norm_fn, with_metrics=with_metrics)


def lm_mesh(mesh: str, world: int, *, zigzag: bool = False) -> str:
    """The grid spec of a ``--mesh`` value: ``""`` is ``data=<world>`` (data parallelism
    over the process group); otherwise the spec must name a data axis and only data, seq
    and model axes, as the JAX package's LM trainer requires, and ``zigzag`` needs a seq
    axis. The grid (``ProcessGrid``) then checks the product against the world."""
    axes = mesh_axes(mesh) if mesh else {"data": world}
    if any(n not in ("data", "seq", "model") for n in axes) or "data" not in axes:
        raise ValueError("the LM trainer's --mesh needs a data axis and supports data, "
                         f"seq, and model axes only, got {mesh!r} (use data=1,seq=N for "
                         f"pure context parallelism)")
    if zigzag and axes.get("seq", 1) < 2:
        raise ValueError("--zigzag-attention needs a seq axis in --mesh")
    return mesh or f"data={world}"


def main(config: LMConfig = LMConfig(), *,
         datasets=None) -> tuple[TrainState, M.MetricsHistory]:
    """Run LM training as this process's rank; returns the final state and the metric
    history. ``datasets`` optionally injects a ``(train, test)`` MNIST Dataset pair."""
    watch = M.Stopwatch()
    device = resolve_device(config.device)            # fail fast, before any data work
    check_lm_config(config)
    validate_remat_policy(config.remat, config.remat_policy)
    if config.attention_window:
        validate_window(config.attention_window)
    optimizer = lm_optimizer(config)
    store_dir = os.path.join(config.results_dir, "checkpoints") if config.results_dir else ""
    grt = GuardRuntime(config, store_dir=store_dir)
    with cluster(device) as info:
        run_plan, plan_events = None, []
        if config.plan:
            # before the grid: the plan rewrites --mesh and --grad-accum; the trial events
            # buffer until the telemetry writer exists
            from csed_514_project_distributed_training_using_pytorch_tpu_torch import (
                plan as plan_mod,
            )
            config, run_plan = plan_mod.apply_plan(config, "lm", emit=plan_events.append,
                                                   device=info.device)
        grid = ProcessGrid(lm_mesh(config.mesh, info.process_count,
                                   zigzag=config.zigzag_attention))
        data, seq, tp_axis = grid.axis("data"), grid.axis("seq"), grid.axis("model")
        world, seq_world = data.size, seq.size
        rank = info.process_index
        tele = T.TrainerTelemetry(config.telemetry, config, run_type="lm",
                                  device=info.device, axes=mesh_axes(grid.spec),
                                  preserve=bool(config.resume_from))
        grt.tele = tele.writer
        if run_plan is not None:
            tele.plan(run_plan, plan_events)
        # the ranks of one data coordinate hold the same batch and draw the same dropout
        # masks
        data_rank = data.index
        if config.batch_size % world:
            raise ValueError(f"batch {config.batch_size} not divisible by data axis "
                             f"{world}")
        per_rank = config.batch_size // world
        if config.grad_accum > 1 and per_rank % config.grad_accum:
            raise ValueError(f"per-rank batch {per_rank} not divisible by grad_accum "
                             f"{config.grad_accum}")

        loader = None
        eval_batch = config.eval_batch
        if config.corpus:
            # the token corpus: the loader's (seed, epoch)-pure order IS the epoch's
            # order, so each epoch refills the device token array and runs the identity plan
            loader = stream_mod.StreamLoader(config.corpus, config.batch_size,
                                             seed=config.seed,
                                             throttle_s=config.data_throttle_s)
            seq_len, vocab = loader.seq_len, loader.vocab
            test_tokens = stream_mod.eval_tokens(config.corpus)
            if test_tokens is None or not len(test_tokens):
                raise ValueError(f"--corpus {config.corpus} has no eval split")
            n_train = loader.batches_per_epoch * config.batch_size
            eval_batch = min(config.eval_batch, len(test_tokens))
            test_tokens = test_tokens[:len(test_tokens) - len(test_tokens) % eval_batch]
            train_tokens = np.zeros((n_train, seq_len), np.int32)
            data_source = f"corpus:{config.corpus}"
        else:
            if config.download_data and datasets is None:
                download_mnist(config.data_dir)
            train_ds, test_ds = (datasets if datasets is not None
                                 else load_mnist(config.data_dir))
            train_ds = truncate(train_ds, config.max_train_examples)
            test_ds = truncate(test_ds, config.max_test_examples)
            # tokenized once on the host; the token arrays are the device-resident split
            tokenize = lambda ds: lm_mod.tokenize_images_to_ids(
                torch.from_numpy(np.ascontiguousarray(ds.images)),
                num_levels=config.num_levels).numpy()
            train_tokens, test_tokens = tokenize(train_ds), tokenize(test_ds)
            n_train, seq_len = train_tokens.shape
            vocab = config.num_levels
            data_source = train_ds.source
        n_test = len(test_tokens)
        # sampling knobs fail here, not after the whole training run
        if not 0 <= config.top_k <= vocab + 1:
            raise ValueError(f"top_k {config.top_k} outside [0, {vocab + 1}]")
        if not 0.0 < config.top_p <= 1.0:
            raise ValueError(f"top_p {config.top_p} outside (0, 1]")
        need = 2 * seq_world if config.zigzag_attention else seq_world
        if seq_len % need:
            raise ValueError(f"seq_len {seq_len} must divide by "
                             f"{'2*seq axis' if config.zigzag_attention else 'the seq axis'}"
                             f" = {need}")
        sharded = seq_world > 1 or tp_axis.size > 1
        model = lm_model(config, vocab=vocab, seq_len=seq_len, seq_world=seq_world,
                         seq_group=seq.group,
                         shard=ShardContext.of(grid)).to(info.device)
        # decoding runs on one rank, with the default core and the window as a model field
        decode_model = (lm_model(config, vocab=vocab, seq_len=seq_len).to(info.device)
                        if sharded else model)
        M.log(f"LM training: {info.process_count} process(es) ({info.backend}"
              f"{f', mesh {mesh_axes(grid.spec)}' if sharded else ''}), batch "
              f"{config.batch_size}, vocab {vocab}+BOS, seq {seq_len}, data source: "
              f"{data_source}")

        state = create_train_state(decode_model, torch.Generator().manual_seed(config.seed),
                                   optimizer=optimizer, device=info.device,
                                   ema=config.ema_decay > 0, guard=config.guard)
        dp.broadcast_params_(state.params)
        steps_per_epoch = n_train // config.batch_size
        if steps_per_epoch == 0:
            raise ValueError(f"batch {config.batch_size} larger than the train split "
                             f"({n_train} examples) — nothing to step")
        start_epoch = 0
        if config.resume_from:
            state, start_epoch, warning = checkpoint.restore_for_resume(
                config.resume_from, state, process_index=rank,
                process_count=info.process_count,
                steps_per_epoch=steps_per_epoch, tele=tele.writer)
            if warning:
                M.log(f"WARNING: {warning}")
            M.log(f"Resumed from {config.resume_from} at step {int(state.step)} "
                  f"(starting epoch {start_epoch})")
            start_epoch = _resume_epoch(config, loader, int(state.step), start_epoch)
        # this rank's shards (the model axis's column/row split; whole otherwise)
        specs = tp.filter_to_grid(tp.param_partition_specs(state.params), grid.names)
        state = tp.shard_train_state(state, specs, grid)
        full_state = lambda st: tp.unshard_train_state(st, specs, grid)
        grt.baseline(state)

        # the seq and model ranks of a data coordinate hold agreeing gradients already:
        # the reduce spans the data axis only (the whole group when nothing else is split)
        reducer = (dp.GradReducer(state.params, group=data.group)
                   if world > 1 or not sharded else None)
        health = config.health_stats
        norm_fn = tp.sharded_norm_fn(specs, grid)
        step_fn = make_lm_step(model, config, optimizer=optimizer,
                               steps_per_epoch=steps_per_epoch, grad_reduce=reducer,
                               guard=grt.spec, rank=data_rank, norm_fn=norm_fn,
                               with_metrics=health)
        if not sharded:
            epoch_fn = make_epoch_from_step(step_fn, grad_reduce=reducer, health=health)
            M.log(describe_program(segment_program(info.device, reducer), info.device))
        else:
            epoch_fn = make_segment_fn(step_fn, health=health)
            M.log(f"Segment program: eager on {info.device} (mesh {mesh_axes(grid.spec)}: "
                  f"the seq and model collectives cross the process group outside a "
                  f"graph)")
        eval_fn = make_eval_nll_fn(model, batch_size=eval_batch)

        to_device = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(info.device)
        tokens_d = to_device(train_tokens)
        # the labels argument: the LM's loss reads none, the step's signature wants one
        zeros_d = torch.zeros(n_train, dtype=torch.int64, device=info.device)
        test_d = to_device(test_tokens)
        history = M.MetricsHistory()
        ckpt_path = (os.path.join(config.results_dir, "model_lm.ckpt")
                     if config.results_dir else "")
        saver = checkpoint.make_saver(config.async_checkpoint, tele=tele.writer)
        rt = resilience.RunHooks(heartbeat_dir=config.heartbeat_dir,
                                 handle_preemption=config.handle_preemption,
                                 process_index=rank)
        cols = slice(data_rank * per_rank, (data_rank + 1) * per_rank)   # this rank's block
        if tele.on:
            first = torch.arange(per_rank, device=info.device) % n_train
            tele.flops_per_step = T.train_step_flops(
                make_lm_step(model, config, optimizer=optimizer,
                             steps_per_epoch=steps_per_epoch, rank=data_rank,
                             norm_fn=norm_fn),
                state, tokens_d[first], zeros_d[first], config.seed + 1)

        def epoch_plan(epoch: int) -> torch.Tensor:
            """The epoch's ``[steps, global batch]`` plan, this rank's columns, on the
            device; a corpus epoch's tokens are copied into the split's tensor first (the
            same address, so the captured segments replay over them)."""
            if loader is not None:
                epoch_np = loader.epoch_tokens(epoch)
                tokens_d.copy_(torch.from_numpy(epoch_np))
                history.data_wait_seconds.append(loader.pop_wait_s())
                stream_digest[0] = zlib.crc32(epoch_np.tobytes())
                order = np.arange(n_train)
            else:
                # the (seed, epoch)-keyed permutation of parallel/sampler's contract, so a
                # resumed run replays exactly the epochs it missed
                order = np.random.default_rng(np.random.SeedSequence(
                    [config.seed, epoch])).permutation(n_train)
            plan = order[:steps_per_epoch * config.batch_size].reshape(steps_per_epoch, -1)
            return to_device(plan[:, cols])

        stream_digest = [None]      # the corpus epoch's token CRC (the data event's)

        def run_epochs(state: TrainState) -> TrainState:
            for epoch in range(start_epoch, config.epochs):
                # the heartbeat, with the previous boundary's fingerprint; no-op off
                rt.epoch_tick(state, epoch, fingerprint=grt.fingerprint)
                t_data = time.perf_counter()
                plan = epoch_plan(epoch)
                t_exec = time.perf_counter()
                losses = []
                epoch_health = init_health(info.device) if health else None
                for start in range(0, steps_per_epoch, SEGMENT_STEPS):
                    state, out = tele.first_call(
                        epoch_fn, state, tokens_d, zeros_d,
                        plan[start:start + SEGMENT_STEPS], config.seed + 1,
                        steps_per_call=min(SEGMENT_STEPS, steps_per_epoch), name="epoch")
                    if health:
                        out, seg_health = out
                        epoch_health = merge_health(epoch_health, seg_health)
                    losses.append(out)
                train_loss = torch.cat(losses).mean().item()   # the epoch's one host sync
                history.epoch_seconds.append(time.perf_counter() - t_exec)
                t_eval = time.perf_counter()
                eval_params = state.ema if state.ema is not None else state.params
                val_nll = eval_fn(eval_params, test_d).item() / (n_test * seq_len)
                if health:
                    # every rank: the norm of a split state is a collective
                    health_host = T.host_health(epoch_health)
                    param_norm = T.global_l2_norm(state.params, norm_fn)
                if tele.on:
                    tele.epoch(epoch, examples=steps_per_epoch * config.batch_size,
                               steps=steps_per_epoch,
                               wall_s=time.perf_counter() - t_data,
                               execute_s=history.epoch_seconds[-1],
                               eval_s=time.perf_counter() - t_eval,
                               data_s=t_exec - t_data, train_loss=train_loss,
                               val_loss=val_nll,
                               health=health_host if health else None,
                               param_norm=param_norm if health else None)
                    if loader is not None:
                        tele.writer.emit(T.data_event(
                            epoch, batches=steps_per_epoch,
                            sequences=steps_per_epoch * config.batch_size,
                            wait_s=history.data_wait_seconds[-1],
                            throttle_s=config.data_throttle_s,
                            cursor=loader.cursor(epoch + 1, 0),
                            stream_digest=stream_digest[0]))
                examples = (epoch + 1) * steps_per_epoch * config.batch_size
                history.record_train(examples, train_loss)
                history.record_test(examples, val_nll)
                M.log(f"Epoch {epoch}: train_loss: {train_loss:.4f}, val_nll/token: "
                      f"{val_nll:.4f}, val_ppl: {math.exp(val_nll):.3f}, epoch_s: "
                      f"{history.epoch_seconds[-1]:.3f}, data_s: {t_exec - t_data:.3f}, "
                      f"time_elapsed: {watch.elapsed():.2f}s")
                stamp = grt.epoch_end(state, epoch, steps_per_epoch)
                host_state = full_state(state) if sharded else state
                if ckpt_path:
                    saver.save_train_state(ckpt_path, host_state)
                    if store_dir and config.keep_checkpoints:
                        # the NEXT epoch's data position, in the manifest beside the file
                        cursor = (loader.cursor(epoch + 1, 0) if loader is not None
                                  else {"version": 1, "kind": "epoch", "seed": config.seed,
                                        "epoch": epoch + 1, "batch": 0,
                                        "step": int(state.step)})
                        checkpoint.save_versioned(store_dir, host_state,
                                                  keep=config.keep_checkpoints,
                                                  tele=tele.writer,
                                                  health=stamp, cursor=cursor)
                # the guard's exit after the stamped checkpoint is durable (raises
                # Poisoned; __main__ exits 65)
                grt.check_poisoned(state)
                # preemption with this epoch's checkpoint written (raises Preempted; 75)
                rt.check_preempt(epoch=epoch, state=state, checkpoint=ckpt_path,
                                 tele=tele.writer)
            return state

        try:
            state = run_epochs(state)
            tele.close()
            if sharded:
                state = full_state(state)
        finally:
            # drain the write-behind queue however the loop ended; give the signals back
            rt.uninstall()
            saver.flush()
        assert_replicas_synced(state.params)

    if ckpt_path:
        M.log(f"Saved {ckpt_path}")
    if config.generate > 0 and loader is None and M.is_logging_process():
        # corpus-trained models skip the digit grids: ids_to_images means something only
        # for the pixel tokenizer
        gen_params = state.ema if state.ema is not None else state.params

        def sample_grid(filename: str, seed_offset: int, batch: int, **gen_kw) -> None:
            generator = torch.Generator(device=info.device).manual_seed(
                config.seed + seed_offset)
            ids = lm_mod.generate(decode_model, gen_params, generator, batch=batch,
                                  temperature=config.temperature, top_k=config.top_k,
                                  top_p=config.top_p, **gen_kw)
            path = os.path.join(config.images_dir, filename)
            images = lm_mod.ids_to_images(ids, num_levels=config.num_levels)
            if plotting.save_generated_grid(images.cpu().numpy(), path, n=batch):
                M.log(f"Saved {path}")

        sample_grid("lm_samples.png", 2, config.generate)
        # digit completion: the top half of real test images forced, the bottom sampled
        n_c = min(config.generate, n_test)
        sample_grid("lm_completions.png", 3, n_c, prompt=test_d[:n_c],
                    prompt_len=seq_len // 2)
    plotting.save_loss_curves(history, os.path.join(config.images_dir, "lm_loss_curve.png"))
    if config.results_dir and M.is_logging_process():
        M.save_metrics_jsonl(history, os.path.join(config.results_dir, "metrics.jsonl"))
    return state, history


def _resume_epoch(config: LMConfig, loader, step: int, start_epoch: int) -> int:
    """The manifest cursor's rules: a stream cursor is verified against this corpus (a
    corpus that changed under the checkpoint raises) and sets the start epoch; an epoch
    cursor is cross-checked against the step-derived one (a mismatch warns)."""
    cursor = checkpoint.cursor_for(config.resume_from)
    if loader is not None and cursor is not None:
        cur_epoch, cur_batch = loader.verify_cursor(cursor)
        if cur_batch:
            M.log(f"WARNING: stream cursor resumes mid-epoch (batch {cur_batch}) but the "
                  f"epoch program replays whole epochs — starting at epoch {cur_epoch}")
        return cur_epoch
    note = checkpoint.check_cursor_resume(config.resume_from, seed=config.seed, step=step,
                                          start_epoch=start_epoch)
    if note:
        M.log(f"WARNING: {note}")
    return start_epoch


if __name__ == "__main__":
    run_cli(LMConfig, main)
