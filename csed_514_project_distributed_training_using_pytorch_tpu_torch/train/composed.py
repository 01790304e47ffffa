"""Composed trainer for the transformer classifier: one device, or a sequence-parallel
world of ranks.

Counterpart of the JAX package's ``train/composed.py`` for ``--mesh data=1`` (one device)
and ``--mesh data=1,seq=N`` (sequence parallelism over N ranks): the
``TransformerClassifier`` at the trainer's widths (embed 64, 2 layers, 4 heads),
SGD-momentum, ``epochs`` of ``n_train // batch_size`` steps over the ``(seed, epoch)``
permutation (bitwise the JAX package's), the eval after each epoch, the ``Epoch N:
train_loss ...`` line and ``results/metrics.jsonl``. Per-step losses stay on the device;
the host reads them once per epoch.

``--flash-attention`` routes attention through ``ops.flash_attention.dispatch_attention``
on one device: the CUDA flash kernels at ``seq_len >= 2048`` (the JAX package's
predicate), the dense core below. Under a seq axis (``--mesh data=1,seq=N``) the schedule
is the JAX package's choice: ``--seq-impl ulysses`` runs Ulysses (``parallel.ulysses``:
two all-to-alls around the local op, which is the flash kernels B4/B5 with
``--flash-attention`` and the dense core without); the ring (the default) runs the
ring-of-flash with ``--flash-attention`` (``parallel.ring_attention``, the flash kernels on
every hop with its offset), or with ``--zigzag-attention --causal`` the zig-zag
ring-of-flash, and without ``--flash-attention`` the einsum ring or the einsum zig-zag;
``--attention-window`` binds the band into each. The seq world is the process group
(``parallel.mesh.cluster``: ``train.launch`` or ``torchrun`` start it; without them a world
of one): every rank holds the whole batch and the same parameters, attention shards the
sequence, the ranks draw the same dropout masks, and the parameter gradients agree with no
reduce; the trainer checks that the replicas are still equal at the end. Metrics print and
save on rank 0. Run the slice's paths on the card with::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.composed \\
        --mesh data=1 --flash-attention --seq-len 2048
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.launch \\
        --num-processes 2 -- \\
        -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.composed \\
        --mesh data=1,seq=2 --seq-impl ulysses --flash-attention --seq-len 2048

(two ranks on one card run gloo and time-slice it: ``parallel/mesh.py``'s backend rule;
every hop and all-to-all is staged through host memory).

The step's options are ``train.single``'s (``utils.config.StepOptions``: AdamW, LR
schedules, clipping, label smoothing, EMA, gradient accumulation, the guard and its
``--anomaly-exit``), with ``--remat``/``--remat-policy`` (each block recomputed in the
backward, its collectives with it). The segment stays the eager loop on every device: the
f32 step at seq 2048 is device-bound, and the seq world's gloo hops cannot be captured
(ROADMAP B, "composed data=1 under the graph").

The run options are the JAX package's (``utils.config.ResilienceOptions``): rank 0 writes
``results/model_composed.ckpt`` each epoch in the JAX byte layout (the versioned store too
under ``--keep-checkpoints``; ``--async-checkpoint`` writes behind the loop);
``--resume-from`` takes any trainer's transformer checkpoint and skips the epochs it holds
(rank 0 restores and broadcasts); ``--heartbeat-dir`` beats each epoch;
``--handle-preemption`` turns SIGTERM into a stop at the next epoch boundary, and
``__main__`` exits 75; ``--profile`` traces the run with ``torch.profiler``.

Not ported yet (ROADMAP A10): meshes of more than one device other than a seq axis alone
(data beside seq, tensor/expert/pipeline parallelism and MoE); telemetry (A11).
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
    ring_attention,
    ulysses,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    cluster,
    parse_mesh_spec,
    seq_axis_size,
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


def epoch_plan(seed: int, epoch: int, n_train: int, steps: int, batch: int) -> np.ndarray:
    """The epoch's ``[steps, batch]`` index plan: the first ``steps·batch`` entries of the
    ``(seed, epoch)``-keyed permutation, the JAX package's expression."""
    perm = np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(n_train)
    return perm[:steps * batch].astype(np.int64).reshape(steps, batch)


def validate_config(config: ComposedConfig) -> int:
    """The flag checks, before any data work, with the JAX package's messages where it has
    them; returns the seq axis size (the seq world)."""
    names, _ = parse_mesh_spec(config.mesh)
    seq = seq_axis_size(config.mesh)
    check_step_options(config)
    validate_remat_policy(config.remat, config.remat_policy)
    if config.grad_accum > 1 and config.batch_size % config.grad_accum:
        raise ValueError(f"batch_size {config.batch_size} not divisible by grad_accum "
                         f"{config.grad_accum}")
    if config.kv_heads and (config.kv_heads < 0 or NUM_HEADS % config.kv_heads):
        raise ValueError(f"--kv-heads {config.kv_heads} must be a positive divisor of the "
                         f"transformer's {NUM_HEADS} heads")
    if config.attention_window:
        attention.validate_window(config.attention_window)
    if config.seq_impl not in ("ring", "ulysses"):
        raise ValueError(
            f"--seq-impl must be 'ring' or 'ulysses', got {config.seq_impl!r}")
    if config.seq_impl == "ulysses" and config.zigzag_attention:
        raise ValueError("--zigzag-attention is a ring schedule — it does not "
                         "compose with --seq-impl ulysses")
    block = flash_attention.BLOCK
    if config.seq_impl == "ulysses" and seq > 1:
        ulysses.check_shapes(config.seq_len, NUM_HEADS, seq, config.flash_attention)
    elif config.zigzag_attention:
        if not config.causal:
            raise ValueError("--zigzag-attention is causal-only — add --causal")
        if "seq" not in names:
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
    elif seq > 1 and config.seq_len % seq:
        raise ValueError(f"model seq_len {config.seq_len} not divisible by seq axis {seq}")
    return seq


def attention_core(config: ComposedConfig, seq: int):
    """The attention core the flags choose, as the JAX package chooses it: Ulysses (dense
    or of flash) or the ring family (einsum or of flash, plain or zig-zag) under a seq
    axis; else one device's flash dispatch, windowed core or dense core."""
    window = config.attention_window
    if config.seq_impl == "ulysses" and seq > 1:
        return ulysses.make_ulysses_attention_fn(use_flash=config.flash_attention,
                                                 window=window)
    if config.zigzag_attention or seq > 1:
        return ring_attention.make_ring_attention_fn(
            use_flash=config.flash_attention, use_zigzag=config.zigzag_attention,
            window=window)
    if config.flash_attention:
        return functools.partial(flash_attention.dispatch_attention, window=window or None)
    if window:
        return attention.windowed_attention_fn(window)
    return attention.full_attention


def build_classifier(config: ComposedConfig) -> TransformerClassifier:
    """The model the trainer runs: ``models.build_model`` maps the knobs, and the attention
    core is chosen from the flags (``attention_core``, which binds the window itself)."""
    return build_model("transformer", **{**model_options(config), "attention_window": 0},
                       seq_len=config.seq_len, dropout_rate=config.dropout_rate,
                       attention_fn=attention_core(config, seq_axis_size(config.mesh)))


def build_segment_fn(config: ComposedConfig, model: TransformerClassifier, *,
                     total_steps: int = 0, guard: GuardSpec | None = None):
    """The optimizer and the eager segment function ``main`` trains with (one call per
    epoch over the epoch's index plan), from the flags (``total_steps``: the cosine
    schedule's horizon; ``guard``: the guard's spec): one definition, so that a caller
    timing the trainer's steps runs the same ones."""
    optimizer = optim.make_optimizer(config.optimizer, learning_rate=config.learning_rate,
                                     momentum=config.momentum,
                                     weight_decay=config.weight_decay)
    lr_schedule = optim.make_lr_schedule(config.lr_schedule,
                                         warmup_steps=config.warmup_steps,
                                         total_steps=total_steps)
    step = make_train_step(model, **step_options(config, optimizer, lr_schedule, guard),
                           grad_accum=config.grad_accum)
    return optimizer, make_segment_fn(step, pregather=config.pregather)


def main(config: ComposedConfig = ComposedConfig(), *, datasets=None,
         init_params: dict[str, torch.Tensor] | None = None,
         ) -> tuple[TrainState, M.MetricsHistory]:
    """Run composed training as this process's rank (every rank of the seq world calls
    it); returns the final state (the same on every rank) and the history.

    ``datasets`` optionally injects a ``(train, test)`` Dataset pair; ``init_params``
    optionally replaces the drawn initial parameters (both for tests: the JAX package's
    initial parameters carried across with ``models.transformer.params_from_jax``)."""
    seq = validate_config(config)
    resolve_device(config.device)                     # fail fast, before any data work
    with cluster(config.device) as info:
        if info.process_count != seq:
            raise ValueError(
                f"--mesh {config.mesh} has a seq world of {seq}, but {info.process_count} "
                f"process(es) run: the seq world is the process count — start {seq} with "
                f"train.launch --num-processes {seq} (or torchrun)")
        return _train(config, info, datasets, init_params)


def _train(config: ComposedConfig, info, datasets, init_params):
    watch = M.Stopwatch()
    device = info.device
    model = build_classifier(config)
    store_dir = os.path.join(config.results_dir, "checkpoints") if config.results_dir else ""
    grt = GuardRuntime(config, store_dir=store_dir)
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
    M.log(f"Composed training: mesh {dict(zip(*parse_mesh_spec(config.mesh)))} over "
          f"{info.process_count} devices on {info.process_count} process(es) "
          f"({info.backend}), batch {batch}, data source: {train_ds.source}")

    optimizer, segment_fn = build_segment_fn(
        config, model, total_steps=config.epochs * steps_per_epoch, guard=grt.spec)
    state = create_train_state(model, torch.Generator().manual_seed(config.seed),
                               optimizer=optimizer, device=device,
                               ema=config.ema_decay > 0, guard=config.guard)
    if init_params is not None:
        params = {k: p.to(device) for k, p in init_params.items()}
        state = state._replace(params=params, velocity=optimizer.init(params),
                               ema=(None if state.ema is None
                                    else {k: p.clone() for k, p in params.items()}))
    start_epoch = 0
    if config.resume_from:
        # checkpoints are in the one transformer layout whatever mesh or trainer wrote
        # them, so a run resumes from any of them
        state, start_epoch, warning = checkpoint.restore_for_resume(
            config.resume_from, state, process_index=info.process_index,
            process_count=info.process_count, steps_per_epoch=steps_per_epoch)
        if warning:
            M.log(f"WARNING: {warning}")
        M.log(f"Resumed from {config.resume_from} at step {int(state.step)} "
              f"(starting epoch {start_epoch})")
        note = checkpoint.check_cursor_resume(config.resume_from, seed=config.seed,
                                              step=int(state.step), start_epoch=start_epoch)
        if note:
            M.log(f"WARNING: {note}")
    grt.baseline(state)
    eval_fn = make_eval_fn(model, batch_size=config.batch_size_test)

    # Device-resident splits: the one host->device transfer.
    to_device = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    train_x, test_x = to_device(train_ds.images), to_device(test_ds.images)
    train_y = to_device(train_ds.labels.astype(np.int64))
    test_y = to_device(test_ds.labels.astype(np.int64))
    history = M.MetricsHistory()
    ckpt_path = (os.path.join(config.results_dir, "model_composed.ckpt")
                 if config.results_dir else "")
    saver = checkpoint.make_saver(config.async_checkpoint)
    # host-side hooks at epoch boundaries; with both flags off they touch no state
    rt = resilience.RunHooks(heartbeat_dir=config.heartbeat_dir,
                             handle_preemption=config.handle_preemption,
                             process_index=info.process_index)
    try:
        with maybe_profile(config.profile, config.profile_dir):
            for epoch in range(start_epoch, config.epochs):
                # the heartbeat, with the previous boundary's fingerprint; no-op off
                rt.epoch_tick(state, epoch, fingerprint=grt.fingerprint)
                t_epoch = time.perf_counter()
                plan = to_device(epoch_plan(config.seed, epoch, n_train, steps_per_epoch,
                                            batch))
                state, losses = segment_fn(state, train_x, train_y, plan, config.seed + 1)
                epoch_loss = losses.mean().item()               # the epoch's one host sync
                history.epoch_seconds.append(time.perf_counter() - t_epoch)
                sum_nll, correct = eval_fn(
                    state.ema if state.ema is not None else state.params, test_x, test_y)
                val_loss = sum_nll.item() / n_test
                examples_trained = (epoch + 1) * steps_per_epoch * batch
                history.record_train(examples_trained, epoch_loss)
                history.record_test(examples_trained, val_loss)
                M.log(f"Epoch {epoch}: train_loss: {epoch_loss:.4f}, val_loss: "
                      f"{val_loss:.4f}, accuracy: {int(correct.item()) / n_test:.4f}, "
                      f"time_elapsed: {watch.elapsed():.2f}s")
                stamp = grt.epoch_end(state, epoch, steps=steps_per_epoch)
                if ckpt_path:
                    # the per-epoch full state (rank 0, the JAX layout), for --resume-from
                    saver.save_train_state(ckpt_path, state)
                    if store_dir and config.keep_checkpoints:
                        checkpoint.save_versioned(
                            store_dir, state, keep=config.keep_checkpoints, health=stamp,
                            cursor={"version": 1, "kind": "epoch", "seed": config.seed,
                                    "epoch": epoch + 1, "batch": 0,
                                    "step": int(state.step)})
                grt.check_poisoned(state)           # raises Poisoned; __main__ exits 65
                # preemption with this epoch's checkpoint written (raises Preempted;
                # __main__ exits 75)
                rt.check_preempt(epoch=epoch, state=state, checkpoint=ckpt_path)
        if ckpt_path and start_epoch >= config.epochs:
            saver.save_train_state(ckpt_path, state)   # a resume with nothing left to run
    finally:
        # drain the write-behind queue however the loop ended; give the signals back
        rt.uninstall()
        saver.flush()
    assert_replicas_synced(state.params)      # a collective; no-op at one rank
    if ckpt_path:
        M.log(f"Saved {ckpt_path}")
    if config.results_dir and info.is_coordinator:
        M.save_metrics_jsonl(history, os.path.join(config.results_dir, "metrics.jsonl"))
    return state, history


if __name__ == "__main__":
    run_cli(ComposedConfig, main)
