"""Single-process trainer — the reference ``train.py`` workflow on one CUDA device.

Counterpart of the JAX package's ``train/single.py``. In order: the download
(``--download-data``), seeding, the loader, the sample grid (``images/train_images.png``),
the resume (``--resume-from``), baseline eval before training, then ``n_epochs`` of
(train with a progress line, a metric record and the overwrite checkpoint
``results/model.ckpt`` every ``log_interval`` batches, the ragged tail batch, eval, the
versioned store under ``--keep-checkpoints``, the guard's exit, the preemption check),
and finally the loss curve (``train_test_curve.png``), ``results/metrics.jsonl`` and the
closing save of the final state.

The whole training split lives on the device, and each step gathers its batch with
``index_select`` by the sampler's plan, as the JAX package's device-resident path does.
Training runs in ``log_interval``-step segments through ``train.step.make_epoch_fn``: on
the card each segment shape is captured once as a CUDA graph and replayed (the JAX
package's scanned program; the tail segment of ``steps % log_interval`` steps gets its
own graph), on the CPU the eager loop; the trainer prints the rule's choice. The ragged
last batch runs as one eager step, as the JAX package runs it outside its scan. The host
syncs once per log tick, to print the tick's loss, and the tick's checkpoint copies the
state to host memory there, before the next replay overwrites the graph's buffers.

``--use-host-pipeline`` trains the reference's loop shape instead: host batches in the
same plan order through the native C++ prefetcher (``BatchLoader.prefetch_iter``; numpy's
gather where the library is not built, and the trainer's line names which), one step a
batch through ``train.step.HostFedStep`` (on the card a one-step CUDA graph over static
input buffers that each batch is copied into, by the same rule), with the same dropout
key (seed, step, rank), the same log ticks, their checkpoints and the eager tail step, and
a live progress bar on a terminal. On the CPU its epoch equals the device-resident epoch
bitwise; the loader's data-wait seconds go to ``MetricsHistory.data_wait_seconds``.

Checkpoints are the JAX package's files, byte for byte (``utils.checkpoint``): either
package resumes from the other's. ``--resume-from`` means "train ``n_epochs`` more": the
schedule's horizon runs from the restored step, and a versioned file's data cursor is
checked against the config. ``--async-checkpoint`` writes behind the loop (the host copy
stays on it). ``--heartbeat-dir`` beats each epoch; ``--handle-preemption`` turns SIGTERM
into a stop at the next epoch boundary with the checkpoint durable, and ``__main__`` exits
75. ``--profile`` traces the run with ``torch.profiler``.

The step's options (``utils.config.StepOptions``): AdamW, LR schedules, clipping, label
smoothing, EMA (evaluation then uses the EMA weights), gradient accumulation and the
numerical guard, whose ``--anomaly-exit`` policy raises ``Poisoned`` at an epoch boundary
after writing ``results/checkpoints/poison.json``; ``__main__`` then exits 65.

The trainer runs on the card (``--device cuda``, the default) and raises when none is
present; the CPU is used only when asked for (``--device cpu``). On CUDA it turns TF32 off
for cuDNN convolutions and cuBLAS matmuls, so float32 means float32.

Run it with::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single \\
        --use-pallas-kernels

``--model transformer`` trains the transformer classifier (``models.transformer``) on the
same paths, with the JAX package's knobs (``utils.config.ModelOptions``: ``--bf16``,
``--remat``, ``--remat-policy``, ``--causal``, ``--attention-window``, ``--kv-heads``,
``--rope``; ``--bf16`` applies to the CNN too): captured on the card with B1-B3 inside the
graph under ``--use-pallas-kernels``, its dropout masks drawn from the step's device key,
and ``model.ckpt`` in the JAX package's transformer layout::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single \
        --model transformer --use-pallas-kernels

Telemetry (``--telemetry PATH``, ``utils/telemetry.py``): the manifest, the first segment
call's seconds and one step's flops as the ``compile`` event, one ``epoch`` event an epoch
and the ``mfu`` event at the end; ``--health-stats`` adds one ``health`` event an epoch,
from the accumulators the segment carries (on the card inside its CUDA graph: no extra
host sync, and the same parameters and kernel launches as without them).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch import resilience
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
    BatchLoader,
    download_mnist,
    load_mnist,
    native,
    truncate,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
    build_model,
    validate_model_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import optim
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.guard import (
    GuardRuntime,
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
    update_health,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    checkpoint,
    plotting,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import telemetry as T
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import metrics as M
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
    SingleProcessConfig,
    check_step_options,
    model_options,
    parse_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.profiling import (
    annotate,
    maybe_profile,
)


def resolve_device(name: str) -> torch.device:
    """The device the trainer runs on. ``cuda`` needs a card and turns TF32 off; there is
    no quiet fallback to the CPU."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but no CUDA device is "
                               "available; pass --device cpu to train on the CPU")
        # cuDNN convolutions default to TF32 (about 3 decimal digits); keep float32.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r} — use 'cuda' or 'cpu'")
    return device


def step_options(config, optimizer: optim.Optimizer, lr_schedule, guard) -> dict:
    """The keyword arguments of ``make_train_step`` / ``make_epoch_fn`` that a trainer's
    flags set (all but ``grad_accum``, which the ragged tail step leaves out)."""
    return dict(learning_rate=config.learning_rate, momentum=config.momentum,
                optimizer=optimizer, lr_schedule=lr_schedule,
                clip_grad_norm=config.clip_grad_norm, ema_decay=config.ema_decay,
                label_smoothing=config.label_smoothing, guard=guard)


def describe_program(program: str, device: torch.device) -> str:
    """The one line a trainer prints for the segment-program rule's choice."""
    return (f"Segment program: {program} on {device} (the rule: a CUDA graph on a CUDA "
            f"device unless the gradient reduce is staged through host memory, else eager)")


def describe_host_fed(program: str, device: torch.device) -> str:
    """The one line a host-fed trainer prints: the step's program and the host data path
    that ran (``native`` or ``numpy``)."""
    return (f"Host-fed program: {program} on {device} (the rule: a one-step CUDA graph over "
            f"static input buffers on a CUDA device unless the gradient reduce is staged "
            f"through host memory, else eager); host batches: {native.path_name()}")


def main(config: SingleProcessConfig = SingleProcessConfig(), *,
         resume_from: str | None = None,
         datasets=None) -> tuple[TrainState, M.MetricsHistory]:
    """Run the single-process workflow; returns the final state and the metric history.

    ``resume_from`` (or ``config.resume_from``) restores a checkpoint and trains
    ``n_epochs`` more. ``datasets`` optionally injects a ``(train, test)`` Dataset pair
    (tests, notebooks); by default MNIST is loaded from ``config.data_dir``.
    """
    watch = M.Stopwatch()
    device = resolve_device(config.device)            # fail fast, before any data work
    validate_model_config(config.model, remat=config.remat,
                          remat_policy=config.remat_policy, causal=config.causal,
                          attention_window=config.attention_window,
                          kv_heads=config.kv_heads, rope=config.rope)
    if config.health_stats and config.use_host_pipeline:
        raise ValueError("--health-stats rides the compiled scan carry "
                         "(train/step.py::HealthStats) — it is not available on the "
                         "per-batch --use-host-pipeline path")
    check_step_options(config)
    if config.grad_accum > 1 and config.batch_size_train % config.grad_accum:
        raise ValueError(f"batch_size_train {config.batch_size_train} not divisible "
                         f"by grad_accum {config.grad_accum}")
    optimizer = optim.make_optimizer(config.optimizer, learning_rate=config.learning_rate,
                                     momentum=config.momentum,
                                     weight_decay=config.weight_decay)
    if config.optimizer != "sgd" and config.use_pallas_kernels:
        raise ValueError("--use-pallas-kernels fuses the SGD-momentum update — it "
                         "requires --optimizer sgd")
    tele = T.TrainerTelemetry(config.telemetry, config, run_type="single", device=device,
                              preserve=bool(resume_from or config.resume_from))
    health = config.health_stats
    grt = GuardRuntime(config, store_dir=os.path.join(config.results_dir, "checkpoints"),
                       tele=tele.writer)
    if config.download_data and datasets is None:
        download_mnist(config.data_dir)       # torchvision download=True, src/train.py:26-31
    train_ds, test_ds = datasets if datasets is not None else load_mnist(config.data_dir)
    train_ds = truncate(train_ds, config.max_train_examples)
    test_ds = truncate(test_ds, config.max_test_examples)
    M.log(f"Loaded MNIST ({train_ds.source}): {len(train_ds)} train / {len(test_ds)} test")

    init_generator = torch.Generator().manual_seed(config.seed)
    train_loader = BatchLoader(train_ds, config.batch_size_train, shuffle=True,
                               seed=config.seed)
    plotting.save_sample_grid(test_ds.images, test_ds.labels,
                              os.path.join(config.images_dir, "train_images.png"))
    model = build_model(config.model, **model_options(config)).to(device)
    state = create_train_state(model, init_generator, optimizer=optimizer, device=device,
                               ema=config.ema_decay > 0, guard=config.guard)
    resume_from = resume_from or config.resume_from or None
    if resume_from:
        state = checkpoint.restore_train_state(resume_from, state)
        M.log(f"Resumed from {resume_from} at step {int(state.step)}")
        note = checkpoint.check_cursor_resume(resume_from, seed=config.seed,
                                              step=int(state.step))
        if note:
            M.log(f"WARNING: {note}")
    grt.baseline(state)
    # the schedule's horizon: this run's updates after the restored step ("n_epochs
    # more"; the ragged tail batch is one more each epoch, drop_last=False)
    total_steps = (int(state.step)
                   + config.n_epochs * -(-len(train_ds) // config.batch_size_train))
    lr_schedule = optim.make_lr_schedule(config.lr_schedule,
                                         warmup_steps=config.warmup_steps,
                                         total_steps=total_steps)
    if lr_schedule is not None and config.use_pallas_kernels:
        raise ValueError("--use-pallas-kernels bakes the learning rate into the fused "
                         "update kernel — use the default constant schedule without "
                         "warmup")

    # Device-resident splits: the one host->device transfer (the host pipeline keeps its
    # training split on the host).
    to_device = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    test_x, test_y = to_device(test_ds.images), to_device(test_ds.labels.astype(np.int64))
    if not config.use_host_pipeline:
        train_x = to_device(train_ds.images)
        train_y = to_device(train_ds.labels.astype(np.int64))

    common = step_options(config, optimizer, lr_schedule, grt.spec) | dict(
        use_pallas=config.use_pallas_kernels)
    if config.use_host_pipeline:
        host_step = HostFedStep(make_train_step(model, **common,
                                                grad_accum=config.grad_accum), device)
        M.log(describe_host_fed(host_step.program, device))
    else:
        segment_fn = make_epoch_fn(model, **common, grad_accum=config.grad_accum,
                                   pregather=config.pregather, unroll=config.scan_unroll,
                                   health=health)
        M.log(describe_program(segment_program(device), device))
        if tele.on:
            step_fn = make_train_step(model, **common, grad_accum=config.grad_accum)
            first = np.arange(config.batch_size_train) % len(train_ds)
            tele.flops_per_step = T.train_step_flops(
                step_fn, state, train_x[first], train_y[first], config.seed)
    # the ragged last batch need not divide by grad_accum, a memory knob: it steps
    # unaccumulated, as in the JAX package
    tail_step_fn = make_train_step(model, **common, with_metrics=health)
    eval_fn = make_eval_fn(model, batch_size=config.batch_size_test)

    history = M.MetricsHistory()
    n_train, n_test = len(train_ds), len(test_ds)
    batch = config.batch_size_train
    ckpt_path = os.path.join(config.results_dir, "model.ckpt")
    ckpt_store = os.path.join(config.results_dir, "checkpoints")
    saver = checkpoint.make_saver(config.async_checkpoint, tele=tele.writer)
    # host-side hooks at epoch boundaries; with both flags off they touch no state
    rt = resilience.RunHooks(heartbeat_dir=config.heartbeat_dir,
                             handle_preemption=config.handle_preemption)

    def timed_save(state: TrainState) -> float:
        """A log tick's overwrite save; its seconds leave the epoch's ``execute_s``, as the
        JAX package's timer stops before it (the save is its own ``checkpoint`` event)."""
        t0 = time.perf_counter()
        saver.save_train_state(ckpt_path, state)
        return time.perf_counter() - t0

    def evaluate(state: TrainState, examples_seen: int) -> None:
        # an EMA run evaluates the averaged weights (the reason to keep one)
        eval_params = state.ema if state.ema is not None else state.params
        sum_nll, correct = eval_fn(eval_params, test_x, test_y)
        avg = sum_nll.item() / n_test              # sum-then-divide
        history.record_test(examples_seen, avg)
        M.log(M.test_summary_line(avg, int(correct.item()), n_test, watch.elapsed()))

    def train_epoch(state: TrainState, epoch: int) -> tuple[TrainState, dict]:
        """One epoch; returns the state and its ledger: the index plan's seconds, the
        losses' device sum and count, and the health accumulators (``--health-stats``)."""
        t_data = time.perf_counter()
        train_loader.set_epoch(epoch)
        indices = train_loader.sampler.epoch_indices(epoch)
        idx_full = to_device(train_loader.epoch_index_matrix(epoch, allow_empty=True))
        full_steps = idx_full.shape[0]
        ledger = {"data_s": time.perf_counter() - t_data, "save_s": 0.0,
                  "loss_sum": torch.zeros((), device=device), "loss_steps": 0,
                  "health": init_health(device) if health else None}

        # log_interval-sized segments (the last may be shorter), then the ragged tail.
        li = config.log_interval
        for seg_start in range(0, full_steps, li):
            state, out = tele.first_call(segment_fn, state, train_x, train_y,
                                         idx_full[seg_start:seg_start + li], config.seed,
                                         steps_per_call=li)
            losses = out[0] if health else out
            if health:
                ledger["health"] = merge_health(ledger["health"], out[1])
            ledger["loss_sum"] += losses.sum()
            ledger["loss_steps"] += losses.shape[0]
            last_loss = losses[-1].item()              # the tick's one host sync
            batches_done = min(seg_start + li, full_steps)
            examples_seen = (epoch - 1) * n_train + batches_done * batch
            M.log(M.train_progress_line(epoch, batches_done * batch, n_train, last_loss))
            history.record_train(examples_seen, last_loss)
            # the every-log-tick overwrite checkpoint: the state is on the host before the
            # next segment replays over it
            ledger["save_s"] += timed_save(state)

        # final partial batch (drop_last=False, as torch's DataLoader defaults)
        tail = indices[full_steps * batch:]
        if len(tail):
            tail_idx = to_device(tail)
            state, out = tail_step_fn(state, train_x.index_select(0, tail_idx),
                                      train_y.index_select(0, tail_idx), config.seed)
            loss = out[0] if health else out
            if health:
                ledger["health"] = update_health(ledger["health"], *out)
            ledger["loss_sum"] += loss
            ledger["loss_steps"] += 1
        return state, ledger

    def train_epoch_host_pipeline(state: TrainState, epoch: int) -> TrainState:
        """The reference-shaped loop: host batches through the native threaded prefetcher,
        one step a batch; the same plan, dropout keys, ticks and tail as ``train_epoch``."""
        train_loader.set_epoch(epoch)
        train_loader.pop_wait_s()                  # this epoch's data wait starts at zero
        full_steps = train_loader.epoch_index_matrix(epoch, allow_empty=True).shape[0]
        save_s = 0.0
        li = config.log_interval
        # the live bar (the reference's tqdm) draws only on a rank-0 terminal
        with M.ProgressBar(full_steps, desc=f"Epoch {epoch} ") as bar:
            for b, (bx, by) in enumerate(train_loader.prefetch_iter(epoch), start=1):
                state, loss = host_step(state, bx, by, config.seed)
                if b % li == 0 or b == full_steps:
                    bar.close()                    # the log line starts on a clean line
                    last_loss = loss.item()        # the tick's one host sync
                    examples_seen = (epoch - 1) * n_train + b * batch
                    M.log(M.train_progress_line(epoch, b * batch, n_train, last_loss))
                    history.record_train(examples_seen, last_loss)
                    # the state is on the host before the next replay overwrites it
                    save_s += timed_save(state)
                bar.update(1)
        history.data_wait_seconds.append(train_loader.pop_wait_s())
        tail = train_loader.sampler.epoch_indices(epoch)[full_steps * batch:]
        if len(tail):
            state, _ = tail_step_fn(state, to_device(train_ds.images[tail]),
                                    to_device(train_ds.labels[tail].astype(np.int64)),
                                    config.seed)
        return state, {"data_s": None, "save_s": save_s, "loss_sum": None, "loss_steps": 0,
                       "health": None}

    if config.use_host_pipeline:
        train_epoch = train_epoch_host_pipeline

    try:
        with maybe_profile(config.profile, config.profile_dir):
            with annotate("eval"):
                evaluate(state, 0)                     # baseline eval
            for epoch in range(1, config.n_epochs + 1):
                # the heartbeat, with the previous boundary's fingerprint; no-op off
                rt.epoch_tick(state, epoch, fingerprint=grt.fingerprint)
                step_before = int(state.step)
                t_epoch = time.perf_counter()
                with annotate(f"train_epoch_{epoch}"):
                    state, ledger = train_epoch(state, epoch)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)     # honest wall-clock
                history.epoch_seconds.append(time.perf_counter() - t_epoch)
                t_eval = time.perf_counter()
                with annotate("eval"):
                    evaluate(state, epoch * n_train)
                if tele.on:
                    steps = int(state.step) - step_before
                    h = ledger["health"]
                    tele.epoch(epoch, examples=n_train, steps=steps,
                               wall_s=time.perf_counter() - t_epoch,
                               execute_s=(history.epoch_seconds[-1]
                                          - (ledger["data_s"] or 0.0) - ledger["save_s"]),
                               eval_s=time.perf_counter() - t_eval,
                               data_s=ledger["data_s"],
                               train_loss=(ledger["loss_sum"].item() / ledger["loss_steps"]
                                           if ledger["loss_steps"] else None),
                               val_loss=history.test_losses[-1],
                               health=T.host_health(h) if h is not None else None,
                               param_norm=(T.global_l2_norm(state.params)
                                           if h is not None else None))
                stamp = grt.epoch_end(state, epoch, steps=int(state.step) - step_before)
                if config.keep_checkpoints:
                    # the versioned store, with the guard's health stamp and the data
                    # cursor of the (seed, epoch) permutation
                    checkpoint.save_versioned(
                        ckpt_store, state, keep=config.keep_checkpoints, health=stamp,
                        tele=tele.writer,
                        cursor={"version": 1, "kind": "epoch", "seed": config.seed,
                                "epoch": epoch + 1, "batch": 0, "step": int(state.step)})
                # the guard's exit after the stamped checkpoint is durable (raises
                # Poisoned; __main__ exits 65)
                grt.check_poisoned(state)
                # preemption at the epoch boundary: the tick checkpoint lags the tail
                # batch, so save first (raises Preempted; __main__ exits 75)
                rt.check_preempt(epoch=epoch, state=state, checkpoint=ckpt_path,
                                 save=lambda: saver.save_train_state(ckpt_path, state),
                                 tele=tele.writer)
            tele.close()

        plotting.save_loss_curves(history,
                                  os.path.join(config.images_dir, "train_test_curve.png"))
        M.save_metrics_jsonl(history, os.path.join(config.results_dir, "metrics.jsonl"))
        saver.save_train_state(ckpt_path, state)       # the final state
    finally:
        # drain the write-behind queue however the loop ended: the queued checkpoint is a
        # stopped run's artifact (flush re-raises a background error); give the signals
        # back to an in-process caller
        rt.uninstall()
        saver.flush()
    return state, history


def run_cli(config_cls, main_fn) -> None:
    """A trainer's ``__main__``: parse the flags, train, and exit ``EXIT_PREEMPTED`` (75)
    after a cooperative stop, ``EXIT_POISONED`` (65) when the guard's ``--anomaly-exit``
    policy stopped the run."""
    try:
        main_fn(parse_config(config_cls))
    except resilience.Preempted as e:
        M.log(f"preempted at step {e.step} (checkpoint {e.checkpoint or 'n/a'}); exiting "
              f"{resilience.EXIT_PREEMPTED} — resume with --resume-from")
        raise SystemExit(resilience.EXIT_PREEMPTED) from None
    except resilience.Poisoned as e:
        M.log(f"poisoned at step {e.step} (anomaly window {e.window[0]}:{e.window[1]}); "
              f"exiting {resilience.EXIT_POISONED} — a supervisor rolls back to the newest "
              f"healthy checkpoint and skips the window")
        raise SystemExit(resilience.EXIT_POISONED) from None


if __name__ == "__main__":
    run_cli(SingleProcessConfig, main)
