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
predicate), the dense core below. Under a seq axis it runs the ring-of-flash
(``parallel.ring_attention``, the flash kernels on every hop with its offset), or with
``--zigzag-attention --causal`` the zig-zag ring-of-flash; ``--attention-window`` binds
the band into either. The seq world is the process group (``parallel.mesh.cluster``:
``train.launch`` or ``torchrun`` start it; without them a world of one): every rank holds
the whole batch and the same parameters, attention shards the sequence, the ranks draw
the same dropout masks, and the parameter gradients agree with no reduce; the trainer
checks that the replicas are still equal at the end. Metrics print and save on rank 0.
Run the slice's paths on the card with::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.composed \\
        --mesh data=1 --flash-attention --seq-len 2048
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.launch \\
        --num-processes 2 -- \\
        -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.composed \\
        --mesh data=1,seq=2 --flash-attention --seq-len 2048

(two ranks on one card run gloo and time-slice it: ``parallel/mesh.py``'s backend rule).

Not ported yet: meshes of more than one device other than a seq axis alone (data beside
seq, tensor/expert/pipeline parallelism and MoE), the einsum ring and zig-zag, Ulysses
(ROADMAP A6/A10), remat, AdamW, label smoothing, LR schedules, EMA, telemetry and the
resilience hooks, and the checkpoint (ROADMAP A5).
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
    load_mnist,
    truncate,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
    NUM_HEADS,
    TransformerClassifier,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    attention,
    flash_attention,
    optim,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    ring_attention,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    cluster,
    parse_mesh_spec,
    seq_axis_size,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
    resolve_device,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    make_eval_fn,
    make_segment_fn,
    make_train_step,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import metrics as M
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
    ComposedConfig,
    parse_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.determinism import (
    assert_replicas_synced,
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
    if config.kv_heads and (config.kv_heads < 0 or NUM_HEADS % config.kv_heads):
        raise ValueError(f"--kv-heads {config.kv_heads} must be a positive divisor of the "
                         f"transformer's {NUM_HEADS} heads")
    if config.attention_window:
        attention.validate_window(config.attention_window)
    if config.seq_impl not in ("ring", "ulysses"):
        raise ValueError(
            f"--seq-impl must be 'ring' or 'ulysses', got {config.seq_impl!r}")
    if config.seq_impl == "ulysses":
        if config.zigzag_attention:
            raise ValueError("--zigzag-attention is a ring schedule — it does not "
                             "compose with --seq-impl ulysses")
        raise ValueError("--seq-impl ulysses (head-scatter all-to-all) is not ported "
                         "(ROADMAP A10) — use --seq-impl ring")
    block = flash_attention.BLOCK
    if config.zigzag_attention:
        if not config.causal:
            raise ValueError("--zigzag-attention is causal-only — add --causal")
        if "seq" not in names:
            raise ValueError("--zigzag-attention needs a seq axis in --mesh")
        if not config.flash_attention:
            raise ValueError("--zigzag-attention without --flash-attention is the einsum "
                             "zig-zag, not ported (ROADMAP A10) — add --flash-attention")
        if config.seq_len % (2 * seq * block):
            raise ValueError(
                f"--zigzag-attention --flash-attention needs seq_len divisible "
                f"by 2·seq_axis·BLOCK = {2 * seq * block}, got {config.seq_len} "
                f"(e.g. --seq-len {2 * seq * block})")
    elif config.flash_attention:
        if config.seq_len % (seq * block):
            raise ValueError(
                f"--flash-attention needs seq_len divisible by "
                f"seq_axis·BLOCK = {seq}·{block}, got "
                f"{config.seq_len} (e.g. --seq-len {seq * block})")
    elif seq > 1:
        raise ValueError(f"a seq axis without --flash-attention is the einsum ring, not "
                         f"ported (ROADMAP A10) — add --flash-attention (--mesh "
                         f"{config.mesh})")
    return seq


def build_classifier(config: ComposedConfig) -> TransformerClassifier:
    """The model the trainer runs, with its attention core chosen from the flags: the
    zig-zag or plain ring-of-flash under a seq axis, else one device's flash dispatch,
    windowed core or dense core."""
    attention_fn = attention.full_attention
    window = config.attention_window or None
    if config.zigzag_attention:
        attention_fn = ring_attention.make_ring_attention_fn(
            use_flash=True, use_zigzag=True, window=config.attention_window)
    elif config.flash_attention and seq_axis_size(config.mesh) > 1:
        attention_fn = ring_attention.make_ring_attention_fn(
            use_flash=True, window=config.attention_window)
    elif config.flash_attention:
        attention_fn = functools.partial(flash_attention.dispatch_attention, window=window)
    elif window:
        attention_fn = attention.windowed_attention_fn(window)
    return TransformerClassifier(
        seq_len=config.seq_len, dropout_rate=config.dropout_rate,
        dtype=torch.bfloat16 if config.bf16 else torch.float32, causal=config.causal,
        num_kv_heads=config.kv_heads or None, rope=config.rope, attention_fn=attention_fn)


def build_segment_fn(config: ComposedConfig, model: TransformerClassifier):
    """The optimizer and the segment function ``main`` trains with (one call per epoch over
    the epoch's index plan), from the flags: one definition, so that a caller timing the
    trainer's steps runs the same ones."""
    optimizer = optim.make_optimizer(config.optimizer, learning_rate=config.learning_rate,
                                     momentum=config.momentum)
    return optimizer, make_segment_fn(make_train_step(
        model, learning_rate=config.learning_rate, momentum=config.momentum,
        optimizer=optimizer))


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
    optimizer, segment_fn = build_segment_fn(config, model)
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

    state = create_train_state(model, torch.Generator().manual_seed(config.seed),
                               optimizer=optimizer, device=device)
    if init_params is not None:
        params = {k: p.to(device) for k, p in init_params.items()}
        state = TrainState(params, optimizer.init(params), 0)
    eval_fn = make_eval_fn(model, batch_size=config.batch_size_test)

    # Device-resident splits: the one host->device transfer.
    to_device = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    train_x, test_x = to_device(train_ds.images), to_device(test_ds.images)
    train_y = to_device(train_ds.labels.astype(np.int64))
    test_y = to_device(test_ds.labels.astype(np.int64))
    history = M.MetricsHistory()
    for epoch in range(config.epochs):
        t_epoch = time.perf_counter()
        plan = to_device(epoch_plan(config.seed, epoch, n_train, steps_per_epoch, batch))
        state, losses = segment_fn(state, train_x, train_y, plan, config.seed + 1)
        epoch_loss = losses.mean().item()               # the epoch's one host sync
        history.epoch_seconds.append(time.perf_counter() - t_epoch)
        sum_nll, correct = eval_fn(state.params, test_x, test_y)
        val_loss = sum_nll.item() / n_test
        examples_trained = (epoch + 1) * steps_per_epoch * batch
        history.record_train(examples_trained, epoch_loss)
        history.record_test(examples_trained, val_loss)
        M.log(f"Epoch {epoch}: train_loss: {epoch_loss:.4f}, val_loss: {val_loss:.4f}, "
              f"accuracy: {int(correct.item()) / n_test:.4f}, "
              f"time_elapsed: {watch.elapsed():.2f}s")
    assert_replicas_synced(state.params)      # a collective; no-op at one rank
    if config.results_dir and info.is_coordinator:
        M.save_metrics_jsonl(history, os.path.join(config.results_dir, "metrics.jsonl"))
    return state, history


if __name__ == "__main__":
    main(parse_config(ComposedConfig))
