"""Data-parallel trainer — the reference ``train_dist.py`` workflow on ``torch.distributed``.

Counterpart of the JAX package's ``train/distributed.py``. Every rank runs this same
module; its coordinates come from the launcher's environment (``train.launch``,
``torchrun``), and without one it trains as a world of one. In order: rendezvous
(``parallel.mesh.cluster``: NCCL when each rank has a card of its own, else gloo), the
per-rank batch ``global_batch_size // world``, one ``ShardedSampler`` per rank, rank 0's
parameters broadcast to all, then ``epochs`` rounds of (train, evaluate, print the epoch
summary), the replica-sync check, and rank 0's ``results/metrics.jsonl``.

The whole split lives on each rank's device. Every rank builds the same global
``[steps, global_batch]`` plan (``epoch_index_plan``) and trains on its own column block,
so each step's global batch is the one the JAX package trains on; the gradient and the
loss are averaged over the ranks by one all-reduce a step (``GradReducer``). The final
sub-global-batch remainder of each epoch is dropped, as in the JAX package. Training runs
in ``log_interval``-step segments; the host syncs once a segment, for the progress line's
global-mean loss.

Run it with (a world of 2 on the CPU; ``--device cuda``, the default, on the card)::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.launch \\
        --num-processes 2 -- \\
        -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.distributed \\
        --device cpu --epochs 1

Not ported (ROADMAP A5): the ``model_dist.msgpack`` export and the loss-curve figure.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
    load_mnist,
    truncate,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import build_model
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import optim
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    data_parallel as dp,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    cluster,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.sampler import (
    ShardedSampler,
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
    DistributedConfig,
    parse_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.determinism import (
    assert_replicas_synced,
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


def main(config: DistributedConfig = DistributedConfig(), *,
         datasets=None) -> tuple[TrainState, M.MetricsHistory]:
    """Run data-parallel training as this process's rank; every rank calls it. Returns the
    rank's final state (the same on every rank) and the metric history.

    ``datasets`` optionally injects a ``(train, test)`` Dataset pair (tests, notebooks); by
    default MNIST is loaded from ``config.data_dir``."""
    watch = M.Stopwatch()
    device = resolve_device(config.device)            # fail fast, before the rendezvous
    optimizer = optim.make_optimizer(config.optimizer, learning_rate=config.learning_rate,
                                     momentum=config.momentum)
    with cluster(device) as info:
        world, rank = info.process_count, info.process_index
        if config.global_batch_size % world:
            raise ValueError(f"global batch {config.global_batch_size} not divisible by "
                             f"world size {world}")
        per_replica_batch = config.global_batch_size // world

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

        samplers = [ShardedSampler(n_train, num_replicas=world, rank=r,
                                   seed=config.sampler_seed) for r in range(world)]
        model = build_model("cnn").to(info.device)
        state = create_train_state(model, torch.Generator().manual_seed(config.seed),
                                   optimizer=optimizer, device=info.device)
        dp.broadcast_params_(state.params)
        step_fn = make_train_step(model, learning_rate=config.learning_rate,
                                  momentum=config.momentum, optimizer=optimizer,
                                  grad_reduce=dp.GradReducer(state.params), rank=rank)
        segment_fn = make_segment_fn(step_fn)
        eval_fn = make_eval_fn(model, batch_size=config.batch_size_test)

        to_device = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(info.device)
        train_x, test_x = to_device(train_ds.images), to_device(test_ds.images)
        train_y = to_device(train_ds.labels.astype(np.int64))
        test_y = to_device(test_ds.labels.astype(np.int64))
        columns = slice(rank * per_replica_batch, (rank + 1) * per_replica_batch)

        history = M.MetricsHistory()
        li = config.log_interval
        for epoch in range(config.epochs):
            t_epoch = time.perf_counter()
            plan = epoch_index_plan(samplers, epoch, per_replica_batch)
            idx = to_device(plan[:, columns])
            steps = plan.shape[0]
            segments = []
            for seg_start in range(0, steps, li):
                state, losses = segment_fn(state, train_x, train_y,
                                           idx[seg_start:seg_start + li], config.seed)
                segments.append(losses)
                last_loss = losses[-1].item()             # the segment's one host sync
                done = min(seg_start + li, steps) * config.global_batch_size
                M.log(M.train_progress_line(epoch, done, n_train, last_loss))
            if info.device.type == "cuda":
                torch.cuda.synchronize(info.device)       # honest wall-clock
            history.epoch_seconds.append(time.perf_counter() - t_epoch)
            losses = torch.cat(segments).cpu().numpy()
            train_loss = float(losses.mean())     # per-epoch mean of per-step global means
            for i, loss in enumerate(losses[::li]):
                history.record_train(epoch * plan.size + i * li * plan.shape[1],
                                     float(loss))

            sum_nll, correct = dp.evaluate(eval_fn, state.params, test_x, test_y,
                                           shard=config.shard_eval)
            val_loss, accuracy = sum_nll / n_test, correct / n_test
            history.record_test((epoch + 1) * plan.size, val_loss)
            M.log(M.dist_epoch_summary_line(epoch, train_loss, val_loss, accuracy,
                                            watch.elapsed()))

        assert_replicas_synced(state.params)
        if info.is_coordinator:
            M.save_metrics_jsonl(history, os.path.join(config.results_dir, "metrics.jsonl"))
    return state, history


if __name__ == "__main__":
    main(parse_config(DistributedConfig))
