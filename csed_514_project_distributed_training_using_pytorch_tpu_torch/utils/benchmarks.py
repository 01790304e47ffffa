"""The epoch bench's protocol: honest wall-clock for one training epoch of the data-parallel
CNN trainer.

Counterpart of the parts of the JAX package's ``utils/benchmarks.py`` that its epoch bench
uses: the reference's headline number, time to train one epoch, measured as:

- the data-parallel step of ``train/distributed.py`` (the gradient all-reduce included,
  at any world size), over the whole epoch's column block of the global plan;
- one untimed warm-up epoch, which pays for cuDNN's algorithm choice, the allocator's
  first growth and the process group's first collectives;
- N timed epochs, each closed by ``torch.cuda.synchronize()`` and a host fetch of the
  epoch's last loss plus one element of the last update's parameters, so that no step is
  still in flight when the clock stops.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data.mnist import Dataset
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.cnn import Net
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    data_parallel as dp,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    ProcessInfo,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.sampler import (
    ShardedSampler,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.distributed import (
    epoch_index_plan,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    make_segment_fn,
    make_train_step,
)

# The reference-parity training configuration the bench measures under (the reference's
# single trainer's values; the global batch stays fixed as the world grows).
GLOBAL_BATCH = 64
LEARNING_RATE = 0.01
MOMENTUM = 0.5

# Per-example model FLOPs, forward pass, from the architecture (models/cnn.py): conv as
# 2·H_out·W_out·C_out·(K·K·C_in), dense as 2·in·out.
FWD_FLOPS_PER_EXAMPLE = (
    2 * 24 * 24 * 10 * (5 * 5 * 1)      # conv1: 288,000
    + 2 * 8 * 8 * 20 * (5 * 5 * 10)     # conv2: 640,000
    + 2 * 320 * 50                      # fc1:    32,000
    + 2 * 50 * 10                       # fc2:     1,000
)
TRAIN_FLOPS_PER_EXAMPLE = 3 * FWD_FLOPS_PER_EXAMPLE   # fwd + ~2x for backward

# Published H100 SXM figures, by substring of the device name (first match wins). The
# model computes in f32, so an MFU against the bf16 peak is a conservative lower bound.
PEAK_FLOPS_BY_KIND = [("h100", 989e12)]               # bf16 dense, tensor cores
PEAK_F32_FLOPS_BY_KIND = [("h100", 67e12)]            # f32 (FFMA)
PEAK_HBM_BYTES_BY_KIND = [("h100", 3.35e12)]          # device-memory bytes/s
HBM_CAPACITY_BY_KIND = [("h100", 80e9)]               # device-memory bytes


def lookup_by_kind(table, device_kind: str, default=None):
    """First-match substring lookup over a device-kind spec table (case-insensitive)."""
    kind = device_kind.lower()
    return next((val for key, val in table if key in kind), default)


def peak_flops(device_kind: str) -> float | None:
    """bf16 peak FLOP/s for a device name, or None if unknown."""
    return lookup_by_kind(PEAK_FLOPS_BY_KIND, device_kind)


@dataclass(frozen=True)
class EpochBenchResult:
    """One world size's measurement of the reference's headline metric."""

    devices: int
    epoch_seconds: list[float]      # every timed epoch, in order
    median_seconds: float
    steps_per_epoch: int
    final_train_loss: float
    final_state: TrainState         # after warm-up + timed epochs (for eval)


def time_epochs(info: ProcessInfo, train_ds: Dataset, *, global_batch: int = 64,
                learning_rate: float = 0.01, momentum: float = 0.5,
                seed: int = 1, sampler_seed: int = 42,
                timed_epochs: int = 3) -> EpochBenchResult:
    """Measure full-epoch wall-clock of the data-parallel step in ``info``'s process group
    under the protocol above (every rank calls it)."""
    world, rank, device = info.process_count, info.process_index, info.device
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by world size "
                         f"{world} — the reported protocol would be wrong")
    per = global_batch // world
    model = Net()
    state = create_train_state(model, torch.Generator().manual_seed(seed), device=device)
    dp.broadcast_params_(state.params)
    segment_fn = make_segment_fn(make_train_step(
        model, learning_rate=learning_rate, momentum=momentum,
        grad_reduce=dp.GradReducer(state.params), rank=rank))
    train_x = torch.from_numpy(train_ds.images).to(device)
    train_y = torch.from_numpy(train_ds.labels.astype(np.int64)).to(device)
    samplers = [ShardedSampler(len(train_ds), num_replicas=world, rank=r,
                               seed=sampler_seed) for r in range(world)]
    probe_leaf = next(iter(state.params))

    def one_epoch(state: TrainState, epoch: int):
        plan = epoch_index_plan(samplers, epoch, per)
        idx = torch.from_numpy(np.ascontiguousarray(plan[:, rank * per:(rank + 1) * per]))
        state, losses = segment_fn(state, train_x, train_y, idx.to(device), seed + 1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        # the host fetch: the last step's loss and an element of its update's parameters
        final_loss = losses[-1].item()
        state.params[probe_leaf].reshape(-1)[0].item()
        return state, final_loss, plan.shape[0]

    state, final_loss, steps = one_epoch(state, 0)       # warm-up
    times = []
    for epoch in range(1, timed_epochs + 1):
        t0 = time.perf_counter()
        state, final_loss, steps = one_epoch(state, epoch)
        times.append(time.perf_counter() - t0)
    return EpochBenchResult(devices=world, epoch_seconds=times,
                            median_seconds=float(np.median(times)), steps_per_epoch=steps,
                            final_train_loss=final_loss, final_state=state)
