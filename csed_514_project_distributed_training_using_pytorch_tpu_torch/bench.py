"""Benchmark: MNIST 1-epoch wall-clock of the data-parallel CNN trainer — the reference's
headline metric, on the port.

Counterpart of the repository's ``bench.py`` (its ``measure()``). The reference's published
result is time to train one epoch against the machine count: about 17.5 on one CPU machine
and 7.6 on four machines with DDP over gloo, the unit unlabeled (read as seconds).
``vs_baseline`` is the speedup over 7.6. The protocol (``utils/benchmarks.py``): one
warm-up epoch, then ``BENCH_TIMED_EPOCHS`` (default 7) timed epochs; the median is the
value, the min and every sample ride beside it. ``BENCH_MAX_TRAIN_EXAMPLES`` truncates the
train split for a functional run, which says so and has no ``vs_baseline``.

The world size comes from the launcher's environment (``train.launch``, ``torchrun``); a
plain run is a world of 1. The bench runs on the card and exits non-zero without one,
unless ``--device cpu`` asks for the CPU. Rank 0 prints exactly one JSON line on stdout::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.bench
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
    load_mnist,
    truncate,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.cnn import Net
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    data_parallel as dp,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    cluster,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
    resolve_device,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
    make_eval_fn,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.benchmarks import (
    GLOBAL_BATCH,
    LEARNING_RATE,
    MOMENTUM,
    TRAIN_FLOPS_PER_EXAMPLE,
    peak_flops,
    time_epochs,
)

BASELINE_BEST = 7.6          # the reference's 4-machine DDP/gloo epoch time


def measure(device: str = "cuda", data_dir: str = "files") -> dict | None:
    """Run the bench as this process's rank; rank 0 returns the result, the others None."""
    dev = resolve_device(device)
    with cluster(dev) as info:
        train_ds, test_ds = load_mnist(data_dir)
        # Functional-test knob only — the published protocol is the full 60k split (0).
        truncated_to = int(os.environ.get("BENCH_MAX_TRAIN_EXAMPLES", "0"))
        full_split = truncated_to <= 0 or truncated_to >= len(train_ds)
        train_ds = truncate(train_ds, truncated_to)
        timed = max(1, int(os.environ.get("BENCH_TIMED_EPOCHS", "7")))
        result = time_epochs(info, train_ds, global_batch=GLOBAL_BATCH,
                             learning_rate=LEARNING_RATE, momentum=MOMENTUM, seed=1,
                             timed_epochs=timed, pregather=True)
        test_x = torch.from_numpy(test_ds.images).to(info.device)
        test_y = torch.from_numpy(test_ds.labels.astype(np.int64)).to(info.device)
        sum_nll, correct = dp.evaluate(make_eval_fn(Net(), batch_size=1000),
                                       result.final_state.params, test_x, test_y)
        if not info.is_coordinator:
            return None
        on_card = info.device.type == "cuda"
        kind = torch.cuda.get_device_name(info.device) if on_card else "cpu"
        examples_per_epoch = result.steps_per_epoch * GLOBAL_BATCH
        examples_per_s = examples_per_epoch / result.median_seconds
        achieved_flops = examples_per_s * TRAIN_FLOPS_PER_EXAMPLE
        peak = peak_flops(kind) if on_card else None
        return {
            "event": "bench",
            # A truncated functional run is labeled as such and never compared against
            # the reference's full-epoch time.
            "metric": ("MNIST 1-epoch wall-clock (60k examples, global batch 64)"
                       if full_split else
                       f"MNIST truncated-epoch wall-clock ({len(train_ds)} examples, "
                       f"global batch 64) — FUNCTIONAL TEST, not the published protocol"),
            "value": round(result.median_seconds, 4),
            "unit": "s",
            "vs_baseline": (round(BASELINE_BEST / result.median_seconds, 2)
                            if full_split else None),
            "devices": result.devices,
            "platform": "gpu" if on_card else "cpu",
            "device_kind": kind,
            "collective_backend": info.backend,
            "scan_unroll": 1,
            "pregather": True,
            "steps_per_epoch": result.steps_per_epoch,
            "train_examples": len(train_ds),
            "steps_per_s": round(result.steps_per_epoch / result.median_seconds, 1),
            "examples_per_s": round(examples_per_s, 1),
            "model_train_flops_per_example": TRAIN_FLOPS_PER_EXAMPLE,
            "achieved_model_flops_per_s": round(achieved_flops),
            "mfu_vs_bf16_peak": (round(achieved_flops / (peak * result.devices), 8)
                                 if peak else None),
            "epoch_seconds_all": [round(t, 4) for t in result.epoch_seconds],
            "min_epoch_seconds": round(min(result.epoch_seconds), 4),
            "final_train_loss": round(result.final_train_loss, 4),
            "epochs_trained": 1 + timed,        # warm-up + timed, all real training
            "test_nll_after_run": round(sum_nll / len(test_ds), 4),
            "test_accuracy_after_run": round(correct / len(test_ds), 4),
            "data_source": train_ds.source,
        }


def _sanitize_json(obj):
    """Strict JSON: non-finite floats become None."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _sanitize_json(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_sanitize_json(v) for v in obj]
    return obj


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0],
                                     allow_abbrev=False)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default: exits non-zero when no card is "
                             "present) or 'cpu', which must be asked for")
    parser.add_argument("--data-dir", default="files",
                        help="MNIST IDX files; the synthetic split without them")
    args = parser.parse_args(argv)
    payload = measure(args.device, args.data_dir)
    if payload is not None:
        print(json.dumps(_sanitize_json(payload), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
