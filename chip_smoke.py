#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100: builds the hand-written CUDA kernels,
holds each against its plain PyTorch version on the card, trains the reference CNN for one
epoch through the fused kernels, trains the transformer classifier through the flash
kernels (the composed trainer at seq 2048, and a few steps at the large bench widths), and
serves the pixel LM through the paged-decode kernel (the continuous-batching engine).

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. the device: ``torch.cuda.get_device_name`` and nvidia-smi's name and power limit;
2. build ``csrc/fused_kernels.cu``, ``csrc/flash_attention.cu`` and
   ``csrc/paged_attention.cu`` with nvcc for sm_90a, one nvcc per source started together;
   report the build seconds, ptxas's registers and spills (every kernel must spill 0
   bytes), and the tensor-core (HMMA) instructions of each flash kernel as ``cuobjdump
   -sass`` lists them (every flash kernel must have them: the bf16 kernels and the f32
   3xTF32 kernels);
3. each kernel against its plain version on the card, at the main path's shapes and more,
   with its time, its plain version's time, its bound and, where one PyTorch call computes
   the same function, that call's time (a yardstick only; the port never calls it); the
   SGD step (one multi-tensor launch over every leaf) and one leaf (a table of one) bitwise;
4. a 20-step trajectory with dropout off, kernels against the plain path, on the card, and
   the kernel path on the card against the plain path on the CPU;
5. the whole slice: ``train.single.main`` on cuda with ``use_pallas_kernels=True`` for one
   epoch of the 60k/10k split at batch 64, with the launch counts read around it;
6. where a step spends its time: the train step's wall time with the kernels and with the
   plain path, in turns (plain, kernels, kernels, plain), then a ``torch.profiler`` window
   over the kernel path: device time by kernel, device time per launch of each fused
   kernel, and the device's busy share of the window (the rest is idle, waiting on the
   host);
7. the flash kernels (B4, B5) against their plain versions on the card, at the composed
   trainer's shape, the large bench shape and test shapes (masks, widths, bf16), with the
   time of each kernel, of its plain version and of ``F.scaled_dot_product_attention``
   (a yardstick only), its bound, and its device time per launch from a profiler window;
   f32 operands take the 3xTF32 tensor-core kernels, bf16 ones the bf16 tensor-core
   kernels (B4 and B5); the f32 bound is the tensor cores' 3xTF32 one, with the CUDA
   cores' FFMA bound printed beside it;
8. flash against the dense core at the composed widths, S in {512, 1024, 2048}, forward and
   forward+backward: the card's own flash/dense crossover (recorded; nothing reads it);
9. the slice's path: ``train.composed.main`` on cuda, ``--mesh data=1 --flash-attention
   --seq-len 2048``, one epoch (capped at ``COMPOSED_TRAIN`` train and ``COMPOSED_TEST``
   test examples), with the flash launch counts read around it against what the step
   count predicts, the val loss against its value at init, and a profiler window over
   five steps of the segment function ``main`` trains with;
10. a few bf16 optimizer steps of the classifier at the ``bench_transformer.py --large``
    widths on synthetic ``[16, 2048, 16]`` tokens through the tensor-core backward, with
    the flash launch counts read around the timed steps, step ms and a profiler window;
11. the paged-decode kernels (B6: the split kernel and the combine kernel that merges its
    chunks) against their plain version on the card: the serving shape ``[8, 4, 1, 16]``
    f32 over a 105-page pool, D = 32 bf16 GQA, int8 and fp8 codes with scales, a window,
    ``t = 0``, every slot at the last position (every chunk live), slots' t spread so that
    some chunks are empty, and 8 query rows per KV head at D = 128; for each, the split,
    max |err|, kernel and plain ms, device µs per call (both kernels), its bound, and
    ``F.scaled_dot_product_attention`` on the gathered view (a yardstick only);
12. the slice: ``serving.ContinuousBatchingEngine.run`` at ``tools/serve_loadgen.py``'s
    default widths (vocab 17, seq 784, embed 64, 2 layers, 4 heads, 8 slots, pages of 64,
    chunks 32/128/512, budget 1) serving 32 greedy requests cut from the synthetic test
    split, in the paged layout (through B6) and the contiguous one (plain torch): equal
    streams (up to true ties), B6 launches = layers × decode steps, tokens/s, and a
    profiler window over decode steps;
13. a few requests at ``bench_lm.py``'s widths (d 256, 4 layers, 8 heads, 2 KV heads,
    bf16, 8 slots) through B6;
14. rendezvous: ``train.smoke`` at world 1 on NCCL in this process, then at world 2 on gloo
    through the port's launcher, two processes on the one card (NCCL refuses two ranks on
    one device), each with its backend and its ring;
15. the data-parallel slice: ``train.distributed.main`` on cuda at world 1 (NCCL) for one
    epoch of the 60k/10k split at global batch 64 (937 steps), with every kernel count
    read around it (the data-parallel path runs no kernel of the port's, as the JAX
    package's runs no Pallas kernel), a profiler window over its step (busy share,
    launches per step) and one over the gradient reducer alone (the all-reduce's device
    µs per step); then world 2 on gloo through the launcher on a capped split (the val
    loss falls, the replicas stay in sync), and 20 steps with dropout off at world 2
    against world 1;
16. the port's epoch bench (``python -m <port>.bench``) at world 1, the full protocol (a
    warm-up epoch and 7 timed ones), its JSON line printed and checked;
17. the hop offset in B4/B5: every flash kernel, both routes, against its plain version at
    the composed shard shape ``[64, 1024, 4, 16]`` with ``q_offset`` in {−2C, −C, +C, +2C}
    (C = 1024), causal and not, windows 0, 100, 300 and 1000 (cases in which every row is
    dead included: out 0, lse −1e30), dq and dk/dv from the full row's lse and Δ; then
    each kernel's ms per call at ``q_offset = +C`` beside its ms at offset 0;
18. the ring ops (``parallel/ring_attention.py``: the ring-of-flash non-causal and causal,
    windows 100 and 300, the zig-zag plain and windowed) at gloo worlds 2 and 4 through the
    port's launcher, every rank on ``cuda:0``, against the one-process ``flash_attention``
    on the full sequence at the composed shape, forward and gradients, with each rank's
    launches against the plan (hops × blocks within the truncated reach), those at a
    nonzero hop offset included;
19. the slice: ``train.composed.main`` at ``--mesh data=1,seq=2 --flash-attention
    --seq-len 2048`` at full width for 20 steps (two gloo ranks through the launcher)
    against ``--mesh data=1`` in this process, per-step losses and final parameters, with
    each rank's launches (all, and at a nonzero hop offset) against the plan; then the
    same with ``--attention-window 300`` (every off-diagonal hop at its offset ±C), with
    ``--zigzag-attention --causal``, and with both; step ms (a time of two ranks
    time-slicing one card, no scaling point);
20. one JSON line with every kernel's numbers (each flash kernel with its offset form),
    then, last, the JSON result line.

It exits non-zero, and prints no result, when no CUDA device is present or when the port's
package is not beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "results" / "chip_smoke"
TPU_KERNELS = "csed_514_project_distributed_training_using_pytorch_tpu/ops/pallas_kernels.py"
SOURCE = f"{PKG}/csrc/fused_kernels.cu"
TPU_ATTENTION = "csed_514_project_distributed_training_using_pytorch_tpu/ops/pallas_attention.py"
FLASH_SOURCE = f"{PKG}/csrc/flash_attention.cu"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores (FFMA)
BF16_OPS_PER_S = 989e12        # H100 SXM bfloat16, dense, tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM TF32, dense, tensor cores
F32_3XTF32_OPS_PER_S = TF32_OPS_PER_S / 3   # an f32 product as three TF32 products

NLL_SHAPES = ((64, 10), (32, 10), (1, 10), (300, 130), (4096, 1000))
NLL_ATOL, NLL_RTOL = 1e-6, 1e-5
CNN_LEAVES = (250, 10, 5000, 20, 16000, 50, 500, 10)
TRAJECTORY_STEPS = 20
TRAJECTORY_ATOL = 1e-5         # kernels vs plain path, both on the card
CROSS_DEVICE_ATOL = 1e-4       # card vs CPU: conv sums run in another order
LR, MOMENTUM, BATCH = 0.01, 0.5, 64
PROFILE_STEPS = 200            # per timed run of phase 6
PROFILE_WINDOW = 100           # steps under the profiler

# Flash attention, phases 7-10. Shapes are [batch, seq, heads, head dim].
COMPOSED = (64, 2048, 4, 16)   # train.composed --seq-len 2048: embed 64 over 4 heads, f32
LARGE = (16, 2048, 8, 128)     # bench_transformer.py --large: d_model 1024, 8 heads, bf16
FLASH_CASES = (                # (shape, dtype, causal, window)
    (COMPOSED, "float32", False, 0), (LARGE, "bfloat16", False, 0),
    ((2, 128, 4, 16), "float32", True, 0), ((2, 256, 2, 64), "float32", False, 160),
    ((2, 256, 2, 64), "bfloat16", True, 160), ((2, 2048, 2, 128), "float32", True, 160),
    ((2, 2048, 2, 128), "bfloat16", False, 100), ((2, 2048, 2, 128), "bfloat16", True, 160),
    ((2, 2048, 4, 16), "bfloat16", True, 0))
# kernel vs plain (atol, rtol), as tests/test_torch_port_cuda.py: f32, the same arithmetic
# with f32 sums in another order; bf16 out and grads within one bf16 ulp — rtol 2^-7 is one
# ulp at any magnitude, atol 1e-3 two ulps below 0.125 — so a wrong tile (a 64-key tile
# skipped moves out by ~5e-3 at the large shape, where |out| ~ 0.03) fails; lse stays f32
# in both. bf16 operands lie on the grid of 1/16 in [-4, 4], on which q·kᵀ and dO·vᵀ are
# exact in f32 whatever the order of the sums: the tensor-core backward sums them in
# another order than the plain version, and on randn operands a p or ds within that f32
# error of a bf16 rounding midpoint rounds one step apart in the two (see the card tests)
BF16_RTOL = 2.0 ** -7
FLASH_TOL = {"float32": {"out": (2e-5, 1e-5), "lse": (1e-4, 1e-4), "grad": (1e-4, 1e-4)},
             "bfloat16": {"out": (1e-3, BF16_RTOL), "lse": (1e-4, 1e-4),
                          "grad": (1e-3, BF16_RTOL)}}
FLASH_ITERS, FLASH_WARMUP = 10, 2
CROSSOVER_SEQS = (512, 1024, 2048)
COMPOSED_TRAIN = 60000         # phase 9: the whole synthetic train split, 937 steps of 64
                               # (about 40 s on the card; 150 steps did not lower the val
                               # loss at seq 2048, one epoch does)
COMPOSED_TEST = 10000          # phase 9: the whole test split, 10 eval batches of 1000
LARGE_LAYERS, LARGE_STEPS = 8, 3   # phase 10: full depth; timed steps after one warm-up

# Paged decode and serving, phases 11-13.
TPU_PAGED = "csed_514_project_distributed_training_using_pytorch_tpu/ops/paged_attention.py"
PAGED_SOURCE = f"{PKG}/csrc/paged_attention.cu"
SERVE_LM = dict(vocab_size=17, seq_len=784, embed_dim=64, num_layers=2, num_heads=4)
SERVE_SLOTS, SERVE_PAGE, SERVE_REQUESTS = 8, 64, 32   # tools/serve_loadgen.py defaults
SERVE_MAX_NEW = 128            # phase 12: max_new_tokens drawn from 1..128
PAGED_CASES = (                # (label, KV heads G, rows per head R, D, pool dtype, window, t)
    ("serving", 4, 1, 16, "float32", 0, "random"),
    ("bench_lm_gqa", 2, 4, 32, "bfloat16", 0, "random"),
    ("int8", 4, 1, 16, "int8", 0, "random"),
    ("fp8", 2, 4, 32, "float8_e4m3fn", 0, "random"),
    ("window", 4, 1, 16, "float32", 100, "random"),
    ("t0", 4, 1, 16, "float32", 0, "zero"),
    ("long_t", 4, 1, 16, "float32", 0, "last"),
    ("mixed_t", 4, 1, 16, "int8", 0, "spread"),
    ("r8_d128", 2, 8, 128, "float32", 0, "random"))
# B6 vs plain: the same f32 arithmetic on the same f32 values (pool rows read as f32 or
# dequantised code·scale in both) with sums in another order over up to 784 positions
PAGED_ATOL, PAGED_RTOL = 1e-5, 1e-5
PAGED_ITERS, PAGED_WARMUP = 200, 20
TIE_GAP = 1e-5                 # a stream mismatch is a true tie when the plain path's top-2
                               # log-prob gap there is below this
DECODE_WINDOW = 50             # phase 12: decode steps under the profiler
BENCH_LM = dict(vocab_size=17, seq_len=784, embed_dim=256, num_layers=4, num_heads=8,
                num_kv_heads=2)   # bench_lm.py's widths (--kv-heads 2)
BENCH_LM_REQUESTS, BENCH_LM_MAX_NEW = 8, 64

# Data parallelism, phases 14-16. Worlds of 2 are two processes on the one card (gloo).
FLEET_TIMEOUT = 300            # seconds; the launcher kills the fleet and exits 124
DP_PROFILE_STEPS = 200         # phase 15: the data-parallel step under the profiler
DP_W2_TRAIN, DP_W2_TEST = 8192, 10000   # phase 15: the world-2 run's split, 2 epochs
DP_TRAJECTORY_ATOL = 1e-5      # world 2 vs world 1: the reduce adds two halves' gradients
BENCH_TIMED_EPOCHS, BENCH_TIMEOUT = 7, 600

# Ring-of-flash, phases 17-19: the hop offset in B4/B5, the ring ops, the seq-parallel
# trainer. Worlds of 2 and 4 are gloo processes time-slicing the one card.
OFFSET_SHAPE = (64, 1024, 4, 16)   # the composed trainer's shard: seq 2048 over 2 ranks
OFFSET_MASKS = ((False, 0), (True, 0), (False, 100), (True, 100), (False, 300),
                (True, 300), (False, 1000), (True, 1000))   # (causal, window)
OFFSET_TIMED = ((False, 0), (False, 300), (True, 1000))     # timed at +C and at offset 0
RING_WORLDS = (2, 4)
RING_CASES = (("ring", False, 0), ("ring", True, 0), ("ring", False, 100),
              ("ring", True, 100), ("ring", False, 300), ("ring", True, 300),
              ("zigzag", True, 0), ("zigzag", True, 300))   # (schedule, causal, window)
# ring op vs the one-process flash_attention on the full sequence, both 3xTF32 kernels on
# the card: the same pairs in other blocks, merged in f32 (the kernels' own f32 tolerance)
RING_TOL = {"out": (2e-5, 1e-5), "grad": (1e-4, 1e-4)}
RING_STEPS = 20                # phase 19: trainer steps a run, batch 64, dropout off
RING_TRAINER_WINDOW = 300      # phase 19's windowed runs: every hop with a nonzero offset
RING_TRAINERS = (              # phase 19: (label, schedule, causal, window)
    ("ring", "ring", False, 0), ("ring window", "ring", False, RING_TRAINER_WINDOW),
    ("zigzag", "zigzag", True, 0), ("zigzag window", "zigzag", True, RING_TRAINER_WINDOW))
RING_TRAJECTORY_ATOL = 1e-4    # seq=2 vs data=1: attention split over ranks and merged,
                               # 20 SGD steps; losses and every parameter


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time the card could take: bytes over the memory rate vs ops over the peak rate
    of their type (f32 by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def flash_bounds(shape, dtype: str, visible_pairs: int, ops_per_s: float | None = None,
                 live_rows: int | None = None,
                 live_keys: int | None = None) -> dict[str, tuple[float, str]]:
    """Bounds of the three flash kernels on ``[B, S, H, D]`` operands: per visible
    (query, key) pair and head, 2·D flops for each product the kernel forms — q·kᵀ and p·v
    forward (4·D); q·kᵀ, dO·vᵀ, ds·k for dq (6·D); q·kᵀ, dO·vᵀ, pᵀ·dO, dsᵀ·q for dk/dv
    (8·D) — at the least time the card can take for them: the tensor cores' bf16 rate for
    bf16, their TF32 rate taken three times (3xTF32) for f32, or ``ops_per_s`` where given
    (the CUDA cores' FFMA rate, for comparison). Bytes: the inputs the function needs read
    once — q, dO, lse and Δ at the ``live_rows`` query positions that see a key, k and v at
    the ``live_keys`` key positions that a query sees (all S of each unless given) — and
    each output written once whole (out and lse, dq, or dk and dv; lse and Δ are f32
    [B, H, S])."""
    b, s, h, d = shape
    elem = 4 if dtype == "float32" else 2
    rate = ops_per_s or (F32_3XTF32_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S)
    rows = s if live_rows is None else live_rows
    keys = s if live_keys is None else live_keys
    head = b * h * d * elem
    x, x_rows, x_keys = head * s, head * rows, head * keys
    stat, stat_rows, pairs = b * h * s * 4, b * h * rows * 4, b * h * visible_pairs
    reads = 2 * x_keys + x_rows                            # k, v; q
    reads_bwd = reads + x_rows + 2 * stat_rows             # and dO, lse, Δ
    return {"flash_fwd": bound_ms(reads + x + stat, 4 * d * pairs, rate),
            "flash_dq": bound_ms(reads_bwd + x, 6 * d * pairs, rate),
            "flash_dkv": bound_ms(reads_bwd + 2 * x, 8 * d * pairs, rate)}


def tensor_core_instructions(library: Path) -> dict[str, int]:
    """HMMA (tensor-core matrix) instructions of each kernel in a built library's SASS, as
    ``cuobjdump -sass`` lists them, by mangled kernel name. Fails without cuobjdump, which
    ships with the nvcc that built the library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        fail("cuobjdump not found beside nvcc: the tensor-core kernels' HMMA not checked")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            kernel = found.group(1)
            counts[kernel] = 0
        elif kernel and re.search(r"\bHMMA\b", line):
            counts[kernel] += 1
    return counts


def device_kernel_times(prof) -> list[tuple[float, int, str]]:
    """``(device µs, launches, name)`` of every kernel in a profiler window."""
    rows = []
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            rows.append((us, evt.count, evt.key))
    return rows


def report_window(tag: str, rows, steps: int, wall: float, ours: tuple[str, ...],
                  card: str) -> dict[str, float]:
    """Print a profiler window's busy share and kernels (top 10, then the port's own);
    return the device µs per launch of each of ``ours`` found in it."""
    busy_us = sum(r[0] for r in rows)
    print(f"{tag} profiled {steps} steps: wall {wall * 1e3:.3f} ms, "
          f"{wall / steps * 1e3:.4f} ms per step [{card}]")
    if busy_us == 0:
        print(f"{tag} the profiler recorded no device time: busy share not measured")
        return {}
    n_launch = sum(r[1] for r in rows)
    print(f"{tag} device busy {busy_us / 1e3:.3f} ms = {busy_us / 1e6 / wall:.4f} of the "
          f"window (idle {1 - busy_us / 1e6 / wall:.4f}); {n_launch} kernel launches, "
          f"{n_launch / steps:.1f} per step")
    print(f"{tag}   us/step  launches/step  share  kernel (top 10, then the port's own)")
    per_launch = {}
    for rank, (us, count, name) in enumerate(sorted(rows, reverse=True)):
        if rank < 10 or any(k in name for k in ours):
            print(f"{tag}   {us / steps:9.3f}  {count / steps:5.1f}  "
                  f"{us / busy_us:6.3f}  {name[:100]}")
        for kernel in ours:
            if kernel in name:
                per_launch[kernel] = us / count
                print(f"{tag} {kernel}: {us / count:.3f} us of device time per launch "
                      f"[{card}]")
    return per_launch


def run_fleet(tag: str, command: list[str], env: dict | None = None, n: int = 2):
    """``python <command>`` as a world of ``n`` through the port's launcher, from the root
    of the checkout; echoes its output under ``tag`` and fails unless every rank exits
    0."""
    env = {k: v for k, v in (env or os.environ).items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.train.launch", "--num-processes",
                           str(n), "--timeout", str(FLEET_TIMEOUT), "--", *command],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=FLEET_TIMEOUT + 60)
    for line in proc.stdout.splitlines():
        if line.strip():
            print(f"{tag} {line}")
    print(f"{tag} launcher exit {proc.returncode} after {time.perf_counter() - t0:.2f} s")
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        fail(f"{tag} a rank failed: the launcher exited {proc.returncode}")
    return proc.stdout


def dp_trajectory(out: str) -> None:
    """``TRAJECTORY_STEPS`` data-parallel steps of the CNN with dropout off, on the card, as
    this process's rank (a world of 1 without a launcher): each rank steps on its block of
    rows of the same global batches of ``BATCH``; rank 0 saves the parameters and the
    losses to ``out``. Run by phase 15 at world 1 in process and at world 2 through the
    launcher."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import Net
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
        data_parallel as dp, mesh,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        single, step,
    )

    xs, ys = mnist._synthesize_split(TRAJECTORY_STEPS * BATCH, 2024)
    with mesh.cluster(single.resolve_device("cuda")) as info:
        per = BATCH // info.process_count
        images = torch.from_numpy(mnist._normalize(xs)).to(info.device)
        labels = torch.from_numpy(ys.astype(np.int64)).to(info.device)
        model = Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
        state = step.create_train_state(model, torch.Generator().manual_seed(7),
                                        device=info.device)
        fn = step.make_train_step(model, learning_rate=LR, momentum=MOMENTUM,
                                  grad_reduce=dp.GradReducer(state.params),
                                  rank=info.process_index)
        losses = []
        for i in range(TRAJECTORY_STEPS):
            rows = slice(i * BATCH + info.process_index * per,
                         i * BATCH + (info.process_index + 1) * per)
            state, loss = fn(state, images[rows], labels[rows], 1)
            losses.append(loss)
        if info.is_coordinator:
            np.savez(out, losses=torch.stack(losses).cpu().numpy(), backend=info.backend,
                     **{k: p.cpu().numpy() for k, p in state.params.items()})


def ring_ops_child(out: str, shape: tuple[int, int, int, int] = COMPOSED) -> None:
    """Phase 18 in each rank of a world on the card: every ring op of ``RING_CASES`` at
    ``shape`` (f32; the composed shape by default), forward and backward, with each
    kernel's launches (and those at a nonzero hop offset) read around it and gathered from
    every rank beside the plan's; rank 0 holds the full output and gradients against the
    one-process ``flash_attention`` on the full sequence (raising beyond ``RING_TOL``) and
    saves the results to ``out`` (JSON). ``check_ring_ops`` reads them."""
    import torch

    sys.path.insert(0, str(ROOT))
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        flash_attention as fa,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
        collectives, mesh, ring_attention as ra,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import single

    with mesh.cluster(single.resolve_device("cuda")) as info:
        n, rank, dev = info.process_count, info.process_index, info.device
        rows = []
        for schedule, causal, window in RING_CASES:
            gen = torch.Generator(device=dev).manual_seed(1000 + window + causal)
            q, k, v, do = (torch.randn(*shape, generator=gen, device=dev)
                           for _ in range(4))
            if schedule == "zigzag":
                op = lambda *a: ra.zigzag_ring_flash_attention(*a, window=window)
            else:
                op = lambda *a: ra.ring_flash_attention(*a, causal=causal, window=window)

            def run():
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                out_ = op(*leaves)
                fwd = fa.launch_counts()["flash_fwd"]
                return out_, torch.autograd.grad(out_, leaves, do), fwd

            torch.cuda.synchronize()
            fa.reset_launch_counts()
            out_, grads, fwd = run()
            counts, offsets = fa.launch_counts(), fa.offset_launch_counts()
            plan = dict(seq_len=shape[1], causal=causal, window=window)
            mine = torch.tensor([
                fwd, counts["flash_fwd"] - fwd, counts["flash_dq"], counts["flash_dkv"],
                ra.planned_blocks(schedule, n, rank, **plan), *offsets.values(),
                ra.planned_blocks(schedule, n, rank, **plan, offset_only=True)])
            everyone = collectives.all_gather(mine).tolist()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            row = {"schedule": schedule, "causal": causal, "window": window,
                   "counts": everyone, "ms": step_ms}
            if rank == 0:
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                ref = fa.flash_attention(*leaves, causal=causal, window=window or None)
                ref_grads = torch.autograd.grad(ref, leaves, do)
                for name, got, want, tol in (
                        ("out", out_, ref, RING_TOL["out"]),
                        *((f"d{x}", g, w, RING_TOL["grad"])
                          for x, g, w in zip("qkv", grads, ref_grads))):
                    torch.testing.assert_close(got, want, atol=tol[0], rtol=tol[1],
                                               msg=lambda m: f"{schedule} {name}: {m}")
                    row[name] = (got - want).abs().max().item()
            rows.append(row)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"world": n, "backend": info.backend, "rows": rows}, f)


def check_ring_ops(path: str, world: int) -> dict:
    """What ``ring_ops_child`` saved at ``path`` for a gloo world of ``world``, its launch
    counts held against the plan: on every rank, each case's flash_fwd (its forward),
    flash_dq and flash_dkv launches all equal the planned blocks (at least one), no
    forward kernel runs in the backward, and the launches at a nonzero hop offset equal
    the plan's offset blocks. Raises otherwise; returns the saved results."""
    with open(path) as f:
        result = json.load(f)
    if result["world"] != world or result["backend"] != "gloo":
        raise AssertionError(f"world {world} ran {result['world']} rank(s) on "
                             f"{result['backend']}")
    for row in result["rows"]:
        for rank, counts in enumerate(row["counts"]):
            fwd, fwd_in_bwd, dq, dkv, planned, o_fwd, o_dq, o_dkv, o_planned = counts
            if not (fwd == dq == dkv == planned > 0 and fwd_in_bwd == 0
                    and o_fwd == o_dq == o_dkv == o_planned):
                raise AssertionError(
                    f"world {world} rank {rank} {row['schedule']} causal={row['causal']} "
                    f"window={row['window']}: launches fwd {fwd} (+{fwd_in_bwd} in "
                    f"backward), dq {dq}, dkv {dkv}, planned {planned}; at a hop offset "
                    f"{o_fwd}, {o_dq}, {o_dkv}, planned {o_planned}")
    return result


def composed_trajectory(out: str, *flags: str) -> None:
    """Phase 19: ``train.composed.main`` on the card for ``RING_STEPS`` steps at the
    composed widths (seq 2048, batch 64, dropout off, one eval batch of 100), from the CLI
    flags ``flags`` on top of those, as this process's rank (a world of 1 without a
    launcher). It records the segment's per-step losses and the flash launch counts read
    around ``main()``, all and at a nonzero hop offset; each rank saves its counts to
    ``out.rank<r>.json``, rank 0 also the losses, the final parameters and the epoch's
    seconds to ``out``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        flash_attention as fa,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import composed
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        ComposedConfig, parse_config,
    )

    cfg = parse_config(ComposedConfig, [
        "--flash-attention", "--seq-len", str(COMPOSED[1]), "--epochs", "1",
        "--batch-size", str(COMPOSED[0]), "--batch-size-test", "100", "--device", "cuda",
        "--results-dir", str(OUT_DIR / Path(out).stem), *flags])
    splits = (mnist._synthesize_split(RING_STEPS * cfg.batch_size, 300),
              mnist._synthesize_split(100, 301))
    datasets = tuple(mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic")
                     for x, y in splits)
    losses, build = [], composed.build_segment_fn

    def recording(config, model):
        optimizer, segment = build(config, model)

        def segment_and_record(*args):
            state, step_losses = segment(*args)
            losses.append(step_losses)
            return state, step_losses

        return optimizer, segment_and_record

    composed.build_segment_fn = recording
    try:
        fa.reset_launch_counts()
        state, history = composed.main(cfg, datasets=datasets)
        counts = {"all": fa.launch_counts(), "offset": fa.offset_launch_counts()}
    finally:
        composed.build_segment_fn = build
    rank = int(os.environ.get("RANK", "0"))
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(counts, f)
    if rank == 0:
        np.savez(out, losses=torch.cat(losses).cpu().numpy(),
                 epoch_seconds=history.epoch_seconds[0], steps=state.step,
                 **{k: p.cpu().numpy() for k, p in state.params.items()})


def main() -> None:
    if not (ROOT / PKG).is_dir():
        fail(f"the port's package {PKG}/ is not beside this script")
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
        load_mnist, mnist,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch import serving
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
        Net, TransformerClassifier, lm,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        _build, attention, flash_attention as fa, fused_kernels as fk,
        paged_attention as paged,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
        data_parallel as dp, mesh, ring_attention,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.sampler import (
        ShardedSampler,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        composed, distributed, single, smoke,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
        create_train_state, make_eval_fn, make_segment_fn, make_train_step,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        ComposedConfig, DistributedConfig, SingleProcessConfig,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1] device: {kind}; devices: {torch.cuda.device_count()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[1] nvidia-smi name, power.limit: {card}")

    # -- 2. build ----------------------------------------------------------------------
    t0 = time.perf_counter()
    builds = _build.build()                   # one nvcc per source, all started together
    print(f"[2] {len(builds)} kernel libraries built in {time.perf_counter() - t0:.2f} s of "
          f"wall time")
    for name, built in builds.items():
        print(f"[2] {name}: nvcc {built.seconds:.2f} s: {built.path.name}")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[2] ptxas: {line.strip()}")
    spills = {}
    for built in builds.values():
        entry = None
        for line in built.log.splitlines():
            found = re.search(r"Function properties for (\S+)", line)
            if found:
                entry = found.group(1)
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if found and entry:
                spills[entry] = int(found.group(1)) + int(found.group(2))
    if any(spills.values()):
        fail(f"kernels that spill: {[k for k, n in spills.items() if n]}")
    print(f"[2] {len(spills)} kernels, 0 spill bytes in each")
    hmma = tensor_core_instructions(builds["flash_attention"].path)
    for kernel, count in sorted(hmma.items()):
        print(f"[2] cuobjdump -sass: {count} HMMA instructions in {kernel}")
    for kernel in ("flash_fwd_mma_kernel", "flash_dq_mma_kernel", "flash_dkv_mma_kernel",
                   "flash_fwd_tf32_kernel", "flash_dq_tf32_kernel", "flash_dkv_tf32_kernel"):
        for d in fa.HEAD_DIMS:
            if not any(f"{kernel}ILi{d}E" in k and n for k, n in hmma.items()):
                fail(f"{kernel}<{d}> has no HMMA (tensor-core) instruction in its SASS")

    # -- 3. kernels against their plain versions ------------------------------------------
    def timed_ms(fn, iters: int = 200, warmup: int = 20) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def close(name: str, got, want, atol: float, rtol: float) -> float:
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol, msg=lambda m: f"{name}: {m}")
        return (got - want).abs().max().item() if got.numel() else 0.0

    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"nll_fwd": 0.0, "nll_bwd": 0.0, "sgd_momentum": 0.0}
    print(f"[3] nll_fwd/nll_bwd vs plain: atol {NLL_ATOL:g} + rtol {NLL_RTOL:g}")
    for rows, cols in NLL_SHAPES:
        x = torch.randn(rows, cols, generator=gen, device=dev) * 3.0
        y = torch.randint(0, cols, (rows,), generator=gen, device=dev)
        if rows >= 2:   # out-of-range labels pick nothing in both versions
            y[0], y[1] = cols, -1
        e_f = close(f"nll_fwd {rows}x{cols}", fk.nll_fwd(x, y), fk.nll_fwd_plain(x, y),
                    NLL_ATOL, NLL_RTOL)
        e_b = 0.0
        for reduction in ("mean", "sum", "none"):
            xk = x.clone().requires_grad_()
            loss = fk.nll_from_logits(xk, y, reduction)
            ct = (torch.rand(rows, generator=gen, device=dev) if reduction == "none"
                  else torch.tensor(0.75, device=dev))
            (dk,) = torch.autograd.grad(loss, xk, ct)
            want = fk._nll_reduce(fk.nll_fwd_plain(x, y), reduction)
            e_f = max(e_f, close(f"nll {reduction} {rows}x{cols}", loss.detach(), want,
                                 NLL_ATOL, NLL_RTOL))
            scale = 1.0 / rows if reduction == "mean" else 1.0
            e_b = max(e_b, close(f"dlogits {reduction} {rows}x{cols}", dk,
                                 fk.nll_bwd_plain(x, y, ct, scale), NLL_ATOL, NLL_RTOL))
        err["nll_fwd"] = max(err["nll_fwd"], e_f)
        err["nll_bwd"] = max(err["nll_bwd"], e_b)
        print(f"[3]   B={rows} C={cols}: max |fwd err| {e_f:.3e}, max |bwd err| {e_b:.3e}")

    print("[3] sgd_momentum vs plain, 3 steps, bitwise: sgd_momentum_step (one multi-tensor "
          "launch a step) over the 8 CNN leaves and one of 2^22 together, and "
          "sgd_momentum_leaf on each")
    p0, v0, sgd_g = ({f"leaf{i}": torch.randn(n, generator=gen, device=dev)
                      for i, n in enumerate(CNN_LEAVES + (1 << 22,))} for _ in range(3))
    runs = {name: ({k: t.clone() for k, t in p0.items()}, {k: t.clone() for k, t in v0.items()})
            for name in ("multi", "leaf", "plain")}
    before = fk.launch_counts()["sgd_momentum"]
    for _ in range(3):
        fk.sgd_momentum_step(*runs["multi"], sgd_g, learning_rate=LR, momentum=MOMENTUM)
    multi_launches = fk.launch_counts()["sgd_momentum"] - before
    for _ in range(3):
        for k, g in sgd_g.items():
            fk.sgd_momentum_leaf(runs["leaf"][0][k], runs["leaf"][1][k], g, learning_rate=LR,
                                 momentum=MOMENTUM)
            fk.sgd_momentum_leaf_plain(runs["plain"][0][k], runs["plain"][1][k], g,
                                       learning_rate=LR, momentum=MOMENTUM)
    torch.cuda.synchronize()
    for name in ("multi", "leaf"):
        for got, want in zip(runs[name], runs["plain"]):
            for k in sgd_g:
                e = close(f"sgd {name} {k}", got[k], want[k], 0.0, 0.0)
                err["sgd_momentum"] = max(err["sgd_momentum"], e)
    print(f"[3]   max |err| {err['sgd_momentum']:.3e}; sgd_momentum_step launches over 3 "
          f"steps: {multi_launches}")
    if multi_launches != 3:
        fail(f"sgd_momentum_step made {multi_launches} launches in 3 steps, expected 3")
    del p0, v0, sgd_g, runs

    # Times at the main path's shapes: one [64, 10] loss block, one step over the 8 leaves.
    x = torch.randn(64, 10, generator=gen, device=dev) * 3.0
    y = torch.randint(0, 10, (64,), generator=gen, device=dev)
    ct = torch.tensor(1.0, device=dev)
    leaves = {f"leaf{i}": torch.randn(n, generator=gen, device=dev) * 0.1
              for i, n in enumerate(CNN_LEAVES)}
    vel = {k: torch.zeros_like(t) for k, t in leaves.items()}
    grads = {k: torch.randn_like(t) * 0.01 for k, t in leaves.items()}
    lib_params = [t.clone() for t in leaves.values()]
    for t, g in zip(lib_params, grads.values()):
        t.grad = g.clone()
    lib_sgd = torch.optim.SGD(lib_params, lr=LR, momentum=MOMENTUM, fused=True)
    plain_step = lambda: [fk.sgd_momentum_leaf_plain(leaves[k], vel[k], grads[k],
                                                     learning_rate=LR, momentum=MOMENTUM)
                          for k in leaves]
    n_params = sum(CNN_LEAVES)
    rows, cols = x.shape
    times = {
        "nll_fwd": dict(
            ms=timed_ms(lambda: fk.nll_fwd(x, y)),
            plain_ms=timed_ms(lambda: fk.nll_fwd_plain(x, y)),
            library_ms=timed_ms(lambda: F.cross_entropy(x, y, reduction="none")),
            # read logits and labels once, write one f32 per row; ~5 ops per logit
            bound=bound_ms(rows * cols * 4 + rows * 8 + rows * 4, 5 * rows * cols)),
        "nll_bwd": dict(
            ms=timed_ms(lambda: fk.nll_bwd(x, y, ct, 1.0 / rows)),
            plain_ms=timed_ms(lambda: fk.nll_bwd_plain(x, y, ct, 1.0 / rows)),
            library_ms=None,
            # read logits, labels and ct once, write dlogits; ~8 ops per logit
            bound=bound_ms(2 * rows * cols * 4 + rows * 8 + 4, 8 * rows * cols)),
        "sgd_momentum": dict(
            ms=timed_ms(lambda: fk.sgd_momentum_step(leaves, vel, grads, learning_rate=LR,
                                                     momentum=MOMENTUM)),
            plain_ms=timed_ms(plain_step),
            library_ms=timed_ms(lib_sgd.step),
            # read p, v, g and write p, v: 20 bytes and 4 ops per parameter
            bound=bound_ms(20 * n_params, 4 * n_params)),
    }
    for name, t in times.items():
        lib_ms = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.5f}"
        print(f"[3] {name}: kernel_ms {t['ms']:.5f}, plain_ms {t['plain_ms']:.5f}, "
              f"library_ms {lib_ms}, bound_ms {t['bound'][0]:.3e} ({t['bound'][1]}) "
              f"[{card}]")

    # -- 4. trajectory ------------------------------------------------------------------
    xs, ys = mnist._synthesize_split(TRAJECTORY_STEPS * BATCH, 2024)
    images = torch.from_numpy(mnist._normalize(xs))
    labels = torch.from_numpy(ys)
    model = Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)

    def trajectory(use_pallas: bool, device: torch.device):
        state = create_train_state(model, torch.Generator().manual_seed(7), device=device)
        step = make_train_step(model, learning_rate=LR, momentum=MOMENTUM,
                               use_pallas=use_pallas)
        xd, yd = images.to(device), labels.to(device)
        for i in range(TRAJECTORY_STEPS):
            state, _ = step(state, xd[i * BATCH:(i + 1) * BATCH],
                            yd[i * BATCH:(i + 1) * BATCH], 1)
        return {k: p.cpu() for k, p in state.params.items()}

    kernels_path = trajectory(True, dev)
    plain_path = trajectory(False, dev)
    cpu_path = trajectory(False, torch.device("cpu"))
    e_traj = max(close(f"trajectory {k}", kernels_path[k], plain_path[k], TRAJECTORY_ATOL, 0.0)
                 for k in kernels_path)
    e_cpu = max(close(f"card vs cpu {k}", kernels_path[k], cpu_path[k], CROSS_DEVICE_ATOL, 0.0)
                for k in kernels_path)
    print(f"[4] {TRAJECTORY_STEPS} steps, dropout off: kernels vs plain on the card max "
          f"|dp| {e_traj:.3e} (atol {TRAJECTORY_ATOL:g}); kernels on the card vs plain on "
          f"the CPU max |dp| {e_cpu:.3e} (atol {CROSS_DEVICE_ATOL:g})")

    # -- 5. the whole slice -------------------------------------------------------------
    t0 = time.perf_counter()
    train_ds, test_ds = load_mnist(str(ROOT / "files"))
    print(f"[5] data ({train_ds.source}): {len(train_ds)} train / {len(test_ds)} test in "
          f"{time.perf_counter() - t0:.2f} s")
    config = SingleProcessConfig(n_epochs=1, use_pallas_kernels=True, device="cuda",
                                 results_dir=str(OUT_DIR))
    full_steps, tail = divmod(len(train_ds), config.batch_size_train)
    steps = full_steps + (1 if tail else 0)
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = single.main(config, datasets=(train_ds, test_ds))
    main_s = time.perf_counter() - t0
    launches = fk.launch_counts()
    print(f"[5] launches in main(): {launches} over {state.step} steps")
    if state.step != steps:
        fail(f"main() took {state.step} steps, expected {steps}")
    if not (launches["nll_fwd"] == launches["nll_bwd"] == steps):
        fail(f"nll launches {launches} != {steps} steps")
    if launches["sgd_momentum"] != steps:    # one multi-tensor launch a step, all leaves
        fail(f"sgd_momentum launches {launches['sgd_momentum']} != {steps} steps")
    test_x = torch.from_numpy(test_ds.images).to(dev)
    test_y = torch.from_numpy(test_ds.labels.astype("int64")).to(dev)
    sum_nll, correct = make_eval_fn(single.build_model("cnn"))(state.params, test_x, test_y)
    test_nll, accuracy = sum_nll.item() / len(test_ds), correct.item() / len(test_ds)
    finite = all(torch.isfinite(p).all().item() for p in state.params.values())
    epoch_s = history.epoch_seconds[0]
    print(f"[5] test NLL {history.test_losses[0]:.4f} -> {test_nll:.4f} (history "
          f"{history.test_losses[-1]:.4f}), accuracy {accuracy:.4f}, params finite: {finite}")
    print(f"[5] epoch {epoch_s:.3f} s, {steps / epoch_s:.1f} steps/s, main() {main_s:.2f} s "
          f"[{card}]")
    if not finite:
        fail("non-finite parameters after training")
    if abs(test_nll - history.test_losses[-1]) > 1e-4:
        fail(f"re-evaluated NLL {test_nll} disagrees with main()'s {history.test_losses[-1]}")
    if not test_nll < 1.0:
        fail(f"test NLL {test_nll:.4f} is not below 1.0")
    if not accuracy >= 0.85:
        fail(f"test accuracy {accuracy:.4f} is below 0.85")

    # -- 6. where a step spends its time ------------------------------------------------
    n_prof = PROFILE_STEPS * BATCH
    prof_x = torch.from_numpy(train_ds.images[:n_prof]).to(dev)
    prof_y = torch.from_numpy(train_ds.labels[:n_prof].astype("int64")).to(dev)
    plan = torch.randperm(n_prof, generator=torch.Generator().manual_seed(0)).view(
        PROFILE_STEPS, BATCH).to(dev)
    prof_model = Net()

    def steps_run(use_pallas: bool, steps: int):
        state = create_train_state(prof_model, torch.Generator().manual_seed(1), device=dev)
        fn = make_train_step(prof_model, learning_rate=LR, momentum=MOMENTUM,
                             use_pallas=use_pallas)
        for i in range(20):                     # warm-up: cuDNN picks its algorithms
            state, _ = fn(state, prof_x.index_select(0, plan[i]),
                          prof_y.index_select(0, plan[i]), 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            idx = plan[i % PROFILE_STEPS]
            state, _ = fn(state, prof_x.index_select(0, idx), prof_y.index_select(0, idx), 1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps, fn, state

    step_ms = {False: [], True: []}
    for use_pallas in (False, True, True, False):
        step_ms[use_pallas].append(steps_run(use_pallas, PROFILE_STEPS)[0] * 1e3)
    for use_pallas in (True, False):
        print(f"[6] step ms ({'kernels' if use_pallas else 'plain'}, {PROFILE_STEPS} steps "
              f"per run): {', '.join(f'{t:.4f}' for t in step_ms[use_pallas])} [{card}]")

    _, fn, state = steps_run(True, 10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_WINDOW):
            idx = plan[i]
            state, _ = fn(state, prof_x.index_select(0, idx), prof_y.index_select(0, idx), 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_window("[6]", device_kernel_times(prof), PROFILE_WINDOW, wall,
                  ("nll_fwd_kernel", "nll_bwd_kernel", "sgd_momentum_multi_kernel"), card)

    # -- 7. flash kernels against their plain versions ------------------------------------
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def flash_inputs(shape, dtype: str, seed: int):
        """randn operands; bf16 ones on the grid of 1/16 in [-4, 4]."""
        g = torch.Generator(device=dev).manual_seed(seed)
        xs = [torch.randn(*shape, generator=g, device=dev) for _ in range(4)]
        if dtype == "bfloat16":
            xs = [(x * 16).round().clamp(-64, 64) / 16 for x in xs]
        return [x.to(dtypes[dtype]) for x in xs]

    # each error goes to the name of the kernel that made it: f32 the 3xTF32 kernels, bf16
    # the bf16 tensor-core kernels
    flash_err = {"flash_fwd_tf32": 0.0, "flash_dq_tf32": 0.0, "flash_dkv_tf32": 0.0,
                 "flash_fwd_mma": 0.0, "flash_dq_mma": 0.0, "flash_dkv_mma": 0.0}
    routes = {"float32": ("flash_fwd_tf32", "flash_dq_tf32", "flash_dkv_tf32"),
              "bfloat16": ("flash_fwd_mma", "flash_dq_mma", "flash_dkv_mma")}
    print(f"[7] flash kernels vs plain, (atol, rtol) by dtype: {FLASH_TOL}")
    for shape, dtype, causal, window in FLASH_CASES:
        q, k, v, do = flash_inputs(shape, dtype, sum(shape) + window)
        tol = FLASH_TOL[dtype]
        tag = f"{list(shape)} {dtype} causal={causal} window={window}"
        out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
        out_p, lse_p = fa.flash_forward_plain(q, k, v, causal=causal, window=window)
        e_out = close(f"flash out {tag}", out.float(), out_p.float(), *tol["out"])
        e_lse = close(f"flash lse {tag}", lse, lse_p, *tol["lse"])
        dq, dk, dv = fa.flash_backward(q, k, v, out_p, lse_p, do, causal=causal,
                                       window=window)
        want = fa.flash_backward_plain(q, k, v, out_p, lse_p, do, causal=causal,
                                       window=window)
        e_dq, e_dk, e_dv = (close(f"flash {n} {tag}", got.float(), w.float(), *tol["grad"])
                            for n, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want))
        torch.cuda.synchronize()
        for name, e in zip(routes[dtype], (max(e_out, e_lse), e_dq, max(e_dk, e_dv))):
            flash_err[name] = max(flash_err[name], e)
        print(f"[7]   {tag}: max |err| out {e_out:.3e} lse {e_lse:.3e} dq {e_dq:.3e} "
              f"dk {e_dk:.3e} dv {e_dv:.3e}")

    def visible_pairs(s: int, causal: bool, window: int, q_offset: int = 0) -> int:
        return mask_counts(s, causal, window, q_offset)[0]

    def mask_counts(s: int, causal: bool, window: int, q_offset: int = 0):
        """(visible pairs, query rows that see a key, keys that a query sees) of one head."""
        vis = attention.visibility_mask(s, s, causal=causal, window=window or None,
                                        device=dev, q_offset=q_offset)
        return (int(vis.sum().item()), int(vis.any(1).sum().item()),
                int(vis.any(0).sum().item()))

    def flash_kernel_times(shape, dtype: str) -> dict[str, dict]:
        """Each flash kernel of the dtype's route at one shape (no mask), by name: its ms,
        its plain version's, SDPA's, and its bound."""
        q, k, v, do = flash_inputs(shape, dtype, 1)
        out, lse = fa.flash_forward(q, k, v)
        delta = fa.flash_delta(out, do)
        bhsd = lambda x: x.transpose(1, 2)
        sdpa = lambda: F.scaled_dot_product_attention(bhsd(q), bhsd(k), bhsd(v))
        leaves = [bhsd(x).detach().requires_grad_() for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves)
        lib_bwd = lambda: torch.autograd.grad(lib_out, leaves, bhsd(do), retain_graph=True)
        plain_bwd = lambda: fa.flash_backward_plain(q, k, v, out, lse, do)
        pairs = visible_pairs(shape[1], False, 0)
        bounds = flash_bounds(shape, dtype, pairs)
        ffma = flash_bounds(shape, dtype, pairs, ops_per_s=F32_OPS_PER_S)
        t = lambda fn: timed_ms(fn, iters=FLASH_ITERS, warmup=FLASH_WARMUP)
        plain_bwd_ms, lib_bwd_ms = t(plain_bwd), t(lib_bwd)
        fwd, dq, dkv = routes[dtype]
        return {
            fwd: dict(ms=t(lambda: fa.flash_forward(q, k, v)),
                      plain_ms=t(lambda: fa.flash_forward_plain(q, k, v)),
                      library_ms=t(sdpa), bound=bounds["flash_fwd"],
                      ffma_bound=ffma["flash_fwd"]),
            # the plain backward and SDPA's backward each compute dq, dk and dv at once:
            # their times stand beside both backward kernels
            dq: dict(ms=t(lambda: fa.flash_dq(q, k, v, do, lse, delta)),
                     plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms,
                     bound=bounds["flash_dq"], ffma_bound=ffma["flash_dq"]),
            dkv: dict(ms=t(lambda: fa.flash_dkv(q, k, v, do, lse, delta)),
                      plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms,
                      bound=bounds["flash_dkv"], ffma_bound=ffma["flash_dkv"]),
        }

    flash_ours = ("flash_fwd_tf32_kernel", "flash_dq_tf32_kernel", "flash_dkv_tf32_kernel",
                  "flash_fwd_mma_kernel", "flash_dq_mma_kernel", "flash_dkv_mma_kernel")
    flash_by_shape = {}
    for label, shape, dtype in (("composed", COMPOSED, "float32"),
                                ("large", LARGE, "bfloat16")):
        flash_by_shape[label] = flash_kernel_times(shape, dtype)
        for name, tm in flash_by_shape[label].items():
            ffma = (f"; FFMA bound_ms {tm['ffma_bound'][0]:.5f} ({tm['ffma_bound'][1]}), "
                    f"{tm['ffma_bound'][0] / tm['ms']:.4f} of it" if dtype == "float32" else "")
            print(f"[7] {name} {label} {list(shape)} {dtype}: kernel_ms {tm['ms']:.5f}, "
                  f"plain_ms {tm['plain_ms']:.5f}, library_ms {tm['library_ms']:.5f}, "
                  f"bound_ms {tm['bound'][0]:.5f} ({tm['bound'][1]}), "
                  f"{tm['bound'][0] / tm['ms']:.4f} of the bound{ffma} [{card}]")
        q, k, v, do = flash_inputs(shape, dtype, 2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                out, lse = fa.flash_forward(q, k, v)
                fa.flash_backward(q, k, v, out, lse, do)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report_window(f"[7] {label}:", device_kernel_times(prof), 3, wall, flash_ours, card)
    # the f32 kernels' rows are the composed shape's (the main path's), the bf16 kernels'
    # the large shape's
    flash_times = flash_by_shape["composed"] | flash_by_shape["large"]

    # -- 8. flash against the dense core: the card's crossover -------------------------
    b, _, h, d = COMPOSED
    print(f"[8] flash_attention vs full_attention at [{b}, S, {h}, {d}] f32, ms per call "
          f"(the JAX package's dispatch takes flash at S >= {fa.FLASH_MIN_SEQ}) [{card}]")
    for s in CROSSOVER_SEQS:
        q, k, v, do = flash_inputs((b, s, h, d), "float32", s)
        row = []
        for core in (fa.flash_attention, attention.full_attention):
            with torch.no_grad():
                fwd = timed_ms(lambda: core(q, k, v), iters=5, warmup=1)
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            both = timed_ms(lambda: torch.autograd.grad(core(*leaves), leaves, do),
                            iters=5, warmup=1)
            row.append((fwd, both))
        (f_fwd, f_both), (d_fwd, d_both) = row
        print(f"[8]   S={s}: forward flash {f_fwd:.4f} dense {d_fwd:.4f} "
              f"(flash/dense {f_fwd / d_fwd:.3f}); forward+backward flash {f_both:.4f} "
              f"dense {d_both:.4f} (flash/dense {f_both / d_both:.3f})")
        del q, k, v, do
        torch.cuda.empty_cache()

    # -- 9. the slice's path: the composed trainer through the flash kernels --------------
    cfg = ComposedConfig(mesh="data=1", flash_attention=True, seq_len=COMPOSED[1],
                         epochs=1, max_train_examples=COMPOSED_TRAIN,
                         max_test_examples=COMPOSED_TEST, device="cuda",
                         results_dir=str(OUT_DIR / "composed"))
    init_model = composed.build_classifier(cfg)
    init_state = create_train_state(init_model, torch.Generator().manual_seed(cfg.seed),
                                    device=dev)
    sum_nll, _ = make_eval_fn(init_model, batch_size=cfg.batch_size_test)(
        init_state.params, torch.from_numpy(test_ds.images[:COMPOSED_TEST]).to(dev),
        torch.from_numpy(test_ds.labels[:COMPOSED_TEST].astype("int64")).to(dev))
    print(f"[9] composed trainer: mesh {cfg.mesh}, seq {cfg.seq_len}, flash, "
          f"{COMPOSED_TRAIN} train / {COMPOSED_TEST} test examples, batch {cfg.batch_size}, "
          f"lr {cfg.learning_rate}, momentum {cfg.momentum}, seed {cfg.seed}")
    val_at_init = sum_nll.item() / COMPOSED_TEST
    del init_state
    steps = COMPOSED_TRAIN // cfg.batch_size
    eval_batches = COMPOSED_TEST // cfg.batch_size_test
    layers = init_model.num_layers
    expected = {"flash_fwd": layers * (steps + eval_batches), "flash_dq": layers * steps,
                "flash_dkv": layers * steps}
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    c_state, c_hist = composed.main(cfg, datasets=(train_ds, test_ds))
    c_main_s = time.perf_counter() - t0
    flash_launches = fa.launch_counts()
    print(f"[9] launches in composed.main(): {flash_launches} over {c_state.step} steps and "
          f"{eval_batches} eval batch(es); predicted {expected}")
    if flash_launches != expected:
        fail(f"flash launches {flash_launches} != predicted {expected}")
    val_loss, epoch_s = c_hist.test_losses[0], c_hist.epoch_seconds[0]
    finite = all(torch.isfinite(p).all().item() for p in c_state.params.values())
    print(f"[9] val loss {val_at_init:.4f} at init -> {val_loss:.4f} after {steps} steps "
          f"(bar: below its value at init); train loss {c_hist.train_losses[0]:.4f}; "
          f"params finite: {finite}")
    print(f"[9] epoch {epoch_s:.3f} s, {steps / epoch_s:.3f} steps/s, "
          f"{epoch_s / steps * 1e3:.3f} ms per step; main() {c_main_s:.2f} s [{card}]")
    if not finite:
        fail("non-finite parameters after the composed epoch")
    if not val_loss < val_at_init:
        fail(f"val loss {val_loss:.4f} is not below its value at init {val_at_init:.4f}")
    # where the trainer's step spends its time: the optimizer and segment function that
    # main() trains with (composed.build_segment_fn), over the first steps of the next
    # epoch's plan, one warm-up step and then five under the profiler
    _, c_segment = composed.build_segment_fn(cfg, init_model)
    c_x = torch.from_numpy(train_ds.images[:COMPOSED_TRAIN]).to(dev)
    c_y = torch.from_numpy(train_ds.labels[:COMPOSED_TRAIN].astype("int64")).to(dev)
    c_plan = torch.from_numpy(composed.epoch_plan(cfg.seed, 1, COMPOSED_TRAIN, 6,
                                                  cfg.batch_size)).to(dev)
    c_state, _ = c_segment(c_state, c_x, c_y, c_plan[:1], cfg.seed + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        c_state, _ = c_segment(c_state, c_x, c_y, c_plan[1:], cfg.seed + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_window("[9]", device_kernel_times(prof), 5, wall, flash_ours, card)
    del c_state, c_x, c_y
    torch.cuda.empty_cache()

    # -- 10. the large bench widths in bf16 --------------------------------------------
    lb, ls, lh, ld = LARGE
    large = TransformerClassifier(seq_len=ls, embed_dim=lh * ld, num_layers=LARGE_LAYERS,
                                  num_heads=lh, dropout_rate=0.0, dtype=torch.bfloat16,
                                  attention_fn=fa.dispatch_attention, token_features=16)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.normal(size=(lb, ls, 16)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(np.arange(lb) % 10).to(dev)
    l_state = create_train_state(large, torch.Generator().manual_seed(1), device=dev)
    l_step = make_train_step(large, learning_rate=0.01, momentum=0.5)
    torch.cuda.reset_peak_memory_stats()
    l_state, l_loss = l_step(l_state, tokens, labels, 2)      # warm-up
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(LARGE_STEPS):
        l_state, l_loss = l_step(l_state, tokens, labels, 2)
    torch.cuda.synchronize()
    l_step_ms = (time.perf_counter() - t0) / LARGE_STEPS * 1e3
    large_launches = fa.launch_counts()
    loss_value = l_loss.item()
    print(f"[10] large widths {list(LARGE)} bf16, {LARGE_LAYERS} layers: step "
          f"{l_step_ms:.3f} ms over {LARGE_STEPS} steps, loss {loss_value:.4f}, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    print(f"[10] flash launches over the {LARGE_STEPS} timed steps: {large_launches} "
          f"(bf16: the tensor-core kernels'); predicted "
          f"{LARGE_LAYERS * LARGE_STEPS} each")
    if set(large_launches.values()) != {LARGE_LAYERS * LARGE_STEPS}:
        fail(f"flash launches {large_launches} != {LARGE_LAYERS} x {LARGE_STEPS} each")
    if not np.isfinite(loss_value):
        fail(f"non-finite loss {loss_value} at the large widths")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            l_state, l_loss = l_step(l_state, tokens, labels, 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_window("[10]", device_kernel_times(prof), 2, wall, flash_ours, card)
    del l_state, large
    torch.cuda.empty_cache()

    # -- 11. the paged-decode kernel against its plain version ----------------------------
    s_len, ps = SERVE_LM["seq_len"], SERVE_PAGE
    p_max = lm.pages_per_slot(s_len, ps)
    n_pages = SERVE_SLOTS * p_max + 1            # the engine's default pool: 105 pages

    def quantize_rows(x, dtype):
        """Symmetric per-row codes over the last axis and their f32 scales, the JAX
        package's ``ops/quant.py`` rule (scale = amax / qmax; int8 rounds and clips)."""
        qmax = 127.0 if dtype == torch.int8 else 448.0
        amax = x.abs().amax(dim=-1)
        scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
        codes = x / scale[..., None]
        if dtype == torch.int8:
            codes = codes.round().clamp(-qmax, qmax)
        return codes.to(dtype), scale

    def paged_case(g, r, d, dtype, t_kind, seed):
        """A random pool, a shuffled full-context table per slot (the engine's
        reservation at 105 pages), q and t."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        k = torch.randn(n_pages, ps, g, d, generator=gen, device=dev)
        v = torch.randn(n_pages, ps, g, d, generator=gen, device=dev)
        scales = {}
        if dtype in (torch.int8, torch.float8_e4m3fn):
            (k, ks), (v, vs) = quantize_rows(k, dtype), quantize_rows(v, dtype)
            scales = dict(k_scale=ks, v_scale=vs)
        else:
            k, v = k.to(dtype), v.to(dtype)
        perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
        table = perm[:SERVE_SLOTS * p_max].reshape(SERVE_SLOTS, p_max).to(torch.int32)
        q = torch.randn(SERVE_SLOTS, g, r, d, generator=gen, device=dev)
        t = torch.randint(0, s_len, (SERVE_SLOTS,), generator=torch.Generator()
                          .manual_seed(seed), dtype=torch.int32)
        if t_kind == "zero":
            t.zero_()
        elif t_kind == "last":                   # every chunk of every slot live
            t.fill_(s_len - 1)
        elif t_kind == "spread":                 # slots end in different chunks
            t = torch.arange(SERVE_SLOTS, dtype=torch.int32) * (s_len // SERVE_SLOTS) + 17
        if t_kind in ("random", "spread"):       # the edges ride along: t = 0, the last
            t[0], t[1], t[2] = 0, s_len - 1, s_len   # position, a finished slot
        return q, k, v, table.to(dev), t.to(dev), scales

    def visible_rows(t, window: int) -> int:
        last = t.clamp(max=s_len - 1)
        first = (t - window + 1).clamp(min=0) if window else torch.zeros_like(t)
        return int((last - first + 1).clamp(min=0).sum().item())

    def paged_bound(q, k, t, window, scales):
        """Least time: the visible K/V rows (and their scales), q, out, table and t read or
        written once, over the memory rate; 4·D flops per visible row and query row (q·k
        and p·v) over the f32 rate."""
        b, g, r, d = q.shape
        rows = visible_rows(t, window)
        nbytes = (2 * rows * g * d * k.element_size() + (2 * rows * g * 4 if scales else 0)
                  + 2 * b * g * r * d * 4 + b * p_max * 4 + b * 4)
        return bound_ms(nbytes, 4 * d * r * g * rows)

    def sdpa_on_view(q, k, v, table, t, window, scales):
        """``F.scaled_dot_product_attention`` on the already-gathered f32 view with the
        visibility mask, K/V heads repeated over their query rows (a yardstick only)."""
        b, g, r, d = q.shape
        view = lambda pool, sc: (paged.gather_view(pool, table, s_len).float()
                                 * (paged.gather_view(sc, table, s_len)[..., None]
                                    if sc is not None else 1.0))
        kv = [view(pool, scales.get(name)).repeat_interleave(r, dim=2).transpose(1, 2)
              .contiguous() for pool, name in ((k, "k_scale"), (v, "v_scale"))]
        pos = torch.arange(s_len, device=dev)[None]
        mask = pos <= t.long()[:, None]
        if window:
            mask &= t.long()[:, None] - pos < window
        qh = q.reshape(b, g * r, 1, d)
        return lambda: F.scaled_dot_product_attention(qh, kv[0], kv[1],
                                                      attn_mask=mask[:, None, None, :])

    paged_err, paged_times = 0.0, None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[11] paged_attend vs plain (atol {PAGED_ATOL:g}, rtol {PAGED_RTOL:g}); pool "
          f"[{n_pages}, {ps}, G, D], table [{SERVE_SLOTS}, {p_max}]; {sms} SMs [{card}]")
    for label, g, r, d, dtype_name, window, t_kind in PAGED_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v, table, t, scales = paged_case(g, r, d, dtype, t_kind, g * 100 + r * 10 + d)
        out = paged.paged_attend(q, k, v, table, t, window=window, seq_len=s_len, **scales)
        want = paged.paged_attend_reference(q, k, v, table, t, seq_len=s_len, window=window,
                                            **scales)
        torch.cuda.synchronize()
        e = close(f"paged_attend {label}", out, want, PAGED_ATOL, PAGED_RTOL)
        paged_err = max(paged_err, e)
        t_kernel = lambda: paged.paged_attend(q, k, v, table, t, window=window, seq_len=s_len,
                                              **scales)
        t_plain = lambda: paged.paged_attend_reference(q, k, v, table, t, seq_len=s_len,
                                                       window=window, **scales)
        tm = dict(ms=timed_ms(t_kernel, PAGED_ITERS, PAGED_WARMUP),
                  plain_ms=timed_ms(t_plain, PAGED_ITERS, PAGED_WARMUP),
                  library_ms=timed_ms(sdpa_on_view(q, k, v, table, t, window, scales),
                                      PAGED_ITERS, PAGED_WARMUP),
                  bound=paged_bound(q, k, t, window, scales))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                t_kernel()
            torch.cuda.synchronize()
        b6_us = [(re.search(r"paged_attend\w*", name).group(0), us)
                 for us, _, name in device_kernel_times(prof) if "paged_attend" in name]
        us = (f"{sum(u for _, u in b6_us) / 20:.3f} ("
              + " + ".join(f"{u / 20:.3f} {n}" for n, u in b6_us) + ")"
              if b6_us else "not measured")
        row_blk, n_split, split_tiles = paged.split_plan(SERVE_SLOTS, g, r, d, s_len, sms)
        print(f"[11]   {label} q {list(q.shape)} {dtype_name} window={window} "
              f"visible rows {visible_rows(t, window)}, grid "
              f"{SERVE_SLOTS * g * -(-r // row_blk)} "
              f"row blocks x {n_split} chunks of {split_tiles} tiles: max |err| {e:.3e}; "
              f"kernel_ms {tm['ms']:.5f}, plain_ms {tm['plain_ms']:.5f}, device us/call {us}, "
              f"bound_ms {tm['bound'][0]:.3e} ({tm['bound'][1]}), {tm['bound'][0] / tm['ms']:.4f} "
              f"of the bound, sdpa_ms {tm['library_ms']:.5f} [{card}]")
        if label == "serving":
            paged_times = {"paged_attend": tm}
        del q, k, v, table, t, scales
    torch.cuda.empty_cache()

    # -- 12. the slice: the serving engine through B6 -------------------------------------
    lm_model = lm.TransformerLM(**SERVE_LM)
    lm_params = lm_model.init(torch.Generator().manual_seed(0))
    lm_params_dev = {name: p.to(dev) for name, p in lm_params.items()}
    vocab = SERVE_LM["vocab_size"]

    def request_mix(ids, n, max_new, seed):
        """``n`` greedy requests cut from image token streams: prompt lengths 0..S/2 and
        ``max_new_tokens`` 1..``max_new``, drawn from ``seed``."""
        rng = np.random.default_rng(seed)
        plens = rng.integers(0, s_len // 2 + 1, size=n)
        news = rng.integers(1, max_new + 1, size=n)
        return [serving.Request(prompt=ids[i, :plens[i]].copy(), max_new_tokens=int(news[i]),
                                request_id=i) for i in range(n)]

    def serve(model, params, layout, requests, warmup):
        """A warmed-up engine's ``run`` over ``requests``, with the B6 count set to 0 just
        before it and read just after; (engine, streams, wall s, B6 launches)."""
        engine = serving.ContinuousBatchingEngine(model, params, num_slots=SERVE_SLOTS,
                                                  kv_layout=layout, page_size=SERVE_PAGE,
                                                  device=dev)
        engine.run(warmup)
        engine.reset_stats()
        torch.cuda.synchronize()
        paged.reset_launch_counts()
        t0 = time.perf_counter()
        done = engine.run(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (engine, {c.request.request_id: c.tokens.tolist() for c in done}, wall,
                paged.launch_counts()["paged_attend"])

    def plain_gap(model, params_dev, stream, fill: int, p: int) -> float:
        """The plain (contiguous) path's top-2 log-prob gap at position ``p`` of
        ``stream``, BOS masked: replay the slot alone — its prompt in the engine's chunk
        plan, then one decode step per position up to ``p``."""
        cache = lm.init_cache(model, 1, device=dev)
        prompt = torch.zeros((1, model.seq_len), dtype=torch.int32, device=dev)
        prompt[0, :fill] = torch.as_tensor(stream[:fill], device=dev)
        for start, length, size in serving.greedy_chunk_plan(lm.PREFILL_CHUNK_SIZES, 0, fill):
            lm.prefill_chunk(model, params_dev, cache, prompt, 0, start, length, start == 0,
                             chunk=size)
        with torch.no_grad():
            for pos in range(fill, p + 1):
                ids = stream[pos - 1] if pos else model.vocab_size - 1
                _, lp = lm.decode_step_slots(
                    model, params_dev, cache, torch.tensor([ids], device=dev),
                    torch.tensor([pos], dtype=torch.int32, device=dev))
        lp = lp[0].clone()
        lp[model.vocab_size - 1] = float("-inf")
        top2 = lp.topk(2).values
        return (top2[0] - top2[1]).item()

    def compare_streams(tag, model, params_dev, requests, kernel_streams,
                        plain_streams) -> int:
        """Paged (kernel) streams against contiguous (plain) ones: equal, or diverging at a
        true tie (the plain path's top-2 log-prob gap there below ``TIE_GAP``). Returns
        the number of ties."""
        ties = 0
        for req in requests:
            rid = req.request_id
            got, plain = kernel_streams[rid], plain_streams[rid]
            if got == plain:
                continue
            p = next((i for i, (a, b) in enumerate(zip(got, plain)) if a != b),
                     min(len(got), len(plain)))
            gap = (plain_gap(model, params_dev, plain, len(req.prompt), p)
                   if p < min(len(got), len(plain)) else float("inf"))
            print(f"{tag} request {rid}: streams differ first at position {p} (kernel "
                  f"{got[p] if p < len(got) else None}, plain "
                  f"{plain[p] if p < len(plain) else None}); plain top-2 gap {gap:.3e}")
            if not gap < TIE_GAP:
                fail(f"{tag} request {rid}: kernel and plain streams differ at position {p} "
                     f"with a top-2 gap of {gap:.3e} (not a tie below {TIE_GAP:g})")
            ties += 1
        return ties

    test_ids = lm.tokenize_images_to_ids(torch.from_numpy(
        test_ds.images[:max(SERVE_REQUESTS, SERVE_SLOTS)])).numpy()
    warmup = request_mix(test_ids, 2, 8, 99)
    requests = request_mix(test_ids, SERVE_REQUESTS, SERVE_MAX_NEW, 0)
    print(f"[12] engine: TransformerLM {SERVE_LM}, {SERVE_SLOTS} slots, pages of {ps} "
          f"(P_max {p_max}), chunks {lm.PREFILL_CHUNK_SIZES}, budget 1, f32; "
          f"{SERVE_REQUESTS} greedy requests, prompts {min(len(r.prompt) for r in requests)}"
          f"-{max(len(r.prompt) for r in requests)}, max_new_tokens "
          f"{min(r.max_new_tokens for r in requests)}-{max(r.max_new_tokens for r in requests)}")
    plain_engine, plain_streams, plain_wall, plain_launches = serve(
        lm_model, lm_params, "contiguous", requests, warmup)
    kernel_engine, kernel_streams, kernel_wall, paged_launches = serve(
        lm_model, lm_params, "paged", requests, warmup)
    pstats = kernel_engine.page_stats()
    for tag, engine, wall in (("paged (B6)", kernel_engine, kernel_wall),
                              ("contiguous (plain)", plain_engine, plain_wall)):
        print(f"[12] {tag}: {engine.steps} decode steps, {engine.generated_tokens} generated "
              f"tokens, {engine.prefill_invocations} prefill chunks, run {wall:.4f} s, "
              f"{engine.generated_tokens / wall:.1f} generated tokens/s, "
              f"{wall / engine.steps * 1e3:.4f} ms per decode step (prefill included), "
              f"occupancy {engine.slot_occupancy:.4f} [{card}]")
    print(f"[12] B6 launches in the paged run: {paged_launches} (layers x steps = "
          f"{lm_model.num_layers} x {kernel_engine.steps}); in the contiguous run: "
          f"{plain_launches}; pool {pstats['num_pages']} pages, peak in use "
          f"{pstats['peak_in_use']}")
    if paged_launches != lm_model.num_layers * kernel_engine.steps or paged_launches == 0:
        fail(f"B6 launches {paged_launches} != {lm_model.num_layers} x {kernel_engine.steps}")
    if plain_launches:
        fail(f"the contiguous run launched B6 {plain_launches} times")
    if sorted(kernel_streams) != list(range(SERVE_REQUESTS)):
        fail(f"the paged run completed {len(kernel_streams)} of {SERVE_REQUESTS} requests")
    for req in requests:
        stream = kernel_streams[req.request_id]
        want_len = min(len(req.prompt) + req.max_new_tokens, s_len)
        if (len(stream) != want_len or stream[:len(req.prompt)] != req.prompt.tolist()
                or not all(0 <= x < vocab - 1 for x in stream[len(req.prompt):])):
            fail(f"request {req.request_id}: stream of length {len(stream)} (want "
                 f"{want_len}) or its prompt or its tokens are wrong")
    ties = compare_streams("[12]", lm_model, lm_params_dev, requests, kernel_streams,
                           plain_streams)
    same = sum(kernel_streams[i] == plain_streams[i] for i in plain_streams)
    print(f"[12] paged (kernel) vs contiguous (plain) streams: {same}/{SERVE_REQUESTS} "
          f"equal, {ties} diverging at a true tie (gap < {TIE_GAP:g})")
    # where a decode step spends its time: 8 slots decoding, prompts prefilled
    engine = serving.ContinuousBatchingEngine(lm_model, lm_params, num_slots=SERVE_SLOTS,
                                              kv_layout="paged", page_size=SERVE_PAGE,
                                              device=dev)
    engine.admit_many([(i, serving.Request(prompt=test_ids[i, :200].copy(),
                                           max_new_tokens=400, request_id=i))
                       for i in range(SERVE_SLOTS)])
    while engine.num_prefilling:
        engine.step()
    engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_WINDOW):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows_12 = device_kernel_times(prof)
    report_window("[12] decode window:", rows_12, DECODE_WINDOW, wall,
                  ("paged_attend_kernel", "paged_attend_combine_kernel"), card)
    b6_us = sum(us for us, _, name in rows_12 if "paged_attend" in name)
    print(f"[12] decode window: B6 {b6_us / (lm_model.num_layers * DECODE_WINDOW):.3f} us of "
          f"device time per call (both kernels; {lm_model.num_layers} calls a step) [{card}]")
    del engine, plain_engine, kernel_engine
    torch.cuda.empty_cache()

    # -- 13. bench_lm.py's widths in bf16 ---------------------------------------------------
    big = lm.TransformerLM(**BENCH_LM, dtype=torch.bfloat16)
    big_params = {name: p.to(torch.bfloat16)
                  for name, p in big.init(torch.Generator().manual_seed(1)).items()}
    big_requests = request_mix(test_ids, BENCH_LM_REQUESTS, BENCH_LM_MAX_NEW, 1)
    big_plain, big_plain_streams, _, _ = serve(big, big_params, "contiguous", big_requests,
                                               warmup)
    big_kernel, big_streams, big_wall, big_launches = serve(big, big_params, "paged",
                                                            big_requests, warmup)
    print(f"[13] bench_lm widths {BENCH_LM} bf16 weights and KV pool: "
          f"{big_kernel.steps} decode steps, {big_kernel.generated_tokens} tokens in "
          f"{big_wall:.4f} s ({big_kernel.generated_tokens / big_wall:.1f} tokens/s, "
          f"{big_wall / big_kernel.steps * 1e3:.4f} ms per step); B6 launches {big_launches} "
          f"(layers x steps = {big.num_layers} x {big_kernel.steps}) [{card}]")
    if big_launches != big.num_layers * big_kernel.steps or big_launches == 0:
        fail(f"[13] B6 launches {big_launches} != {big.num_layers} x {big_kernel.steps}")
    if sorted(big_streams) != list(range(BENCH_LM_REQUESTS)) or not all(
            0 <= x < vocab for s in big_streams.values() for x in s):
        fail("[13] the bf16 engine's streams are incomplete or out of the vocabulary")
    big_ties = compare_streams("[13]", big, {k: p.to(dev) for k, p in big_params.items()},
                               big_requests, big_streams, big_plain_streams)
    big_same = sum(big_streams[i] == big_plain_streams[i] for i in big_plain_streams)
    print(f"[13] paged (kernel) vs contiguous (plain) streams: {big_same}/"
          f"{BENCH_LM_REQUESTS} equal, {big_ties} diverging at a true tie")
    del big_plain, big_kernel
    torch.cuda.empty_cache()

    # -- 14. rendezvous -----------------------------------------------------------------
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        ring_ok = smoke.main("cuda")                  # world 1, this process
    for line in said.getvalue().splitlines():
        print(f"[14] world 1: {line}")
    if not ring_ok or "backend nccl" not in said.getvalue():
        fail("[14] the world-1 smoke failed or did not run on NCCL")
    w2_smoke = run_fleet("[14] world 2:", ["-m", f"{PKG}.train.smoke"])
    if not ("backend gloo" in w2_smoke and "Device 1 has data 0.0" in w2_smoke
            and "OK — rendezvous + ring p2p verified" in w2_smoke):
        fail("[14] the world-2 smoke did not verify its ring on gloo")

    # -- 15. the data-parallel slice ------------------------------------------------------
    dconfig = DistributedConfig(epochs=1, device="cuda",
                                results_dir=str(OUT_DIR / "distributed"))
    full_steps = len(train_ds) // dconfig.global_batch_size
    all_counts = lambda: fk.launch_counts() | fa.launch_counts() | paged.launch_counts()
    with mesh.cluster(dev) as info:                   # world 1; main() joins this group
        print(f"[15] world {info.process_count}, backend {info.backend}, {info.device}")
        if info.backend != "nccl":
            fail(f"[15] world 1 on the card ran {info.backend}, not nccl")
        fk.reset_launch_counts()
        fa.reset_launch_counts()
        paged.reset_launch_counts()
        t0 = time.perf_counter()
        d_state, d_hist = distributed.main(dconfig, datasets=(train_ds, test_ds))
        d_main_s = time.perf_counter() - t0
        d_counts = all_counts()
        print(f"[15] kernel counts in distributed.main(): {d_counts} (the data-parallel "
              f"path runs no kernel of the port's)")
        if any(d_counts.values()):
            fail(f"[15] the data-parallel path launched a kernel: {d_counts}")
        if d_state.step != full_steps:
            fail(f"[15] main() took {d_state.step} steps, expected {full_steps}")
        sum_nll, correct = make_eval_fn(Net())(d_state.params, test_x, test_y)
        d_nll, d_acc = sum_nll.item() / len(test_ds), correct.item() / len(test_ds)
        d_epoch_s = d_hist.epoch_seconds[0]
        print(f"[15] {d_state.step} steps at global batch {dconfig.global_batch_size}: test "
              f"NLL {d_nll:.4f} (history {d_hist.test_losses[-1]:.4f}), accuracy "
              f"{d_acc:.4f}")
        print(f"[15] epoch {d_epoch_s:.3f} s, {d_state.step / d_epoch_s:.1f} steps/s, "
              f"main() {d_main_s:.2f} s (world 1, nccl) [{card}]")
        if not all(torch.isfinite(p).all().item() for p in d_state.params.values()):
            fail("[15] non-finite parameters after the data-parallel epoch")
        if abs(d_nll - d_hist.test_losses[-1]) > 1e-4:
            fail(f"[15] re-evaluated NLL {d_nll} disagrees with main()'s")
        if not (d_nll < 1.0 and d_acc >= 0.85):
            fail(f"[15] test NLL {d_nll:.4f} / accuracy {d_acc:.4f} miss the bar "
                 f"(< 1.0, >= 0.85)")
        # where the data-parallel step spends its time: the step main() trains with, over
        # the next epoch's plan, 10 warm-up steps and then a window under the profiler
        d_model = Net()
        reducer = dp.GradReducer(d_state.params)
        d_segment = make_segment_fn(make_train_step(
            d_model, learning_rate=dconfig.learning_rate, momentum=dconfig.momentum,
            grad_reduce=reducer))
        d_x = torch.from_numpy(train_ds.images).to(dev)
        d_y = torch.from_numpy(train_ds.labels.astype("int64")).to(dev)
        d_plan = torch.from_numpy(distributed.epoch_index_plan(
            [ShardedSampler(len(train_ds), seed=dconfig.sampler_seed)], 1,
            dconfig.global_batch_size)).to(dev)
        d_state, _ = d_segment(d_state, d_x, d_y, d_plan[:10], dconfig.seed)
        # the all-reduce's cost end to end: the same step without and with the reducer,
        # in turns (plain, data-parallel, data-parallel, plain), host clock and a sync
        plain_segment = make_segment_fn(make_train_step(
            d_model, learning_rate=dconfig.learning_rate, momentum=dconfig.momentum))
        dp_ms = {"plain": [], "data-parallel": []}
        for name in ("plain", "data-parallel", "data-parallel", "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d_state, _ = (plain_segment if name == "plain" else d_segment)(
                d_state, d_x, d_y, d_plan[10:10 + DP_PROFILE_STEPS], dconfig.seed)
            torch.cuda.synchronize()
            dp_ms[name].append((time.perf_counter() - t0) / DP_PROFILE_STEPS * 1e3)
        print(f"[15] step ms in turns ({DP_PROFILE_STEPS} steps a run): plain "
              f"{', '.join(f'{t:.4f}' for t in dp_ms['plain'])}; data-parallel (world 1, "
              f"{info.backend}) {', '.join(f'{t:.4f}' for t in dp_ms['data-parallel'])} "
              f"[{card}]")
        torch.cuda.synchronize()
        calls_before = reducer.calls
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            d_state, _ = d_segment(d_state, d_x, d_y, d_plan[10:10 + DP_PROFILE_STEPS],
                                   dconfig.seed)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        d_rows = device_kernel_times(prof)
        report_window("[15]", d_rows, DP_PROFILE_STEPS, wall, ("nccl",), card)
        if reducer.calls - calls_before != DP_PROFILE_STEPS:
            fail(f"[15] {reducer.calls - calls_before} reduces in {DP_PROFILE_STEPS} steps")
        # the reducer alone on the step's gradients: bucket copies, all-reduce, division
        grads = {k: torch.randn_like(p) for k, p in d_state.params.items()}
        loss = torch.zeros((), device=dev)
        reducer(grads, loss)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_PROFILE_STEPS):
            reducer(grads, loss)
        torch.cuda.synchronize()
        r_host_us = (time.perf_counter() - t0) / DP_PROFILE_STEPS * 1e6
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(DP_PROFILE_STEPS):
                reducer(grads, loss)
            torch.cuda.synchronize()
            r_wall = time.perf_counter() - t0
        r_rows = device_kernel_times(prof)
        r_us = sum(r[0] for r in r_rows) / DP_PROFILE_STEPS
        r_launch = sum(r[1] for r in r_rows) / DP_PROFILE_STEPS
        nccl_us = sum(r[0] for r in r_rows if "nccl" in r[2].lower()) / DP_PROFILE_STEPS
        print(f"[15] all-reduce (GradReducer over {reducer.numel + 1} floats, one "
              f"{info.backend} all-reduce a step): {r_us:.3f} us of device time per step in "
              f"{r_launch:.1f} launches ({nccl_us:.3f} us in NCCL kernels); wall time per "
              f"call {r_host_us:.1f} us ({r_wall / DP_PROFILE_STEPS * 1e6:.1f} us under the "
              f"profiler) [{card}]")
        for us, count, name in sorted(r_rows, reverse=True):
            print(f"[15]   reducer kernel {us / DP_PROFILE_STEPS:8.3f} us/step "
                  f"{count / DP_PROFILE_STEPS:4.1f}/step  {name[:90]}")
    del d_x, d_y, grads

    w2_dir = OUT_DIR / "distributed_w2"
    w2_out = run_fleet("[15] world 2:", [
        "-m", f"{PKG}.train.distributed", "--device", "cuda", "--epochs", "2",
        "--max-train-examples", str(DP_W2_TRAIN), "--max-test-examples", str(DP_W2_TEST),
        "--results-dir", str(w2_dir)])
    w2_val = [json.loads(l)["loss"] for l in open(w2_dir / "metrics.jsonl")
              if json.loads(l)["kind"] == "test"]
    print(f"[15] world 2 (gloo, two ranks time-slicing one card: a correctness run, not a "
          f"scaling point): val loss by epoch {w2_val}; replicas in sync at atol 0 "
          f"(main()'s closing check)")
    if "Collective backend: gloo (device cuda, 2 rank(s))" not in w2_out:
        fail("[15] the world-2 run did not run gloo on cuda")
    if not (len(w2_val) == 2 and all(map(math.isfinite, w2_val)) and w2_val[1] < w2_val[0]):
        fail(f"[15] the world-2 val loss did not fall: {w2_val}")

    traj = {1: OUT_DIR / "dp_trajectory_w1.npz", 2: OUT_DIR / "dp_trajectory_w2.npz"}
    dp_trajectory(str(traj[1]))
    run_fleet("[15] trajectory world 2:", [
        "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
              f"chip_smoke.dp_trajectory({str(traj[2])!r})"])
    w1, w2 = np.load(traj[1]), np.load(traj[2])
    e_loss = close("dp trajectory loss", torch.from_numpy(w2["losses"]),
                   torch.from_numpy(w1["losses"]), DP_TRAJECTORY_ATOL, 0.0)
    e_par = max(close(f"dp trajectory {k}", torch.from_numpy(w2[k]), torch.from_numpy(w1[k]),
                      DP_TRAJECTORY_ATOL, 0.0)
                for k in d_state.params)
    print(f"[15] {TRAJECTORY_STEPS} steps, dropout off, world 2 ({w2['backend']}) vs world 1 "
          f"({w1['backend']}): max |dloss| {e_loss:.3e}, max |dp| {e_par:.3e} (atol "
          f"{DP_TRAJECTORY_ATOL:g})")
    del d_state
    torch.cuda.empty_cache()

    # -- 16. the epoch bench ---------------------------------------------------------------
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                        "BENCH_MAX_TRAIN_EXAMPLES")}
    env.update(PYTHONPATH=str(ROOT), BENCH_TIMED_EPOCHS=str(BENCH_TIMED_EPOCHS))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.bench"], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=BENCH_TIMEOUT)
    bench_s = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        fail(f"[16] the bench exited {proc.returncode}")
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    if len(lines) != 1:
        fail(f"[16] the bench printed {len(lines)} JSON lines, not one")
    print(f"[16] bench ({bench_s:.1f} s, world 1) [{card}]: {lines[0]}")
    result = json.loads(lines[0])
    want = {"platform": "gpu", "devices": 1, "steps_per_epoch": full_steps,
            "collective_backend": "nccl", "epochs_trained": 1 + BENCH_TIMED_EPOCHS}
    got = {k: result.get(k) for k in want}
    if got != want or len(result.get("epoch_seconds_all", [])) != BENCH_TIMED_EPOCHS:
        fail(f"[16] the bench line has {got} (want {want}) and "
             f"{len(result.get('epoch_seconds_all', []))} timed epochs")
    if not result["test_accuracy_after_run"] >= 0.85:
        fail(f"[16] test accuracy {result['test_accuracy_after_run']} is below 0.85")
    print(f"[16] median epoch {result['value']} s, min {result['min_epoch_seconds']} s, "
          f"samples {result['epoch_seconds_all']}, vs_baseline {result['vs_baseline']}, "
          f"test accuracy {result['test_accuracy_after_run']} [{card}]")

    # -- 17. the hop offset in B4/B5: each kernel against its plain version -------------
    c_len = OFFSET_SHAPE[1]
    offsets = (-2 * c_len, -c_len, c_len, 2 * c_len)
    offset_err = {name: 0.0 for name in flash_err}
    dead_cases = 0
    print(f"[17] the offset kernels vs plain at {list(OFFSET_SHAPE)} (the composed shard at "
          f"seq 2048 over 2 ranks), q_offset in {offsets} (C = {c_len}), both routes, "
          f"(atol, rtol) by dtype as [7]; dq and dk/dv from the full row's lse and delta "
          f"(this hop merged with the diagonal block)")
    for dtype in ("float32", "bfloat16"):
        tol = FLASH_TOL[dtype]
        for causal, window in OFFSET_MASKS:
            q, k0, v0, do = flash_inputs(OFFSET_SHAPE, dtype, 17 + window + causal)
            _, k1, v1, _ = flash_inputs(OFFSET_SHAPE, dtype, 18 + window + causal)
            out0, lse0 = fa.flash_forward_plain(q, k0, v0, causal=causal, window=window)
            worst = [0.0] * 5
            for off in offsets:
                tag = f"{dtype} q_offset {off:+d} causal={causal} window={window}"
                mask = dict(causal=causal, window=window, q_offset=off)
                out, lse = fa.flash_forward_with_lse(q, k1, v1, **mask)
                out_p, lse_p = fa.flash_forward_plain(q, k1, v1, **mask)
                e_out = close(f"offset out {tag}", out.float(), out_p.float(), *tol["out"])
                e_lse = close(f"offset lse {tag}", lse, lse_p, *tol["lse"])
                if (lse_p == attention.MASK_VALUE).all():     # no row sees this hop
                    if not ((out == 0).all() and (lse == attention.MASK_VALUE).all()):
                        fail(f"[17] {tag}: dead rows not written as out 0, lse -1e30")
                    dead_cases += 1
                lse_full = torch.logaddexp(lse0, lse_p)
                rows = lambda x: x.transpose(1, 2)[..., None]
                out_full = (out0.float() * rows(torch.exp(lse0 - lse_full))
                            + out_p.float() * rows(torch.exp(lse_p - lse_full)))
                delta = fa.flash_delta(out_full, do)
                got = fa.flash_backward_blocks(q, k1, v1, do, lse_full, delta, **mask)
                want = fa._backward_plain(q, k1, v1, lse_full, delta, do, **mask)
                e_grads = [close(f"offset {n} {tag}", g.float(), w.float(), *tol["grad"])
                           for n, g, w in zip(("dq", "dk", "dv"), got, want)]
                for i, e in enumerate((e_out, e_lse, *e_grads)):
                    worst[i] = max(worst[i], e)
            torch.cuda.synchronize()
            for name, e in zip(routes[dtype], (max(worst[:2]), worst[2], max(worst[3:]))):
                offset_err[name] = max(offset_err[name], e)
            print(f"[17]   {dtype} causal={causal} window={window}: max |err| over the 4 "
                  f"offsets: out {worst[0]:.3e} lse {worst[1]:.3e} dq {worst[2]:.3e} "
                  f"dk {worst[3]:.3e} dv {worst[4]:.3e}")
    if not dead_cases:
        fail("[17] no case had every row dead")
    print(f"[17] {dead_cases} case(s) with every query row dead: out 0 and lse -1e30 in "
          f"kernel and plain version alike")
    offset_times = {}
    for dtype in ("float32", "bfloat16"):
        for causal, window in OFFSET_TIMED:
            q, k, v, do = flash_inputs(OFFSET_SHAPE, dtype, 3)
            row = {}
            for off in (0, c_len):      # +C last: the plain versions below reuse its lse, delta
                mask = dict(causal=causal, window=window, q_offset=off)
                out, lse = fa.flash_forward(q, k, v, **mask)
                delta = fa.flash_delta(out, do)
                row[off] = (
                    timed_ms(lambda: fa.flash_forward(q, k, v, **mask), iters=FLASH_ITERS,
                             warmup=FLASH_WARMUP),
                    timed_ms(lambda: fa.flash_dq(q, k, v, do, lse, delta, **mask),
                             iters=FLASH_ITERS, warmup=FLASH_WARMUP),
                    timed_ms(lambda: fa.flash_dkv(q, k, v, do, lse, delta, **mask),
                             iters=FLASH_ITERS, warmup=FLASH_WARMUP),
                    mask_counts(c_len, causal, window, off))
            mask = dict(causal=causal, window=window, q_offset=c_len)
            plain_fwd = timed_ms(lambda: fa.flash_forward_plain(q, k, v, **mask), iters=3,
                                 warmup=1)
            plain_bwd = timed_ms(lambda: fa._backward_plain(q, k, v, lse, delta, do, **mask),
                                 iters=3, warmup=1)
            pairs, live_rows, live_keys = row[c_len][3]
            bounds = flash_bounds(OFFSET_SHAPE, dtype, pairs, live_rows=live_rows,
                                  live_keys=live_keys)
            for i, name in enumerate(routes[dtype]):
                entry = dict(ms=row[c_len][i], ms_at_offset_0=row[0][i],
                             plain_ms=plain_fwd if i == 0 else plain_bwd,
                             bound=bounds[("flash_fwd", "flash_dq", "flash_dkv")[i]])
                print(f"[17] {name} {dtype} causal={causal} window={window}: q_offset +C "
                      f"{entry['ms']:.5f} ms ({pairs} visible pairs a head; {live_rows} "
                      f"query rows see a key, {live_keys} keys are seen), offset 0 "
                      f"{entry['ms_at_offset_0']:.5f} ms ({row[0][3][0]} pairs); plain "
                      f"{entry['plain_ms']:.5f} ms; bound_ms {entry['bound'][0]:.5f} "
                      f"({entry['bound'][1]}; bytes of the live rows and keys read, every "
                      f"output written) [{card}]")
                if (causal, window) == (False, 300):   # a windowed ring hop's block
                    offset_times[name] = entry

    # -- 18. the ring ops at gloo worlds 2 and 4 on the card -------------------------------
    for world in RING_WORLDS:
        path = OUT_DIR / f"ring_ops_w{world}.json"
        run_fleet(f"[18] world {world}:", [
            "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
                  f"chip_smoke.ring_ops_child({str(path)!r})"], n=world)
        result = check_ring_ops(path, world)
        for row in result["rows"]:
            print(f"[18] world {world} {row['schedule']} causal={row['causal']} window="
                  f"{row['window']} vs one-process flash_attention at {list(COMPOSED)} f32: "
                  f"max |err| out {row['out']:.3e} dq {row['dq']:.3e} dk {row['dk']:.3e} dv "
                  f"{row['dv']:.3e} (out {RING_TOL['out']}, grads {RING_TOL['grad']}); "
                  f"launches per rank = hops x blocks (fwd = dq = dkv): "
                  f"{[c[0] for c in row['counts']]}, at a hop offset "
                  f"{[c[5] for c in row['counts']]}; forward+backward {row['ms']:.3f} ms "
                  f"(gloo ranks time-slicing one card: no scaling point) [{card}]")

    # -- 19. the seq-parallel trainer: train.composed --mesh data=1,seq=2 ---------------
    ring_launches = {}
    layers = init_model.num_layers
    for label, schedule, causal, window in RING_TRAINERS:
        # the flags of both runs; the seq=2 run adds the zig-zag's. The zig-zag's reference
        # is the one-device causal flash path
        both = (["--causal"] if causal else []) + (
            ["--attention-window", str(window)] if window else [])
        seq_only = ["--zigzag-attention"] if schedule == "zigzag" else []
        stem = f"composed_{label.replace(' ', '_')}"
        w1, w2 = OUT_DIR / f"{stem}_w1.npz", OUT_DIR / f"{stem}_w2.npz"
        composed_trajectory(str(w1), "--mesh", "data=1", *both)      # this process
        run_fleet(f"[19] {label} seq=2:", [
            "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
                  f"chip_smoke.composed_trajectory({str(w2)!r}, '--mesh', 'data=1,seq=2', "
                  f"*{both + seq_only!r})"])
        one, two = np.load(w1), np.load(w2)
        if not int(one["steps"]) == int(two["steps"]) == RING_STEPS:
            fail(f"[19] {label}: {int(one['steps'])} and {int(two['steps'])} steps, "
                 f"expected {RING_STEPS}")
        e_loss = close(f"[19] {label} losses", torch.from_numpy(two["losses"]),
                       torch.from_numpy(one["losses"]), RING_TRAJECTORY_ATOL, 0.0)
        params = [k for k in one.files if k not in ("losses", "epoch_seconds", "steps")]
        e_par = max(close(f"[19] {label} {k}", torch.from_numpy(two[k]),
                          torch.from_numpy(one[k]), RING_TRAJECTORY_ATOL, 0.0)
                    for k in params)
        for rank in range(2):
            with open(f"{w2}.rank{rank}.json") as f:
                counts = json.load(f)
            plan = dict(seq_len=COMPOSED[1], causal=causal, window=window)
            blocks = ring_attention.planned_blocks(schedule, 2, rank, **plan)
            at_offset = ring_attention.planned_blocks(schedule, 2, rank, **plan,
                                                      offset_only=True)
            want = {key: {"flash_fwd": layers * (RING_STEPS + 1) * n,
                          "flash_dq": layers * RING_STEPS * n,
                          "flash_dkv": layers * RING_STEPS * n}
                    for key, n in (("all", blocks), ("offset", at_offset))}
            if counts != want:
                fail(f"[19] {label} rank {rank}: launches {counts}, predicted {want}")
            if window and not at_offset:
                fail(f"[19] {label} rank {rank}: the plan has no hop at a nonzero offset")
            if rank == 0:
                ring_launches[label] = counts
            print(f"[19] {label} seq=2 rank {rank}: launches in composed.main() "
                  f"{counts['all']} = layers x (steps + 1 eval batch) x {blocks} hop blocks "
                  f"(fwd), layers x steps x {blocks} (dq, dk/dv); at a nonzero hop offset "
                  f"{counts['offset']} ({at_offset} of the blocks)")
        with open(f"{w1}.rank0.json") as f:
            one_counts = json.load(f)["all"]
        print(f"[19] {label}: {RING_STEPS} steps at {list(COMPOSED)} f32, dropout off, "
              f"--mesh data=1,seq=2 (gloo, 2 ranks) vs data=1 (one process, launches "
              f"{one_counts}), flags {both + seq_only}: max |dloss| {e_loss:.3e}, max "
              f"|dparam| {e_par:.3e} (atol {RING_TRAJECTORY_ATOL:g}); replicas in sync at "
              f"atol 0 (main()'s closing check); losses {two['losses'][0]:.4f} -> "
              f"{two['losses'][-1]:.4f}")
        step_ms = {n: float(r["epoch_seconds"]) / RING_STEPS * 1e3
                   for n, r in (("seq=2", two), ("data=1", one))}
        print(f"[19] {label}: step {step_ms['seq=2']:.3f} ms at seq=2 (a gloo time-slicing "
              f"time: two ranks share one card, every hop staged through host memory; no "
              f"scaling point), {step_ms['data=1']:.3f} ms at data=1 (one process), each "
              f"over the epoch of {RING_STEPS} steps [{card}]")

    counted = ("flash_fwd", "flash_dq", "flash_dkv")
    all_launches = (launches | {"paged_attend": paged_launches}
                    | dict(zip(routes["float32"], (flash_launches[n] for n in counted)))
                    | dict(zip(routes["bfloat16"], (large_launches[n] for n in counted))))
    # the offset form's launches: those at a nonzero hop offset in the windowed seq=2 ring
    # trainer (rank 0), which promotes to f32; no main path runs the bf16 kernels with one
    offset_launches = (dict(zip(routes["float32"], (ring_launches["ring window"]["offset"][n]
                                                    for n in counted)))
                       | dict.fromkeys(routes["bfloat16"], 0))
    all_err = err | flash_err | {"paged_attend": paged_err}

    # -- 20. result ---------------------------------------------------------------------
    replaces = {"nll_fwd": f"{TPU_KERNELS}:53", "nll_bwd": f"{TPU_KERNELS}:69",
                "sgd_momentum": f"{TPU_KERNELS}:156", "flash_fwd_tf32": f"{TPU_ATTENTION}:479",
                "flash_dq_tf32": f"{TPU_ATTENTION}:666", "flash_dkv_tf32": f"{TPU_ATTENTION}:731",
                "flash_fwd_mma": f"{TPU_ATTENTION}:479", "flash_dq_mma": f"{TPU_ATTENTION}:666", "flash_dkv_mma": f"{TPU_ATTENTION}:731",
                "paged_attend": f"{TPU_PAGED}:85"}
    sources = ({name: SOURCE for name in times} | {name: FLASH_SOURCE for name in flash_times}
               | {"paged_attend": PAGED_SOURCE})
    kernels = [{"name": name, "route": "cuda", "source": sources[name],
                "replaces": replaces[name], "launches": all_launches[name],
                "max_abs_err": all_err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"]}
               for name, t in (times | flash_times | paged_times).items()]
    for entry in kernels:          # each flash kernel's offset form ([17], [19] ring window)
        if entry["name"] in offset_times:
            o = offset_times[entry["name"]]
            entry["offset"] = {
                "q_offsets": list(offsets), "case": "q_offset +C, window 300, non-causal",
                "launches": offset_launches[entry["name"]],
                "max_abs_err": offset_err[entry["name"]], "ms": o["ms"],
                "ms_at_offset_0": o["ms_at_offset_0"], "plain_ms": o["plain_ms"],
                "bound_ms": o["bound"][0], "bound_by": o["bound"][1], "library_ms": None}
    print(f"[20] chip_smoke.py {time.perf_counter() - t_start:.1f} s from the device check "
          f"to here, the builds included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
