#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100: builds the hand-written CUDA kernels,
holds each against its plain PyTorch version on the card, trains the reference CNN for one
epoch through the fused kernels (a captured CUDA graph of the step, replayed), trains the
transformer classifier through the flash kernels (the composed trainer at seq 2048, and a
few steps at the large bench widths) and on every trainer and sequence schedule, and
serves the pixel LM through the paged-decode kernel (the continuous-batching engine;
quantized, with the prefix cache, and behind the threaded ``Server``).

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
   and B1/B2's launch floor: 1,000 launches captured in one CUDA graph and replayed, at
   one row and at 64, in µs a launch;
4. a 20-step trajectory with dropout off, kernels against the plain path, on the card, and
   the kernel path on the card against the plain path on the CPU;
5. the whole slice: ``train.single.main`` on cuda with ``use_pallas_kernels=True`` for one
   epoch of the 60k/10k split at batch 64 (its segments replayed as CUDA graphs), with
   the launch counts read around it (replays counted);
6. where a step spends its time: the train step's wall time with the kernels and with the
   plain path, in turns (plain, kernels, kernels, plain), then a ``torch.profiler`` window
   over the kernel path: device time by kernel, device time per launch of each fused
   kernel, and the device's busy share of the window (the rest is idle, waiting on the
   host);
7. the flash kernels (B4, B5) against their plain versions on the card, at the composed
   trainer's shape, Ulysses' local shape of [27] (a), [28]'s stage microbatch and
   data=2,model=2 shapes, the large bench shape and test shapes
   (masks, widths, bf16), with the
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
    on the full sequence at ``[16, 2048, 4, 16]`` (the composed shape at batch 16),
    forward and gradients, with each rank's launches against the plan (hops × blocks
    within the truncated reach), those at a nonzero hop offset included;
19. the slice: ``train.composed.main`` at ``--mesh data=1,seq=2 --flash-attention
    --seq-len 2048`` at full width for 3 steps against ``--mesh data=1`` in this process,
    per-step losses and final parameters, with each rank's launches (all, and at a nonzero
    hop offset) against the plan; then the same with ``--attention-window 300`` (every
    off-diagonal hop at its offset ±C), with ``--zigzag-attention --causal``, and with
    both; the four seq=2 runs one after another in [18]'s world-2 fleet, after its ring
    ops (``seq_fleet_child``); step ms (a time of two ranks time-slicing one card, no
    scaling point);
20. the captured epoch: ``train.single.main`` (``--use-pallas-kernels``) and
    ``train.distributed.main`` at world 1 on NCCL for 20 steps each, which the rule runs
    as CUDA graphs on the card, against the eager loop of the same step from the same
    start, dropout off and on, losses and parameters within 1e-6, with B1-B3 launches and
    reducer calls counted at each replay; then profiler windows over replays of each
    trainer's full-split segments beside the eager loop (step ms in turns, busy share,
    kernel launches and host launch calls a step, the dropout key's device time), and the
    full captured epochs of [5], [15] and the bench of [16];
21. the step's remainder, captured on the card against the eager loop on the CPU: (a) the
    fused kernels with grad_accum 4, clipping and the EMA, (b) AdamW, a cosine schedule
    with warmup, label smoothing and clipping, (c) the guard with a NaN batch and a skip
    window, within 1e-5, the guard's counters equal; then ``python -m <port>.train.single
    --guard --anomaly-exit 1`` on a split with one NaN image: exit 65, the poison marker
    and the step window the plan predicts;
22. the checkpoints on the card (the JAX package's files, through the port's own msgpack
    codec): (a) ``train.distributed`` at world 1 on NCCL, captured, with B1-B3 in the
    graph, 2 epochs straight against 1 epoch and ``--resume-from model_dist.ckpt``,
    within 1e-6, launches and reducer calls equal to the plan; (b) ``train.single
    --use-pallas-kernels`` for one epoch with its 94 log-tick saves: bytes and host ms a
    save, the epoch against saves turned off in the harness (in turns), and
    ``--async-checkpoint``'s ``model.ckpt`` byte-identical to the sync run's; (c) the
    card's files restored on the CPU bitwise; (d) ``--handle-preemption`` under SIGTERM in
    epoch 2: exit 75, a verified, clean newest manifest entry, and a resume from it; (e)
    the plots, or that matplotlib is absent. [5] runs its epoch with the saves turned off
    in the harness, as before this phase existed;
23. the host-fed data path (the paper's own input pipeline): (a) the native C++ loader
    built with g++ from the repo's source and held bitwise against numpy (normalize,
    gather, the prefetcher's order, the IDX reader on ``tests/fixtures/mnist_idx``), an
    epoch of host batches through it and through numpy, ``download_mnist`` from a local
    ``http.server``; (b) ``train.single --use-pallas-kernels --use-host-pipeline`` for one
    full epoch under each host-fed program in turns (eager steps; a one-step CUDA graph
    over static input buffers), and captured on the numpy path, each against the
    device-resident captured epoch, B1-B3 launches = 938, with epoch seconds, ms a step,
    the loader's data wait and host launch calls a step; (c) ``train.distributed
    --host-local-feed`` at world 1 on NCCL against the device-resident run; (d)
    ``BatchLoader(prefetch=2, device=cuda)`` against the host iterator, and its data wait;
24. quantized serving at ``bench_lm.py``'s widths (bf16 weights, paged layout, 8 slots):
    (a) int8 and fp8 KV through B6's quantized branches (the engine's own narrow pools and
    their scale pools handed to the kernel, layers × steps launches), streams against the
    contiguous quantized engine (plain torch) up to true ties, bytes per token from
    ``byte_accounting`` against ``kv_dtype="model"``, tokens/s and ms a decode step;
    (b) w8 and w8a8 weights: the int8 accumulator on the card bitwise the CPU's int32
    product, the routes it took, every B6 call against its plain version on the same
    operands, the streams against plain; (c) the prefix cache on 8 requests sharing a
    392-token prefix: hits, prefill chunks saved, boundary-page copy-on-writes, streams
    equal to the run without the cache; (d) ``serving.Server``: 32 requests from 4
    submitter threads, two tenants, the preemptible one parked and resumed, every future
    ``ok``, streams equal to ``engine.run``'s, TTFT/TPOT/e2e p50/p95; (e) B6's int8 and fp8
    branches alone at ``[8, 2, 4, 32]`` and R = 8, D = 128 (ms, device µs, the bound of the
    narrow pool and its scales, plain and SDPA ms);
25. the pixel LM trained on the card and served through B6: (a) ``train.lm`` for two
    epochs at ``LMConfig``'s defaults on 30,000 examples (468 steps an epoch in captured
    segments; of the
    first: epoch seconds, ms a step, the loss falls, test NLL per token below ln 17,
    perplexity), 20 captured steps against the eager loop and a profiler window over each
    (host launch calls a step); (b) ``--resume-from`` (a)'s first-epoch store checkpoint
    against (a)'s two epochs straight; (c) the
    card's ``model_lm.ckpt`` restored on the CPU bitwise; (d) the trained parameters
    through ``load_params_or_state`` into the paged engine: 8 greedy requests prompted with
    the top half of test images, streams against greedy ``generate`` up to true ties, B6
    launches = layers x decode steps, then int8 and fp8 KV: the greedy token-match rate
    and the teacher-forced ``decode_nll`` delta against the unquantized model (a bar at
    0.05); (e) ``bench_lm.main([])`` (the module's defaults, in process), its JSON line
    printed;
26. speculative decoding on [25]'s trained LM (``spec_phase``): (a) ``verify_chunk`` and
    ``paged_verify_chunk`` in f32, int8 and fp8 planes against ``decode_step_slots`` at
    t + j (rows past ``seq_len`` dropped, the rows written quantize_rows' own); (b)
    ``bench_spec_ab``'s chat A/B on the paged layout, spec off (B6) against ngram and the
    draft LM (seeded, and trained in the phase), streams up to true ties, B6 and the decode
    step never run under spec; (c) the sampled accept rule against its target and a
    ``Server`` park/resume over spec; (d) ``serve_loadgen`` in process, open loop and chat;
27. the transformer on every trainer and every sequence schedule
    (``transformer_trainers_phase``): (a) ``train.composed --mesh data=1,seq=2 --seq-impl
    ulysses --flash-attention`` at the composed widths for 3 steps on two gloo ranks
    sharing the card (B4/B5 at ``[64, 2048, 2, 16]`` on each) against ``--mesh data=1``,
    launches against the plan; (b) ``python -m <port>.bench_transformer --large --flash``
    (its ``main`` in this process): its JSON line, the bf16 flash route, B4/B5 launches =
    layers x runs x steps; (c) B3's table over the transformer's leaves bitwise the plain
    update; ``train.single --model transformer --use-pallas-kernels`` for 20 steps, captured,
    dropout off and on, against the eager loop with the kernels (within 1e-6) and the eager
    plain step (within 1e-5), losses and parameters; then for one epoch, B1-B3 launches =
    steps, the loss falling, ``model.ckpt`` restored on the CPU bitwise; (d) composed ``--resume-from`` against the straight run,
    and SIGTERM inside an epoch giving exit 75; (e) the composed trainer's einsum ring
    (causal, ``--remat``) and windowed einsum zig-zag, and the LM's einsum ring and
    zig-zag, at seq=2 against data=1 for 3 steps each (no kernel launched on these paths);
28. the training meshes (``mesh_phase``), every world of gloo ranks time-slicing the one
    card (correctness runs, no scaling points): (a)-(d) ``train.composed`` at the composed
    widths (``--seq-len 2048 --flash-attention``) for 5 steps at ``data=1,model=2``;
    ``data=1,stage=2 --pipeline-microbatches 4`` under gpipe and 1f1b (the bubble
    printed); ``data=2 --fsdp`` and ``data=2,model=2 --fsdp``; ``data=1,expert=2`` at
    ``--moe-top-k`` 1 and 2; each within 1e-4 of ``--mesh data=1`` (the MoE runs of one
    rank running the same MoE model), each rank's B4/B5 launches against the plan (local
    operands ``[64, 2048, 2, 16]``, ``[16, 2048, 4, 16]``, ``[32, 2048, 4, 16]``,
    ``[32, 2048, 2, 16]``); (e) the JAX default mesh ``data=2,seq=2,model=2`` through
    ``train.launch --num-processes 8`` for one short epoch with ``--sharded-checkpoint``,
    its ``model_composed.ckpt`` and sharded directory restored on the CPU bitwise equal;
    (f) the LM at ``data=1,model=2`` and ``data=2,seq=2`` against data=1, and
    ``train.distributed --fsdp`` at world 1 on NCCL, captured, against plain DP;
29. the serve mesh and the telemetry stream (``serve_mesh_phase``): (a) [25]'s trained LM
    in the paged engine on ``build_serve_mesh(2, 2)``, four gloo ranks time-slicing the
    card (``serve_mesh_child``: a correctness run, no speed), 16 greedy requests whose
    streams equal the unsharded engine's (run in this process meanwhile) up to true ties,
    each rank's B6 launches = layers x decode steps at its own ``[4, 2, 1, 16]`` (the
    unsharded call is ``[8, 4, 1, 16]``), every call held against the plain version,
    params + KV per rank <= the unsharded / 1.8, the replica check, then ``serve_loadgen
    --shard tp=2,dp=2 --telemetry`` (the ``Server`` on rank 0 over ``MeshLeader``); (b)
    ``train.single --use-pallas-kernels --telemetry --health-stats`` for one short epoch:
    the stream has the JAX package's kinds and keys, and parameters and B1-B3 launches
    equal the run without the flags; (c) [24] (d)'s ``Server(telemetry=...)`` stream;
30. the fault and tracing plane (``fault_plane_phase``), every process a port entry point
    on the card: (a) ``resilience.supervisor.supervise`` (``fleet_supervise``) over
    ``train.single --use-pallas-kernels`` (captured) with ``kill`` at the top of epoch 2
    and the epoch-1 checkpoint torn: one restart, the torn file skipped, the final state
    bitwise an unbroken run's, B1-B3 launches equal, the goodput ledger summing to the
    wall within 1e-6 s with restart badput (none in the unbroken run); (b) ``nan`` poison
    inside the captured step with ``--guard --anomaly-exit 1``: exit 65, the restart with
    ``--skip-steps``, the final state bitwise the oracle's, B1-B3 launches = the replayed
    steps; (c) the replica process (paged, traced, [25]'s LM) through the port's wire,
    framed: 8 greedy streams against the in-process engine's, B6 launches = layers x
    decode steps with every call held against the plain version, 8 span trees,
    ``validate_chrome`` clean, a ChaosProxy ``corrupt`` as a typed ``WireCorrupt``,
    ``kill:step=N`` -> 41, SIGTERM -> 75;
31. the serving fleet (``fleet_phase``), every process a port entry point on the card:
    (a) ``serving.router.Router`` over 2 paged replicas with prefix affinity, 16 greedy
    requests (8 on one prefix), replica 1 killed mid-decode: every request ok, one
    restart, streams equal to the in-process paged engine's up to true ties, each replica
    process's B6 launches = layers x its own decode steps with every call held against
    the plain version; (b) ``scale_up`` to 3 with warm prefixes (the new replica's first
    affine request a prefix-cache hit), ``scale_down`` with 8 requests in flight (zero
    loss), a rolling ``reload`` onto the same checkpoint (streams unchanged); (c) a
    ``--tier prefill`` + ``--tier decode`` pair (contiguous): every request handed off, the
    streams the contiguous engine's, the decode tier prefilling 0 tokens, the handoff
    bytes one slot's planes each; a ``ChaosProxy`` corrupting the first handoff falls back
    to local prefill with zero loss; (d) ``python -m <port>.serve_loadgen --replicas 2``
    with the JAX tool's fleet summary keys; then, on (a)-(b)'s fleet once (c)-(d) are done,
    (e) the promotion gate (``deploy.Promoter``, the port tool's
    ``train_serve_loop.Scorers``: ``models.lm.decode_nll`` on the card): [25]'s LM
    published into a versioned store with a clean stamp gates, canaries on one replica and
    is promoted fleet-wide; the tool's ``publish_corrupted`` copy of it (every float leaf +
    N(0, 2), clean stamp) is rejected at the NLL gate; a head-negated copy passes a
    loosened gate and is rolled back at the canary by the incumbent-scored NLL of its
    sampled tokens; the ledger in order, the events with the JAX package's keys, every
    request ok through the rolls, B6 = layers x decode steps in every replica process;
32. the parallelism planner (``planner_phase``): (a) ``plan.Topology.detect`` of the card;
    (b) ``train.composed --plan tune --flash-attention --seq-len 2048`` at world 1: three
    measured candidates (the dense core in the trials), B4/B5 launches = the planned
    run's, ``plan_report`` against the run's telemetry; (c) the saved plan replayed
    bitwise against the pinned ``--mesh``/``--grad-accum``; (d) ``for_serve``'s slot
    bytes against the engine's ``byte_accounting`` for kv_dtype None, int8 and fp8;
33. the train→serve promotion loop (``promote_loop_phase``), each step a port entry point
    in a process of its own: (a) ``build_corpus`` over the repository's six frozen texts
    (seq 256); (b) ``train_serve_loop --quick`` on that corpus at ``LMConfig``'s widths
    (a trainer publishing while two contiguous replicas serve, the gate, the canary, the
    corrupted candidates caught, the resume leg bitwise, the throttled run's goodput):
    every gate true, nothing lost through the rolls, the promotion ledger's transitions in
    order with their measured margins (a clean candidate through gate and canary to the
    fleet; a corrupted one stopped at the NLL gate; another rolled back at the canary by
    the incumbent-scored NLL of its sampled tokens), the promote and canary events with
    the JAX package's keys, each leg's seconds and each promotion's seconds from publish;
    (c)
    ``telemetry_report`` over its streams (no unknown kind) and ``--goodput`` (its
    ``data_wait_s`` the loop's). No port kernel lies on this path;
34. the sharded replica behind the router (``sharded_fleet_phase``): a ``Router`` over 2
    replicas each ``--shard tp=2`` (a world of 2 ranks the router spawns, restarts and
    addresses as one), paged KV through B6 on each rank's own heads and pages, [25]'s LM;
    (b) [31] (a)'s 16 requests with one world's follower rank SIGKILLed and the other's
    leader killed by ``kill:proc=1,step=N``: both worlds restart whole, no old pid alive,
    zero lost, the streams the unsharded engine's up to true ties; (a) the requests again
    on the restarted worlds: every rank's B6 launches = layers x its world's decode steps,
    each call held against the plain version, params + KV a rank <= the unsharded / 1.8;
    (c) ``serve_loadgen --replicas 2 --shard tp=2`` with the JAX tool's fleet keys;
35. one JSON line with every kernel's numbers (each flash kernel with its offset form; B6's
    int8 and fp8 branches as rows of their own; B1/B2 with their launch floor; B1-B5 with
    their launches on [27]'s, [28]'s, [30]'s and [32]'s paths; B6 with its serve-mesh run
    of [29] and its replica processes of [30], [31] and [34]'s ranks), then, last, the JSON
    result line.

It exits non-zero, and prints no result, when no CUDA device is present or when the port's
package is not beside it.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
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
FLOOR_ROWS = (1, 64)            # phase 3: B1/B2's launch floor at one row and the path's 64
FLOOR_LAUNCHES, FLOOR_REPLAYS = 1000, 5   # launches captured in one graph; replays timed
TRAJECTORY_STEPS = 20
TRAJECTORY_ATOL = 1e-5         # kernels vs plain path, both on the card
CROSS_DEVICE_ATOL = 1e-4       # card vs CPU: conv sums run in another order
LR, MOMENTUM, BATCH = 0.01, 0.5, 64
PROFILE_STEPS = 200            # per timed run of phase 6
PROFILE_WINDOW = 100           # steps under the profiler

# Flash attention, phases 7-10. Shapes are [batch, seq, heads, head dim].
COMPOSED = (64, 2048, 4, 16)   # train.composed --seq-len 2048: embed 64 over 4 heads, f32
LARGE = (16, 2048, 8, 128)     # bench_transformer.py --large: d_model 1024, 8 heads, bf16
ULYSSES_LOCAL = (64, 2048, 2, 16)   # [27] (a): B4/B5's operands on each rank (heads 4 over 2)
                                    # and [28] (a) model=2's local heads
STAGE_LOCAL = (16, 2048, 4, 16)     # [28] (b): a stage's microbatch (64 over 4)
DATA_MODEL_LOCAL = (32, 2048, 2, 16)   # [28] (c): data=2,model=2's batch shard, local heads
FLASH_CASES = (                # (shape, dtype, causal, window)
    (COMPOSED, "float32", False, 0), (LARGE, "bfloat16", False, 0),
    (ULYSSES_LOCAL, "float32", False, 0), (STAGE_LOCAL, "float32", False, 0),
    (DATA_MODEL_LOCAL, "float32", False, 0),
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
FLASH_ITERS, FLASH_WARMUP = 5, 2   # timed calls a case, after the warm-up
CROSSOVER_SEQS = (512, 1024, 2048)
COMPOSED_TRAIN = 30000         # phase 9: half the synthetic train split, 468 steps of 64
                               # (~10 s on the card; 150 steps did not lower the val loss
                               # at seq 2048, 937 did)
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
# Quantized serving and the Server, phase 24, at BENCH_LM's widths.
QUANT_REQUESTS = 8             # (a)-(c): requests a run
SHARED_PREFIX = 392            # (c): the prompts' common prefix (a hit ends mid-page)
PREFIX_SLOTS = 4               # (c): fewer slots than requests, so later ones find entries
SERVER_REQUESTS = 32           # (d): from 4 submitter threads, half of each tenant
SERVER_TENANTS = "paid:prio=2;free:preempt=1"

# Data parallelism, phases 14-16. Worlds of 2 are two processes on the one card (gloo).
FLEET_TIMEOUT = 300            # seconds; the launcher kills the fleet and exits 124
DP_PROFILE_STEPS = 100         # phase 15: the data-parallel step under the profiler
DP_W2_TRAIN, DP_W2_TEST = 4096, 10000   # phase 15: the world-2 run's split, 2 epochs
DP_TRAJECTORY_ATOL = 1e-5      # world 2 vs world 1: the reduce adds two halves' gradients
BENCH_TIMED_EPOCHS, BENCH_TIMEOUT = 7, 600

# Ring-of-flash, phases 17-19: the hop offset in B4/B5, the ring ops, the seq-parallel
# trainer. Worlds of 2 and 4 are gloo processes time-slicing the one card.
OFFSET_SHAPE = (64, 1024, 4, 16)   # the composed trainer's shard: seq 2048 over 2 ranks
OFFSET_MASKS = ((False, 0), (True, 0), (False, 100), (True, 100), (False, 300),
                (True, 300), (False, 1000), (True, 1000))   # (causal, window)
OFFSET_TIMED = ((False, 0), (False, 300), (True, 1000))     # timed at +C and at offset 0
RING_WORLDS = (2, 4)
RING_OPS_SHAPE = (16, 2048, 4, 16)   # phase 18's operands: the composed shape's sequence
                                     # and heads at batch 16
RING_CASES = (("ring", False, 0), ("ring", True, 0), ("ring", False, 100),
              ("ring", True, 100), ("ring", False, 300), ("ring", True, 300),
              ("zigzag", True, 0), ("zigzag", True, 300))   # (schedule, causal, window)
# ring op vs the one-process flash_attention on the full sequence, both 3xTF32 kernels on
# the card: the same pairs in other blocks, merged in f32 (the kernels' own f32 tolerance)
RING_TOL = {"out": (2e-5, 1e-5), "grad": (1e-4, 1e-4)}
RING_STEPS = 3                 # phases 19, 27 (a): trainer steps a run, batch 64, dropout
                               # off (few: the smoke's time limit holds [28] too)
RING_TRAINER_WINDOW = 300      # phase 19's windowed runs: every hop with a nonzero offset
RING_TRAINERS = (              # phase 19: (label, schedule, causal, window)
    ("ring", "ring", False, 0), ("ring window", "ring", False, RING_TRAINER_WINDOW),
    ("zigzag", "zigzag", True, 0), ("zigzag window", "zigzag", True, RING_TRAINER_WINDOW))
RING_TRAJECTORY_ATOL = 1e-4    # seq=2 vs data=1: attention split over ranks and merged,
                               # 20 SGD steps; losses and every parameter

# The captured epoch and the step's remainder, phases 20-21.
CAPTURE_STEPS = 20             # phase 20: two segments of the trainers' log_interval 10
CAPTURE_LOG_INTERVAL = 10
CAPTURE_ATOL = 1e-6            # captured segment vs the eager loop, both on the card: the
                               # same kernels on the same inputs, losses and parameters
CAPTURE_WINDOW = 10            # phase 20: segment replays (10 steps each) under the profiler
REMAINDER_ATOL = 1e-5          # phase 21: the card's captured program vs the CPU's eager
                               # loop, 20 steps (conv sums in another order)
POISON_STEP, SKIP_WINDOW = 7, (12, 14)   # phase 21 (c): a NaN batch, a replayed window
POISON_TRAIN = 640             # phase 21: the poisoned run's split, 10 steps an epoch
RESUME_ATOL = 1e-6             # phase 22 (a): 1 epoch + resume vs 2 epochs straight, both
                               # captured on the card (the tolerance of [20])
PREEMPT_EPOCHS = 3             # phase 22 (d): SIGTERM once epoch 2 has begun
PREFETCH_TIMED = 12800         # phase 23 (d): the timed turns' examples, 200 batches (a
                               # fifth of the epoch: the smoke's time limit)
HOST_FED_WINDOW = 100          # phase 23 (b): host-fed steps of each program under the
                               # profiler

# The pixel LM trained on the card and served through B6, phase 25.
LM_TRAIN = 30000               # (a), (b) and [26]'s draft LM: the train split's first
                               # 30,000 examples, 468 steps an epoch (half the split: the
                               # smoke's time limit)
LM_CAPTURE_STEPS = 20          # (a): captured vs eager, and the profiler windows
LM_CAPTURE_ATOL = 1e-5         # (a): the same operations on the same inputs on the card
LM_PROMPT = 392                # (d): the top half of a test image
LM_REQUESTS = 8                # (d): greedy requests, one a slot
SPEC_K = 4                     # phase 26: drafts a verify pass scores (bench_spec_ab's -k)
SPEC_PROMPTS = (96, 300, 500, 782)   # (a): four slots' prefilled lengths; 782 + 4 > 783
SPEC_ATOL = 1e-5               # (a): verify row j vs decode at t + j, |diff| <= atol +
                               # atol·|decode| (f32, int8 and fp8 planes alike: the planes'
                               # written rows must be bitwise equal, so the reads are too)
SPEC_DRAWS = 40_000            # (c): vectorised draws of the sampled accept rule
SPEC_STEADY_NEW = 200          # (b): new tokens a slot in the steady-tick run (96-token prompts)
SPEC_AB = dict(sessions=6, turns=3, max_new_tokens=48, prompt_lens="32,64,96", num_slots=4,
               spec_k=SPEC_K, seed=0)   # bench_spec_ab.py's defaults, on the paged layout
SPEC_JAX_GATES = (1.0, 1.5, 1.5)   # the JAX tool's token match, tok/step, invocation ratio
# phase 27: the transformer on every trainer and every sequence schedule
SEQ_TRAJECTORY_ATOL = 1e-4     # (a), (e): seq=2 vs data=1, as [19]
SEQ_WINDOW = 300               # (e): the windowed einsum zig-zag
SEQ_SHORT_STEPS = 3            # (e): steps of the einsum runs (the LM's at its defaults)
BENCH_LARGE_STEPS = 10         # (b): bench_transformer --large's steps a run
BENCH_RUNS = 4                 # (b): its warm-up and three timed runs
RESUME_TRAIN = 4096            # (d): the composed runs' split, 64 steps an epoch
PREEMPT_TRAIN = 1024           # (d): the preempted run's split, 16 steps an epoch
TOKEN_MATCH_BUDGET, NLL_DELTA_BUDGET = 0.90, 0.05   # (d): tests/test_quant.py's budgets
# phase 28: the training meshes. Worlds of 2, 4 and 8 are gloo processes time-slicing the
# one card (correctness runs: every collective staged through host memory, no scaling)
MESH_STEPS = 5                 # (a)-(d): composed steps a run, at the composed widths
                               # (few: the smoke's time limit)
MESH_LM_STEPS = 5              # (f): the LM's steps a run, at LMConfig's widths
MESH_MICROBATCHES = 4          # (b): the pipeline's microbatches a step
MESH_ATOL = 1e-4               # every run vs its data=1 (or one-rank) reference: losses and
                               # every parameter (the sums of another layout, MESH_STEPS steps)
DEFAULT_MESH_TRAIN = 640       # (e): the JAX default mesh's short epoch, 10 steps of 64


PHASE_START: dict[int, float] = {}   # main()'s phases by number: when each began


def phase_seconds() -> dict[int, float]:
    """Each of main()'s phases that has begun, with its seconds (up to the next one)."""
    marks = sorted(PHASE_START.items()) + [(None, time.perf_counter())]
    return {n: round(t1 - t0, 1) for (n, t0), (_, t1) in zip(marks, marks[1:])}


def write_json(path, doc) -> None:
    """Write ``doc`` to ``path`` whole or not at all (tmp + rename): a child killed, or
    ended by another of its threads, mid-write leaves only its temporary file, which no
    reader's pattern matches."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_text(json.dumps(doc))
    os.replace(tmp, path)


def fail(msg: str) -> None:
    if PHASE_START:
        print(f"chip_smoke: seconds by phase: {phase_seconds()}", file=sys.stderr)
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


def start_fleet(command: list[str], env: dict | None = None, n: int = 2) -> dict:
    """``python <command>`` as a world of ``n`` through the port's launcher, from the root
    of the checkout, started and not waited for (its output goes to files under
    ``OUT_DIR``); ``finish_fleet`` waits for it."""
    env = {k: v for k, v in (env or os.environ).items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    stem = OUT_DIR / f"fleet_{time.monotonic_ns()}"
    out, err = open(f"{stem}.out", "w+"), open(f"{stem}.err", "w+")
    proc = subprocess.Popen([sys.executable, "-m", f"{PKG}.train.launch", "--num-processes",
                             str(n), "--timeout", str(FLEET_TIMEOUT), "--", *command],
                            stdout=out, stderr=err, text=True, cwd=ROOT, env=env)
    return {"proc": proc, "out": out, "err": err, "t0": time.perf_counter()}


def finish_fleet(tag: str, fleet: dict) -> str:
    """Wait for a ``start_fleet`` world; echo its output under ``tag`` and fail unless every
    rank exited 0 (a fleet past the launcher's own timeout is killed)."""
    proc = fleet["proc"]
    try:
        proc.wait(timeout=FLEET_TIMEOUT + 60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    outputs = []
    for f in (fleet["out"], fleet["err"]):
        f.seek(0)
        outputs.append(f.read())
        f.close()
    for line in outputs[0].splitlines():
        if line.strip():
            print(f"{tag} {line}")
    print(f"{tag} launcher exit {proc.returncode} after "
          f"{time.perf_counter() - fleet['t0']:.2f} s")
    if proc.returncode != 0:
        print(outputs[1][-4000:], file=sys.stderr)
        fail(f"{tag} a rank failed: the launcher exited {proc.returncode}")
    return outputs[0]


def run_fleet(tag: str, command: list[str], env: dict | None = None, n: int = 2):
    """``start_fleet`` then ``finish_fleet``: a world of ``n`` run to its end."""
    return finish_fleet(tag, start_fleet(command, env, n))


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


def composed_trajectory(out: str, *flags: str, steps: int = RING_STEPS) -> None:
    """Phase 19: ``train.composed.main`` on the card for ``steps`` steps at the
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
    splits = (mnist._synthesize_split(steps * cfg.batch_size, 300),
              mnist._synthesize_split(100, 301))
    datasets = tuple(mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic")
                     for x, y in splits)
    losses, build = [], composed.build_segment_fn

    def recording(config, model, **kwargs):
        optimizer, segment = build(config, model, **kwargs)

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
                 epoch_seconds=history.epoch_seconds[0], steps=int(state.step),
                 **{k: p.cpu().numpy() for k, p in state.params.items()})


def lm_trajectory(out: str, *flags: str, steps: int = 20) -> None:
    """Phase 27 (e): ``train.lm.main`` on the card for ``steps`` steps at
    ``LMConfig``'s widths (seq 784, embed 64, 2 layers, 4 heads, batch 64, AdamW, clip 1),
    from the CLI flags ``flags``, as this process's rank; rank 0 saves the epoch's train
    loss, the test NLL, the step count, the epoch's seconds and the final parameters to
    ``out``."""
    import numpy as np

    sys.path.insert(0, str(ROOT))
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import lm
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        LMConfig, parse_config,
    )

    cfg = parse_config(LMConfig, [
        "--epochs", "1", "--device", "cuda", "--generate", "0", "--eval-batch", "500",
        "--results-dir", str(OUT_DIR / Path(out).stem),
        "--images-dir", str(OUT_DIR / "images"), *flags])
    splits = (mnist._synthesize_split(steps * cfg.batch_size, 300),
              mnist._synthesize_split(500, 301))
    datasets = tuple(mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic")
                     for x, y in splits)
    state, history = lm.main(cfg, datasets=datasets)
    if int(os.environ.get("RANK", "0")) == 0:
        np.savez(out, train=np.array(history.train_losses),
                 test=np.array(history.test_losses), steps=int(state.step),
                 epoch_seconds=history.epoch_seconds[0],
                 **{k: p.cpu().numpy() for k, p in state.params.items()})


SEQ_RUNS = (   # phase 27 (a), (e): (label, seq=2 flags, data=1 flags, trainer, steps)
    ("ulysses of flash", ["--seq-impl", "ulysses"], [], "composed", RING_STEPS),
    ("einsum ring, causal, remat", ["--no-flash-attention", "--causal", "--remat"],
     ["--no-flash-attention", "--causal"], "composed", SEQ_SHORT_STEPS),
    ("einsum zig-zag, window 300",
     ["--no-flash-attention", "--causal", "--zigzag-attention", "--attention-window",
      str(SEQ_WINDOW)],
     ["--no-flash-attention", "--causal", "--attention-window", str(SEQ_WINDOW)], "composed",
     SEQ_SHORT_STEPS),
    ("LM einsum ring", [], [], "lm", SEQ_SHORT_STEPS),
    ("LM einsum zig-zag, window 100", ["--zigzag-attention", "--attention-window", "100"],
     ["--attention-window", "100"], "lm", SEQ_SHORT_STEPS),
)


def seq_fleet_child(runs: list) -> None:
    """Phases 18, 19, 27 and 28's runs in one world of gloo ranks: for each ``(trainer,
    out, flags, steps)`` in turn, ``ring_ops_child(out, flags)`` (``trainer`` "ring_ops",
    ``flags`` the shape), or ``composed_trajectory`` or ``lm_trajectory`` (``trainer``) of
    ``(out, *flags, steps=steps)``, on one process group (the trainers reuse a group that
    is up)."""
    sys.path.insert(0, str(ROOT))
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import mesh

    with mesh.cluster("cuda"):
        for trainer, out, flags, steps in runs:
            if trainer == "ring_ops":
                ring_ops_child(out, tuple(flags))
                continue
            run = composed_trajectory if trainer == "composed" else lm_trajectory
            run(out, *flags, steps=steps)


def seq_fleet_command(runs: list) -> list[str]:
    """The launcher command that runs ``seq_fleet_child(runs)`` in each rank."""
    return ["-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
                  f"chip_smoke.seq_fleet_child({runs!r})"]


def run_seq_fleet(tag: str, runs: list, n: int = 2) -> None:
    """``seq_fleet_child(runs)`` on ``n`` ranks of the launcher."""
    run_fleet(tag, seq_fleet_command(runs), n=n)


PREEMPT_CHILD = """
import os, signal, sys
import numpy as np
sys.path.insert(0, {root!r})
from {pkg}.data import mnist
from {pkg}.train import composed, single
from {pkg}.utils import config
splits = []
for n, seed in (({n}, 400), (500, 401)):
    x, y = mnist._synthesize_split(n, seed)
    splits.append(mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic"))
plan = composed.epoch_plan
def plan_then_term(seed, epoch, *a):
    if epoch == 1:
        os.kill(os.getpid(), signal.SIGTERM)   # inside epoch 1: stop at its boundary
    return plan(seed, epoch, *a)
composed.epoch_plan = plan_then_term
single.run_cli(config.ComposedConfig, lambda cfg: composed.main(cfg, datasets=tuple(splits)))
"""


def transformer_step_check(dev, card: str, train_ds, test_ds) -> None:
    """Phase 27 (c)'s hold on the transformer's step with the kernels, on the card.

    B3's multi-tensor table over the transformer classifier's own leaves (one launch a
    step) against the plain update, 3 steps, bitwise. Then ``train.single.main --model
    transformer --use-pallas-kernels`` trains ``CAPTURE_STEPS`` steps (the rule's CUDA
    graph), dropout off and at the model's default 0.1, against two eager loops of the same
    step from the same start on the same plan: with the kernels (captured vs eager,
    within ``CAPTURE_ATOL``) and with the plain loss and update (kernels vs plain, within
    ``TRAJECTORY_ATOL``), per-step losses and final parameters, B1-B3 launched once a step
    in ``main()`` (replays counted). The dropout masks come from the step's device key on
    every path, so they agree."""
    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
        BatchLoader, mnist,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
        build_model,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        fused_kernels as fk,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        single, step as st,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        SingleProcessConfig, model_options,
    )

    gen = torch.Generator(device=dev).manual_seed(27)
    leaves = st.create_train_state(build_model("transformer"), torch.Generator().manual_seed(1),
                                   device=dev).params
    p0, v0, g0 = ({k: torch.randn(t.shape, generator=gen, device=dev) for k, t in leaves.items()}
                  for _ in range(3))
    runs = {name: ({k: t.clone() for k, t in p0.items()}, {k: t.clone() for k, t in v0.items()})
            for name in ("multi", "plain")}
    before = fk.launch_counts()["sgd_momentum"]
    for _ in range(3):
        fk.sgd_momentum_step(*runs["multi"], g0, learning_rate=LR, momentum=MOMENTUM)
        for k, g in g0.items():
            fk.sgd_momentum_leaf_plain(runs["plain"][0][k], runs["plain"][1][k], g,
                                       learning_rate=LR, momentum=MOMENTUM)
    launches = fk.launch_counts()["sgd_momentum"] - before
    for got, want in zip(runs["multi"], runs["plain"]):
        for k in g0:
            if not torch.equal(got[k], want[k]):
                fail(f"[27] (c) sgd_momentum_step's {k} {tuple(want[k].shape)} differs from "
                     f"the plain update")
    if launches != 3 * -(-len(g0) // fk.SGD_TABLE_LEAVES):
        fail(f"[27] (c) sgd_momentum_step made {launches} launches in 3 steps over "
             f"{len(g0)} leaves")
    print(f"[27] (c) sgd_momentum_step over the transformer's {len(g0)} leaves "
          f"({sum(t.numel() for t in g0.values())} parameters), 3 steps: bitwise the plain "
          f"update; {launches} launches")
    del p0, v0, g0, runs, leaves

    li, n = CAPTURE_LOG_INTERVAL, CAPTURE_STEPS * BATCH
    sub = (mnist.Dataset(train_ds.images[:n], train_ds.labels[:n], train_ds.source),
           mnist.Dataset(test_ds.images[:1000], test_ds.labels[:1000], test_ds.source))
    x = torch.from_numpy(sub[0].images).to(dev)
    y = torch.from_numpy(sub[0].labels.astype("int64")).to(dev)
    for rate in (0.0, 0.1):
        make = lambda name, **kw: build_model(name, **kw, dropout_rate=rate)
        cfg = SingleProcessConfig(n_epochs=1, use_pallas_kernels=True, model="transformer",
                                  device="cuda", log_interval=li,
                                  results_dir=str(OUT_DIR / "captured_tf"),
                                  images_dir=str(OUT_DIR / "images"))
        losses = []
        fk.reset_launch_counts()
        with patched(single, "make_epoch_fn", recording_epoch_fn(single.make_epoch_fn,
                                                                 losses)), \
                patched(single, "build_model", make), \
                contextlib.redirect_stdout(io.StringIO()) as said:
            state, _ = single.main(cfg, datasets=sub)
        counts = fk.launch_counts()
        if "Segment program: cuda-graph on cuda" not in said.getvalue():
            fail("[27] (c) train.single --model transformer did not run the captured program")
        if counts != dict.fromkeys(counts, CAPTURE_STEPS):
            fail(f"[27] (c) dropout {rate}: B1-B3 launches {counts} != {CAPTURE_STEPS} steps")
        got = torch.cat(losses).cpu()
        if got.shape != (CAPTURE_STEPS,):
            fail(f"[27] (c) dropout {rate}: {tuple(got.shape)} losses, expected "
                 f"{CAPTURE_STEPS}")
        loader = BatchLoader(sub[0], BATCH, shuffle=True, seed=cfg.seed)
        loader.set_epoch(1)
        plan = torch.from_numpy(loader.epoch_index_matrix(1, allow_empty=True)).to(dev)
        shown = []
        for name, use_pallas, atol in (("eager with the kernels", True, CAPTURE_ATOL),
                                       ("eager plain", False, TRAJECTORY_ATOL)):
            model = make("transformer", **model_options(cfg))
            e_state = st.create_train_state(model, torch.Generator().manual_seed(cfg.seed),
                                            device=dev)
            eager = st.make_segment_fn(st.make_train_step(
                model, learning_rate=cfg.learning_rate, momentum=cfg.momentum,
                use_pallas=use_pallas))
            e_losses = []
            for s0 in range(0, CAPTURE_STEPS, li):
                e_state, l = eager(e_state, x, y, plan[s0:s0 + li], cfg.seed)
                e_losses.append(l)
            want = torch.cat(e_losses).cpu()
            torch.testing.assert_close(got, want, atol=atol, rtol=0.0,
                                       msg=lambda m: f"[27] (c) {name} losses: {m}")
            e_p = 0.0
            for k, p in e_state.params.items():
                torch.testing.assert_close(state.params[k], p, atol=atol, rtol=0.0,
                                           msg=lambda m: f"[27] (c) {name} {k}: {m}")
                e_p = max(e_p, (state.params[k] - p).abs().max().item())
            shown.append(f"vs {name} max |dloss| {(got - want).abs().max().item():.3e}, max "
                         f"|dparam| {e_p:.3e} (atol {atol:g})")
        print(f"[27] (c) train.single --model transformer --use-pallas-kernels, dropout "
              f"{rate}: {CAPTURE_STEPS} steps captured (main) {'; '.join(shown)}; B1-B3 "
              f"launches in main() {counts}; losses {got[0]:.4f} -> {got[-1]:.4f} [{card}]")


def transformer_trainers_phase(dev, card: str, train_ds, test_ds) -> dict:
    """Phase 27: the transformer on every trainer and every sequence schedule, on the card.

    (a) ``train.composed --mesh data=1,seq=2 --seq-impl ulysses --flash-attention`` at the
    composed widths (seq 2048) for 3 steps on two gloo ranks sharing the card, against
    ``--mesh data=1`` in this process, each rank's B4/B5 launches against the plan;
    (b) ``python -m <port>.bench_transformer --large --flash`` (its ``main``, in this
    process, so that its launches can be read): its JSON line, the flash route, B4/B5
    launches = layers x steps; (c) ``transformer_step_check``, then ``train.single --model
    transformer --use-pallas-kernels`` for one epoch, captured, B1-B3 launches = steps, the
    loss falling, ``model.ckpt`` restored on the CPU bitwise; (d) composed ``--resume-from`` against the straight run,
    and SIGTERM inside an epoch giving exit 75; (e) the einsum ring (causal, with remat) and
    the windowed einsum zig-zag on the composed trainer, and the LM's einsum ring and
    zig-zag, at seq=2 against data=1 for ``SEQ_SHORT_STEPS`` steps (no kernel on these paths:
    their launches are 0).
    Returns each new path's launches by kernel counter."""
    import numpy as np
    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch import (
        bench_transformer,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
        TransformerClassifier,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        flash_attention as fa, fused_kernels as fk,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        composed, single,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
        create_train_state, segment_program,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        ComposedConfig, SingleProcessConfig,
    )

    t_phase = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    found: dict = {}

    def max_diff(got, want) -> float:
        return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())

    # -- (a), (e): every seq=2 run in one fleet, the data=1 references here ----------------
    stem = str(OUT_DIR / "seq_run")
    t0 = time.perf_counter()
    fleet = start_fleet(seq_fleet_command([
        (trainer, f"{stem}{i}_w2.npz", ["--mesh", "data=1,seq=2", *flags], steps)
        for i, (_, flags, _, trainer, steps) in enumerate(SEQ_RUNS)]))
    for i, (_, _, ref_flags, trainer, n_steps) in enumerate(SEQ_RUNS):
        run = composed_trajectory if trainer == "composed" else lm_trajectory
        run(f"{stem}{i}_w1.npz", "--mesh", "data=1", *ref_flags, steps=n_steps)
    finish_fleet("[27] seq=2:", fleet)
    fleet_s = time.perf_counter() - t0
    layers = 2
    for i, (label, _, ref_flags, trainer, n_steps) in enumerate(SEQ_RUNS):
        w1, w2 = f"{stem}{i}_w1.npz", f"{stem}{i}_w2.npz"
        one, two = np.load(w1), np.load(w2)
        params = [k for k in one.files
                  if k not in ("losses", "train", "test", "epoch_seconds", "steps")]
        if not int(one["steps"]) == int(two["steps"]) == n_steps:
            fail(f"[27] {label}: {int(two['steps'])} steps at seq=2, {int(one['steps'])} at "
                 f"data=1, expected {n_steps}")
        losses = ("losses",) if trainer == "composed" else ("train", "test")
        e_loss = max(max_diff(two[k], one[k]) for k in losses)
        e_par = max(max_diff(two[k], one[k]) for k in params)
        if not (e_loss <= SEQ_TRAJECTORY_ATOL and e_par <= SEQ_TRAJECTORY_ATOL):
            fail(f"[27] {label}: seq=2 vs data=1 max |dloss| {e_loss:.3e}, max |dparam| "
                 f"{e_par:.3e} beyond {SEQ_TRAJECTORY_ATOL:g}")
        counts = []
        if trainer == "composed":
            for rank in range(2):
                with open(f"{w2}.rank{rank}.json") as f:
                    counts.append(json.load(f)["all"])
            steps = int(one["steps"])
            if i == 0:      # Ulysses of flash: one local flash call a layer, every rank
                want = {"flash_fwd": layers * (steps + 1), "flash_dq": layers * steps,
                        "flash_dkv": layers * steps}
                found["ulysses_rank0"] = counts[0]
            else:           # the einsum schedules launch no kernel
                want = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
            if any(c != want for c in counts):
                fail(f"[27] {label}: launches by rank {counts}, predicted {want} each")
        shown = (f"losses {two['losses'][0]:.4f} -> {two['losses'][-1]:.4f}"
                 if trainer == "composed" else
                 f"train loss {float(two['train'][0]):.4f}, test NLL/token "
                 f"{float(two['test'][0]):.4f}")
        step_ms = float(two["epoch_seconds"]) / int(two["steps"]) * 1e3
        print(f"[27] ({'a' if i == 0 else 'e'}) {trainer} {label}: {int(two['steps'])} steps, "
              f"--mesh data=1,seq=2 (gloo, 2 ranks on one card) vs data=1: max |dloss| "
              f"{e_loss:.3e}, max |dparam| {e_par:.3e} (atol {SEQ_TRAJECTORY_ATOL:g}); "
              f"{shown}; launches by rank {counts or 'n/a (the LM runs no kernel)'}; step "
              f"{step_ms:.3f} ms at seq=2 (two ranks time-slicing one card, every transfer "
              f"staged through host memory: no scaling point) [{card}]")
    print(f"[27] (a), (e) the seq=2 fleet, the data=1 references in this process meanwhile: "
          f"{fleet_s:.1f} s for {len(SEQ_RUNS)} runs; "
          f"Ulysses' B4/B5 operands on each rank {list(ULYSSES_LOCAL)} f32")

    # -- (b) bench_transformer --large --flash ---------------------------------------------
    fa.reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = bench_transformer.main(["--large", "--flash"])
    bench_s = time.perf_counter() - t0
    launches = fa.launch_counts()
    lines = [l for l in out.getvalue().splitlines() if l.startswith("{")]
    if code != 0 or len(lines) != 1:
        fail(f"[27] (b) bench_transformer returned {code} with {len(lines)} JSON lines")
    bench = json.loads(lines[0])
    want = LARGE_LAYERS * BENCH_RUNS * BENCH_LARGE_STEPS
    if set(launches.values()) != {want}:
        fail(f"[27] (b) flash launches {launches} != {LARGE_LAYERS} layers x "
             f"{BENCH_RUNS} runs x {BENCH_LARGE_STEPS} steps = {want} each")
    if ("attn-dispatch(flash)" not in bench["metric"] or bench["flash_layout"] != "mma-bf16"
            or bench["platform"] != "gpu" or not np.isfinite(bench["final_train_loss"])
            or bench["mfu_vs_bf16_peak"] is None):
        fail(f"[27] (b) bench_transformer's line: {lines[0]}")
    found["bench"] = launches
    print(f"[27] (b) python -m {PKG}.bench_transformer --large --flash ({bench_s:.1f} s, in "
          f"process) [{card}]: {lines[0]}")
    print(f"[27] (b) flash launches {launches} = {LARGE_LAYERS} layers x {BENCH_RUNS} "
          f"runs (warm-up + 3 timed) x {BENCH_LARGE_STEPS} steps (bf16: the tensor-core "
          f"kernels)")

    # -- (c) train.single --model transformer --use-pallas-kernels -------------------------
    transformer_step_check(dev, card, train_ds, test_ds)
    config = SingleProcessConfig(n_epochs=1, use_pallas_kernels=True, model="transformer",
                                 device="cuda", results_dir=str(OUT_DIR / "single_tf"),
                                 images_dir=str(OUT_DIR / "images"))
    full_steps, tail = divmod(len(train_ds), config.batch_size_train)
    steps = full_steps + (1 if tail else 0)
    fk.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = single.main(config, datasets=(train_ds, test_ds))
    main_s = time.perf_counter() - t0
    launches = fk.launch_counts()
    if int(state.step) != steps or set(launches.values()) != {steps}:
        fail(f"[27] (c) launches {launches} over {int(state.step)} steps, expected {steps} "
             f"each (the transformer's leaves fit one B3 launch)")
    if any(fa.launch_counts().values()):
        fail(f"[27] (c) flash launched at seq 16: {fa.launch_counts()}")
    if not (history.test_losses[-1] < history.test_losses[0]
            and history.train_losses[-1] < history.train_losses[0]):
        fail(f"[27] (c) the loss did not fall: train {history.train_losses[0]:.4f} -> "
             f"{history.train_losses[-1]:.4f}, test {history.test_losses}")
    model = TransformerClassifier()
    restored = checkpoint.restore_train_state(
        str(OUT_DIR / "single_tf" / "model.ckpt"),
        create_train_state(model, torch.Generator()))
    for k, p in state.params.items():
        if not torch.equal(restored.params[k], p.cpu()):
            fail(f"[27] (c) model.ckpt's {k} restored on the CPU differs from the card's")
    found["single_transformer"] = launches
    epoch_s = history.epoch_seconds[0]
    print(f"[27] (c) train.single --model transformer --use-pallas-kernels, one epoch "
          f"({segment_program(dev)}): launches {launches} over {steps} steps; test NLL "
          f"{history.test_losses[0]:.4f} -> {history.test_losses[-1]:.4f}, train loss "
          f"{history.train_losses[0]:.4f} -> {history.train_losses[-1]:.4f}; epoch "
          f"{epoch_s:.3f} s ({epoch_s / steps * 1e3:.3f} ms a step, saves included), main() "
          f"{main_s:.2f} s; model.ckpt restored on the CPU bitwise [{card}]")

    # -- (d) composed resume and preemption ------------------------------------------------
    kw = dict(mesh="data=1", epochs=2, device="cuda", max_train_examples=RESUME_TRAIN,
              max_test_examples=1000)
    runs = {}
    for name, more in (("straight", {}), ("first", dict(epochs=1)),
                       ("resumed", dict(resume_from=str(OUT_DIR / "c_first" /
                                                        "model_composed.ckpt")))):
        runs[name] = composed.main(ComposedConfig(
            **{**kw, **more}, results_dir=str(OUT_DIR / f"c_{name}")),
            datasets=(train_ds, test_ds))
    (s_state, s_hist), (r_state, r_hist) = runs["straight"], runs["resumed"]
    e_res = max((r_state.params[k] - p).abs().max().item() for k, p in s_state.params.items())
    if int(r_state.step) != int(s_state.step) or e_res > RESUME_ATOL:
        fail(f"[27] (d) resumed run at step {int(r_state.step)}, max |dparam| {e_res:.3e} vs "
             f"the straight run at {int(s_state.step)} (atol {RESUME_ATOL:g})")
    print(f"[27] (d) train.composed --mesh data=1, 2 epochs of {RESUME_TRAIN // 64} steps "
          f"straight vs 1 epoch + --resume-from model_composed.ckpt: step "
          f"{int(r_state.step)}, max |dparam| {e_res:.3e} (atol {RESUME_ATOL:g}), val loss "
          f"{r_hist.test_losses[-1]:.6f} vs {s_hist.test_losses[-1]:.6f} [{card}]")
    args = ["--device", "cuda", "--mesh", "data=1", "--epochs", "3", "--batch-size-test",
            "500", "--handle-preemption",
            "--results-dir", str(OUT_DIR / "c_preempt"), "--heartbeat-dir",
            str(OUT_DIR / "c_preempt_hb")]
    proc = subprocess.run(
        [sys.executable, "-c", PREEMPT_CHILD.format(root=str(ROOT), pkg=PKG,
                                                    n=PREEMPT_TRAIN), *args],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    preempt_step = 2 * PREEMPT_TRAIN // 64
    beat = json.loads((OUT_DIR / "c_preempt_hb" / "heartbeat_p0.json").read_text())
    if (proc.returncode != 75 or f"preempted at step {preempt_step}" not in proc.stdout
            or beat.get("status") != "preempted"):
        print(proc.stdout[-2000:], proc.stderr[-2000:], file=sys.stderr)
        fail(f"[27] (d) the preempted composed run exited {proc.returncode}, beat {beat}")
    print(f"[27] (d) train.composed --handle-preemption, SIGTERM inside epoch 1: exit "
          f"{proc.returncode} at step {preempt_step}, the last beat {beat.get('status')!r}")
    print(f"[27] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return found


def serve_mesh_child(ckpt: str, requests_path: str, out: str) -> None:
    """Phase 29 (a), one rank of the ``tp=2,dp=2`` serve mesh on the card: [25]'s trained LM
    (``ckpt``) in the paged engine at ``serve_loadgen``'s widths on
    ``serving.shard.build_serve_mesh(2, 2)``, warmed up, then the requests of
    ``requests_path`` served by ``engine.run`` with the B6 count set to 0 just before and
    read just after, every B6 call held against ``paged_attend_reference`` on the same
    operands (the plain version launches nothing); the byte accounting, the replica check;
    then ``serve_loadgen --shard tp=2,dp=2 --telemetry`` (the ``Server`` on rank 0 over
    ``MeshLeader``, the others following). Writes ``out``-rank<r>.json."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist

    from csed_514_project_distributed_training_using_pytorch_tpu_torch import (
        serve_loadgen,
        serving,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        paged_attention as paged,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import mesh
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import shard
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )

    spec = json.loads(Path(requests_path).read_text())
    make = lambda rows: [serving.Request(prompt=np.asarray(p, np.int32), max_new_tokens=n,
                                         request_id=i) for i, (p, n) in enumerate(rows)]
    with mesh.cluster("cuda"):
        rank = dist.get_rank()
        model = lm.TransformerLM(**SERVE_LM)
        params = checkpoint.load_params_or_state(ckpt, model.init(torch.Generator()))
        sm = shard.build_serve_mesh(2, 2)
        eng = serving.ContinuousBatchingEngine(model, params, num_slots=SERVE_SLOTS,
                                               kv_layout="paged", page_size=SERVE_PAGE,
                                               mesh=sm, device="cuda")
        eng.run(make(spec["warmup"]))
        eng.reset_stats()
        errs, excess, shapes = [], [], set()
        real = paged.paged_attend

        def spy(q, k_pool, v_pool, table, t, **kw):
            out_ = real(q, k_pool, v_pool, table, t, **kw)
            want = paged.paged_attend_reference(q, k_pool, v_pool, table, t, **kw)
            errs.append((out_ - want).abs().max().item())
            excess.append(errs[-1] - PAGED_RTOL * want.abs().max().item())
            shapes.add((tuple(q.shape), tuple(k_pool.shape)))
            return out_

        torch.cuda.synchronize()
        paged.reset_launch_counts()
        t0 = time.perf_counter()
        with patched(paged, "paged_attend", spy):
            done = eng.run(make(spec["requests"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = paged.launch_counts()["paged_attend"]
        acct = eng.byte_accounting()
        shard.check_replicas(eng)
        doc = {"rank": rank, "group": eng._group, "launches": launches, "steps": eng.steps,
               "layers": model.num_layers, "calls": len(errs),
               "max_abs_err": max(errs) if errs else None,
               "excess": max(excess) if excess else None,
               "shapes": sorted(map(list, shapes)), "wall_s": wall,
               "streams": {c.request.request_id: c.tokens.tolist() for c in done},
               "bytes": acct}
        tele = str(OUT_DIR / "serve_mesh_loadgen.jsonl")
        summary = str(OUT_DIR / "serve_mesh_loadgen.json")
        argv = ["--device", "cuda", "--checkpoint", ckpt, "--num-slots", str(SERVE_SLOTS),
                "--kv-layout", "paged", "--page-size", str(SERVE_PAGE), "--requests", "8",
                "--max-new-tokens", "16", "--prompt-lens", "0,64,200", "--rate", "50",
                "--shard", "tp=2,dp=2", "--telemetry", tele, "--summary-json", summary]
        t0 = time.perf_counter()
        doc["loadgen_rc"] = serve_loadgen.main(argv)
        doc["loadgen_s"] = time.perf_counter() - t0
        write_json(f"{out}-rank{rank}.json", doc)


# The telemetry stream's keys per event kind, the JAX package's (utils/telemetry.py's
# event functions there); [29] holds the port's streams to them.
TELEMETRY_KEYS = {
    "manifest": ("schema_version", "run_type", "unix_time", "platform", "device_kind",
                 "device_count", "local_device_count", "process_count", "process_index",
                 "jax_version", "jaxlib_version", "python_version"),
    "compile": ("fn", "lower_s", "compile_s", "flops_per_call", "steps_per_call",
                "flops_per_step", "bytes_accessed_per_call", "bytes_accessed_per_step"),
    "epoch": ("epoch", "examples", "steps", "wall_s", "execute_s", "eval_s", "data_s",
              "compile_s", "examples_per_s", "steps_per_s", "flops_per_step", "train_loss",
              "val_loss", "mfu"),
    "health": ("epoch", "steps", "grad_norm", "grad_norm_max", "loss_min", "loss_max",
               "loss_mean", "param_norm"),
    "mfu": ("flops_per_step", "step_s", "achieved_flops_per_s_per_device", "device_kind",
            "devices", "peak_flops_per_s_per_device", "mfu", "bytes_accessed_per_step",
            "achieved_bytes_per_s_per_device", "peak_hbm_bytes_per_s", "hbm_frac"),
    "serve": ("request_id", "prompt_len", "new_tokens", "finish", "queue_wait_s", "ttft_s",
              "tpot_s", "e2e_s", "tokens_per_s", "tenant", "preemptions"),
    "prefill": ("request_id", "prompt_len", "chunks", "tokens", "cache_hit_len", "wall_s",
                "latency_s", "tokens_per_s"),
    "tenant_summary": ("source", "tenant", "requests", "ok", "timeout", "shed",
                       "new_tokens", "preemptions", "ttft_s", "e2e_s", "slo"),
    "serve_summary": ("requests", "ok", "timeout", "new_tokens", "wall_s", "tokens_per_s",
                      "steps", "decode_invocations", "generated_tokens",
                      "tokens_per_invocation", "spec", "slot_occupancy", "prefill_tokens",
                      "prefill_chunks", "prefill_wall_s", "prefill_tokens_per_s",
                      "prefix_cache", "queue", "bytes", "kv_pages", "slo", "shed",
                      "preemptions", "resumes", "tenants", "ttft_s", "tpot_s", "e2e_s",
                      "queue_wait_s"),
}
MESH_REQUESTS, MESH_MAX_NEW = 16, 64   # [29] (a): greedy requests on the tp=2,dp=2 mesh
MESH_BYTES_RATIO = 1.8          # [29] (a): params + KV per rank <= the unsharded / 1.8
TELEMETRY_TRAIN = 1280          # [29] (b): the train.single runs' split (20 steps)


def check_stream(tag: str, path: Path, counts: dict[str, int]) -> list[dict]:
    """The telemetry stream at ``path``: valid JSONL, every kind in the registry, the
    JAX package's keys on each kind ``TELEMETRY_KEYS`` names, the manifest first, and
    ``counts`` (kind -> events) met; returns its events."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        jsonl,
        telemetry_events,
    )

    rows = jsonl.read_jsonl(str(path))
    if not rows or rows[0].get("event") != "manifest":
        fail(f"{tag} {path.name}: the stream does not open with its manifest")
    for row in rows:
        kind = row.get("event")
        if telemetry_events.describe(kind) is None:
            fail(f"{tag} {path.name}: event kind {kind!r} is not in the registry")
        missing = [k for k in TELEMETRY_KEYS.get(kind, ()) if k not in row]
        if missing:
            fail(f"{tag} {path.name}: a {kind!r} event lacks {missing}")
    got = {kind: sum(r["event"] == kind for r in rows) for kind in counts}
    if got != counts:
        fail(f"{tag} {path.name}: events {got}, expected {counts}")
    return rows


def serve_mesh_phase(dev, card: str, model, params: dict, ckpt: Path, test_ids, warmup,
                     serve, compare_streams, request_mix, train_ds, test_ds,
                     server_stream: Path) -> dict:
    """Phase 29: (a) the serve mesh ``tp=2,dp=2``, four gloo ranks time-slicing the card
    (``serve_mesh_child``; a correctness run, no speed), against the unsharded paged
    engine run in this process meanwhile; (b) ``train.single --telemetry --health-stats``
    against the same run without them; (c) [24] (d)'s ``Server(telemetry=...)`` stream.
    Returns B6's serve-mesh entry for the kernels line."""
    import numpy as np
    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        fused_kernels as fk,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import single
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        SingleProcessConfig,
    )

    t_phase = time.perf_counter()
    requests = request_mix(test_ids, MESH_REQUESTS, MESH_MAX_NEW, 29)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    req_path = OUT_DIR / "serve_mesh_requests.json"
    req_path.write_text(json.dumps(
        {name: [[r.prompt.tolist(), r.max_new_tokens] for r in rs]
         for name, rs in (("warmup", warmup), ("requests", requests))}))
    out = str(OUT_DIR / "serve_mesh")
    fleet = start_fleet(["-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                               f"import chip_smoke; chip_smoke.serve_mesh_child("
                               f"{str(ckpt)!r}, {str(req_path)!r}, {out!r})"], n=4)

    # (a), meanwhile: the unsharded paged engine on the same requests
    ref_eng, ref_streams, ref_wall, ref_launches = serve(model, params, "paged", requests,
                                                         warmup)
    single_acct = ref_eng.byte_accounting()
    del ref_eng

    # (b), meanwhile: train.single with and without --telemetry --health-stats
    small = (mnist.truncate(train_ds, TELEMETRY_TRAIN), mnist.truncate(test_ds, 1000))
    stream = OUT_DIR / "single_telemetry.jsonl"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True      # two runs of one seed, bit for bit
    runs = {}
    for name, kw in (("off", {}), ("on", dict(telemetry=str(stream), health_stats=True))):
        torch.cuda.synchronize()
        fk.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            state, _ = single.main(SingleProcessConfig(
                n_epochs=1, use_pallas_kernels=True, device="cuda",
                results_dir=str(OUT_DIR / f"telemetry_{name}"),
                images_dir=str(OUT_DIR / "telemetry_images"), **kw), datasets=small)
        torch.cuda.synchronize()
        runs[name] = (state, fk.launch_counts())
    torch.backends.cudnn.deterministic = deterministic
    (s_off, n_off), (s_on, n_on) = runs["off"], runs["on"]
    if n_on != n_off or not all(n_off.values()):
        fail(f"[29] (b) B1-B3 launches with telemetry and health stats {n_on}, without "
             f"{n_off}")
    differ = [k for k in s_off.params if not torch.equal(s_off.params[k], s_on.params[k])]
    if differ:
        fail(f"[29] (b) parameters differ with --telemetry --health-stats: {differ}")
    rows = check_stream("[29] (b)", stream, {"manifest": 1, "compile": 1, "epoch": 1,
                                             "health": 1, "mfu": 1})
    ev = {r["event"]: r for r in rows}
    h, e, m = ev["health"], ev["epoch"], ev["mfu"]
    if not (ev["compile"]["flops_per_step"] or 0) > 0 or not (m["mfu"] or 0) > 0 or not (
            h["grad_norm"] > 0 and h["param_norm"] > 0
            and h["loss_min"] <= h["loss_mean"] <= h["loss_max"]):
        fail(f"[29] (b) stream values: compile {ev['compile']}, health {h}, mfu {m}")
    print(f"[29] (b) train.single --use-pallas-kernels --telemetry --health-stats, one epoch "
          f"of {TELEMETRY_TRAIN} examples ({e['steps']} steps), under cudnn.deterministic: "
          f"parameters bitwise those of the run without them, B1-B3 launches {n_on} equal; "
          f"the stream ({len(rows)} events) has the JAX package's kinds and keys: "
          f"compile_s {ev['compile']['compile_s']:.4f} (the first segment call: warm-up, "
          f"capture, first replay), flops/step {e['flops_per_step']:.4e} (FlopCounterMode "
          f"+ B1-B3 by formula), epoch execute_s {e['execute_s']:.4f}, grad norm mean "
          f"{h['grad_norm']:.5f}, param norm {h['param_norm']:.5f}, mfu {m['mfu']:.3e} "
          f"(bf16 peak; the CNN is f32 and tiny) [{card}]")

    # (c): [24] (d)'s Server stream
    rows = check_stream("[29] (c)", server_stream, {
        "manifest": 1, "serve_config": 1, "serve": SERVER_REQUESTS, "kv_pages": 1,
        "tenant_summary": 2, "serve_summary": 1})
    summ = rows[-1]
    if summ["event"] != "serve_summary" or summ["requests"] != SERVER_REQUESTS or len(
            summ["bytes"]["per_chip"]) != 1:
        fail(f"[29] (c) the stream's last event: {summ}")
    print(f"[29] (c) [24] (d)'s Server(telemetry=...): {len(rows)} events (manifest, "
          f"serve_config, {SERVER_REQUESTS} serve, "
          f"{sum(r['event'] == 'prefill' for r in rows)} prefill, kv_pages, 2 tenant_summary, "
          f"serve_summary: {summ['ok']} ok, ttft p95 {summ['ttft_s']['p95']:.4f} s) with the "
          f"JAX package's kinds and keys [{card}]")

    # (a): the fleet's ranks against the unsharded engine
    finish_fleet("[29] (a) tp=2,dp=2:", fleet)
    ranks = [json.loads(Path(f"{out}-rank{r}.json").read_text()) for r in range(4)]
    layers = model.num_layers
    local = [SERVE_SLOTS // 2, model.kv_heads // 2, 1, model.head_dim]
    for row in ranks:
        tag = f"[29] (a) rank {row['rank']}"
        if row["launches"] != layers * row["steps"] or not row["launches"]:
            fail(f"{tag}: B6 launches {row['launches']} != {layers} x {row['steps']} steps")
        if row["calls"] != row["launches"] or {tuple(s[0]) for s in row["shapes"]} != {
                tuple(local)}:
            fail(f"{tag}: {row['calls']} held calls at q {row['shapes']}, expected "
                 f"{row['launches']} at {local}")
        if row["excess"] > PAGED_ATOL:
            fail(f"{tag}: B6 vs its plain version beyond atol {PAGED_ATOL} + rtol "
                 f"{PAGED_RTOL}: excess {row['excess']:.3e}")
        if row["loadgen_rc"] != 0:
            fail(f"{tag}: serve_loadgen --shard returned {row['loadgen_rc']}")
    got = {int(k): v for k, v in ranks[0]["streams"].items()}
    params_dev = {k: p.to(dev) for k, p in params.items()}
    ties = compare_streams("[29] (a)", model, params_dev, requests, got, ref_streams)
    acct = ranks[0]["bytes"]
    single_total = single_acct["params_bytes"] + single_acct["kv_bytes_resident"]
    if len(acct["per_chip"]) != 4 or acct["params_kv_bytes_per_chip_max"] > (
            single_total / MESH_BYTES_RATIO):
        fail(f"[29] (a) per-chip params+kv {acct['params_kv_bytes_per_chip_max']} over "
             f"{len(acct['per_chip'])} ranks vs the unsharded {single_total} / "
             f"{MESH_BYTES_RATIO}")
    loadgen = json.loads((OUT_DIR / "serve_mesh_loadgen.json").read_text())
    l_rows = check_stream("[29] (a) serve_loadgen", OUT_DIR / "serve_mesh_loadgen.jsonl",
                          {"manifest": 1, "serve": 8, "serve_summary": 1})
    if loadgen["shard"] != "tp=2,dp=2" or loadgen["ok"] != 8 or len(
            loadgen["bytes"]["per_chip"]) != 4 or len(l_rows[-1]["bytes"]["per_chip"]) != 4:
        fail(f"[29] (a) serve_loadgen --shard summary: {loadgen}")
    same = sum(got[i] == ref_streams[i] for i in ref_streams)
    print(f"[29] (a) ContinuousBatchingEngine(mesh=build_serve_mesh(2, 2)), paged, "
          f"{SERVE_SLOTS} slots, pages of {SERVE_PAGE}, [25]'s trained LM {SERVE_LM}: "
          f"{MESH_REQUESTS} greedy requests, {same}/{MESH_REQUESTS} streams equal to the "
          f"unsharded engine's, {ties} diverging at a true tie; every rank's B6 calls at q "
          f"{local} (the unsharded {[SERVE_SLOTS, model.kv_heads, 1, model.head_dim]}) held "
          f"against the plain version (max |err| {max(r['max_abs_err'] for r in ranks):.3e}, "
          f"within atol {PAGED_ATOL} + rtol {PAGED_RTOL}); B6 launches by rank "
          f"{[r['launches'] for r in ranks]} = "
          f"{layers} layers x {ranks[0]['steps']} decode steps; params+kv per rank "
          f"{acct['params_kv_bytes_per_chip_max']} B max vs {single_total} B unsharded "
          f"(ratio {single_total / acct['params_kv_bytes_per_chip_max']:.2f} >= "
          f"{MESH_BYTES_RATIO}); the replica check passed; serve_loadgen --shard tp=2,dp=2 "
          f"(Server on rank 0 over MeshLeader): {loadgen['ok']}/8 ok in "
          f"{ranks[0]['loadgen_s']:.1f} s, its stream {len(l_rows)} events "
          f"(4 gloo ranks on one card: a correctness run, never a speed) [{card}]")
    print(f"[29] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"path": "ContinuousBatchingEngine(mesh=build_serve_mesh(2, 2)), paged, "
                    "serve_loadgen's widths [29] (a)",
            "local_q_shape": local, "launches_by_rank": [r["launches"] for r in ranks],
            "decode_steps": ranks[0]["steps"],
            "max_abs_err_by_rank": [r["max_abs_err"] for r in ranks],
            "streams_equal": same, "streams": MESH_REQUESTS, "ties": ties}


# phase 30: the fault and tracing plane. Every process it starts is a port entry point on
# the card (no --device cpu); the supervised trainer runs are 1,280 synthetic examples (20
# captured steps an epoch, two segments of log_interval 10), the replica runs [25]'s LM
FAULT_TRAIN = 1280             # (a), (b): the trainer's split, 20 steps of 64 an epoch
FAULT_KILL_STEP = 20           # (a): the top of epoch 2; the epoch-1 checkpoint is torn
FAULT_NAN_STEP = 7             # (b): the poisoned step, inside epoch 1's first segment
REPLICA_REQUESTS, REPLICA_MAX_NEW = 8, 64   # (c): greedy requests through the wire
REPLICA_KILL_STEP = 5          # (c): kill:step=N on a second replica
GOODPUT_TOL = 1e-6             # (a): the decomposition's segments sum to the wall within


def fault_trainer_child() -> None:
    """Phase 30 (a)/(b): one attempt of ``train.single`` on the card, as the supervisor
    spawns it (``python -c ... <out dir> <trainer flags> [--resume-from ...]
    [--skip-steps ...]``): the split is ``FAULT_TRAIN`` synthetic examples, cuDNN runs
    deterministically (two runs of one seed are then the same bits), the attempt's
    telemetry goes to ``<out>/attempt<n>.jsonl`` (a restart from scratch would otherwise
    overwrite its predecessor's stream), and at exit (0 or 65; a ``kill`` fault's
    ``os._exit`` skips it) B1-B3's launch counts go to ``<out>/attempt<n>.json``."""
    import atexit
    import runpy

    out, argv = Path(sys.argv[1]), sys.argv[2:]
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch import data
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        fused_kernels as fk,
    )

    torch.backends.cudnn.deterministic = True
    n = sum(f.name.startswith("start") for f in out.iterdir())
    (out / f"start{n}").write_text(json.dumps(argv))

    def load_mnist(data_dir):
        x, y = mnist._synthesize_split(FAULT_TRAIN, 400)
        tx, ty = mnist._synthesize_split(1000, 401)
        return (mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic"),
                mnist.Dataset(mnist._normalize(tx), ty.astype(np.int32), "synthetic"))

    data.load_mnist = load_mnist
    atexit.register(lambda: write_json(out / f"attempt{n}.json",
                                       {"launches": fk.launch_counts(), "argv": argv}))
    sys.argv = ["train.single", *argv, "--telemetry", str(out / f"attempt{n}.jsonl")]
    runpy.run_module(f"{PKG}.train.single", run_name="__main__")


def replica_child() -> None:
    """Phase 30 (c): the replica process on the card (``serving.replica.main`` with the
    flags after ``<out>``), with every B6 call held against ``paged_attend_reference`` on
    its operands; when ``main`` returns (``stop``), B6's launch count since the warm-up, the
    held calls' errors and the engine's decode steps (``reset_stats`` zeroes them after the
    warm-up) go to ``<out>`` as JSON. The counts travel outside
    the protocol: the wire carries no key of the harness's."""
    out, argv = Path(sys.argv[1]), sys.argv[2:]
    sys.path.insert(0, str(ROOT))
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        paged_attention as paged,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        replica,
    )

    engines, errs, excess, shapes = [], [], [], set()
    real, build = paged.paged_attend, replica.build_engine_server

    def spy(q, k_pool, v_pool, table, t, **kw):
        got = real(q, k_pool, v_pool, table, t, **kw)
        want = paged.paged_attend_reference(q, k_pool, v_pool, table, t, **kw)
        errs.append((got - want).abs().max().item())
        excess.append(errs[-1] - PAGED_RTOL * want.abs().max().item())
        shapes.add(tuple(q.shape))
        return got

    def hold(args, trace=None):
        engine, server = build(args, trace=trace)     # its warm-up served: counts to 0
        engines.append(engine)
        paged.reset_launch_counts()
        del errs[:], excess[:]
        shapes.clear()
        return engine, server

    paged.paged_attend, replica.build_engine_server = spy, hold
    rc = replica.main(argv)
    write_json(out, {
        "rc": rc, "launches": paged.launch_counts()["paged_attend"],
        "steps": engines[0].steps, "calls": len(errs),
        "max_abs_err": max(errs) if errs else None,
        "excess": max(excess) if excess else None, "shapes": sorted(map(list, shapes))})
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)          # as the replica's own __main__: no teardown under live threads


class WirePeer:
    """A client of the replica's line protocol built on the port's ``serving/wire.py``:
    newline JSON until ``negotiate`` (``hello_ack``), length + CRC frames after."""

    def __init__(self, port: int, timeout: float = 300.0):
        import socket

        from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
            wire,
        )

        self.wire, self.framed, self.pending = wire, False, []
        deadline = time.monotonic() + timeout
        while True:
            try:
                self.sock = socket.create_connection(("127.0.0.1", port), timeout=1.0)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        self.lines, self.frames = wire.LineDecoder(), wire.FrameDecoder()
        self.sock.settimeout(timeout)
        self.hello = self.recv()

    def negotiate(self) -> None:
        if not self.wire.hello_wants_framing(self.hello):
            fail(f"[30] (c) the replica's hello advertises no framing: {self.hello}")
        self.send(self.wire.make_hello_ack())
        self.framed = True

    def send(self, obj: dict) -> None:
        self.sock.sendall(self.wire.encode_msg(obj, framed=self.framed))

    def recv(self) -> dict:
        dec = self.frames if self.framed else self.lines
        while not self.pending:
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                raise EOFError("the replica closed the connection")
            self.pending += dec.feed(chunk)
        return json.loads(self.pending.pop(0))

    def close(self) -> None:
        self.sock.close()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(faults: str | None = None) -> dict:
    """This process's environment without a launcher's rank variables (a child's fault
    ``proc`` would read them) and with ``RESILIENCE_FAULTS`` as given."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                        "RESILIENCE_FAULTS", "JAX_PROCESS_ID")}
    if faults:
        env["RESILIENCE_FAULTS"] = faults
    return env


def _child_command(fn: str, *args: str) -> list[str]:
    return ["-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
                  f"chip_smoke.{fn}()", *args]


def fault_plane_phase(dev, card: str, t_model, t_params: dict, ckpt: Path, test_ids,
                      request_mix, serve, compare_streams, warmup) -> dict:
    """Phase 30: the fault and tracing plane on the card. (a) ``fleet_supervise``'s
    ``supervise`` over ``train.single --use-pallas-kernels`` (captured) with ``kill`` at
    the top of epoch 2 and the epoch-1 checkpoint torn, against an unbroken run, and the
    goodput ledger of both; (b) ``nan`` poison with ``--guard --anomaly-exit 1``: exit 65,
    the rollback with ``--skip-steps``, against an oracle run skipping from the start; (c)
    the replica process (paged, traced) driven through the port's wire, its streams against
    the in-process engine's, B6 held against its plain version, the span trees, a chaos
    ``corrupt``, ``kill:step=N`` and SIGTERM. Everything runs at once: the supervisors in
    threads, the other processes beside them. Returns the launches of each path for the
    kernels line."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
        supervisor,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )

    t_phase = time.perf_counter()
    base = OUT_DIR / "fault_plane"
    shutil.rmtree(base, ignore_errors=True)
    dirs = {name: base / name for name in ("kill", "unbroken", "nan", "oracle", "replica")}
    for d in dirs.values():
        d.mkdir(parents=True)
    (base / "flags").mkdir()
    steps = FAULT_TRAIN // BATCH

    def trainer_args(d: Path, *extra: str) -> list[str]:
        return ["--use-pallas-kernels", "--results-dir", str(d / "results"),
                "--images-dir", str(d / "images"), *extra]

    kill_args = trainer_args(dirs["kill"], "--n-epochs", "2", "--keep-checkpoints", "2")
    nan_args = trainer_args(dirs["nan"], "--n-epochs", "1", "--guard", "--anomaly-exit",
                            "1")
    kill_faults = (f"kill:step={FAULT_KILL_STEP},flag={base / 'flags' / 'kill'};"
                   f"torn:match={checkpoint.versioned_name(steps)},"
                   f"flag={base / 'flags' / 'torn'}")
    results, timings = {}, {}

    def supervised(name: str, args: list[str], faults: str, store: Path) -> None:
        t0 = time.perf_counter()
        cfg = supervisor.SupervisorConfig(
            num_processes=1, max_restarts=2, backoff_s=0.0, checkpoint_dir=str(store),
            attempt_timeout_s=300, telemetry=str(dirs[name] / "supervisor.jsonl"))
        try:
            results[name] = supervisor.supervise(
                _child_command("fault_trainer_child", str(dirs[name]), *args), cfg,
                env=_child_env(faults))
        except Exception as e:                  # surfaced on the main thread
            results[name] = e
        timings[name] = time.perf_counter() - t0

    def spawn(name: str, command: list[str], faults: str | None = None):
        log = open(base / f"{name}.log", "w")
        return subprocess.Popen([sys.executable, *command], cwd=ROOT, env=_child_env(faults),
                                stdout=log, stderr=subprocess.STDOUT)

    # everything at once: two supervisors, the two reference runs, three replicas
    threads = [threading.Thread(target=supervised, args=a) for a in (
        ("kill", kill_args, kill_faults, dirs["kill"] / "results" / "checkpoints"),
        ("nan", nan_args, f"nan:step={FAULT_NAN_STEP}",
         dirs["nan"] / "results" / "checkpoints"))]
    for t in threads:
        t.start()
    refs = {
        "unbroken": spawn("unbroken", _child_command(
            "fault_trainer_child", str(dirs["unbroken"]),
            *trainer_args(dirs["unbroken"], "--n-epochs", "2", "--keep-checkpoints", "2"))),
        "oracle": spawn("oracle", _child_command(
            "fault_trainer_child", str(dirs["oracle"]),
            *trainer_args(dirs["oracle"], "--n-epochs", "1", "--guard", "--anomaly-exit",
                          "1", "--skip-steps", f"{FAULT_NAN_STEP}:{FAULT_NAN_STEP + 1}")))}
    ports = {name: _free_port() for name in ("main", "kill", "term")}
    span_dir = dirs["replica"] / "spans"
    replica_flags = ["--checkpoint", str(ckpt), "--kv-layout", "paged", "--page-size",
                     str(SERVE_PAGE), "--num-slots", str(SERVE_SLOTS)]
    replicas = {
        "main": spawn("replica_main", _child_command(
            "replica_child", str(dirs["replica"] / "main.json"), "--port",
            str(ports["main"]), "--trace", str(span_dir / "replica0.jsonl"),
            *replica_flags)),          # warmed up (--warmup 1): the spans time the schedule
        "kill": spawn("replica_kill", [
            "-m", f"{PKG}.serving.replica", "--port", str(ports["kill"]), "--replica-id",
            "1", *replica_flags, "--warmup", "0"],
            faults=f"kill:proc=1,step={REPLICA_KILL_STEP}"),
        "term": spawn("replica_term", [
            "-m", f"{PKG}.serving.replica", "--port", str(ports["term"]), "--replica-id",
            "2", *replica_flags, "--warmup", "0"], faults="stall:proc=2,step=3,secs=60")}

    try:
        return _fault_plane_checks(dev, card, t_model, t_params, test_ids, request_mix,
                                   serve, compare_streams, warmup, base, dirs, steps, ports,
                                   span_dir, replicas, refs, threads, results, timings,
                                   t_phase)
    finally:      # a failed check leaves no process of the phase's behind
        for p in (*replicas.values(), *refs.values()):
            if p.poll() is None:
                p.kill()
                p.wait()


def _fault_plane_checks(dev, card, t_model, t_params, test_ids, request_mix, serve,
                        compare_streams, warmup, base, dirs, steps, ports, span_dir,
                        replicas, refs, threads, results, timings, t_phase) -> dict:
    """Phase 30's client side and checks, once its processes are started."""
    import signal

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs import goodput
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
        faults,
        netfaults,
        poison,
        preemption,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import wire
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
        trace,
    )

    # (c), meanwhile: the replica process through the wire
    t_c = time.perf_counter()
    requests = request_mix(test_ids, REPLICA_REQUESTS, REPLICA_MAX_NEW, 30)
    client = trace.Tracer(str(span_dir / "loadgen.jsonl"), proc="loadgen")
    peer = WirePeer(ports["main"])
    hello = peer.hello
    peer.negotiate()
    t_submit = {}
    for r in requests:
        t_submit[r.request_id] = time.monotonic()
        peer.send({"op": "submit", "id": r.request_id, "prompt": r.prompt.tolist(),
                   "max_new_tokens": r.max_new_tokens, "temperature": 0.0, "top_k": 0,
                   "top_p": 1.0, "timeout_s": None, "trace_id": f"smoke-{r.request_id}"})
    done = {}
    while len(done) < len(requests):
        msg = peer.recv()
        if msg.get("op") != "done":
            fail(f"[30] (c) the replica answered {msg}")
        done[msg["id"]] = msg
        client.span("client", f"smoke-{msg['id']}", t_submit[msg["id"]], time.monotonic(),
                    finish=msg["finish"])
    client.close()
    peer.send({"op": "stats", "id": 99})
    stats = peer.recv()
    peer.close()
    wire_s = time.perf_counter() - t_c
    # a ChaosProxy in front: connection 0 has its first reply after the hello damaged
    proxy = netfaults.ChaosProxy(ports["main"], "corrupt:dir=s2c,after=1,conn=0", seed=30)
    corrupt = None
    try:
        chaos = WirePeer(proxy.start())
        chaos.negotiate()
        chaos.send({"op": "submit", "id": 100, "prompt": requests[0].prompt.tolist(),
                    "max_new_tokens": 4, "temperature": 0.0, "top_k": 0, "top_p": 1.0,
                    "timeout_s": None, "trace_id": "smoke-chaos"})
        try:
            chaos.recv()
        except wire.WireCorrupt as e:
            corrupt = str(e)
        chaos.close()
    finally:
        proxy.stop()
    if corrupt is None:
        fail("[30] (c) the ChaosProxy corrupt fault did not surface as a WireCorrupt")
    after = WirePeer(ports["main"])                   # the replica lives on: a legacy peer
    after.send({"op": "stats", "id": 101})
    alive = after.recv()
    after.send({"op": "stop"})
    after.close()
    # kill:step=N mid-request on the second replica; SIGTERM on the third while its request
    # is held in flight (a stall fault sleeps its serving loop at decode step 3)
    kpeer, tpeer = WirePeer(ports["kill"]), WirePeer(ports["term"])
    for p in (kpeer, tpeer):
        p.send({"op": "submit", "id": 0, "prompt": [], "max_new_tokens": 40,
                "temperature": 0.0, "top_k": 0, "top_p": 1.0, "timeout_s": None})
    time.sleep(2.0)
    replicas["term"].send_signal(signal.SIGTERM)
    codes = {name: p.wait(timeout=300) for name, p in replicas.items()}
    term_lines = []
    try:
        while True:
            term_lines.append(tpeer.recv())
    except (EOFError, OSError):
        pass
    kpeer.close(), tpeer.close()
    replica_s = time.perf_counter() - t_c

    # (c): the readings
    if codes != {"main": 0, "kill": faults.DEFAULT_KILL_EXIT,
                 "term": preemption.EXIT_PREEMPTED}:
        for name in replicas:
            print((base / f"replica_{name}.log").read_text()[-3000:], file=sys.stderr)
        fail(f"[30] (c) replica exit codes {codes}")
    if any(m.get("op") == "done" for m in term_lines):
        fail(f"[30] (c) the SIGTERM'd replica flushed done lines: {term_lines}")
    row = json.loads((dirs["replica"] / "main.json").read_text())
    if alive.get("op") != "stats" or stats.get("op") != "stats":
        fail(f"[30] (c) stats replies {stats}, {alive}")
    got = {rid: m["tokens"] for rid, m in done.items()}
    ref_eng, ref_streams, _, _ = serve(t_model, t_params, "paged", requests, warmup)
    del ref_eng
    params_dev = {k: p.to(dev) for k, p in t_params.items()}
    ties = compare_streams("[30] (c)", t_model, params_dev, requests, got, ref_streams)
    layers = t_model.num_layers
    if row["launches"] != layers * row["steps"] or not row["launches"] or \
            row["calls"] != row["launches"]:
        fail(f"[30] (c) B6 launches {row['launches']} (held calls {row['calls']}) != "
             f"{layers} layers x {row['steps']} decode steps")
    if row["excess"] > PAGED_ATOL:
        fail(f"[30] (c) B6 vs its plain version beyond atol {PAGED_ATOL} + rtol "
             f"{PAGED_RTOL}: excess {row['excess']:.3e}")
    spans, _ = trace.read_spans([str(span_dir)])
    summary = trace.summarize_traces(spans)
    doc = trace.chrome_trace(spans)
    problems = trace.validate_chrome(doc)
    (dirs["replica"] / "chrome_trace.json").write_text(json.dumps(doc))
    names = {s["name"] for s in spans}
    trees = trace.assemble(spans)
    want_trees = {f"smoke-{r.request_id}" for r in requests} | {"smoke-chaos"}
    if set(trees) != want_trees or summary["orphans"] or problems or not {
            "client", "queue_wait", "prefill", "decode", "resolve"} <= names or not names <= (
            set(trace.SEGMENTS) | {"client", "queue_wait", "decode"}):
        fail(f"[30] (c) span trees {sorted(trees)}, names {sorted(names)}, orphans "
             f"{summary['orphans']}, chrome problems {problems[:5]}")
    same = sum(got[r.request_id] == ref_streams[r.request_id] for r in requests)
    seg = summary["segments"]
    print(f"[30] (c) python -m {PKG}.serving.replica --kv-layout paged --page-size "
          f"{SERVE_PAGE} --num-slots {SERVE_SLOTS} --trace (device cuda), [25]'s trained LM "
          f"{SERVE_LM}: hello {list(hello)} caps {hello['caps']}, framed after hello_ack; "
          f"{REPLICA_REQUESTS} greedy requests through the port's wire, {same}/"
          f"{REPLICA_REQUESTS} streams equal to the in-process engine's, {ties} diverging at "
          f"a true tie; B6 launches {row['launches']} = {layers} layers x {row['steps']} "
          f"decode steps (the replica's own counter, outside the protocol), every call at q "
          f"{row['shapes']} held against the plain version (max |err| "
          f"{row['max_abs_err']:.3e}, within atol {PAGED_ATOL} + rtol {PAGED_RTOL}); "
          f"{len(trees) - 1} span trees with their client spans (+ the chaos request's), "
          f"{summary['spans']} spans, names {sorted(names)}, 0 orphans, validate_chrome: "
          f"no problem; critical path p50 ms "
          f"{ {k: round(v['p50'] * 1e3, 3) for k, v in seg.items()} }; ChaosProxy corrupt: "
          f"WireCorrupt({corrupt!r}) and the replica answered a legacy peer after it; "
          f"kill:step={REPLICA_KILL_STEP} exit {codes['kill']}; SIGTERM with a request in "
          f"flight (held by stall:step=3) exit {codes['term']} and no done line; stop exit "
          f"0; wire "
          f"{wire_s:.1f} s, replicas {replica_s:.1f} s [{card}]")

    # (a) and (b): the supervisors and their references
    for t in threads:
        t.join(timeout=600)
    for name, res in results.items():
        if isinstance(res, Exception):
            fail(f"[30] supervise {name}: {res!r}")
    ref_codes = {name: p.wait(timeout=300) for name, p in refs.items()}
    if ref_codes != {"unbroken": 0, "oracle": 0}:
        for name in refs:
            print((base / f"{name}.log").read_text()[-3000:], file=sys.stderr)
        fail(f"[30] reference runs exited {ref_codes}")

    def final(d: Path) -> bytes:
        return (d / "results" / "model.ckpt").read_bytes()

    def attempts(d: Path) -> list[dict]:
        return [json.loads(p.read_text()) for p in sorted(d.glob("attempt*.json"))]

    def restarts(d: Path) -> list[dict]:
        rows = [json.loads(line) for line in open(d / "supervisor.jsonl")]
        return [r for r in rows if r["event"] == "restart"]

    kill, nan = results["kill"], results["nan"]
    k_rows, n_rows = restarts(dirs["kill"]), restarts(dirs["nan"])
    k_att, n_att = attempts(dirs["kill"]), attempts(dirs["nan"])
    ref_k, ref_n = attempts(dirs["unbroken"])[0], attempts(dirs["oracle"])[0]
    torn_path = dirs["kill"] / "results" / "checkpoints" / checkpoint.versioned_name(steps)
    if (kill.status, kill.attempts, kill.restarts, kill.resume_history) != (
            "ok", 2, 1, [None, None]) or [(r["reason"], r["exit_code"]) for r in k_rows] != [
            ("crash", 41)] or not (base / "flags" / "torn.p0").exists():
        fail(f"[30] (a) supervise: {kill}, restarts {k_rows}")
    if len(k_att) != 1 or k_att[0]["launches"] != ref_k["launches"] or set(
            ref_k["launches"].values()) != {2 * steps}:
        fail(f"[30] (a) B1-B3 launches: restarted attempt {k_att}, unbroken {ref_k}")
    if final(dirs["kill"]) != final(dirs["unbroken"]):
        fail("[30] (a) the supervised run's final state differs from the unbroken run's")
    faulted = goodput.decompose([str(dirs["kill"])])
    clean = goodput.decompose([str(dirs["unbroken"] / "attempt0.jsonl")])
    for tag, rep in (("supervised", faulted), ("unbroken", clean)):
        if abs(sum(rep["segments"].values()) - rep["wall_s"]) > GOODPUT_TOL:
            fail(f"[30] (a) {tag} goodput segments sum to {sum(rep['segments'].values())} "
                 f"vs wall {rep['wall_s']}")
    if not faulted["segments"]["restart_badput_s"] > 0 or \
            clean["segments"]["restart_badput_s"] != 0.0 or faulted["attempts"] != 2:
        fail(f"[30] (a) goodput: supervised {faulted}, unbroken {clean}")
    fmt = lambda rep: {k: round(v, 4) for k, v in rep["segments"].items()}
    print(f"[30] (a) fleet_supervise over python -m {PKG}.train.single "
          f"--use-pallas-kernels --n-epochs 2 --keep-checkpoints 2 (captured, "
          f"{FAULT_TRAIN} examples, {steps} steps an epoch), RESILIENCE_FAULTS "
          f"kill:step={FAULT_KILL_STEP} + torn:match={torn_path.name}: attempt 1 exit 41, 1 "
          f"restart; the torn epoch-1 file was skipped (resume history "
          f"{kill.resume_history}: with it torn no healthy checkpoint was left, so the "
          f"restart began anew, and rewrote it whole); final model.ckpt bytes equal "
          f"to the unbroken run's; B1-B3 launches of the restarted attempt "
          f"{k_att[0]['launches']} = the unbroken run's (RESILIENCE_FAULTS unset there: an "
          f"unarmed step); goodput supervised: wall {faulted['wall_s']:.3f} s = "
          f"{fmt(faulted)} (restart badput {faulted['segments']['restart_badput_s']:.3f} s, "
          f"{faulted['epochs_replayed']} epoch replayed), unbroken: wall "
          f"{clean['wall_s']:.3f} s, restart badput 0.0; supervise {timings['kill']:.1f} s "
          f"[{card}]")
    if (nan.status, nan.attempts, nan.rollbacks, nan.skip_windows) != (
            "ok", 2, 1, ((FAULT_NAN_STEP, FAULT_NAN_STEP + 1),)) or [
            (r["reason"], r["exit_code"], r["skip"]) for r in n_rows] != [
            ("poisoned", poison.EXIT_POISONED, f"{FAULT_NAN_STEP}:{FAULT_NAN_STEP + 1}")]:
        fail(f"[30] (b) supervise: {nan}, restarts {n_rows}")
    if n_att[-1]["argv"][-2:] != ["--skip-steps", f"{FAULT_NAN_STEP}:{FAULT_NAN_STEP + 1}"]:
        fail(f"[30] (b) the restart's flags: {n_att[-1]['argv']}")
    if set(n_att[-1]["launches"].values()) != {steps} or \
            n_att[-1]["launches"] != ref_n["launches"]:
        fail(f"[30] (b) B1-B3 launches: {[a['launches'] for a in n_att]}, oracle "
             f"{ref_n['launches']} (want {steps} each)")
    if final(dirs["nan"]) != final(dirs["oracle"]):
        fail("[30] (b) the rolled-back run's final state differs from the oracle's")
    poisoned = goodput.decompose([str(dirs["nan"])])
    if abs(sum(poisoned["segments"].values()) - poisoned["wall_s"]) > GOODPUT_TOL or not \
            poisoned["segments"]["rollback_badput_s"] > 0:
        fail(f"[30] (b) goodput: {poisoned}")
    print(f"[30] (b) fleet_supervise over train.single --use-pallas-kernels --guard "
          f"--anomaly-exit 1 (captured), RESILIENCE_FAULTS nan:step={FAULT_NAN_STEP} (a "
          f"torch.where on the device-resident step inside the CUDA graph): attempt 1 exit "
          f"{n_rows[0]['exit_code']}, marker window {nan.skip_windows[0]}, restart with "
          f"--skip-steps {n_rows[0]['skip']} (the poison fires again at step "
          f"{FAULT_NAN_STEP} and is skipped); final model.ckpt bytes equal to the oracle's "
          f"(--skip-steps from the start, RESILIENCE_FAULTS unset); B1-B3 launches of the "
          f"replayed attempt {n_att[-1]['launches']} = its {steps} replayed steps = the "
          f"oracle's; goodput: rollback badput "
          f"{poisoned['segments']['rollback_badput_s']:.3f} s of wall "
          f"{poisoned['wall_s']:.3f} s; supervise {timings['nan']:.1f} s [{card}]")
    print(f"[30] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"b1_b3": {"supervised train.single, restarted attempt [30] (a)": k_att[0][
        "launches"], "rolled-back train.single, replayed attempt [30] (b)": n_att[-1][
        "launches"]}, "b6": {"replica process, paged [30] (c)": row["launches"]}}


FLEET_REQUESTS = 16            # [31] (a): greedy requests, half of them sharing a prefix
FLEET_SHARED = 128             # (a): the shared prompts' common prefix (two pages)
FLEET_MAX_NEW = 48             # (a): new tokens a request
FLEET_KILL_STEP = 20           # (a): replica 1's decode step at its kill, mid-decode
FLEET_PREFIX_CACHE = 16        # the unified replicas' prefix-cache entries
FLEET_TIMEOUT = 300.0          # seconds a batch of futures may take
TIER_REQUESTS = 8              # (c): prompts of 64-256 tokens
TIER_MAX_NEW = 32
TIER_CHAOS = "corrupt:dir=c2s,after=1,conn=0"    # (c): the first handoff's 2nd unit damaged
PROMOTE_EVAL_ROWS = 8          # (e): the gate's held-out test images, scored by decode_nll
PROMOTE_PROMPT = 592           # (e): the canary traffic's prompts, 192 new tokens each: every
                               # completion a full 784-token sample for the scorer
PROMOTE_ROUND = 8              # (e): fresh requests a dwell round
PROMOTE_ROUNDS = 8             # (e): dwell rounds at most (both sides need PROMOTE_MIN)
PROMOTE_MIN = 3                # (e): completions on each side of the canary comparison
PROMOTE_WINDOW = 1.0           # (e): the canary window's seconds (the dwell's floor)
PROMOTE_NLL_MARGIN = 0.5       # (e): canary vs fleet sampled NLL (different prompts a side)
PROMOTE_ROLL_TRAFFIC = (64, 8)  # (e): prompt and new tokens of the requests during the rolls
PROMOTE_ROLL_PAUSE = 0.25      # (e): seconds between those requests' pairs
PROMOTE_PERF_PROBES = 1        # (e): timed decode_nll probes a gate (each 784 steps)
PROMOTE_IDS = (1000, 1160)     # (e): the test images it draws (gate rows, then prompts)


def fleet_replica_child() -> None:
    """Phases 31, 34: one replica of a fleet (``serving.replica.main`` with the router's
    argv after ``<out dir>``; under ``--shard`` one rank of its world), every B6 call held
    against ``paged_attend_reference``. When the process ends through ``main``'s return
    (``stop``, a follower's end) or an exit through ``os._exit`` (a drain, a follower's
    SIGTERM), it writes ``<out dir>/replica<id>_<pid>.json``: its rank and world, B6's
    launch count and the held calls since the warm-up, the engine's decode steps and
    prefill tokens (zeroed by the warm-up's ``reset_stats``), its prefix cache's counters
    and a decode replica's handoff ledger. A killed process writes nothing. ``SMOKE_HANDOFF_CHAOS``, where set, puts a ``ChaosProxy`` of that schedule in
    front of a decode replica's handoff listener (the port the hello advertises is the
    proxy's)."""
    out, argv = Path(sys.argv[1]), sys.argv[2:]
    sys.path.insert(0, str(ROOT))
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        paged_attention as paged,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
        netfaults,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        replica,
    )

    rid = int(argv[argv.index("--replica-id") + 1])
    engines, errs, excess, shapes, handoff = [], [], [], set(), []
    real, build = paged.paged_attend, replica.build_engine_server

    def spy(q, k_pool, v_pool, table, t, **kw):
        got = real(q, k_pool, v_pool, table, t, **kw)
        want = paged.paged_attend_reference(q, k_pool, v_pool, table, t, **kw)
        errs.append((got - want).abs().max().item())
        excess.append(errs[-1] - PAGED_RTOL * want.abs().max().item())
        shapes.add(tuple(q.shape))
        return got

    def hold(args, trace=None):
        engine, server = build(args, trace=trace)     # its warm-up served: counts to 0
        engines.append(engine)
        paged.reset_launch_counts()
        del errs[:], excess[:]
        shapes.clear()
        return engine, server

    def dump(rc: int) -> None:
        eng = engines[0] if engines else None
        cache = getattr(eng, "prefix_cache", None)
        write_json(out / f"replica{rid}_{os.getpid()}.json", {
            "rc": rc, "replica": rid, "pid": os.getpid(),
            "rank": int(os.environ.get("RANK", "0")),     # a sharded replica's world
            "world": os.environ.get("MASTER_PORT"),      # one rendezvous port a world
            "launches": paged.launch_counts()["paged_attend"],
            "calls": len(errs), "steps": eng.steps if eng else None,
            "prefill_tokens": eng.prefill_tokens if eng else None,
            "prefix_cache": cache.stats() if cache is not None else None,
            "handoff": handoff[0].snapshot() if handoff else None,
            "max_abs_err": max(errs) if errs else None,
            "excess": max(excess) if excess else None,
            "shapes": sorted(map(list, shapes))})

    # Several threads may end the process at once (a dead rank fails every request
    # thread while the world's SIGTERM reaches the main thread): the first writes the
    # counters and exits, the others wait for that. Re-entrant for a signal handler that
    # interrupts the main thread inside it.
    exiting = threading.RLock()

    class ExitShim:         # a drain ends the process with os._exit(0) from its thread
        def __getattr__(self, name):
            return getattr(os, name)

        def _exit(self, code):
            with exiting:
                dump(code)
                os._exit(code)

    chaos = os.environ.get("SMOKE_HANDOFF_CHAOS")
    listen = replica._start_handoff_listener

    def proxied(args, engine, state, stop_flag):
        handoff.append(state)
        port = listen(args, engine, state, stop_flag)
        if not chaos:
            return port
        return netfaults.ChaosProxy(port, chaos, proxy_id=rid, seed=31).start()

    replica._start_handoff_listener = proxied
    paged.paged_attend, replica.build_engine_server = spy, hold
    replica.os = ExitShim()
    rc = replica.main(argv)
    with exiting:
        dump(rc)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)      # as the replica's own __main__: no teardown under live threads


def _generations(out_dir: Path) -> list[dict]:
    return [json.loads(p.read_text()) for p in sorted(out_dir.glob("replica*_*.json"))]


def jax_fleet_summary_keys() -> set[str]:
    """The keys ``tools/serve_loadgen.py`` writes for a fleet run, read off its source (the
    file's text, not an import): its ``doc = {...}`` and the fleet branch's
    ``doc.update`` (the one that writes ``replicas``)."""
    import ast

    tree = ast.parse((ROOT / "tools" / "serve_loadgen.py").read_text(encoding="utf-8"))
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys: set[str] = set()
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "doc" for t in node.targets)):
            keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update" and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "doc"):
            kws = {kw.arg for kw in node.keywords}
            if "replicas" in kws:
                keys |= kws
    return keys


def jax_event_keys(name: str) -> set[str]:
    """The keys of the dict the JAX package's ``utils/telemetry.py::<name>`` returns, read
    off its source (the file's text, not an import)."""
    import ast

    path = ROOT / "csed_514_project_distributed_training_using_pytorch_tpu" / "utils" / \
        "telemetry.py"
    tree = ast.parse(path.read_text(encoding="utf-8"))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys if isinstance(k, ast.Constant)}


def promoter_phase(router, t_model, ckpt: Path, eval_ids, dev, out: Path) -> dict:
    """[31] (e): ``deploy.Promoter`` over (a)-(b)'s fleet and a versioned store beside it.
    The probes are the port tool's ``train_serve_loop.Scorers`` on [25]'s model over
    ``PROMOTE_EVAL_ROWS`` held-out test images. [25]'s trained LM is published clean (it
    gates, canaries on one replica, and is promoted fleet-wide); the tool's
    ``publish_corrupted`` copy of that incumbent (every float leaf + N(0, 2), seed 31, a
    clean stamp) is rejected at the NLL gate; a copy with the head negated passes a
    loosened gate (no NLL budget, no perf probe) into the canary, where the
    incumbent-scored NLL of its sampled tokens rolls it back. The canary window's dwell
    serves rounds of fresh full-length requests until both sides hold ``PROMOTE_MIN``
    completions; every promote and rollback roll runs under short requests. Returns the
    readings for the checks after the fleet stops."""
    import argparse

    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch import deploy
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        lm as lm_train, step as st,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train_serve_loop import (
        Scorers, publish_corrupted,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint, telemetry,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        LMConfig,
    )

    store, ledger, stream = out / "store", out / "promotion.jsonl", out / "promote.jsonl"
    seq = t_model.seq_len
    scorers = Scorers(argparse.Namespace(device=str(dev)), model=t_model,
                      eval_rows=eval_ids[:PROMOTE_EVAL_ROWS])
    state = checkpoint.restore_train_state(str(ckpt), st.create_train_state(
        lm.TransformerLM(**SERVE_LM), torch.Generator().manual_seed(0),
        optimizer=lm_train.lm_optimizer(LMConfig())))
    step0 = int(state.step)
    flipped = dict(state.params, head_kernel=-state.params["head_kernel"])
    fresh = iter(range(PROMOTE_EVAL_ROWS + PROMOTE_ROUND, len(eval_ids)))
    reused = itertools.cycle(range(PROMOTE_EVAL_ROWS, PROMOTE_EVAL_ROWS + PROMOTE_ROUND))
    rounds, rolls, roll_ok = [], [], []

    def publish(step: int, params: dict) -> str:
        stamp = {"clean": True, "anomalies": 0, "skipped": 0, "step": step,
                 "fingerprint": telemetry.param_fingerprint(params)}
        return checkpoint.save_versioned(
            str(store), state._replace(params=params, step=torch.tensor(step)), keep=8,
            health=stamp, cursor={"version": 1, "kind": "epoch", "seed": 1, "epoch": 2,
                                  "batch": 0, "step": step})

    def burst(rows, n: int, prompt_len: int, max_new: int) -> list:
        rows = [next(rows) for _ in range(n)]
        futs = [router.submit(eval_ids[r, :prompt_len].copy(), max_new_tokens=max_new)
                for r in rows]
        return [f.result(timeout=FLEET_TIMEOUT) for f in futs]

    def dwell(window_s: float) -> None:
        """The canary window: rounds of fresh full-length requests, at least
        ``window_s`` seconds and until both sides hold PROMOTE_MIN completions and a
        full-length sample."""
        t0, n = time.perf_counter(), 0
        while True:
            comps = burst(fresh, PROMOTE_ROUND, PROMOTE_PROMPT, seq - PROMOTE_PROMPT)
            if not all(c.ok for c in comps):
                raise RuntimeError(f"(e) dwell: finishes {[c.finish for c in comps]}")
            n += 1
            rep = router.canary_report()
            full = [any(len(x["tokens"]) == seq for x in rep[side])
                    for side in ("canary_samples", "fleet_samples")]
            if (rep["canary"]["requests"] >= PROMOTE_MIN
                    and rep["fleet"]["requests"] >= PROMOTE_MIN and all(full)
                    and time.perf_counter() - t0 >= window_s):
                rounds.append((n, rep["canary"]["requests"], rep["fleet"]["requests"]))
                return
            if n >= PROMOTE_ROUNDS:
                raise RuntimeError(f"(e) dwell: {n} rounds left canary {rep['canary']}, "
                                   f"fleet {rep['fleet']}, full samples {full}")

    class Fleet:
        """The router as the promoter sees it: promote and rollback rolls run under
        short requests on a thread, each of which must finish ok."""

        def canary_reload(self, path):
            rolls.append(("canary", router.canary_reload(path)))
            return rolls[-1][1]

        def canary_report(self):
            return router.canary_report()

        def _under_traffic(self, name, fn):
            stop, done = threading.Event(), []

            def traffic():
                while not stop.wait(PROMOTE_ROLL_PAUSE):
                    done.extend(burst(reused, 2, *PROMOTE_ROLL_TRAFFIC))

            t = threading.Thread(target=traffic, name="promote-traffic")
            t.start()
            try:
                rolls.append((name, fn()))
            finally:
                stop.set()
                t.join(timeout=FLEET_TIMEOUT)
            roll_ok.append((name, len(done), sum(c.ok for c in done)))
            return rolls[-1][1]

        def promote_canary(self):
            return self._under_traffic("promote", router.promote_canary)

        def rollback_canary(self):
            return self._under_traffic("rollback", router.rollback_canary)

    promoter = deploy.Promoter(
        str(store), router=Fleet(), nll_fn=scorers.nll, perf_fn=scorers.perf,
        sample_nll_fn=lambda samples: scorers.sample_nll(samples, promoter.incumbent),
        gate=deploy.GateConfig(perf_probes=PROMOTE_PERF_PROBES),
        canary=deploy.CanaryConfig(window_s=PROMOTE_WINDOW, min_requests=PROMOTE_MIN,
                                   nll_margin=PROMOTE_NLL_MARGIN),
        ledger_path=str(ledger), telemetry=str(stream), incumbent=str(ckpt),
        dwell_fn=dwell)
    walls, actions, names = {}, [], {}
    for tag, step, params in (("clean", step0 + 1, state.params),
                              ("noisy", step0 + 2, None),
                              ("flipped", step0 + 3, flipped)):
        if tag == "noisy":         # the tool's corrupted republish of the incumbent
            path = publish_corrupted(str(store), promoter.incumbent, step=step, seed=31)
        else:
            path = publish(step, params)
        names[tag] = os.path.basename(path)
        if tag == "flipped":       # the loosened gate: no NLL budget, no perf probe
            promoter.gate = deploy.GateConfig(nll_budget=float("inf"))
            promoter.perf_fn = None
        t0 = time.perf_counter()
        actions += promoter.run_once()
        walls[tag] = time.perf_counter() - t0
    promoter.close()
    return {"actions": actions, "names": names, "walls": walls, "rounds": rounds,
            "rolls": rolls, "roll_ok": roll_ok, "incumbent": promoter.incumbent,
            "incumbent_nll": promoter.incumbent_nll, "command": list(router._command),
            "ledger": deploy.read_ledger(str(ledger)),
            "events": [json.loads(line) for line in open(stream)]}


def check_promotion(e: dict, wall_s: float, card: str) -> None:
    """[31] (e)'s checks on ``promoter_phase``'s readings, and its line: the terminal
    actions, the ledger's transitions in order, the incumbent and the fleet's command on
    the clean candidate, the events with the JAX package's keys, every request during the
    rolls ok."""
    names = e["names"]
    want_ledger = ["candidate_seen", "gate_pass", "canary_start", "canary_pass", "promoted",
                   "candidate_seen", "gate_fail",
                   "candidate_seen", "gate_pass", "canary_start", "canary_fail",
                   "rolled_back"]
    ledger = e["ledger"]
    by = {row["action"] + ":" + row["candidate"]: row for row in ledger}
    clean_path = str(OUT_DIR / "fleet" / "unified" / "store" / names["clean"])
    if e["actions"] != ["promoted", "gate_fail", "rolled_back"] or \
            [r["action"] for r in ledger] != want_ledger or \
            [r["candidate"] for r in ledger] != [names["clean"]] * 5 + [names["noisy"]] * 2 \
            + [names["flipped"]] * 5 or \
            by["gate_fail:" + names["noisy"]]["reason"] != "nll_over_budget" or \
            e["incumbent"] != clean_path or \
            e["command"][e["command"].index("--checkpoint") + 1] != clean_path:
        fail(f"[31] (e) actions {e['actions']}, ledger {[(r['action'], r['candidate']) for r in ledger]}, "
             f"incumbent {e['incumbent']}, fleet command {e['command']}")
    keys = {"promote": jax_event_keys("promote_event"), "canary": jax_event_keys("canary_event")}
    bad_keys = [ev for ev in e["events"] if set(ev) - {"t_s"} != keys[ev["event"]]]
    kinds = [(ev["event"], ev.get("action") or ev.get("verdict")) for ev in e["events"]]
    if bad_keys or kinds.count(("canary", "pass")) != 1 or \
            kinds.count(("canary", "fail")) != 1 or ("promote", "promoted") not in kinds or \
            ("promote", "rolled_back") not in kinds:
        fail(f"[31] (e) events {kinds}; keys differing from the JAX package's: {bad_keys}")
    if any(ok != n or not n for _, n, ok in e["roll_ok"]):
        fail(f"[31] (e) requests during the rolls (roll, sent, ok): {e['roll_ok']}")
    passed = by["canary_pass:" + names["clean"]]
    failed = by["canary_fail:" + names["flipped"]]
    noisy = by["gate_fail:" + names["noisy"]]
    print(f"[31] (e) deploy.Promoter over this fleet and a versioned store "
          f"(utils.checkpoint.save_versioned, clean health stamps), the port tool's "
          f"train_serve_loop.Scorers (decode_nll on the card) over {PROMOTE_EVAL_ROWS} test "
          f"images: [25]'s LM as {names['clean']}: gate NLL "
          f"{by['gate_pass:' + names['clean']]['nll']:.6f} vs the incumbent's "
          f"{by['gate_pass:' + names['clean']]['incumbent_nll']:.6f}, perf "
          f"{by['gate_pass:' + names['clean']]['perf_s']:.3f} s vs "
          f"{by['gate_pass:' + names['clean']]['incumbent_perf_s']:.3f} s; canary on "
          f"replica {passed['replica']} ({passed['canary_requests']} vs "
          f"{passed['fleet_requests']} requests, sampled NLL {passed['canary_nll']:.4f} vs "
          f"{passed['fleet_nll']:.4f}) -> promoted fleet-wide; {names['noisy']} (the tool's "
          f"publish_corrupted: every float leaf + N(0, 2)): gate NLL {noisy['nll']:.4f} > "
          f"{noisy['incumbent_nll']:.4f} + 0.05 "
          f"-> gate_fail, never on the fleet; {names['flipped']} (head negated, loosened "
          f"gate): canary sampled NLL {failed['canary_nll']:.4f} > fleet "
          f"{failed['fleet_nll']:.4f} + {PROMOTE_NLL_MARGIN} -> rolled back; ledger "
          f"{len(ledger)} rows in order, {len(e['events'])} promote/canary events with the "
          f"JAX package's keys; dwell rounds (rounds, canary, fleet) {e['rounds']}; requests "
          f"during the rolls (roll, sent, ok) {e['roll_ok']}; walls "
          f"{ {k: round(v, 1) for k, v in e['walls'].items()} } s, (e) {wall_s:.1f} s "
          f"[{card}]")


def fleet_requests(test_ids) -> list:
    """[31] (a)'s and [34]'s greedy requests: 8 prompts on one ``FLEET_SHARED``-token
    prefix of a test image and 8 of their own, ``FLEET_MAX_NEW`` new tokens each."""
    import numpy as np

    from csed_514_project_distributed_training_using_pytorch_tpu_torch import serving

    rng = np.random.default_rng(31)
    shared = test_ids[0, :FLEET_SHARED]
    reqs = []
    for i in range(FLEET_REQUESTS):
        if i % 2 == 0:
            tail = test_ids[1 + i, FLEET_SHARED:FLEET_SHARED + int(rng.integers(16, 97))]
            prompt = np.concatenate([shared, tail])
        else:
            prompt = test_ids[1 + i, :int(rng.integers(48, 257))].copy()
        reqs.append(serving.Request(prompt=prompt.astype(np.int32),
                                    max_new_tokens=FLEET_MAX_NEW, request_id=i))
    return reqs


def fleet_phase(dev, card: str, t_model, t_params: dict, ckpt: Path, test_ids, serve,
                compare_streams, warmup, eval_ids) -> dict:
    """Phase 31: the serving fleet on the card, every process a port entry point. (a)
    ``serving.router.Router`` over 2 unified paged replicas (B6) with affinity: 16 greedy
    requests, half sharing a prefix, replica 1 killed mid-decode: zero loss, one restart,
    streams equal to the in-process paged engine's up to true ties, each replica's B6
    launches = layers x its own decode steps, every call held against the plain version;
    (b) ``scale_up`` to 3 with warm prefixes (the new replica's first affine request a
    prefix-cache hit), ``scale_down`` to 2 with work in flight, a rolling ``reload`` onto
    the same checkpoint; (c) ``--tier prefill`` + ``--tier decode`` contiguous replicas:
    handed-off streams equal to the contiguous engine's, the decode tier prefilling
    nothing, the handoff bytes the layout's plane bytes; then a ``ChaosProxy`` corrupting
    the first handoff: local prefill, zero loss; (d) ``python -m <port>.serve_loadgen
    --replicas 2``: the JAX tool's fleet keys. (a)-(b) and (c)-(d) run at once in two
    threads while this process serves the references; then (e) the promotion gate on
    (a)-(b)'s fleet (``promoter_phase``, alone on the card: its perf gate times
    ``decode_nll``): [25]'s LM published clean and promoted through a canary, a noisy copy
    rejected at the NLL gate, a head-negated copy rolled back at the canary by the sampled
    NLL, the ledger and the events in the JAX package's order and keys, every future ok.
    Returns B6's launches by replica process for the kernels line."""
    import numpy as np
    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import quant
    from csed_514_project_distributed_training_using_pytorch_tpu_torch import serving
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import SLOSpec
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import (
        Router,
    )

    t_phase = time.perf_counter()
    base = OUT_DIR / "fleet"
    shutil.rmtree(base, ignore_errors=True)
    dirs = {name: base / name for name in ("unified", "tiers", "chaos", "loadgen")}
    for d in dirs.values():
        d.mkdir(parents=True)
    cpu = dev.type != "cuda"              # a CPU rehearsal asks its replicas for the CPU
    device_flags = ["--device", "cpu"] if cpu else []
    layers = t_model.num_layers

    # the workloads: (a) 8 prompts on one 128-token prefix and 8 of their own, (c) 64-256
    fleet_reqs = fleet_requests(test_ids)
    tier_reqs = [serving.Request(prompt=test_ids[20 + i, :64 + 24 * i].copy(),
                                 max_new_tokens=TIER_MAX_NEW, request_id=i)
                 for i in range(TIER_REQUESTS)]
    chaos_reqs = tier_reqs[:4]

    def env_of(faults: str | None = None, chaos: str | None = None) -> dict:
        env = _child_env(faults)
        env["OMP_NUM_THREADS"] = "2"
        if chaos:
            env["SMOKE_HANDOFF_CHAOS"] = chaos
        return env

    def router_of(name: str, flags: list[str], n: int, env: dict, **kw) -> Router:
        return Router(_child_command("fleet_replica_child", str(dirs[name])) + flags
                      + device_flags, num_replicas=n, env=env,
                      heartbeat_dir=str(dirs[name] / "hb"), heartbeat_timeout_s=60.0,
                      backoff_s=0.5, telemetry=str(dirs[name] / "router.jsonl"), **kw)

    def submit_all(router, reqs, extend: int = 0):
        futs = {r.request_id: router.submit(
            np.concatenate([r.prompt, r.prompt[:extend]]) if extend else r.prompt,
            max_new_tokens=r.max_new_tokens) for r in reqs}
        return {rid: f.result(timeout=FLEET_TIMEOUT) for rid, f in futs.items()}

    paged_flags = ["--checkpoint", str(ckpt), "--kv-layout", "paged", "--page-size",
                   str(SERVE_PAGE), "--num-slots", str(SERVE_SLOTS), "--prefix-cache",
                   str(FLEET_PREFIX_CACHE)]
    contiguous_flags = ["--checkpoint", str(ckpt), "--num-slots", str(SERVE_SLOTS)]
    results, errors, walls = {}, {}, {}
    routers: list[Router] = []
    unified_up = threading.Event()

    def unified() -> None:       # (a) then (b)
        t0 = time.perf_counter()
        kill = f"kill:proc=1,step={FLEET_KILL_STEP},flag={dirs['unified'] / 'kill_flag'}"
        router = router_of("unified", paged_flags, 2, env_of(kill), warm_prefixes=8,
                           snapshot_interval_s=0.5, sample_completions=4,
                           slo=SLOSpec.parse("ttft=30,e2e=120,window=600"))
        routers.append(router)
        router.start()
        ready = router.wait_ready(timeout=FLEET_TIMEOUT)
        unified_up.set()
        if not ready:
            raise RuntimeError("(a) the fleet did not come up")
        results["start_s"] = time.perf_counter() - t0
        results["a"] = submit_all(router, fleet_reqs)
        deadline = time.monotonic() + 120
        while router.replicas[1].restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        # the restarted replica is warm-started with the hot prefixes too, and the last
        # warm start owns them: it must be ready before the scale-up's
        if not router.wait_ready(timeout=FLEET_TIMEOUT):
            raise RuntimeError("(a) replica 1 did not come back")
        walls["a"] = time.perf_counter() - t0
        # (b) scale-up with warm prefixes: the new replica's first affine request
        t0 = time.perf_counter()
        new = router.scale_up()
        if new is None or not router.wait_ready(timeout=FLEET_TIMEOUT):
            raise RuntimeError(f"(b) scale_up gave {new}, not ready")
        results["warmed"] = router.replicas[new].warmed
        first = None
        for r in fleet_reqs:           # one at a time, until one lands on the new replica
            c = submit_all(router, [r], extend=8)[r.request_id]
            if not c.ok:
                raise RuntimeError(f"(b) request {r.request_id}: {c.finish}")
            if c.replica == new:
                first = c
                break
        results["first_affine"] = first
        hits = None
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:     # the snapshot loop's poll of its counters
            row = router.fleet_snapshot()["per_replica"][new]
            if "prefix_hit_rate" in row:
                hits = row["prefix_hit_rate"]
                break
            time.sleep(0.1)
        results["first_hit_rate"] = hits
        walls["scale_up"] = time.perf_counter() - t0
        # scale-down with work in flight
        t0 = time.perf_counter()
        futs = {r.request_id: router.submit(r.prompt, max_new_tokens=r.max_new_tokens)
                for r in fleet_reqs[:8]}
        results["retired"] = router.scale_down()
        results["b_down"] = {rid: f.result(timeout=FLEET_TIMEOUT) for rid, f in futs.items()}
        walls["scale_down"] = time.perf_counter() - t0
        # a rolling reload onto the same checkpoint, then (a)'s requests again
        t0 = time.perf_counter()
        results["reload"] = router.reload(str(ckpt))
        results["b_reload"] = submit_all(router, fleet_reqs)
        walls["reload"] = time.perf_counter() - t0
        results["unified"] = router        # (e) runs on it once (c)-(d) are done

    def tiers() -> None:          # (c) then (d)
        # the unified fleet starts first, alone on the host's cores: it is the longer path
        unified_up.wait(timeout=FLEET_TIMEOUT)
        t0 = time.perf_counter()
        roles = [["--tier", "prefill"], ["--tier", "decode"]]
        clean = router_of("tiers", contiguous_flags, 2, env_of(), replica_extra_args=roles)
        faulty = router_of("chaos", contiguous_flags, 2, env_of(chaos=TIER_CHAOS),
                           replica_extra_args=roles)
        routers.extend((clean, faulty))
        clean.start(), faulty.start()
        if not (clean.wait_ready(timeout=FLEET_TIMEOUT)
                and faulty.wait_ready(timeout=FLEET_TIMEOUT)):
            raise RuntimeError("(c) the tiered fleets did not come up")
        results["c"] = submit_all(clean, tier_reqs)
        results["summary_c"] = clean.stop(timeout=FLEET_TIMEOUT)
        results["c_chaos"] = submit_all(faulty, chaos_reqs)
        results["summary_chaos"] = faulty.stop(timeout=FLEET_TIMEOUT)
        walls["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = dirs["loadgen"] / "summary.json"
        code = subprocess.run(
            [sys.executable, "-m", f"{PKG}.serve_loadgen", "--replicas", "2",
             "--checkpoint", str(ckpt), "--kv-layout", "paged", "--page-size",
             str(SERVE_PAGE), "--num-slots", str(SERVE_SLOTS), "--prefix-cache", "8",
             "--requests", "16", "--max-new-tokens", "32", "--prompt-lens", "0,64,160",
             "--rate", "64", "--summary-json", str(out), "--telemetry",
             str(dirs["loadgen"] / "router.jsonl"), *device_flags],
            cwd=ROOT, env=env_of(), stdout=open(dirs["loadgen"] / "loadgen.log", "w"),
            stderr=subprocess.STDOUT, timeout=600).returncode
        results["d"] = (code, json.loads(out.read_text()) if out.exists() else None)
        walls["d"] = time.perf_counter() - t0

    def guarded(name, fn):
        try:
            fn()
        except BaseException as e:             # noqa: BLE001 — surfaced below
            errors[name] = e
        finally:
            unified_up.set()

    threads = [threading.Thread(target=guarded, args=(n, f), name=f"fleet-{n}")
               for n, f in (("unified", unified), ("tiers", tiers))]
    for t in threads:
        t.start()
    try:
        # meanwhile: the in-process references (paged with B6; contiguous for the tiers)
        _, ref_paged, _, _ = serve(t_model, t_params, "paged", fleet_reqs, warmup)
        _, ref_contig, _, _ = serve(t_model, t_params, "contiguous", tier_reqs, warmup)
        for t in threads:
            t.join(timeout=1800)
        if not errors:
            # (e) the promotion gate on (a)-(b)'s fleet, alone on the card
            t0 = time.perf_counter()
            results["before_e"] = {p.name for p in dirs["unified"].glob("replica*_*.json")}
            try:
                results["e"] = promoter_phase(results["unified"], t_model, ckpt, eval_ids,
                                              dev, dirs["unified"])
            except BaseException as e:           # noqa: BLE001 — surfaced below
                errors["promoter"] = e
            walls["e"] = time.perf_counter() - t0
            results["summary_a"] = results["unified"].stop(timeout=FLEET_TIMEOUT)
    finally:
        for router in routers:           # a failed check leaves no replica behind
            if router.last_summary is None:
                try:
                    router.stop(drain=False, timeout=10)
                except Exception:        # noqa: BLE001 — teardown of a failed phase
                    pass
    if errors:
        for name in ("unified", "tiers", "chaos", "loadgen"):
            for log in sorted(dirs[name].glob("*.log")):
                print(log.read_text()[-3000:], file=sys.stderr)
        fail(f"[31] {errors}")
    params_dev = {k: p.to(dev) for k, p in t_params.items()}

    def streams(comps: dict, tag: str, n: int) -> dict:
        if len(comps) != n or not all(c.ok for c in comps.values()):
            fail(f"[31] {tag}: {n} requests, finishes {[c.finish for c in comps.values()]}")
        return {rid: c.tokens.tolist() for rid, c in comps.items()}

    # (a)
    a = results["a"]
    got_a = streams(a, "(a)", FLEET_REQUESTS)
    ties_a = compare_streams("[31] (a)", t_model, params_dev, fleet_reqs, got_a, ref_paged)
    summ = results["summary_a"]
    rows = [json.loads(line) for line in open(dirs["unified"] / "router.jsonl")]
    fails = [r for r in rows if r["event"] == "replica" and r.get("action") == "fail"]
    if len(fails) != 1 or fails[0]["reason"] != "crash" or fails[0]["replica"] != 1:
        fail(f"[31] (a) replica failures {fails}")
    router_restarts = sum(r["restarts"] for r in summ["per_replica"])
    redispatched = sum(c.redispatches > 0 for c in a.values())
    affinity = sum(c.affinity_hit for c in a.values())
    if router_restarts != 1 or not redispatched or not affinity:
        fail(f"[31] (a) restarts {router_restarts}, redispatched {redispatched}, affinity "
             f"hits {affinity}")
    gens = _generations(dirs["unified"])
    for g in gens:
        want = layers * g["steps"]
        if g["calls"] != want or (not cpu and g["launches"] != want):
            fail(f"[31] replica {g['replica']}: B6 launches {g['launches']} (held "
                 f"calls {g['calls']}) != {layers} layers x {g['steps']} decode steps")
        if g["excess"] is not None and g["excess"] > PAGED_ATOL:
            fail(f"[31] replica {g['replica']}: B6 vs its plain version beyond atol "
                 f"{PAGED_ATOL} + rtol {PAGED_RTOL}: excess {g['excess']:.3e}")
    before_e = results["before_e"]

    def sub_phase(g: dict) -> str:
        """(a)-(b) for a replica process that stopped before (e) began, else (b)-(e)."""
        return ("(a)-(b)" if f"replica{g['replica']}_{g['pid']}.json" in before_e
                else "(b)-(e)")

    b6 = {f"fleet replica {g['replica']}, process {g['pid']} [31] {sub_phase(g)}":
          g["launches"] for g in gens}
    max_err = max((g["max_abs_err"] or 0.0) for g in gens)
    same_a = sum(got_a[r.request_id] == ref_paged[r.request_id] for r in fleet_reqs)
    print(f"[31] (a) Router over 2 python -m {PKG}.serving.replica processes (paged, pages "
          f"of {SERVE_PAGE}, {SERVE_SLOTS} slots, prefix cache {FLEET_PREFIX_CACHE}, "
          f"affinity on; device cuda by the replica's default), [25]'s trained LM "
          f"{SERVE_LM}: {FLEET_REQUESTS} greedy requests (8 on one {FLEET_SHARED}-token "
          f"prefix), kill:proc=1,step={FLEET_KILL_STEP} mid-decode: {len(a)} ok, "
          f"{redispatched} redispatched, {router_restarts} restart (replica 1, crash); "
          f"{same_a}/{FLEET_REQUESTS} streams equal to the in-process paged engine's, "
          f"{ties_a} diverging at a true tie; affinity hits {affinity}; ready in "
          f"{results['start_s']:.1f} s, (a) {walls['a']:.1f} s [{card}]")
    # (b)
    first, rate = results["first_affine"], results["first_hit_rate"]
    if first is None or not first.affinity_hit or rate != 1.0 or not results["warmed"]:
        fail(f"[31] (b) scale-up: warmed {results['warmed']}, first request on the new "
             f"replica {first}, its prefix hit rate {rate}")
    got_down = streams(results["b_down"], "(b) scale-down", 8)
    ties_down = compare_streams("[31] (b) scale-down", t_model, params_dev, fleet_reqs[:8],
                                got_down, ref_paged)
    got_reload = streams(results["b_reload"], "(b) reload", FLEET_REQUESTS)
    ties_reload = compare_streams("[31] (b) reload", t_model, params_dev, fleet_reqs,
                                  got_reload, ref_paged)
    unchanged = sum(got_reload[i] == got_a[i] for i in got_a)
    reload = results["reload"]
    e = results["e"]
    e_rolls = sum(len(r["promoted"]) if name == "promote" else 1 for name, r in e["rolls"])
    if results["retired"] is None or summ["scale"]["retired"] != 1 or \
            len(reload["reloaded"]) != 2 or \
            summ["scale"]["reloads"] != len(reload["reloaded"]) + e_rolls or \
            summ["ok"] != summ["requests"]:
        fail(f"[31] (b) retired {results['retired']}, scale {summ['scale']}, ok "
             f"{summ['ok']} of {summ['requests']}")
    print(f"[31] (b) scale_up 2 -> 3: replica {len(summ['per_replica']) - 1} warmed "
          f"{results['warmed']} hot prefixes, its first affine request (replica "
          f"{first.replica}, affinity hit) a prefix-cache hit (hit rate {rate}) "
          f"({walls['scale_up']:.1f} s); scale_down -> 2 with 8 requests in flight: replica "
          f"{results['retired']} retired, 8/8 ok, {ties_down} ties "
          f"({walls['scale_down']:.1f} s); reload onto the same checkpoint, one replica at "
          f"a time (replicas {reload['reloaded']}, {reload['wall_s']:.1f} s), then (a)'s {FLEET_REQUESTS} requests: {unchanged}/"
          f"{FLEET_REQUESTS} streams unchanged from (a), {ties_reload} ties against the "
          f"in-process engine ({walls['reload']:.1f} s); router: {summ['ok']} ok of "
          f"{summ['requests']}, {summ['redispatches']} redispatches, {summ['duplicates']} "
          f"duplicates; B6 by replica process {list(b6.values())} = {layers} x their own "
          f"decode steps {[g['steps'] for g in gens]}, every call within atol {PAGED_ATOL} "
          f"+ rtol {PAGED_RTOL} of the plain version (max |err| {max_err:.3e}) [{card}]")
    # (e)
    check_promotion(e, walls["e"], card)
    # (c)
    got_c = streams(results["c"], "(c)", TIER_REQUESTS)
    ties_c = compare_streams("[31] (c)", t_model, params_dev, tier_reqs, got_c, ref_contig)
    summ_c = results["summary_c"]
    per_handoff = quant.tree_bytes(lm.init_cache(t_model, 1, device="cpu"))
    tier_gens = {g["replica"]: g for g in _generations(dirs["tiers"])}
    handoffs = [json.loads(line) for line in open(dirs["tiers"] / "router.jsonl")]
    handoffs = [r for r in handoffs if r["event"] == "kv_handoff"]
    if not all(c.disagg for c in results["c"].values()) or \
            summ_c["handoffs"] != TIER_REQUESTS or summ_c["handoff_failures"] or \
            summ_c["handoff_bytes"] != TIER_REQUESTS * per_handoff or \
            tier_gens[1]["prefill_tokens"] != 0 or \
            {r["bytes"] for r in handoffs} != {per_handoff}:
        fail(f"[31] (c) disagg {[c.disagg for c in results['c'].values()]}, handoffs "
             f"{summ_c['handoffs']}, failures {summ_c['handoff_failures']}, bytes "
             f"{summ_c['handoff_bytes']} (want {TIER_REQUESTS} x {per_handoff}), decode "
             f"tier prefill tokens {tier_gens[1]['prefill_tokens']}")
    got_x = streams(results["c_chaos"], "(c) chaos", len(chaos_reqs))
    ties_x = compare_streams("[31] (c) chaos", t_model, params_dev, chaos_reqs, got_x,
                             ref_contig)
    summ_x = results["summary_chaos"]
    stats_x = {g["replica"]: g for g in _generations(dirs["chaos"])}[1]["handoff"] or {}
    if summ_x["handoff_failures"] != 1 or summ_x["ok"] != len(chaos_reqs) or \
            stats_x.get("crc_failures") != 1:
        fail(f"[31] (c) chaos: handoff failures {summ_x['handoff_failures']}, ok "
             f"{summ_x['ok']}, decode replica ledger {stats_x}")
    walls_h = sorted(r["wall_s"] for r in handoffs)
    same_c = sum(got_c[r.request_id] == ref_contig[r.request_id] for r in tier_reqs)
    print(f"[31] (c) --tier prefill + --tier decode (contiguous, [25]'s LM): "
          f"{TIER_REQUESTS} greedy requests, prompts {len(tier_reqs[0].prompt)}-"
          f"{len(tier_reqs[-1].prompt)}: {TIER_REQUESTS} handed off, {same_c}/"
          f"{TIER_REQUESTS} streams equal to the in-process contiguous engine's, {ties_c} "
          f"ties; decode tier prefill tokens {tier_gens[1]['prefill_tokens']}; handoff "
          f"bytes {summ_c['handoff_bytes']} = {TIER_REQUESTS} x {per_handoff} (one slot's "
          f"planes), handoff wall p50 {walls_h[len(walls_h) // 2] * 1e3:.3f} ms max "
          f"{walls_h[-1] * 1e3:.3f} ms; ChaosProxy {TIER_CHAOS} on the decode replica's "
          f"handoff listener: {summ_x['handoff_failures']} handoff bounced (crc_failures "
          f"{stats_x.get('crc_failures')}), {summ_x['handoffs']} handed off, "
          f"{summ_x['ok']}/{len(chaos_reqs)} ok, {ties_x} ties; {walls['c']:.1f} s [{card}]")
    # (d)
    code, doc = results["d"]
    want = jax_fleet_summary_keys()
    if code != 0 or doc is None or set(doc) != want or doc["ok"] != doc["requests"] or \
            doc["replicas"] != 2:
        print((dirs["loadgen"] / "loadgen.log").read_text()[-3000:], file=sys.stderr)
        fail(f"[31] (d) serve_loadgen --replicas 2: exit {code}, keys "
             f"{sorted(set(doc or {}) ^ want)} differ from the JAX tool's")
    print(f"[31] (d) python -m {PKG}.serve_loadgen --replicas 2 --kv-layout paged: exit 0, "
          f"{doc['ok']}/{doc['requests']} ok, {doc['tokens_per_s']:.1f} tokens/s, the JAX "
          f"tool's {len(want)} fleet summary keys; {walls['d']:.1f} s [{card}]")
    print(f"[31] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"b6": b6}


def moe_reference(out: str, top_k: int, steps: int = MESH_STEPS) -> None:
    """Phase 28 (d)'s reference: the same MoE classifier that ``--mesh data=1,expert=2``
    trains (two experts, ``top_k``, the flash core at seq 2048, the same seeded initial
    parameters), trained by one rank with both experts local, through the composed
    trainer's own segment function over the same plan; the losses, step count and final
    parameters to ``out``, as ``composed_trajectory`` saves them."""
    import numpy as np
    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import composed
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
        create_train_state,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        ComposedConfig,
    )

    cfg = ComposedConfig(mesh="data=1,expert=2", moe_top_k=top_k, flash_attention=True,
                         seq_len=COMPOSED[1], batch_size=COMPOSED[0], device="cuda")
    model = composed.build_classifier(cfg).cuda()      # no grid: both experts here
    optimizer, segment = composed.build_segment_fn(cfg, model)
    state = create_train_state(model, torch.Generator().manual_seed(cfg.seed),
                               optimizer=optimizer, device="cuda")
    x, y = mnist._synthesize_split(steps * cfg.batch_size, 300)
    images = torch.from_numpy(mnist._normalize(x)).cuda()
    labels = torch.from_numpy(y.astype(np.int64)).cuda()
    plan = torch.from_numpy(composed.epoch_plan(cfg.seed, 0, steps * cfg.batch_size, steps,
                                                cfg.batch_size)).cuda()
    state, losses = segment(state, images, labels, plan, cfg.seed + 1)
    np.savez(out, losses=losses.cpu().numpy(), steps=int(state.step),
             epoch_seconds=0.0, **{k: p.cpu().numpy() for k, p in state.params.items()})


def mesh_plan(flags: list, steps: int, layers: int = 2) -> dict:
    """B4/B5 launches a rank makes in ``composed_trajectory`` (``steps`` steps, one eval
    batch) under ``flags``: every layer once a step and once at the eval, except under a
    stage axis, where a rank runs its ``layers / 2`` layers on each of the microbatches
    (the eval's too), and ``1f1b`` runs each microbatch's forward again in its
    backward."""
    if "--mesh" in flags and "stage=2" in flags[flags.index("--mesh") + 1]:
        per = (layers // 2) * MESH_MICROBATCHES
        again = "1f1b" in flags
        return {"flash_fwd": per * (steps * (2 if again else 1) + 1),
                "flash_dq": per * steps, "flash_dkv": per * steps}
    return {"flash_fwd": layers * (steps + 1), "flash_dq": layers * steps,
            "flash_dkv": layers * steps}


MESH_RUNS = (   # phase 28: (label, flags, world, flash operand shape on each rank)
    ("(a) data=1,model=2", ["--mesh", "data=1,model=2"], 2, ULYSSES_LOCAL),
    ("(b) data=1,stage=2 gpipe",
     ["--mesh", "data=1,stage=2", "--pipeline-microbatches", str(MESH_MICROBATCHES)], 2,
     STAGE_LOCAL),
    ("(b) data=1,stage=2 1f1b",
     ["--mesh", "data=1,stage=2", "--pipeline-microbatches", str(MESH_MICROBATCHES),
      "--pipeline-schedule", "1f1b"], 2, STAGE_LOCAL),
    ("(c) data=2 --fsdp", ["--mesh", "data=2", "--fsdp"], 2, (32, 2048, 4, 16)),
    ("(d) data=1,expert=2 top-1", ["--mesh", "data=1,expert=2", "--moe-top-k", "1"], 2,
     COMPOSED),
    ("(d) data=1,expert=2 top-2", ["--mesh", "data=1,expert=2", "--moe-top-k", "2"], 2,
     COMPOSED),
    ("(c) data=2,model=2 --fsdp", ["--mesh", "data=2,model=2", "--fsdp"], 4,
     DATA_MODEL_LOCAL),
)
MESH_LM_RUNS = (("(f) LM data=1,model=2", "data=1,model=2", 2),
                ("(f) LM data=2,seq=2", "data=2,seq=2", 4))


PLAN_TRAIN, PLAN_TEST = 640, 1000   # [32] (b), (c): 10 steps of 64 at seq 2048, one eval batch


def planner_phase(dev, card: str, train_ds, test_ds, t_model, t_params: dict) -> dict:
    """Phase 32, the parallelism planner on the card. (a) ``Topology.detect`` of the card:
    its name, torch's total as the ``"runtime"`` budget, the H100's peak, one device and
    one granule. (b) ``train.composed --plan tune --flash-attention --seq-len 2048`` at
    [9]'s widths, world 1, ``PLAN_TRAIN`` examples: ``plan_composed.json`` with ``source:
    "tune"``, a measured step for each of the top three candidates and their ``autotune``
    events; the trials run the dense core (the JAX rule) and launch no flash kernel, so
    B4/B5 launches are the planned run's alone: layers x steps x the plan's grad_accum
    (forward: and the eval batch); ``python -m <port>.plan_report`` renders it against
    the run's telemetry. (c) ``--plan <saved>`` replayed, against the same run with
    ``--mesh``/``--grad-accum`` pinned to the plan: bitwise equal parameters and equal
    launches. (d) ``plan.scenarios.for_serve`` on [25]'s LM for kv_dtype None, int8 and
    fp8: one slot's KV bytes equal the contiguous engine's ``byte_accounting``, and
    ``search_serve``'s pick. Returns (b)'s launches for the kernels line."""
    import dataclasses

    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch import plan, serving
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        flash_attention as fa,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import composed
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        ComposedConfig,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
        read_jsonl,
    )

    t_phase = time.perf_counter()
    root = OUT_DIR / "plan"
    shutil.rmtree(root, ignore_errors=True)
    os.environ.pop("PLAN_HBM_BYTES", None)

    cpu = dev.type != "cuda"              # a CPU rehearsal: the CPU's topology, no launch
    # (a) the card's topology
    topo = plan.Topology.detect(dev)
    if cpu:
        ok = topo == plan.Topology(num_devices=1)
    else:
        ok = ("h100" in topo.device_kind.lower() and topo.hbm_source == "runtime"
              and topo.hbm_bytes == float(torch.cuda.mem_get_info(dev)[1])
              and topo.peak_flops == 989e12)
    if not (ok and topo.num_devices == 1 and topo.num_slices == 1):
        fail(f"[32] (a) Topology.detect: {topo}")
    print(f"[32] (a) Topology.detect(cuda:0): {topo.device_kind}, hbm {topo.hbm_bytes:.0f} B "
          f"({topo.hbm_source}: torch.cuda.mem_get_info's total), peak "
          f"{topo.peak_flops:.3g} FLOP/s, NVLink {topo.ici_bytes:.3g} B/s, across hosts "
          f"{topo.dcn_bytes:.3g} B/s (published figures), {topo.num_devices} device, "
          f"{topo.num_slices} granule [{card}]")

    # (b) the tuned run
    steps = PLAN_TRAIN // COMPOSED[0]
    base = ComposedConfig(mesh="data=1", flash_attention=True, seq_len=COMPOSED[1], epochs=1,
                          max_train_examples=PLAN_TRAIN, max_test_examples=PLAN_TEST,
                          device=dev.type)
    layers = composed.build_classifier(base).num_layers
    eval_batches = PLAN_TEST // base.batch_size_test

    def run(tag: str, cfg):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = composed.main(dataclasses.replace(cfg, results_dir=str(root / tag)),
                                    datasets=(train_ds, test_ds))
        if not cpu:
            torch.cuda.synchronize()
        return state, hist, fa.launch_counts(), time.perf_counter() - t0

    tuned, t_hist, t_counts, t_wall = run("tune", dataclasses.replace(
        base, plan="tune", telemetry=str(root / "tune.jsonl")))
    path = root / "tune" / "plan_composed.json"
    saved = plan.Plan.load(str(path))
    measured = [r for r in saved.candidates if r["measured_step_s"] is not None]
    events = [r for r in read_jsonl(str(root / "tune.jsonl")) if r["event"] == "autotune"]
    accum = saved.grad_accum
    want = {"flash_fwd": layers * (steps * accum + eval_batches),
            "flash_dq": layers * steps * accum, "flash_dkv": layers * steps * accum}
    if cpu:
        want = dict.fromkeys(want, 0)
    if saved.source != "tune" or saved.mesh != "data=1" or len(measured) != 3 or \
            len(events) != 3 or any(not r["measured_step_s"] > 0 for r in measured) or \
            saved.measured_step_s != measured[0]["measured_step_s"] or t_counts != want:
        fail(f"[32] (b) plan {saved.source} {saved.mesh} accum {accum}, {len(measured)} "
             f"measured, {len(events)} autotune events, launches {t_counts} != {want}")
    rows = ", ".join(f"accum {r['candidate']['grad_accum']}: predicted "
                     f"{r['costs']['step_s'] * 1e3:.3f} ms, measured "
                     f"{r['measured_step_s'] * 1e3:.3f} ms (warm-up {r['compile_s']:.2f} s, "
                     f"{r['measured_flops_per_step']:.4g} flops)" for r in measured)
    print(f"[32] (b) train.composed --plan tune --flash-attention --seq-len {COMPOSED[1]}, "
          f"world 1, {PLAN_TRAIN} examples: {path.name} source {saved.source}, mesh "
          f"{saved.mesh}, grad_accum {accum}; the top 3 trialed (the trainer's eager step, "
          f"the dense core, {len(events)} autotune events): {rows}; B4/B5 launches "
          f"{t_counts} = {layers} layers x {steps} steps x accum {accum} (+ {eval_batches} "
          f"eval batch forward), none in the trials; val loss {t_hist.test_losses[0]:.4f}; "
          f"main() {t_wall:.1f} s [{card}]")
    report = subprocess.run([sys.executable, "-m", f"{PKG}.plan_report", str(path),
                             "--telemetry", str(root / "tune.jsonl")],
                            cwd=ROOT, capture_output=True, text=True, timeout=120)
    if report.returncode or "run measured (telemetry)" not in report.stdout or \
            "meas_ms" not in report.stdout:
        fail(f"[32] (b) plan_report exited {report.returncode}: {report.stderr[-2000:]}")
    for line in report.stdout.splitlines():
        print(f"[32] (b) plan_report: {line}")

    # (c) the saved plan replayed against the pinned layout
    replay, _, r_counts, r_wall = run("replay", dataclasses.replace(base, plan=str(path)))
    pinned, _, p_counts, p_wall = run("pinned", dataclasses.replace(
        base, mesh=saved.mesh, grad_accum=accum))
    differ = [k for k in pinned.params if not torch.equal(replay.params[k], pinned.params[k])]
    if differ or r_counts != want or p_counts != want:
        fail(f"[32] (c) replay vs pinned: differing {differ}, launches {r_counts} vs "
             f"{p_counts} (want {want})")
    tuned_diff = max((tuned.params[k] - pinned.params[k]).abs().max().item()
                     for k in pinned.params)
    print(f"[32] (c) --plan {path.name} replayed ({r_wall:.1f} s) against --mesh "
          f"{saved.mesh} --grad-accum {accum} ({p_wall:.1f} s): {len(pinned.params)} "
          f"parameters bitwise equal, launches {r_counts} each; (b)'s tuned run against "
          f"them max |dparam| {tuned_diff:.3e} [{card}]")
    del tuned, replay, pinned
    if not cpu:
        torch.cuda.empty_cache()

    # (d) the serve planner's slot bytes against the engine's
    rows = []
    for kv in (None, "int8", "fp8"):
        sc = plan.scenarios.for_serve(t_model, num_slots=SERVE_SLOTS, prompt_len=LM_PROMPT,
                                      kv_dtype=kv, device=dev)
        engine = serving.ContinuousBatchingEngine(t_model, t_params, num_slots=SERVE_SLOTS,
                                                  kv_layout="contiguous",
                                                  kv_dtype=kv or "model", device=dev)
        got = engine.byte_accounting()["kv_bytes_per_slot"]
        pick = plan.search_serve(sc)[0]
        if sc.stats.kv_bytes_per_slot != got or sc.topo.hbm_source != (
                "nominal" if cpu else "runtime"):
            fail(f"[32] (d) kv_dtype {kv}: for_serve {sc.stats.kv_bytes_per_slot} B a slot, "
                 f"the engine's byte_accounting {got}")
        rows.append(f"{kv or 'model'} {got:.0f} B (pick {pick.shard_spec()}, predicted "
                    f"{pick.costs.tokens_per_s:.4g} tokens/s, {pick.costs.slots_at_budget} "
                    f"slots at the budget)")
        del engine
    print(f"[32] (d) plan.scenarios.for_serve on [25]'s LM, {SERVE_SLOTS} slots: one slot's "
          f"KV bytes = the contiguous engine's byte_accounting: {'; '.join(rows)} [{card}]")
    print(f"[32] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"tf32": t_counts, "grad_accum": accum}


LOOP_TEXTS = ("DESIGN.md", "SURVEY.md", "PAPER.md", "PARITY.md", "RESULTS.md", "VERDICT.md")
LOOP_CORPUS = ("--seq-len", "256", "--shard-sequences", "256", "--eval-frac", "0.1")
LOOP_WIDTHS = ("--embed-dim", "64", "--num-layers", "2", "--num-heads", "4",
               "--batch-size", "64")                     # LMConfig's, as [25] and [31]
# A quarter of each sampled sequence generated, as the tool's default 16 new tokens are of
# its fixture's 64: the canary scores whole samples, and with 16 of 256 the garbage a
# corrupted candidate generates moves the mean by less than --nll-margin (a CPU run at
# these widths on this corpus: canary 3.377 against the fleet's 3.105, promoted). The
# margin also needs --quick's 4 epochs: an incumbent of 2 (at embed 32, one layer) left
# the corrupted canary 0.457 above the fleet, and promoted it.
LOOP_MAX_NEW = ("--max-new-tokens", "64")
LOOP_TIMEOUT = 900             # [33] (b): seconds the loop may take
LOOP_STEPS = ["candidate_seen", "gate_pass", "canary_start", "canary_pass", "promoted"]


def promote_loop_phase(card: str) -> None:
    """[33]: the train→serve loop as a user runs it, every step a port entry point in a
    process of its own. (a) ``python -m <port>.build_corpus`` over the repository's six
    frozen texts, read back through ``data.stream``; (b) ``python -m
    <port>.train_serve_loop --quick`` on that corpus at ``LMConfig``'s widths: a trainer
    publishing into the versioned store while two replicas serve, the promoter's gate and
    canary, the rollback of two corrupted candidates, the resume leg bitwise and the
    throttled run's goodput; its seven gates, the ledger and the events with the JAX
    package's keys; each leg's seconds from the time its first line reached this process;
    the time from each promoted checkpoint's publish (its manifest ``unix_time``) to its
    promotion (the ledger); (c) ``python -m <port>.telemetry_report`` over the promote and
    router streams (no unknown event kind) and ``--goodput`` over the throttled run (its
    ``data_wait_s`` the loop's)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import stream

    t_phase = time.perf_counter()
    root = OUT_DIR / "promote_loop"
    shutil.rmtree(root, ignore_errors=True)
    corpus, out, work = root / "corpus", root / "out", root / "work"
    env = {**_child_env(), "PYTHONPATH": str(ROOT)}

    # (a) the corpus, built here from the texts in the checkout
    t0 = time.perf_counter()
    built = subprocess.run(
        [sys.executable, "-m", f"{PKG}.build_corpus", "--out", str(corpus), *LOOP_CORPUS,
         *(str(ROOT / name) for name in LOOP_TEXTS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    build_s = time.perf_counter() - t0
    if built.returncode != 0:
        fail(f"[33] (a) build_corpus exited {built.returncode}: {built.stderr[-2000:]}")
    meta = stream.load_meta(str(corpus))
    n_train = sum(e["sequences"] for e in meta["shards"])
    n_eval = meta["eval"]["sequences"]
    n_bytes = sum((ROOT / name).stat().st_size for name in LOOP_TEXTS) + len(LOOP_TEXTS) - 1
    if (meta["seq_len"], meta["vocab"]) != (256, 256) or \
            n_train + n_eval != n_bytes // 256 or n_eval != math.ceil(0.1 * (n_bytes // 256)) \
            or stream.eval_tokens(str(corpus)).shape != (n_eval, 256) or \
            stream.StreamLoader(str(corpus), 64).batches_per_epoch != n_train // 64:
        fail(f"[33] (a) corpus meta {meta}, {n_bytes} bytes in")
    print(f"[33] (a) python -m {PKG}.build_corpus over {', '.join(LOOP_TEXTS)} ({n_bytes:,} "
          f"bytes, {build_s:.1f} s): {built.stdout.strip()}; data.stream reads it: "
          f"{n_train // 64} batches of 64 an epoch, sha256 of every shard checked")

    # (b) the loop, its output read line by line to time the legs
    flags = (*LOOP_WIDTHS, *LOOP_MAX_NEW)
    cmd = [sys.executable, "-m", f"{PKG}.train_serve_loop", "--quick", "--corpus",
           str(corpus), *flags, "--out-dir", str(out), "--work-dir", str(work)]
    t0 = time.perf_counter()
    legs, lines = {}, []
    with open(root / "loop.log", "w") as log:
        # a session of its own: on a timeout its trainer and replicas go with it
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, start_new_session=True)
        timer = threading.Timer(LOOP_TIMEOUT, os.killpg, (proc.pid, 9))
        timer.start()
        try:
            for line in proc.stdout:
                log.write(line)
                lines.append(line.rstrip())
                if line.startswith("== "):
                    legs[line.split()[1]] = time.perf_counter() - t0
        finally:
            timer.cancel()
            code = proc.wait()
    loop_s = time.perf_counter() - t0
    if code != 0:
        tail = "\n".join(lines[-40:])
        fail(f"[33] (b) train_serve_loop exited {code} after {loop_s:.1f} s:\n{tail}")
    ends = list(legs.values())[1:] + [loop_s]
    leg_s = {name: round(end - start, 1)
             for (name, start), end in zip(legs.items(), ends)}
    summary = json.loads((out / "summary.json").read_text())
    gates, promote, rollback = summary["gates"], summary["promote"], summary["rollback"]
    if not all(gates.values()) or len(gates) != 7:
        fail(f"[33] (b) gates {gates}")
    # the promotion ledger: the promote leg's candidates each through gate and canary to
    # the fleet (or superseded by a newer one), then the rollback leg's two corrupted ones
    ledger = [json.loads(line) for line in open(out / "promotion_ledger.jsonl")]
    walks: dict[str, list] = {}
    for row in ledger:
        walks.setdefault(row["candidate"], []).append(row)
    names = list(walks)
    *promoted_names, gated, canaried = names
    acts = {c: [r["action"] for r in rows] for c, rows in walks.items()}
    row = {c: {r["action"]: r for r in rows} for c, rows in walks.items()}
    budget, margin = 0.25, 0.5                  # the tool's --nll-budget, --nll-margin
    promoted = [c for c in promoted_names if acts[c] == LOOP_STEPS]
    if not promoted or promoted[-1] != promote["final_incumbent"] or \
            any(acts[c] not in (LOOP_STEPS, ["superseded"]) for c in promoted_names) or \
            any(row[c]["gate_pass"]["nll"] > row[c]["gate_pass"]["incumbent_nll"] + budget
                or row[c]["canary_pass"]["canary_nll"]
                > row[c]["canary_pass"]["fleet_nll"] + margin for c in promoted) or \
            acts[gated] != ["candidate_seen", "gate_fail"] or \
            row[gated]["gate_fail"]["reason"] != "nll_over_budget" or \
            row[gated]["gate_fail"]["nll"] <= row[gated]["gate_fail"]["incumbent_nll"] + budget \
            or acts[canaried] != ["candidate_seen", "gate_pass", "canary_start", "canary_fail",
                                  "rolled_back"] or \
            row[canaried]["canary_fail"]["canary_nll"] \
            <= row[canaried]["canary_fail"]["fleet_nll"] + margin or \
            rollback["incumbent_after"] != promote["final_incumbent"] or \
            rollback["fleet_checkpoint_after"] != promote["final_incumbent"] or \
            promote["traffic"]["lost"] != 0 or not promote["traffic"]["ok"]:
        fail(f"[33] (b) ledger {[(r['action'], r['candidate']) for r in ledger]}, promote "
             f"{promote}, rollback {rollback}")
    events = [json.loads(line) for line in open(out / "promote_telemetry.jsonl")]
    keys = {"promote": jax_event_keys("promote_event"), "canary": jax_event_keys("canary_event")}
    bad_keys = [ev for ev in events if set(ev) - {"t_s"} != keys[ev["event"]]]
    kinds = [(ev["event"], ev.get("action") or ev.get("verdict")) for ev in events]
    if bad_keys or kinds.count(("canary", "pass")) != len(promoted) or \
            kinds.count(("canary", "fail")) != 1 or \
            kinds.count(("promote", "promoted")) != len(promoted) or \
            kinds.count(("promote", "rolled_back")) != 1:
        fail(f"[33] (b) events {kinds}; keys differing from the JAX package's: {bad_keys}")
    store = work / "train" / "checkpoints"
    published = {e["file"]: e["unix_time"]
                 for e in json.loads((store / "manifest.json").read_text())["entries"]}
    to_fleet = {c: round(row[c]["promoted"]["t"] - published[c], 3) for c in promoted}
    stages = {c: (round(row[c]["canary_start"]["t"] - row[c]["candidate_seen"]["t"], 3),
                  round(row[c]["promoted"]["t"] - row[c]["canary_start"]["t"], 3))
              for c in promoted}
    print(f"[33] (b) python -m {PKG}.train_serve_loop --quick {' '.join(flags)} on that "
          f"corpus: exit 0 in {loop_s:.1f} s (legs {leg_s} s); gates {gates}")
    gate = {c: (round(row[c]["gate_pass"]["nll"], 4), round(row[c]["gate_pass"]["incumbent_nll"], 4),
                round(row[c]["gate_pass"]["perf_s"], 3),
                round(row[c]["gate_pass"]["incumbent_perf_s"], 3)) for c in promoted}
    canary = {c: (row[c]["canary_pass"]["replica"], row[c]["canary_pass"]["canary_requests"],
                  row[c]["canary_pass"]["fleet_requests"],
                  round(row[c]["canary_pass"]["canary_nll"], 4),
                  round(row[c]["canary_pass"]["fleet_nll"], 4)) for c in promoted}
    g_fail, c_fail = row[gated]["gate_fail"], row[canaried]["canary_fail"]
    print(f"[33] (b) promote: {promote['promoter_counts']}, {promote['initial_checkpoint']} -> "
          f"{promote['final_incumbent']}; gate (NLL, incumbent's, perf s, incumbent's) {gate}; "
          f"canary (replica, requests, fleet's, sampled NLL, fleet's) {canary}; publish -> "
          f"promoted s {to_fleet} (seen -> canary, canary -> promoted s {stages}); requests "
          f"ok {promote['traffic']['ok']}, lost {promote['traffic']['lost']} through every "
          f"roll, router {promote['router_summary']}")
    print(f"[33] (b) rollback: {gated} (params + N(0, 2), clean stamp): gate NLL "
          f"{g_fail['nll']:.4f} > {g_fail['incumbent_nll']:.4f} + {budget} -> gate_fail, never "
          f"on the fleet; {canaried} (loosened gate): canary sampled NLL "
          f"{c_fail['canary_nll']:.4f} > fleet {c_fail['fleet_nll']:.4f} + {margin} -> rolled "
          f"back, fleet on {rollback['fleet_checkpoint_after']}; ledger {len(ledger)} rows in "
          f"order, {len(events)} promote/canary events with the JAX package's keys")
    resume, data = summary["resume"], summary["data_wait"]
    print(f"[33] (b) resume: {resume['total_epochs']} epochs straight vs {resume['split_at']} + "
          f"resume, model_lm.ckpt bitwise {resume['bitwise_identical']}, stream digests "
          f"{resume['digests_resumed']} equal {resume['stream_digests_match']}; data_wait: "
          f"{data['data_wait_s']:.3f} s of {data['wall_s']:.3f} s wall at "
          f"{data['throttle_s']} s a batch, segments {data['segments']} [{card}]")

    # (c) the reader over the loop's streams
    report = subprocess.run(
        [sys.executable, "-m", f"{PKG}.telemetry_report", str(out / "promote_telemetry.jsonl"),
         str(out / "router.jsonl")], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    if report.returncode != 0 or "unrecognized events" in report.stdout or \
            "promotions" not in report.stdout:
        fail(f"[33] (c) telemetry_report exited {report.returncode}:\n{report.stdout[-3000:]}"
             f"{report.stderr[-2000:]}")
    emitted = root / "goodput_event.jsonl"
    good = subprocess.run(
        [sys.executable, "-m", f"{PKG}.telemetry_report", "--goodput",
         str(out / "train_throttled.jsonl"), "--emit", str(emitted)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    ledger_json = json.loads((out / "goodput.json").read_text())
    got = json.loads(emitted.read_text().splitlines()[-1]) if emitted.exists() else {}
    if good.returncode != 0 or got.get("data_wait_s") != ledger_json["segments"]["data_wait_s"]:
        fail(f"[33] (c) --goodput exited {good.returncode}, data_wait_s {got.get('data_wait_s')} "
             f"vs the loop's {ledger_json['segments']['data_wait_s']}:\n{good.stdout[-2000:]}"
             f"{good.stderr[-2000:]}")
    for line in report.stdout.splitlines():
        if line.startswith("==") or "promotions" in line or "replica" in line[:12]:
            print(f"[33] (c) telemetry_report: {line.strip()}")
    for line in good.stdout.splitlines()[:4]:
        print(f"[33] (c) telemetry_report --goodput: {line.strip()}")
    print(f"[33] (c) no unknown event kind in either stream; --goodput data_wait_s "
          f"{got['data_wait_s']} = the loop's goodput.json")
    print(f"[33] phase {time.perf_counter() - t_phase:.1f} s [{card}]")


SHARD_SPEC = "tp=2"            # [34]: each replica a world of 2 ranks, heads 4 over 2
SHARD_KILL_STEP = 20           # (b): replica 1's leader at its decode step 20, mid-decode
SHARD_BYTES_RATIO = 1.8        # params + KV a rank <= the unsharded engine's / 1.8


def sharded_fleet_phase(dev, card: str, t_model, t_params: dict, ckpt: Path, test_ids,
                        serve, compare_streams, warmup) -> dict:
    """Phase 34: the sharded replica behind the router, every process a port entry point.
    A ``serving.router.Router`` over 2 replicas, each ``--shard tp=2`` (a world of 2 ranks,
    ``train.launch.Fleet(whole=True)``), paged KV through B6 on each rank's own heads and
    pages, [25]'s trained LM: (b) [31] (a)'s 16 greedy requests with replica 0's follower
    rank SIGKILLed at the first completion and replica 1's leader killed by
    ``kill:proc=1,step=N``: each world dies and restarts whole (no pid of the old
    generation alive), zero lost, the streams equal to the unsharded in-process paged
    engine's up to true ties; (a) the same requests again on the restarted worlds: the
    streams again, every rank's B6 launches = layers x its world's decode steps (each call
    held against the plain version), params + KV a rank <= the unsharded engine's / 1.8
    (the replicas' ``stats``); (c) ``python -m <port>.serve_loadgen --replicas 2 --shard
    tp=2 --kv-layout paged``, in a thread while (b)-(a) run: exit 0, the JAX tool's fleet
    keys, ``shard`` "tp=2". Returns B6's launches by rank process for the kernels line."""
    import signal

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import (
        Router,
    )

    t_phase = time.perf_counter()
    base = OUT_DIR / "sharded_fleet"
    shutil.rmtree(base, ignore_errors=True)
    dirs = {name: base / name for name in ("fleet", "loadgen")}
    for d in dirs.values():
        d.mkdir(parents=True)
    cpu = dev.type != "cuda"
    device_flags = ["--device", "cpu"] if cpu else []
    layers = t_model.num_layers
    reqs = fleet_requests(test_ids)
    flags = ["--checkpoint", str(ckpt), "--kv-layout", "paged", "--page-size",
             str(SERVE_PAGE), "--num-slots", str(SERVE_SLOTS), "--shard", SHARD_SPEC]
    env = _child_env(f"kill:proc=1,step={SHARD_KILL_STEP},"
                     f"flag={dirs['fleet'] / 'kill_flag'}")
    env["OMP_NUM_THREADS"] = "2"
    router = Router(_child_command("fleet_replica_child", str(dirs["fleet"])) + flags
                    + device_flags, num_replicas=2, env=env,
                    heartbeat_dir=str(dirs["fleet"] / "hb"), heartbeat_timeout_s=60.0,
                    backoff_s=0.5, telemetry=str(dirs["fleet"] / "router.jsonl"))
    results, errors = {}, {}

    def loadgen() -> None:            # (c), beside the router's worlds
        t0 = time.perf_counter()
        out = dirs["loadgen"] / "summary.json"
        lg_env = _child_env()
        lg_env["OMP_NUM_THREADS"] = "2"
        code = subprocess.run(
            [sys.executable, "-m", f"{PKG}.serve_loadgen", "--replicas", "2", "--shard",
             SHARD_SPEC, "--checkpoint", str(ckpt), "--kv-layout", "paged", "--page-size",
             str(SERVE_PAGE), "--num-slots", str(SERVE_SLOTS), "--requests", "16",
             "--max-new-tokens", "32", "--prompt-lens", "0,64,160", "--rate", "64",
             "--summary-json", str(out), "--telemetry", str(dirs["loadgen"] / "router.jsonl"),
             *device_flags],
            cwd=ROOT, env=lg_env, stdout=open(dirs["loadgen"] / "loadgen.log", "w"),
            stderr=subprocess.STDOUT, timeout=600).returncode
        results["c"] = (code, json.loads(out.read_text()) if out.exists() else None,
                        time.perf_counter() - t0)

    def guarded() -> None:
        try:
            loadgen()
        except BaseException as e:             # noqa: BLE001 — surfaced below
            errors["c"] = e

    def submit_all(reqs_):
        futs = {r.request_id: router.submit(r.prompt, max_new_tokens=r.max_new_tokens)
                for r in reqs_}
        return futs

    def pids() -> list[list[int]]:
        return [[p.pid for p in rep.fleet.procs] for rep in router.replicas]

    thread = threading.Thread(target=guarded, name="sharded-loadgen")
    try:
        t0 = time.perf_counter()
        router.start()
        if not router.wait_ready(timeout=FLEET_TIMEOUT):
            fail("[34] the sharded fleet did not come up")
        start_s = time.perf_counter() - t0
        thread.start()
        # (b) the two kills, mid-decode
        t0 = time.perf_counter()
        old = pids()
        futs = submit_all(reqs)
        deadline = time.monotonic() + FLEET_TIMEOUT
        while not any(f.done() for f in futs.values()) and time.monotonic() < deadline:
            time.sleep(0.02)
        os.kill(old[0][1], signal.SIGKILL)           # replica 0's follower rank
        got_b = {rid: f.result(timeout=FLEET_TIMEOUT) for rid, f in futs.items()}
        deadline = time.monotonic() + FLEET_TIMEOUT
        while (any(rep.restarts < 1 for rep in router.replicas)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        if not router.wait_ready(timeout=FLEET_TIMEOUT):
            fail("[34] (b) the worlds did not come back")
        b_s = time.perf_counter() - t0
        new = pids()
        alive = []
        for pid in (p for world in old for p in world):
            try:
                os.kill(pid, 0)
                alive.append(pid)
            except ProcessLookupError:
                pass
        # (a) the same requests on the restarted worlds, then every rank's counters
        t0 = time.perf_counter()
        got_a = {rid: f.result(timeout=FLEET_TIMEOUT) for rid, f in submit_all(reqs).items()}
        a_s = time.perf_counter() - t0
        router._collect_stats(wait_s=60.0)
        stats = [rep.stats["engine"] for rep in router.replicas]
        # meanwhile the loadgen's worlds; the in-process reference after the kills
        ref_engine, ref, _, _ = serve(t_model, t_params, "paged", reqs, warmup)
        single = ref_engine.byte_accounting()
        del ref_engine
        thread.join(timeout=900)
        summ = router.stop(timeout=FLEET_TIMEOUT)
    finally:
        if router.last_summary is None:
            try:
                router.stop(drain=False, timeout=10)
            except Exception:          # noqa: BLE001 — teardown of a failed phase
                pass
    if errors or "c" not in results:
        print((dirs["loadgen"] / "loadgen.log").read_text()[-3000:], file=sys.stderr)
        fail(f"[34] (c) {errors or 'did not finish'}")
    params_dev = {k: p.to(dev) for k, p in t_params.items()}

    def streams(comps: dict, tag: str) -> dict:
        if len(comps) != FLEET_REQUESTS or not all(c.ok for c in comps.values()):
            fail(f"[34] {tag}: finishes {[c.finish for c in comps.values()]}")
        return {rid: c.tokens.tolist() for rid, c in comps.items()}

    # (b)
    b = streams(got_b, "(b)")
    ties_b = compare_streams("[34] (b)", t_model, params_dev, reqs, b, ref)
    rows = [json.loads(line) for line in open(dirs["fleet"] / "router.jsonl")]
    fails = [r for r in rows if r["event"] == "replica" and r.get("action") == "fail"]
    if sorted((r["replica"], r["reason"]) for r in fails) != [(0, "crash"), (1, "crash")]:
        fail(f"[34] (b) replica failures {fails}")
    codes = {r["replica"]: r["exit_code"] for r in fails}
    restart_s = {}
    for r in fails:
        ready = next(e for e in rows if e["event"] == "replica" and e["action"] == "ready"
                     and e["replica"] == r["replica"] and e["t_s"] > r["t_s"])
        restart_s[r["replica"]] = ready["t_s"] - r["t_s"]
    if alive or any(set(w) & set(n) for w, n in zip(old, new)) or \
            [rep.restarts for rep in router.replicas] != [1, 1]:
        fail(f"[34] (b) old pids {old} alive {alive}, new {new}, restarts "
             f"{[rep.restarts for rep in router.replicas]}")
    redispatched = sum(c.redispatches > 0 for c in got_b.values())
    same_b = sum(b[r.request_id] == ref[r.request_id] for r in reqs)
    print(f"[34] (b) Router over 2 python -m {PKG}.serving.replica --shard {SHARD_SPEC} "
          f"worlds (2 ranks each, gloo on the one card; paged, pages of {SERVE_PAGE}, "
          f"{SERVE_SLOTS} slots), [25]'s trained LM: {FLEET_REQUESTS} greedy requests; "
          f"replica 0's follower rank SIGKILLed at the first completion (world exit "
          f"{codes.get(0)}), replica 1's leader by kill:proc=1,step={SHARD_KILL_STEP} "
          f"(world exit {codes.get(1)}): {len(got_b)} ok, {redispatched} redispatched; each "
          f"world restarted whole (old pids {old} gone, new {new}) in "
          f"{restart_s.get(0, 0):.1f} / {restart_s.get(1, 0):.1f} s; {same_b}/"
          f"{FLEET_REQUESTS} streams equal to the unsharded in-process paged engine's, "
          f"{ties_b} diverging at a true tie; fleet ready in {start_s:.1f} s, (b) "
          f"{b_s:.1f} s [{card}]")
    # (a)
    a = streams(got_a, "(a)")
    ties_a = compare_streams("[34] (a)", t_model, params_dev, reqs, a, ref)
    # every rank process that ended through the replica's own exits wrote its counters:
    # the restarted worlds' four ranks at the router's stop (exit 0), and those of (b)'s
    # worlds that the teardown reached alive (their last step may be cut mid-layer)
    gens = _generations(dirs["fleet"])
    live = [g for g in gens if g["rc"] == 0]
    worlds: dict[str, list[dict]] = {}
    for g in live:
        worlds.setdefault(g["world"], []).append(g)
    if len(worlds) != 2 or any(sorted(g["rank"] for g in ranks) != [0, 1]
                               or len({g["steps"] for g in ranks}) != 1
                               for ranks in worlds.values()):
        fail(f"[34] (a) the restarted worlds' ranks "
             f"{[(g['replica'], g['world'], g['rank'], g['steps']) for g in live]}")
    for g in live:
        want = layers * g["steps"]
        if not g["steps"] or g["calls"] != want or (not cpu and g["launches"] != want):
            fail(f"[34] replica {g['replica']} rank {g['rank']}: B6 launches "
                 f"{g['launches']} (held calls {g['calls']}) != {layers} layers x "
                 f"{g['steps']} decode steps")
    for g in gens:
        if g["excess"] is not None and g["excess"] > PAGED_ATOL:
            fail(f"[34] replica {g['replica']} rank {g['rank']}: B6 vs its plain version "
                 f"beyond atol {PAGED_ATOL} + rtol {PAGED_RTOL}: excess {g['excess']:.3e}")
    single_pk = single["params_bytes"] + single["kv_bytes_resident"]
    per_rank = [row["params_bytes"] + row["kv_bytes"]
                for st in stats for row in st["bytes"]["per_chip"].values()]
    stat_launches = [r["b6_launches"] for st in stats for r in st["ranks"]]
    if len(per_rank) != 4 or max(per_rank) * SHARD_BYTES_RATIO > single_pk:
        fail(f"[34] (a) params + KV a rank {per_rank} vs the unsharded {single_pk} / "
             f"{SHARD_BYTES_RATIO}")
    b6 = {f"sharded replica {g['replica']}, rank {g['rank']}, process {g['pid']} [34] "
          f"{'(a)' if g['rc'] == 0 else '(b)'}": g["launches"] for g in gens}
    max_err = max((g["max_abs_err"] or 0.0) for g in gens)
    shapes = sorted({tuple(s) for g in gens for s in g["shapes"]})
    same_a = sum(a[r.request_id] == ref[r.request_id] for r in reqs)
    tokens = sum(len(a[r.request_id]) - len(r.prompt) for r in reqs)
    print(f"[34] (a) the same {FLEET_REQUESTS} requests on the restarted worlds: {same_a}/"
          f"{FLEET_REQUESTS} streams equal, {ties_a} ties; {tokens / a_s:.1f} tokens/s "
          f"({tokens} new tokens in {a_s:.2f} s); B6 per rank process "
          f"{[(g['replica'], g['rank'], g['launches'], g['steps']) for g in gens]} "
          f"(replica, rank, launches, decode steps: launches = {layers} x steps), operands "
          f"{shapes}, every call within atol {PAGED_ATOL} + rtol {PAGED_RTOL} of the plain "
          f"version (max |err| {max_err:.3e}); stats while serving: B6 {stat_launches}; "
          f"params + KV a rank {per_rank} B, max {max(per_rank) / single_pk:.4f} of the "
          f"unsharded {single_pk} B (bar 1/{SHARD_BYTES_RATIO}); router {summ['ok']} ok of "
          f"{summ['requests']} [{card}]")
    # (c)
    code, doc, c_s = results["c"]
    want = jax_fleet_summary_keys()
    if code != 0 or doc is None or set(doc) != want or doc["ok"] != doc["requests"] or \
            doc["shard"] != SHARD_SPEC or doc["replicas"] != 2:
        print((dirs["loadgen"] / "loadgen.log").read_text()[-3000:], file=sys.stderr)
        fail(f"[34] (c) serve_loadgen --replicas 2 --shard {SHARD_SPEC}: exit {code}, keys "
             f"{sorted(set(doc or {}) ^ want)} differ from the JAX tool's")
    print(f"[34] (c) python -m {PKG}.serve_loadgen --replicas 2 --shard {SHARD_SPEC} "
          f"--kv-layout paged: exit 0, {doc['ok']}/{doc['requests']} ok, "
          f"{doc['tokens_per_s']:.1f} tokens/s, shard {doc['shard']!r}, the JAX tool's "
          f"{len(want)} fleet summary keys; {c_s:.1f} s [{card}]")
    print(f"[34] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"b6": b6}


def mesh_phase(dev, card: str) -> dict:
    """Phase 28: the training meshes on the card, every world of gloo ranks time-slicing
    the one card (correctness runs, not scaling points).

    (a)-(d) ``composed_trajectory`` for ``MESH_STEPS`` steps at the composed widths
    (``--seq-len 2048 --flash-attention``) under each of ``MESH_RUNS``' meshes, in one
    fleet of 2 ranks (and one of 4 for ``data=2,model=2``), against ``--mesh data=1`` in
    this process ((d): against ``moe_reference``, one rank running the same MoE model),
    within ``MESH_ATOL``, with each rank's B4/B5 launches against ``mesh_plan`` and the
    pipeline's bubble printed; (e) the JAX default mesh, ``python -m <port>.train.launch
    --num-processes 8 -- -m <port>.train.composed`` with its defaults for one short epoch
    with ``--sharded-checkpoint``, its ``model_composed.ckpt`` and its sharded directory
    restored on the CPU bitwise equal to each other, and within ``MESH_ATOL`` of the same
    flags at ``--mesh data=1``; (f) the LM at ``data=1,model=2`` and ``data=2,seq=2`` against
    data=1 (``lm_trajectory``), and ``train.distributed --fsdp`` at world 1 on NCCL, captured,
    against the plain run. Returns each run's rank-0 launches by label."""
    import numpy as np
    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        flash_attention as fa,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        composed, distributed,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
        create_train_state,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        ComposedConfig, DistributedConfig,
    )

    t_phase = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    stem = str(OUT_DIR / "mesh_run")
    found: dict = {}

    def max_diff(a, b) -> float:
        return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())

    def held(label: str, got: str, want: str, *loss_keys) -> tuple[float, float]:
        one, two = np.load(want), np.load(got)
        params = [k for k in one.files
                  if k not in ("losses", "train", "test", "epoch_seconds", "steps")]
        if int(one["steps"]) != int(two["steps"]):
            fail(f"[28] {label}: {int(two['steps'])} steps, the reference "
                 f"{int(one['steps'])}")
        e_loss = max(max_diff(two[k], one[k]) for k in loss_keys)
        e_par = max(max_diff(two[k], one[k]) for k in params)
        if not (e_loss <= MESH_ATOL and e_par <= MESH_ATOL):
            fail(f"[28] {label}: max |dloss| {e_loss:.3e}, max |dparam| {e_par:.3e} "
                 f"beyond {MESH_ATOL:g}")
        return e_loss, e_par

    # -- every fleet at once ((a)-(d), (f) on 2 and 4 ranks, (e) on 8), the references here
    runs = {2: [], 4: []}
    for i, (label, flags, world, _) in enumerate(MESH_RUNS):
        runs[world].append(("composed", f"{stem}{i}.npz", flags, MESH_STEPS))
    for i, (label, mesh_spec, world) in enumerate(MESH_LM_RUNS):
        runs[world].append(("lm", f"{stem}_lm{i}.npz", ["--mesh", mesh_spec],
                            MESH_LM_STEPS))
    out_dir = OUT_DIR / "default_mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    no_idx = str(OUT_DIR / "no_idx_files")     # the synthetic split, in both runs
    default_flags = ["--epochs", "1", "--max-train-examples", str(DEFAULT_MESH_TRAIN),
                     "--max-test-examples", "1000", "--sharded-checkpoint"]
    t_fleets = time.perf_counter()
    fleets = {world: start_fleet(seq_fleet_command(world_runs), n=world)
              for world, world_runs in runs.items()}
    fleets[8] = start_fleet(["-m", f"{PKG}.train.composed", *default_flags,
                             "--data-dir", no_idx, "--results-dir", str(out_dir)], n=8)
    ref = f"{stem}_ref.npz"
    composed_trajectory(ref, "--mesh", "data=1", steps=MESH_STEPS)
    for k in (1, 2):
        moe_reference(f"{stem}_moe{k}.npz", k)
    lm_ref = f"{stem}_lm_ref.npz"
    lm_trajectory(lm_ref, steps=MESH_LM_STEPS)
    cfg = ComposedConfig(mesh="data=1", epochs=1, max_train_examples=DEFAULT_MESH_TRAIN,
                         max_test_examples=1000, device="cuda", data_dir=no_idx,
                         results_dir=str(OUT_DIR / "default_mesh_ref"))
    ref_state, _ = composed.main(cfg)
    for world in (2, 4, 8):
        finish_fleet(f"[28] world {world}:" if world < 8 else "[28] (e) default mesh:",
                     fleets[world])
    fleets_s = time.perf_counter() - t_fleets
    for i, (label, flags, world, shape) in enumerate(MESH_RUNS):
        got = f"{stem}{i}.npz"
        want = (f"{stem}_moe{flags[-1]}.npz" if "expert" in label else ref)
        e_loss, e_par = held(label, got, want, "losses")
        counts = []
        for rank in range(world):
            with open(f"{got}.rank{rank}.json") as f:
                counts.append(json.load(f)["all"])
        plan = mesh_plan(flags, MESH_STEPS)
        if any(c != plan for c in counts):
            fail(f"[28] {label}: launches by rank {counts}, planned {plan} each")
        found[label] = counts[0]
        two = np.load(got)
        print(f"[28] {label}: {MESH_STEPS} steps at --seq-len {COMPOSED[1]} "
              f"--flash-attention, {world} gloo ranks on one card vs "
              f"{'one rank running the same MoE model' if 'expert' in label else 'data=1'}: "
              f"max |dloss| {e_loss:.3e}, max |dparam| {e_par:.3e} (atol {MESH_ATOL:g}); "
              f"losses {two['losses'][0]:.4f} -> {two['losses'][-1]:.4f}; B4/B5 on "
              f"{list(shape)} f32, launches a rank {counts[0]} = the plan; step "
              f"{float(two['epoch_seconds']) / MESH_STEPS * 1e3:.3f} ms (time-slicing, "
              f"host-staged collectives: no scaling point) [{card}]")
    for i, (label, mesh_spec, world) in enumerate(MESH_LM_RUNS):
        e_loss, e_par = held(label, f"{stem}_lm{i}.npz", lm_ref, "train", "test")
        print(f"[28] {label}: {MESH_LM_STEPS} steps at LMConfig's widths, {world} gloo ranks "
              f"vs data=1: max |dloss| {e_loss:.3e}, max |dparam| {e_par:.3e} (atol "
              f"{MESH_ATOL:g}) [{card}]")
    print(f"[28] the three fleets (2, 4 and 8 ranks) at once, the references in this process "
          f"meanwhile: {fleets_s:.1f} s")

    # -- (e) the JAX default mesh through the launcher: its checkpoints ---------------------
    cpu_ref = create_train_state(composed.build_classifier(cfg),
                                 torch.Generator().manual_seed(0))
    full = checkpoint.restore_train_state(str(out_dir / "model_composed.ckpt"), cpu_ref)
    sharded = checkpoint.restore_train_state_sharded(
        str(out_dir / "model_composed.ckpt.sharded"), cpu_ref)
    for k in full.params:
        if not (torch.equal(full.params[k], sharded.params[k])
                and torch.equal(full.velocity[k], sharded.velocity[k])):
            fail(f"[28] (e) the sharded directory's {k} differs from model_composed.ckpt's")
    e_par = max(max_diff(full.params[k], ref_state.params[k].cpu()) for k in full.params)
    if int(full.step) != DEFAULT_MESH_TRAIN // 64 or not e_par <= MESH_ATOL:
        fail(f"[28] (e) step {int(full.step)}, max |dparam| vs data=1 {e_par:.3e}")
    print(f"[28] (e) python -m {PKG}.train.launch --num-processes 8 -- -m "
          f"{PKG}.train.composed (--mesh data=2,seq=2,model=2, seq 16, dense core) "
          f"{' '.join(default_flags)}: 8 gloo ranks on one card; "
          f"model_composed.ckpt and the sharded directory restored on the CPU bitwise "
          f"equal ({len(full.params)} leaves, params and velocity); max |dparam| vs data=1 "
          f"{e_par:.3e} (atol {MESH_ATOL:g}) [{card}]")

    # -- (f) train.distributed --fsdp at world 1 on NCCL, captured ---------------------------
    results = {}
    for fsdp in (False, True):
        dcfg = DistributedConfig(epochs=1, max_train_examples=CAPTURE_STEPS * 64,
                                 max_test_examples=1000, log_interval=CAPTURE_LOG_INTERVAL,
                                 device="cuda", fsdp=fsdp, data_dir=no_idx,
                                 results_dir=str(OUT_DIR / f"dist_fsdp{int(fsdp)}"),
                                 images_dir=str(OUT_DIR / "images"))
        buf = io.StringIO()
        with patched(torch.backends.cudnn, "deterministic", True), \
                contextlib.redirect_stdout(buf):
            state, _ = distributed.main(dcfg)
        if "Segment program: cuda-graph" not in buf.getvalue():
            fail(f"[28] (f) train.distributed fsdp={fsdp} at world 1 did not run the "
                 f"captured program:\n{buf.getvalue()[-2000:]}")
        results[fsdp] = state
    e_par = max(max_diff(results[True].params[k].cpu(), results[False].params[k].cpu())
                for k in results[False].params)
    if not e_par <= CAPTURE_ATOL:
        fail(f"[28] (f) train.distributed --fsdp vs plain DP at world 1: max |dparam| "
             f"{e_par:.3e} beyond {CAPTURE_ATOL:g}")
    print(f"[28] (f) train.distributed --fsdp at world 1 on NCCL, {CAPTURE_STEPS} steps in "
          f"captured segments (every split the whole leaf, no collective), vs plain DP: max "
          f"|dparam| {e_par:.3e} (atol {CAPTURE_ATOL:g}) [{card}]")
    print(f"[28] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return found


@contextlib.contextmanager
def patched(owner, name: str, value):
    """``owner.name = value`` for the duration of the block."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def recording_epoch_fn(build, losses: list):
    """Wrap a trainer's ``make_epoch_fn`` so that every segment's losses land in
    ``losses``."""

    def make(*args, **kwargs):
        segment = build(*args, **kwargs)

        def record(*call):
            state, out = segment(*call)
            losses.append(out)
            return state, out

        return record

    return make


def host_launch_calls(prof) -> dict[str, int]:
    """The host's launch calls in a profiler window, by runtime API name (cudaLaunchKernel,
    cudaGraphLaunch, ...): what the host pays per step, whatever runs on the device."""
    counts: dict[str, int] = {}
    for evt in prof.events():
        if "Launch" in evt.name and not str(evt.device_type).endswith("CUDA"):
            counts[evt.name] = counts.get(evt.name, 0) + 1
    return counts


def captured_phase(dev, card: str, train_ds, test_ds, earlier: dict) -> None:
    """Phase 20: the captured segment against the eager loop on the card, then profiled.

    ``train.single.main`` (``--use-pallas-kernels``) and ``train.distributed.main`` at
    world 1 on NCCL each train ``CAPTURE_STEPS`` steps on the card: the segment-program
    rule picks the CUDA graph there. Each is held against the eager loop
    (``make_segment_fn``) of the same step from the same start on the same plan, dropout
    off and on (the masks come from the step's device key on both paths, so they must
    agree), per-step losses and final parameters within ``CAPTURE_ATOL``, under cuDNN's
    deterministic algorithms, with the launch counts read around ``main()`` (replays
    counted). Then a profiler window over
    ``CAPTURE_WINDOW`` replays of each full-split segment (busy share, kernels, host launch
    calls per step) beside an eager window of the same steps, and the full epochs of [5],
    [15] and the bench of [16], which ran captured."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
        BatchLoader, mnist,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import Net
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        fused_kernels as fk,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
        data_parallel as dp, mesh,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.sampler import (
        ShardedSampler,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        distributed, single, step as st,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        DistributedConfig, SingleProcessConfig,
    )

    li, n = CAPTURE_LOG_INTERVAL, CAPTURE_STEPS * BATCH
    sub = (mnist.Dataset(train_ds.images[:n], train_ds.labels[:n], train_ds.source),
           mnist.Dataset(test_ds.images[:1000], test_ds.labels[:1000], test_ds.source))
    x = torch.from_numpy(sub[0].images).to(dev)
    y = torch.from_numpy(sub[0].labels.astype("int64")).to(dev)
    net = lambda dropout: Net() if dropout else Net(conv_dropout_rate=0.0,
                                                    fc_dropout_rate=0.0)
    program = st.segment_program(dev)
    print(f"[20] segment program on {dev}: {program} (the rule); on the CPU: "
          f"{st.segment_program(torch.device('cpu'))}")
    if program != "cuda-graph":
        fail(f"[20] the rule chose {program} on the card")

    def compare(tag, got_losses, got_params, want_losses, want_params):
        got_l, want_l = torch.cat(got_losses).cpu(), torch.cat(want_losses).cpu()
        if got_l.shape != (CAPTURE_STEPS,):
            fail(f"[20] {tag}: {tuple(got_l.shape)} losses, expected {CAPTURE_STEPS}")
        torch.testing.assert_close(got_l, want_l, atol=CAPTURE_ATOL, rtol=0.0)
        e_l = (got_l - want_l).abs().max().item()
        e_p = 0.0
        for k, p in want_params.items():
            torch.testing.assert_close(got_params[k], p, atol=CAPTURE_ATOL, rtol=0.0,
                                       msg=lambda m: f"[20] {tag} {k}: {m}")
            e_p = max(e_p, (got_params[k] - p).abs().max().item())
        return e_l, e_p, got_l

    # the comparisons take cuDNN's deterministic algorithms: its default convolution
    # backward is not deterministic from run to run on the card, so two runs of one
    # step can part in the last bits whatever program runs them (the windows below
    # keep the default, as [5] does)
    with patched(torch.backends.cudnn, "deterministic", True):
        for dropout in (False, True):
            tag = f"dropout {'on' if dropout else 'off'}"
            # train.single --use-pallas-kernels: captured in main(), eager here
            cfg = SingleProcessConfig(n_epochs=1, use_pallas_kernels=True, device="cuda",
                                      log_interval=li,
                                      results_dir=str(OUT_DIR / "captured"),
                                      images_dir=str(OUT_DIR / "images"))
            losses = []
            fk.reset_launch_counts()
            with patched(single, "make_epoch_fn", recording_epoch_fn(single.make_epoch_fn,
                                                                     losses)), \
                    patched(single, "build_model", lambda name, **_: net(dropout)), \
                    contextlib.redirect_stdout(io.StringIO()) as said:
                state, _ = single.main(cfg, datasets=sub)
            counts = fk.launch_counts()
            if "Segment program: cuda-graph on cuda" not in said.getvalue():
                fail("[20] train.single did not print the captured program's rule line")
            model = net(dropout)
            e_state = st.create_train_state(model, torch.Generator().manual_seed(cfg.seed),
                                            device=dev)
            loader = BatchLoader(sub[0], BATCH, shuffle=True, seed=cfg.seed)
            loader.set_epoch(1)
            plan = torch.from_numpy(loader.epoch_index_matrix(1, allow_empty=True)).to(dev)
            eager = st.make_segment_fn(st.make_train_step(
                model, learning_rate=cfg.learning_rate, momentum=cfg.momentum,
                use_pallas=True))
            e_losses = []
            for s0 in range(0, CAPTURE_STEPS, li):
                e_state, l = eager(e_state, x, y, plan[s0:s0 + li], cfg.seed)
                e_losses.append(l)
            e_l, e_p, got = compare(f"single {tag}", losses, state.params, e_losses,
                                    e_state.params)
            if counts != dict.fromkeys(counts, CAPTURE_STEPS):
                fail(f"[20] single {tag}: B1-B3 launches {counts} != {CAPTURE_STEPS} steps")
            print(f"[20] train.single --use-pallas-kernels, {tag}: {CAPTURE_STEPS} steps "
                  f"captured (main) vs eager, max |dloss| {e_l:.3e}, max |dparam| "
                  f"{e_p:.3e} "
                  f"(atol {CAPTURE_ATOL:g}); B1-B3 launches in main() (replays counted) "
                  f"{counts}; losses {got[0]:.4f} -> {got[-1]:.4f}")

            # train.distributed at world 1 on NCCL: the reducer inside the graph
            dcfg = DistributedConfig(epochs=1, device="cuda", log_interval=li,
                                     results_dir=str(OUT_DIR / "captured_dp"),
                                     images_dir=str(OUT_DIR / "images"))
            losses, made = [], []
            reducer_cls = dp.GradReducer

            class Recorded(reducer_cls):
                def __init__(self, params):
                    super().__init__(params)
                    made.append(self)

            fk.reset_launch_counts()
            with mesh.cluster(dev) as info:
                if info.backend != "nccl":
                    fail(f"[20] world 1 on the card ran {info.backend}, not nccl")
                with patched(distributed, "make_epoch_fn", recording_epoch_fn(
                        distributed.make_epoch_fn, losses)), \
                        patched(distributed, "build_model", lambda name, **_: net(dropout)), \
                        patched(dp, "GradReducer", Recorded), \
                        contextlib.redirect_stdout(io.StringIO()) as said:
                    d_state, _ = distributed.main(dcfg, datasets=sub)
                d_counts = fk.launch_counts()
                if "Segment program: cuda-graph on cuda" not in said.getvalue():
                    fail("[20] train.distributed did not print the captured program's "
                         "rule line")
                model = net(dropout)
                e_state = st.create_train_state(
                    model, torch.Generator().manual_seed(dcfg.seed), device=dev)
                reducer = reducer_cls(e_state.params)
                plan = torch.from_numpy(distributed.epoch_index_plan(
                    [ShardedSampler(n, seed=dcfg.sampler_seed)], 0, dcfg.global_batch_size)
                ).to(dev)
                eager = st.make_segment_fn(st.make_train_step(
                    model, learning_rate=dcfg.learning_rate, momentum=dcfg.momentum,
                    grad_reduce=reducer))
                e_losses = []
                for s0 in range(0, CAPTURE_STEPS, li):
                    e_state, l = eager(e_state, x, y, plan[s0:s0 + li], dcfg.seed)
                    e_losses.append(l)
            e_l, e_p, got = compare(f"distributed {tag}", losses, d_state.params, e_losses,
                                    e_state.params)
            calls = [r.calls for r in made]
            if calls != [CAPTURE_STEPS] or any(d_counts.values()):
                fail(f"[20] distributed {tag}: reducer calls {calls} (want "
                     f"[{CAPTURE_STEPS}]), "
                     f"kernel launches {d_counts} (want none)")
            print(f"[20] train.distributed world 1 (nccl), {tag}: {CAPTURE_STEPS} steps "
                  f"captured (main, all-reduce in the graph) vs eager, max |dloss| "
                  f"{e_l:.3e}, "
                  f"max |dparam| {e_p:.3e} (atol {CAPTURE_ATOL:g}); reducer calls (replays "
                  f"counted) {calls[0]}; losses {got[0]:.4f} -> {got[-1]:.4f}")

    # profiler windows over replays of full-split segments, beside the eager loop
    full_x = torch.from_numpy(train_ds.images).to(dev)
    full_y = torch.from_numpy(train_ds.labels.astype("int64")).to(dev)
    loader = BatchLoader(train_ds, BATCH, shuffle=True, seed=1)
    loader.set_epoch(1)
    plan = torch.from_numpy(loader.epoch_index_matrix(1)).to(dev)
    steps = CAPTURE_WINDOW * li

    def windows(tag, captured, eager, state, seed, ours):
        state, _ = captured(state, full_x, full_y, plan[:li], seed)     # the capture
        state, _ = eager(state, full_x, full_y, plan[:li], seed)
        ms = {"captured": [], "eager": []}
        for name in ("eager", "captured", "captured", "eager"):
            fn = captured if name == "captured" else eager
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(1, CAPTURE_WINDOW + 1):
                state, _ = fn(state, full_x, full_y, plan[i * li:(i + 1) * li], seed)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) / steps * 1e3)
        print(f"[20] {tag}: step ms in turns ({steps} steps a run): captured "
              f"{', '.join(f'{t:.4f}' for t in ms['captured'])}; eager "
              f"{', '.join(f'{t:.4f}' for t in ms['eager'])} [{card}]")
        for name, fn in (("captured", captured), ("eager", eager)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(1, CAPTURE_WINDOW + 1):
                    state, _ = fn(state, full_x, full_y, plan[i * li:(i + 1) * li], seed)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            rows = device_kernel_times(prof)
            report_window(f"[20] {tag} {name}:", rows, steps, wall, ours, card)
            keyed = [(us, n) for us, n, k in rows if "elementwise" in k and "<long" in k]
            print(f"[20] {tag} {name}: int64 elementwise kernels (the dropout key and "
                  f"masks, the step count) {sum(us for us, _ in keyed) / steps:.3f} us a "
                  f"step in {sum(n for _, n in keyed) / steps:.1f} launches")
            calls = host_launch_calls(prof)
            print(f"[20] {tag} {name}: host launch calls {sum(calls.values()) / steps:.2f} "
                  f"per step ({calls})")
        return state

    model = Net()
    state = st.create_train_state(model, torch.Generator().manual_seed(1), device=dev)
    step_fn = st.make_train_step(model, learning_rate=LR, momentum=MOMENTUM,
                                 use_pallas=True)
    windows("train.single step (B1-B3)", st.CapturedSegment(step_fn),
            st.make_segment_fn(step_fn), state, 1,
            ("nll_fwd_kernel", "nll_bwd_kernel", "sgd_momentum_multi_kernel"))
    with mesh.cluster(dev):
        model = Net()
        state = st.create_train_state(model, torch.Generator().manual_seed(1), device=dev)
        reducer = dp.GradReducer(state.params)
        step_fn = st.make_train_step(model, learning_rate=0.02, momentum=MOMENTUM,
                                     grad_reduce=reducer)
        windows("train.distributed step (world 1, nccl)",
                st.CapturedSegment(step_fn, grad_reduce=reducer),
                st.make_segment_fn(step_fn), state, 1, ("nccl",))
    single_ms = earlier["single_s"] / earlier["single_steps"] * 1e3
    dp_ms = earlier["dp_s"] / earlier["dp_steps"] * 1e3
    print(f"[20] one full epoch each, captured: train.single {earlier['single_s']:.3f} s "
          f"({earlier['single_steps']} steps, {single_ms:.4f} ms a step, B1-B3 launches "
          f"{earlier['single_launches']}) [5]; train.distributed world 1 "
          f"{earlier['dp_s']:.3f} s ({earlier['dp_steps']} steps, {dp_ms:.4f} ms a step) "
          f"[15]; the bench's captured epoch: median {earlier['bench']['value']} s, "
          f"samples {earlier['bench']['epoch_seconds_all']} [16] [{card}]")
    del full_x, full_y
    torch.cuda.empty_cache()


POISON_CHILD = """
import sys, runpy
import numpy as np
sys.path.insert(0, {root!r})
from {pkg} import data
from {pkg}.data import mnist

def load_mnist(data_dir):
    x, y = mnist._synthesize_split({n_train}, 400)
    x = mnist._normalize(x)
    x[{row}] = np.nan
    tx, ty = mnist._synthesize_split(1000, 401)
    return (mnist.Dataset(x, y.astype(np.int32), "synthetic"),
            mnist.Dataset(mnist._normalize(tx), ty.astype(np.int32), "synthetic"))

data.load_mnist = load_mnist
sys.argv = ["{module}", *{argv!r}]
runpy.run_module("{pkg}.train.{module}", run_name="__main__")
"""


def remainder_phase(dev, card: str) -> None:
    """Phase 21: the step's remainder, the card's captured program against the CPU's
    eager loop, and the guard's exit.

    Three settings, 20 steps each at batch 64 on a synthetic split, dropout off, from the
    same initial parameters: (a) the fused kernels with grad_accum 4, clipping and the EMA;
    (b) AdamW with weight decay, a cosine schedule with warmup, label smoothing and
    clipping; (c) the guard (fused kernels: the in-place update restored from a snapshot
    inside the graph) with a NaN batch at ``POISON_STEP`` and the skip window
    ``SKIP_WINDOW``. Losses (NaN where both are), parameters and the EMA within
    ``REMAINDER_ATOL``, the guard's counters equal as integers. Then ``python -m
    <port>.train.single --guard --anomaly-exit 1`` on a split with one NaN image: exit 65,
    the marker and the window the plan predicts."""
    import numpy as np
    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
        BatchLoader, mnist,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import Net
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import optim
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
        poison,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        step as st,
    )

    xs, ys = mnist._synthesize_split(CAPTURE_STEPS * BATCH, 500)
    images = mnist._normalize(xs)
    images[POISON_STEP * BATCH + 3] = np.nan           # one example of step 7's batch
    plan = np.arange(CAPTURE_STEPS * BATCH).reshape(CAPTURE_STEPS, BATCH)
    cases = (
        ("(a) fused kernels, grad_accum 4, clip 0.5, EMA 0.9", {},
         dict(use_pallas=True, grad_accum=4, clip_grad_norm=0.5, ema_decay=0.9)),
        ("(b) AdamW wd 0.01, cosine warmup 5, label smoothing 0.1, clip 1.0",
         dict(optimizer=optim.adamw(1e-3, weight_decay=0.01)),
         dict(lr_schedule=optim.make_lr_schedule("cosine", warmup_steps=5,
                                                 total_steps=CAPTURE_STEPS),
              label_smoothing=0.1, clip_grad_norm=1.0)),
        (f"(c) guard, fused kernels, NaN batch at step {POISON_STEP}, skip window "
         f"{SKIP_WINDOW[0]}:{SKIP_WINDOW[1]}", {},
         dict(use_pallas=True, guard=st.GuardSpec(skip=(SKIP_WINDOW,)))),
    )
    model = Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    for label, init, kw in cases:
        clean = label.startswith("(a)") or label.startswith("(b)")
        data = images.copy()
        if clean:
            data = np.nan_to_num(data, nan=0.0)
        runs = {}
        for device in (dev, torch.device("cpu")):
            state = st.create_train_state(model, torch.Generator().manual_seed(7),
                                          device=device, ema=kw.get("ema_decay", 0) > 0,
                                          guard="guard" in kw, **init)
            epoch = st.make_epoch_fn(model, learning_rate=LR, momentum=MOMENTUM, **init,
                                     **kw)
            xd = torch.from_numpy(data).to(device)
            yd = torch.from_numpy(ys.astype("int64")).to(device)
            pd = torch.from_numpy(plan).to(device)
            losses = []
            for s0 in range(0, CAPTURE_STEPS, CAPTURE_LOG_INTERVAL):
                state, l = epoch(state, xd, yd, pd[s0:s0 + CAPTURE_LOG_INTERVAL], 1)
                losses.append(l)
            runs[device.type] = (torch.cat(losses).cpu(), state)
        (l_card, s_card), (l_cpu, s_cpu) = runs["cuda"], runs["cpu"]
        torch.testing.assert_close(l_card, l_cpu, atol=REMAINDER_ATOL, rtol=0.0,
                                   equal_nan=True, msg=lambda m: f"[21] {label}: {m}")
        e_p = 0.0
        for name, tree in (("params", "params"), ("ema", "ema")):
            card_t, cpu_t = getattr(s_card, tree), getattr(s_cpu, tree)
            for k in (cpu_t or {}):
                torch.testing.assert_close(card_t[k].cpu(), cpu_t[k], atol=REMAINDER_ATOL,
                                           rtol=0.0, msg=lambda m: f"[21] {label} {k}: {m}")
                e_p = max(e_p, (card_t[k].cpu() - cpu_t[k]).abs().max().item())
        e_l = (l_card - l_cpu).nan_to_num(0.0).abs().max().item()
        guard_line = ""
        if s_cpu.guard is not None:
            counters = {f: (int(getattr(s_card.guard, f)), int(getattr(s_cpu.guard, f)))
                        for f in ("anomalies", "nonfinite", "spikes", "skipped",
                                  "first_anomaly_step", "last_anomaly_step", "count")}
            if any(a != b for a, b in counters.values()):
                fail(f"[21] {label}: guard counters differ (card, cpu): {counters}")
            want = {"anomalies": 1, "nonfinite": 1, "skipped": 3,
                    "first_anomaly_step": POISON_STEP, "last_anomaly_step": POISON_STEP}
            if any(counters[f][0] != v for f, v in want.items()):
                fail(f"[21] {label}: guard counters {counters}, expected {want}")
            guard_line = f"; guard counters equal: { {f: c[0] for f, c in counters.items()} }"
        print(f"[21] {label}: {CAPTURE_STEPS} steps, card (captured) vs CPU (eager): max "
              f"|dloss| {e_l:.3e}, max |dparam| (and EMA) {e_p:.3e} (atol "
              f"{REMAINDER_ATOL:g}){guard_line}")

    # the guard's exit: train.single --guard --anomaly-exit 1 on a poisoned split
    row = 5
    loader = BatchLoader(mnist.Dataset(np.zeros((POISON_TRAIN, 28, 28, 1), np.float32),
                                       np.zeros(POISON_TRAIN, np.int32), "synthetic"),
                         BATCH, shuffle=True, seed=1)
    loader.set_epoch(1)
    bad_step = int(np.nonzero((loader.epoch_index_matrix(1) == row).any(axis=1))[0][0])
    results = OUT_DIR / "poisoned"
    shutil.rmtree(results, ignore_errors=True)
    argv = ["--guard", "--anomaly-exit", "1", "--n-epochs", "2", "--use-pallas-kernels",
            "--results-dir", str(results), "--images-dir", str(results / "images")]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    proc = subprocess.run([sys.executable, "-c", POISON_CHILD.format(
        root=str(ROOT), pkg=PKG, n_train=POISON_TRAIN, row=row, module="single",
        argv=argv)], capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    marker = poison.read_marker(str(results / "checkpoints"), consume=False)
    tail = [l for l in proc.stdout.splitlines() if l.strip()][-2:]
    print(f"[21] python -m {PKG}.train.single {' '.join(argv[:-4])} on {POISON_TRAIN} "
          f"examples with image {row} NaN (step {bad_step} of epoch 1): exit "
          f"{proc.returncode}, marker {marker and marker['window']}; {tail}")
    if proc.returncode != poison.EXIT_POISONED:
        print(proc.stderr[-4000:], file=sys.stderr)
        fail(f"[21] the poisoned run exited {proc.returncode}, not {poison.EXIT_POISONED}")
    if marker is None or marker["window"] != (bad_step, bad_step + 1):
        fail(f"[21] the poison marker {marker} does not name the window "
             f"{bad_step}:{bad_step + 1}")
    if "Segment program: cuda-graph" not in proc.stdout:
        fail("[21] the poisoned run did not train through the captured program")


class _Timed:
    """A trainer's saver, timed on the host around each call (the harness's; the trainers
    have no such option)."""

    def __init__(self, inner):
        self.inner, self.ms = inner, []

    def save_train_state(self, path, state):
        t0 = time.perf_counter()
        self.inner.save_train_state(path, state)
        self.ms.append((time.perf_counter() - t0) * 1e3)

    def flush(self):
        self.inner.flush()


class NoSaves:
    """A saver that writes nothing: the harness's way to run ``main`` without its
    checkpoints ([5], and the baseline of [22] (b))."""

    def save_train_state(self, path, state):
        pass

    def flush(self):
        pass


def checkpoint_phase(dev, card: str, train_ds, test_ds, earlier: dict) -> None:
    """Phase 22: the checkpoints on the card.

    cuDNN's default convolution backward is not deterministic from run to run on the card,
    so the comparisons of one run with another ((a), and (b)'s bytes) take its
    deterministic algorithms (``torch.backends.cudnn.deterministic``); (b)'s timed epochs
    keep the default, as [5] does.

    (a) ``train.distributed`` at world 1 on NCCL, captured, with the fused kernels (B1-B3;
    the data-parallel trainer has no ``--use-pallas-kernels``, as the JAX package's has
    none, so the harness passes ``use_pallas=True`` to its ``make_epoch_fn``): 2 epochs
    straight against 1 epoch and then ``--epochs 2 --resume-from model_dist.ckpt``, losses
    and parameters within ``RESUME_ATOL``, B1-B3 launches and reducer calls equal to the
    steps each run trains; (b) ``train.single --use-pallas-kernels`` for one epoch with its
    log-tick saves: bytes a save, saves an epoch, host ms a save, the epoch's seconds
    against saves turned off in the harness, in turns, then ``--async-checkpoint``'s
    ``model.ckpt`` against the sync run's, byte for byte; (c) the card's files decoded by
    the port's codec and restored on the CPU, bitwise against the card's final states, and
    ``load_params_or_state`` on ``model_dist.msgpack``; (d) ``python -m <port>.train.single
    --handle-preemption --keep-checkpoints 2 --guard`` sent SIGTERM in epoch 2: exit 75, the
    manifest's newest entry verifies with a clean stamp, and a resume from it finishes;
    (e) whether the plots were written.

    ``dev`` may be the CPU for a rehearsal at a small split: the eager program and gloo
    then stand in for the graph and NCCL, and the kernels' counters count nothing."""
    import signal

    import numpy as np
    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch import resilience
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import Net
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        fused_kernels as fk,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
        data_parallel as dp, mesh,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        distributed, single, step as st,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        _msgpack, checkpoint,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        DistributedConfig, SingleProcessConfig,
    )

    on_card = dev.type == "cuda"
    launched = lambda n: n if on_card else 0     # the plain versions count no launch
    rule = f"Segment program: {st.segment_program(dev)} on {dev.type}"
    root = OUT_DIR / "checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    images = root / "images"

    # (a) resume at world 1 on NCCL, captured, B1-B3 and the reducer in the graph
    runs = {}
    with mesh.cluster(dev) as info, patched(torch.backends.cudnn, "deterministic", True):
        if info.backend != ("nccl" if on_card else "gloo"):
            fail(f"[22] world 1 on {dev} ran {info.backend}")
        for name, epochs, resume in (("straight", 2, ""), ("first", 1, ""),
                                     ("resumed", 2, str(root / "first" / "model_dist.ckpt"))):
            losses, made = [], []
            reducer_cls = dp.GradReducer

            class Recorded(reducer_cls):
                def __init__(self, params):
                    super().__init__(params)
                    made.append(self)

            cfg = DistributedConfig(epochs=epochs, device=dev.type, resume_from=resume,
                                    results_dir=str(root / name), images_dir=str(images))
            fused = lambda *a, **k: st.make_epoch_fn(*a, use_pallas=True, **k)
            fk.reset_launch_counts()
            with patched(distributed, "make_epoch_fn", recording_epoch_fn(fused, losses)), \
                    patched(dp, "GradReducer", Recorded), \
                    contextlib.redirect_stdout(io.StringIO()) as said:
                state, _ = distributed.main(cfg, datasets=(train_ds, test_ds))
            out = said.getvalue()
            if rule not in out:
                fail(f"[22] (a) {name}: train.distributed did not print '{rule}'")
            runs[name] = dict(state=state, losses=torch.cat(losses).cpu(),
                              counts=fk.launch_counts(), calls=[r.calls for r in made],
                              out=out)
    steps = len(train_ds) // BATCH                    # a data-parallel epoch
    full = -(-len(train_ds) // BATCH)                 # train.single's: the ragged tail too
    for name, trained in (("straight", 2 * steps), ("first", steps), ("resumed", steps)):
        r = runs[name]
        if (r["counts"] != dict.fromkeys(r["counts"], launched(trained))
                or r["calls"] != [trained]):
            fail(f"[22] (a) {name}: B1-B3 launches {r['counts']}, reducer calls "
                 f"{r['calls']}; the plan is {trained} steps")
        print(f"[22] (a) train.distributed world 1 ({rule}, fused kernels) {name}: "
              f"{trained} steps; B1-B3 launches {r['counts']}, reducer calls {r['calls'][0]} "
              f"(replays counted) = the plan")
    if f"Resumed from {root / 'first' / 'model_dist.ckpt'} at step {steps} (starting " \
            f"epoch 1)" not in runs["resumed"]["out"]:
        fail("[22] (a) the resumed run did not report its resume at epoch 1")
    straight, resumed = runs["straight"], runs["resumed"]
    if not int(resumed["state"].step) == int(straight["state"].step) == 2 * steps:
        fail(f"[22] (a) steps {int(resumed['state'].step)} and "
             f"{int(straight['state'].step)}, expected {2 * steps}")
    want_l = straight["losses"][steps:]
    torch.testing.assert_close(resumed["losses"], want_l, atol=RESUME_ATOL, rtol=0.0)
    e_l = (resumed["losses"] - want_l).abs().max().item()
    e_p = 0.0
    for k, p in straight["state"].params.items():
        got = resumed["state"].params[k]
        torch.testing.assert_close(got, p, atol=RESUME_ATOL, rtol=0.0,
                                   msg=lambda m: f"[22] (a) {k}: {m}")
        e_p = max(e_p, (got - p).abs().max().item())
    print(f"[22] (a) 1 epoch + --resume-from model_dist.ckpt vs 2 epochs straight: max "
          f"|dloss| {e_l:.3e} over epoch 1's {steps} steps, max |dparam| {e_p:.3e} (atol "
          f"{RESUME_ATOL:g}); losses {resumed['losses'][0]:.4f} -> "
          f"{resumed['losses'][-1]:.4f}")

    # (b) the log-tick saves of train.single, their cost, and the async saver's bytes
    real = checkpoint.make_saver
    timed = {"sync": [], "async": []}            # each run's host ms a save, by saver

    def timed_saver(async_=False, tele=None):
        saver = _Timed(real(async_, tele=tele))
        timed["async" if async_ else "sync"].append(saver.ms)
        return saver

    order = ("off", "sync", "async", "async", "sync", "off")   # timed, in turns
    epochs = {mode: [] for mode in order}
    finals = {}
    for turn, mode in enumerate(order + ("sync", "async")):
        pair = turn >= len(order)        # the byte comparison: deterministic convolutions
        d = root / f"single_{turn}_{mode}"
        cfg = SingleProcessConfig(n_epochs=1, use_pallas_kernels=True, device=dev.type,
                                  async_checkpoint=mode == "async", results_dir=str(d),
                                  images_dir=str(images))
        factory = (lambda async_=False, tele=None: NoSaves()) if mode == "off" else timed_saver
        fk.reset_launch_counts()
        with patched(checkpoint, "make_saver", factory), \
                patched(torch.backends.cudnn, "deterministic", pair), \
                contextlib.redirect_stdout(io.StringIO()):
            state, history = single.main(cfg, datasets=(train_ds, test_ds))
        if fk.launch_counts() != dict.fromkeys(fk.launch_counts(), launched(full)):
            fail(f"[22] (b) {mode}: B1-B3 launches {fk.launch_counts()} != {full}")
        if not pair:
            epochs[mode].append(history.epoch_seconds[0])
        else:
            finals[mode] = (d, state)
    ticks = -(-steps // SingleProcessConfig().log_interval)
    for ms in timed["sync"] + timed["async"]:
        if len(ms) != ticks + 1:               # the ticks, and the closing save
            fail(f"[22] (b) {len(ms)} saves in one epoch, expected {ticks} + 1")
    ckpt = {mode: (d / "model.ckpt").read_bytes() for mode, (d, _) in finals.items()}
    nbytes = len(ckpt["sync"])
    tick_ms = {mode: [m for ms in runs[:2] for m in ms[:-1]] for mode, runs in timed.items()}
    print(f"[22] (b) train.single --use-pallas-kernels, one epoch: {ticks} saves an epoch "
          f"(every log tick) + 1 closing, {nbytes} bytes a save; host ms a save "
          f"({len(tick_ms['sync'])} each): sync median {np.median(tick_ms['sync']):.4f}, "
          f"max {max(tick_ms['sync']):.4f}; async (the host copy) median "
          f"{np.median(tick_ms['async']):.4f}, max {max(tick_ms['async']):.4f} [{card}]")
    off_s = np.mean(epochs["off"])
    cost = {mode: np.mean(epochs[mode]) - off_s for mode in ("sync", "async")}
    print(f"[22] (b) epoch s in turns ({', '.join(order)}): "
          f"{', '.join(f'{epochs[m][order[:k].count(m)]:.4f}' for k, m in enumerate(order))};"
          f" the {ticks} saves cost, sync {cost['sync']:.4f} s an epoch "
          f"({cost['sync'] / off_s * 100:.1f}%, {cost['sync'] / ticks * 1e3:.4f} ms a save), "
          f"async {cost['async']:.4f} s ({cost['async'] / off_s * 100:.1f}%); [5]'s epoch "
          f"without saves {earlier['single_s']:.4f} s [{card}]")
    # where a sync save's host time goes, on the last run's final state
    path, parts = str(root / "breakdown.ckpt"), {"host copy": [], "layout": [],
                                                 "encode": [], "write": []}
    for _ in range(20):
        t0 = time.perf_counter()
        host = checkpoint._host_copy(finals["sync"][1])
        t1 = time.perf_counter()
        tree = checkpoint.state_to_jax_dict(host)
        t2 = time.perf_counter()
        data = _msgpack.packb(tree)
        t3 = time.perf_counter()
        checkpoint._atomic_write(path, data)
        t4 = time.perf_counter()
        for name, a, b in (("host copy", t0, t1), ("layout", t1, t2), ("encode", t2, t3),
                           ("write", t3, t4)):
            parts[name].append((b - a) * 1e3)
    print(f"[22] (b) a sync save's host ms by part (median of 20): "
          f"{ {k: round(float(np.median(v)), 4) for k, v in parts.items()} } [{card}]")
    if ckpt["async"] != ckpt["sync"]:
        fail("[22] (b) --async-checkpoint's model.ckpt differs from the sync run's")
    print(f"[22] (b) --async-checkpoint's model.ckpt == the sync run's, byte for byte "
          f"({nbytes} bytes; both runs with deterministic cuDNN convolutions)")

    # (c) the card's files decode with the port's codec and restore bitwise on the CPU
    cpu_ref = st.create_train_state(Net(), torch.Generator().manual_seed(0))
    for label, path, want in (
            ("model_dist.ckpt (a)", root / "resumed" / "model_dist.ckpt",
             resumed["state"]),
            ("model.ckpt (b)", finals["sync"][0] / "model.ckpt", finals["sync"][1])):
        raw = _msgpack.from_bytes(path.read_bytes())
        got = checkpoint.restore_train_state(str(path), cpu_ref)
        same = all(torch.equal(got.params[k], want.params[k].cpu()) for k in got.params)
        same_v = all(torch.equal(got.velocity[k], want.velocity[k].cpu())
                     for k in got.velocity)
        if not (same and same_v and int(got.step) == int(want.step)):
            fail(f"[22] (c) {label} restored on the CPU differs from the card's final state")
        print(f"[22] (c) {label}: decoded ({list(raw)}, step {int(raw['step'])} "
              f"{raw['step'].dtype}), restored on the CPU bitwise equal to the card's final "
              f"params and velocity, step {int(got.step)}")
    export = checkpoint.load_params_or_state(str(root / "resumed" / "model_dist.msgpack"),
                                             cpu_ref.params)
    if not all(torch.equal(export[k], resumed["state"].params[k].cpu()) for k in export):
        fail("[22] (c) model_dist.msgpack differs from the final params")
    print("[22] (c) load_params_or_state(model_dist.msgpack) == the final params, bitwise")

    # (d) preemption: SIGTERM in epoch 2, exit 75, the newest entry verifies, resume
    pre = root / "preempted"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT)
    common = ["--guard", "--use-pallas-kernels", "--images-dir", str(images), "--device",
              dev.type, "--max-train-examples", str(len(train_ds)), "--max-test-examples",
              str(len(test_ds))]
    argv = ["--handle-preemption", "--keep-checkpoints", "2", "--n-epochs",
            str(PREEMPT_EPOCHS), "--heartbeat-dir", str(pre / "hb"), "--results-dir",
            str(pre), *common]
    proc = subprocess.Popen([sys.executable, "-m", f"{PKG}.train.single", *argv], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    beat = pre / "hb" / "heartbeat_p0.json"
    try:
        deadline = time.monotonic() + 300
        while True:
            if proc.poll() is not None:
                print(proc.communicate()[1][-4000:], file=sys.stderr)
                fail(f"[22] (d) the run exited {proc.returncode} before epoch 2")
            if time.monotonic() > deadline:
                fail("[22] (d) no heartbeat of epoch 2 within 300 s")
            try:
                if json.loads(beat.read_text())["epoch"] >= 2:
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.002)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != resilience.EXIT_PREEMPTED:
        print(err[-4000:], file=sys.stderr)
        fail(f"[22] (d) the preempted run exited {proc.returncode}, not "
             f"{resilience.EXIT_PREEMPTED}")
    store = pre / "checkpoints"
    newest = checkpoint.load_manifest(str(store))["entries"][-1]
    newest_path = str(store / newest["file"])
    if checkpoint.newest_valid_checkpoint(str(store)) != newest_path:
        fail(f"[22] (d) the manifest's newest entry {newest['file']} does not verify")
    if not newest.get("health", {}).get("clean") or newest["step"] != 2 * full:
        fail(f"[22] (d) newest entry {newest}: expected a clean stamp at step {2 * full} "
             f"(the end of epoch 2)")
    if rule not in out:
        fail(f"[22] (d) the preempted run did not print '{rule}'")
    print(f"[22] (d) python -m {PKG}.train.single {' '.join(argv[:5] + common[:2])}: "
          f"SIGTERM in epoch 2, "
          f"exit {proc.returncode}; manifest newest {newest['file']} (step {newest['step']}) "
          f"verifies, health {newest['health']}; "
          f"{[l for l in out.splitlines() if l.startswith('preempted')]}")
    resume = subprocess.run(
        [sys.executable, "-m", f"{PKG}.train.single", "--resume-from", newest_path,
         "--n-epochs", "1", "--results-dir", str(pre / "resumed"), *common],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if resume.returncode != 0:
        print(resume.stderr[-4000:], file=sys.stderr)
        fail(f"[22] (d) the resume exited {resume.returncode}")
    final = checkpoint.restore_train_state(str(pre / "resumed" / "model.ckpt"),
                                           st.create_train_state(Net(), torch.Generator(),
                                                                 guard=True))
    if int(final.step) != 3 * full or "WARNING" in resume.stdout:
        fail(f"[22] (d) the resume ended at step {int(final.step)} (want {3 * full}) or "
             f"warned: {resume.stdout[-2000:]}")
    print(f"[22] (d) --resume-from {newest['file']} --n-epochs 1: exit 0 at step "
          f"{int(final.step)}, cursor consistent (no warning)")

    # (e) the plots
    try:
        import matplotlib  # noqa: F401
        have = True
    except ImportError:
        have = False
    pngs = sorted(p.name for p in images.glob("*.png"))
    want = ["train_images.png", "train_test_curve.png", "train_test_curve_dist.png"]
    if have and pngs != want:
        fail(f"[22] (e) matplotlib is present but the plots are {pngs}, not {want}")
    if not have and pngs:
        fail(f"[22] (e) matplotlib is absent but plots were written: {pngs}")
    print(f"[22] (e) plots: {pngs} written" if have else
          "[22] (e) plots: matplotlib is absent on this machine; each plot returned None")


@contextlib.contextmanager
def numpy_data_path(on: bool):
    """``CSED514_TPU_NO_NATIVE`` set for the block when ``on``: the data callers take their
    numpy paths (``data.native.available()`` reads it at each call)."""
    name = "CSED514_TPU_NO_NATIVE"
    old = os.environ.get(name)
    if on:
        os.environ[name] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def host_fed_phase(dev, card: str, train_ds, test_ds) -> None:
    """Phase 23: the host-fed data path on the card.

    (a) the native loader (``data/_native/loader.cc``): a fresh g++ build of the repo's
    source (its seconds; the process's own library was built at first use by [5]'s
    ``load_mnist``), ``native.available()`` asserted, then ``native.normalize`` (1 and 4
    threads), ``native.gather`` and the ``Prefetcher``'s order over a full epoch plan held
    bitwise against numpy on the synthetic split, the epoch's host batches timed through
    the native prefetcher and through numpy's gather; ``tests/fixtures/mnist_idx`` read
    through ``native.load_idx``, and ``download_mnist`` against a local ``http.server``
    that serves that fixture (no network); (b) ``train.single --use-pallas-kernels
    --use-host-pipeline``, one full epoch under each host-fed program in turns (eager,
    captured, captured, eager) and once captured with ``CSED514_TPU_NO_NATIVE`` (the numpy
    path), each against the device-resident captured epoch (the tick losses, the test loss,
    the final parameters within ``CAPTURE_ATOL``), B1-B3 launches = the epoch's steps, the
    bar (test NLL below 1.0, accuracy at least 0.85), epoch seconds, wall ms a step, the
    loader's data-wait seconds, then host launch calls a step of each program in a
    profiler window; (c) ``train.distributed --host-local-feed`` at world 1 on NCCL against
    the device-resident world-1 epoch, reducer calls = steps; (d) ``BatchLoader(prefetch=2,
    device=cuda)``: values and order equal the host iterator's, and the data-wait seconds
    of an epoch fed to the eager fused step with and without the prefetch.

    The runs compared with one another take cuDNN's deterministic algorithms (as [22]).
    ``dev`` may be the CPU for a rehearsal on a cut split: every host-fed program is then
    eager, and gloo stands in for NCCL."""
    import functools
    import http.server
    import threading

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
        BatchLoader, download, iter_plan_batches, mnist, native,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data._native import (
        build as native_build,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import Net
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        fused_kernels as fk,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
        data_parallel as dp, mesh,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        distributed, single, step as st,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        DistributedConfig, SingleProcessConfig,
    )

    on_card = dev.type == "cuda"
    root = OUT_DIR / "host_fed"
    shutil.rmtree(root, ignore_errors=True)
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)

    # (a) the native loader
    with patched(native_build, "BUILD_DIR", root / "native_build"):
        built = native_build.build()
    if not native.available():
        fail(f"[23] (a) the native loader is not available: {native.unavailable_reason()}")
    print(f"[23] (a) g++ built {native_build.SOURCE.relative_to(ROOT)} afresh in "
          f"{built.seconds:.2f} s; the process's library (built at first use): "
          f"{native_build.library_path().name}, available: {native.available()}")
    raw, _ = mnist._synthesize_split(len(train_ds), 514)
    for threads in (1, 4):
        if not np.array_equal(native.normalize(raw, mnist.MNIST_MEAN, mnist.MNIST_STD,
                                               num_threads=threads), mnist._normalize(raw)):
            fail(f"[23] (a) native.normalize ({threads} threads) differs from numpy's")
    loader = BatchLoader(train_ds, BATCH, shuffle=True, seed=1)
    plan = loader.epoch_index_matrix(1)
    for row in plan[::50]:
        gi, gl = native.gather(train_ds.images, train_ds.labels, row)
        if not (np.array_equal(gi, train_ds.images[row])
                and np.array_equal(gl, train_ds.labels[row])):
            fail("[23] (a) native.gather differs from numpy's")
    epoch_s = {}
    for path in ("native", "numpy", "native", "numpy"):
        with numpy_data_path(path == "numpy"):
            if native.path_name() != path:
                fail(f"[23] (a) the {path} path was asked for, {native.path_name()} ran")
            t0 = time.perf_counter()
            got = list(iter_plan_batches(train_ds, plan))
            epoch_s.setdefault(path, []).append(time.perf_counter() - t0)
        if len(got) != len(plan) or not all(
                np.array_equal(bi, train_ds.images[plan[s]])
                and np.array_equal(bl, train_ds.labels[plan[s]])
                for s, (bi, bl) in enumerate(got)):
            fail(f"[23] (a) the {path} path's epoch of batches differs from the plan's")
    print(f"[23] (a) normalize (1 and 4 threads), gather and the Prefetcher's {len(plan)} "
          f"batches in plan order == numpy, bitwise; one epoch of host batches in turns: "
          f"native prefetcher {', '.join(f'{t:.4f}' for t in epoch_s['native'])} s, numpy "
          f"gather {', '.join(f'{t:.4f}' for t in epoch_s['numpy'])} s")
    fixture = ROOT / "tests" / "fixtures" / "mnist_idx"
    for name in sorted(os.listdir(fixture)):
        if not np.array_equal(native.load_idx(str(fixture / name)),
                              mnist._read_idx(str(fixture / name))):
            fail(f"[23] (a) native.load_idx({name}) differs from numpy's reader")
    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Quiet, directory=str(fixture)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        sums = {n: download._md5(str(fixture / n)) for n in download.FILES}
        url = f"http://127.0.0.1:{server.server_address[1]}/"
        paths = download.download_mnist(str(root / "files"), mirrors=(url,), checksums=sums)
    finally:
        server.shutdown()
        thread.join(timeout=10)
    fetched, _ = mnist.load_mnist(str(root / "files"), allow_synthetic=False)
    print(f"[23] (a) native.load_idx on {len(os.listdir(fixture))} fixture files == numpy, "
          f"bitwise; download_mnist from a local http.server: {len(paths)} files checked, "
          f"loaded ({fetched.source}, {len(fetched)} train)")

    # (b) train.single --use-host-pipeline: each program against the device-resident epoch
    full = -(-len(train_ds) // BATCH)
    x_test = torch.from_numpy(test_ds.images).to(dev)
    y_test = torch.from_numpy(test_ds.labels.astype("int64")).to(dev)
    runs = {}
    programs = ("eager", "cuda-graph") if on_card else ("eager", "eager")
    order = [("device", None, False), ("eager", programs[0], False),
             ("captured", programs[1], False), ("captured", programs[1], False),
             ("eager", programs[0], False), ("captured, numpy", programs[1], True)]
    with patched(torch.backends.cudnn, "deterministic", True):
        for name, program, numpy_path in order:
            cfg = SingleProcessConfig(n_epochs=1, use_pallas_kernels=True, device=dev.type,
                                      use_host_pipeline=program is not None,
                                      results_dir=str(root / "single"),
                                      images_dir=str(root / "images"))
            make = (functools.partial(st.HostFedStep, program=program) if program
                    else st.HostFedStep)
            fk.reset_launch_counts()
            with patched(single, "HostFedStep", make), \
                    patched(checkpoint, "make_saver", lambda async_=False, tele=None: NoSaves()), \
                    numpy_data_path(numpy_path), \
                    contextlib.redirect_stdout(io.StringIO()) as said:
                state, hist = single.main(cfg, datasets=(train_ds, test_ds))
            counts = fk.launch_counts()
            sum_nll, correct = st.make_eval_fn(Net())(state.params, x_test, y_test)
            line = next((l for l in said.getvalue().splitlines()
                         if l.startswith(("Host-fed program", "Segment program"))), "")
            runs.setdefault(name, []).append(dict(
                state=state, hist=hist, counts=counts, line=line,
                nll=sum_nll.item() / len(test_ds), acc=correct.item() / len(test_ds)))
    ref = runs["device"][0]
    print(f"[23] (b) the device-resident captured epoch: {ref['hist'].epoch_seconds[0]:.3f} s "
          f"({ref['line']}) [{card}]")
    for name in ("eager", "captured", "captured, numpy"):
        program = "cuda-graph" if name != "eager" and on_card else "eager"
        path = "numpy" if "numpy" in name else "native"
        for r in runs[name]:
            if not (r["line"].startswith(f"Host-fed program: {program} on {dev.type}")
                    and r["line"].endswith(f"host batches: {path}")):
                fail(f"[23] (b) {name}: the trainer printed {r['line']!r}")
            if r["counts"] != dict.fromkeys(r["counts"], full if on_card else 0):
                fail(f"[23] (b) {name}: B1-B3 launches {r['counts']}, expected {full}")
            e_l = np.abs(np.subtract(r["hist"].train_losses,
                                     ref["hist"].train_losses)).max()
            e_t = abs(r["hist"].test_losses[-1] - ref["hist"].test_losses[-1])
            e_p = max((r["state"].params[k] - p).abs().max().item()
                      for k, p in ref["state"].params.items())
            if max(e_l, e_t, e_p) > CAPTURE_ATOL or len(r["hist"].train_losses) != len(
                    ref["hist"].train_losses):
                fail(f"[23] (b) {name}: |dloss| {e_l:.3e}, |dtest| {e_t:.3e}, |dparam| "
                     f"{e_p:.3e} against the device-resident epoch (atol {CAPTURE_ATOL:g})")
            if on_card and not (r["nll"] < 1.0 and r["acc"] >= 0.85):  # the full split
                fail(f"[23] (b) {name}: test NLL {r['nll']:.4f}, accuracy {r['acc']:.4f}")
            s = r["hist"].epoch_seconds[0]
            print(f"[23] (b) {name}: epoch {s:.3f} s, {s / full * 1e3:.4f} ms a step, data "
                  f"wait {r['hist'].data_wait_seconds[0]:.4f} s; B1-B3 launches "
                  f"{r['counts']}; vs the device-resident epoch: max |dloss| {e_l:.3e} over "
                  f"{len(r['hist'].train_losses)} ticks, |dtest| {e_t:.3e}, max |dparam| "
                  f"{e_p:.3e} (atol {CAPTURE_ATOL:g}); test NLL {r['nll']:.4f}, accuracy "
                  f"{r['acc']:.4f} [{card}]")
    print(f"[23] (b) the trainer's rule line: {runs['captured'][0]['line']}")
    batches = [(train_ds.images[row], train_ds.labels[row]) for row in plan[:HOST_FED_WINDOW]]
    for program in dict.fromkeys(programs):
        model = Net()
        state = st.create_train_state(model, torch.Generator().manual_seed(1), device=dev)
        fed = st.HostFedStep(st.make_train_step(model, learning_rate=LR, momentum=MOMENTUM,
                                                use_pallas=True), dev, program=program)
        for bx, by in batches[:3]:                   # the capture, cuDNN's choices
            state, _ = fed(state, bx, by, 1)
        sync()
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if on_card else [])) as prof:
            t0 = time.perf_counter()
            for bx, by in batches:
                state, _ = fed(state, bx, by, 1)
            sync()
            wall = time.perf_counter() - t0
        calls = host_launch_calls(prof)
        print(f"[23] (b) {program} host-fed step, profiler window of {len(batches)} steps: "
              f"{wall / len(batches) * 1e3:.4f} ms a step, host launch calls "
              f"{sum(calls.values()) / len(batches):.2f} a step ({calls}) [{card}]")

    # (c) train.distributed --host-local-feed at world 1 against the device-resident run
    steps = len(train_ds) // BATCH
    dist_runs = {}
    with mesh.cluster(dev) as info, patched(torch.backends.cudnn, "deterministic", True):
        if info.backend != ("nccl" if on_card else "gloo"):
            fail(f"[23] (c) world 1 on {dev} ran {info.backend}")
        for name, host_local in (("device-resident", False), ("host-local", True)):
            made = []
            reducer_cls = dp.GradReducer

            class Recorded(reducer_cls):
                def __init__(self, params):
                    super().__init__(params)
                    made.append(self)

            cfg = DistributedConfig(epochs=1, device=dev.type, host_local_feed=host_local,
                                    results_dir=str(root / "dist"),
                                    images_dir=str(root / "images"))
            with patched(dp, "GradReducer", Recorded), \
                    contextlib.redirect_stdout(io.StringIO()) as said:
                state, hist = distributed.main(cfg, datasets=(train_ds, test_ds))
            dist_runs[name] = dict(state=state, hist=hist, calls=[r.calls for r in made],
                                   out=said.getvalue())
    d, h = dist_runs["device-resident"], dist_runs["host-local"]
    program = "cuda-graph" if on_card else "eager"
    if f"Host-fed program: {program} on {dev.type}" not in h["out"] or \
            "columns [0:64]" not in h["out"]:
        fail("[23] (c) the host-local run did not print its program and columns")
    if d["calls"] != [steps] or h["calls"] != [steps]:
        fail(f"[23] (c) reducer calls {d['calls']} / {h['calls']}, expected [{steps}]")
    e_l = np.abs(np.subtract(h["hist"].train_losses, d["hist"].train_losses)).max()
    e_p = max((h["state"].params[k] - p).abs().max().item()
              for k, p in d["state"].params.items())
    if max(e_l, e_p) > CAPTURE_ATOL:
        fail(f"[23] (c) host-local vs device-resident: |dloss| {e_l:.3e}, |dparam| {e_p:.3e}")
    print(f"[23] (c) train.distributed --host-local-feed world 1 ({info.backend}, {program}): "
          f"{steps} steps, reducer calls {h['calls'][0]} (replays counted); vs the "
          f"device-resident run max |dloss| {e_l:.3e}, max |dparam| {e_p:.3e} (atol "
          f"{CAPTURE_ATOL:g}); epoch {h['hist'].epoch_seconds[0]:.3f} s against "
          f"{d['hist'].epoch_seconds[0]:.3f} s [{card}]")

    # (d) BatchLoader(prefetch=2, device=cuda): values, order, and the data wait
    plain = BatchLoader(train_ds, BATCH, shuffle=True, seed=1)
    pre = BatchLoader(train_ds, BATCH, shuffle=True, seed=1, prefetch=2, device=dev)
    n = 0
    for (hx, hy), (gx, gy) in zip(plain, pre):
        if not (np.array_equal(gx.cpu().numpy(), hx) and np.array_equal(gy.cpu().numpy(), hy)):
            fail(f"[23] (d) prefetched batch {n} differs from the host iterator's")
        n += 1
    if n != full:
        fail(f"[23] (d) {n} prefetched batches, expected {full}")
    model = Net()
    step_fn = st.make_train_step(model, learning_rate=LR, momentum=MOMENTUM, use_pallas=True)
    wait = {}
    timed = mnist.truncate(train_ds, PREFETCH_TIMED)
    for depth in (0, 2, 2, 0):
        state = st.create_train_state(model, torch.Generator().manual_seed(1), device=dev)
        feed = BatchLoader(timed, BATCH, shuffle=True, seed=1, prefetch=depth,
                           device=dev if depth else None)
        t0 = time.perf_counter()
        for bx, by in feed:
            if not depth:
                bx, by = torch.from_numpy(bx).to(dev), torch.from_numpy(by)
            state, _ = step_fn(state, bx, by.to(dev, torch.int64), 1)
        sync()
        wait.setdefault(depth, []).append((feed.pop_wait_s(), time.perf_counter() - t0))
    print(f"[23] (d) BatchLoader(prefetch=2, device={dev}): {n} batches == the host "
          f"iterator's, in order, bitwise; {PREFETCH_TIMED // BATCH} batches fed to the "
          f"eager fused step in turns (data wait s / s): without prefetch "
          f"{', '.join(f'{w:.4f} / {s:.3f}' for w, s in wait[0])}; prefetch=2 "
          f"{', '.join(f'{w:.4f} / {s:.3f}' for w, s in wait[2])} [{card}]")


def lm_phase(dev, card: str, train_ds, test_ds) -> dict:
    """Phase 25 (a)-(c): the pixel LM trained on the card.

    (a) ``python -m <port>.train.lm --epochs 2 --keep-checkpoints 2``'s flags through
    ``parse_config`` and ``train.lm.main`` at ``LMConfig``'s defaults (vocab 16 + BOS, seq
    784, embed 64, 2 layers, 4 heads, batch 64, AdamW 1e-3, clip 1.0) on the synthetic
    seed-514 split's first ``LM_TRAIN`` examples, 468 steps an epoch in captured segments;
    of the first epoch: its
    seconds, ms a step, the first and last segments' mean losses (the loss must fall), the
    test NLL per token (below ln 17) and its perplexity. Then 20 steps of the trainer's step (``train.lm.make_lm_step`` at the
    same flags) captured against the eager loop from the trainer's start on its first plan
    rows, within ``LM_CAPTURE_ATOL``, and a profiler window over each (ms a step, busy
    share, host launch calls a step).
    (b) ``--epochs 2 --resume-from`` the store's first-epoch checkpoint of (a) against
    (a)'s 2 epochs straight: parameters and AdamW moments within ``RESUME_ATOL``; (a)'s two
    epoch seconds (the first includes the segment captures). (c) (a)'s ``model_lm.ckpt``
    decoded and restored on the CPU, bitwise the card's final state.

    Returns the straight run's checkpoint path and final state for (d)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
        data_parallel as dp, mesh,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        lm as lm_train, step as st,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        _msgpack, checkpoint,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        LMConfig, parse_config,
    )

    root = OUT_DIR / "lm"
    shutil.rmtree(root, ignore_errors=True)

    def train(tag: str, argv: list[str]):
        argv = argv + ["--results-dir", str(root / tag), "--images-dir",
                       str(root / tag / "images")]
        segments: list = []
        with patched(lm_train, "make_epoch_from_step",
                     recording_epoch_fn(st.make_epoch_from_step, segments)):
            t0 = time.perf_counter()
            state, hist = lm_train.main(parse_config(LMConfig, argv),
                                        datasets=(train_ds, test_ds))
            torch.cuda.synchronize()
        return state, hist, time.perf_counter() - t0, segments, argv

    # (a) two epochs at the defaults, captured, the store keeping each epoch's checkpoint
    # ((b) resumes from the first); (a)'s readings are the first epoch's
    state, hist, wall, segments, argv = train("a", ["--epochs", "2", "--keep-checkpoints",
                                                    "2", "--max-train-examples",
                                                    str(LM_TRAIN)])
    steps = int(state.step) // 2
    per_epoch = -(-steps // lm_train.SEGMENT_STEPS)
    first, last = segments[0].mean().item(), segments[per_epoch - 1].mean().item()
    nll = hist.test_losses[0]
    if steps != min(len(train_ds), LM_TRAIN) // 64 or len(segments) != 2 * per_epoch:
        fail(f"[25] (a) {2 * steps} steps in {len(segments)} segments")
    if not last < first:
        fail(f"[25] (a) the train loss did not fall: first segment {first}, last {last}")
    if not nll < math.log(17):
        fail(f"[25] (a) test NLL per token {nll} is not below ln 17 = {math.log(17):.4f}")
    epoch_s = hist.epoch_seconds[0]
    print(f"[25] (a) python -m {PKG}.train.lm {' '.join(argv)}, its first epoch: {steps} "
          f"steps in {per_epoch} captured segments of up to {lm_train.SEGMENT_STEPS}; epoch "
          f"{epoch_s:.3f} s ({epoch_s / steps * 1e3:.4f} ms a step, the captures included), "
          f"{wall:.1f} s for both epochs (eval, grids); train loss {first:.4f} (first "
          f"segment) -> {last:.4f} (last), epoch mean {hist.train_losses[0]:.4f}; test NLL "
          f"per token {nll:.4f} < ln 17 = {math.log(17):.4f}, perplexity "
          f"{math.exp(nll):.4f} [{card}]")

    # (a) 20 steps of the trainer's step (train.lm.make_lm_step at (a)'s flags), captured
    # against the eager loop, from the trainer's start on its first plan rows
    cfg = parse_config(LMConfig, argv)
    perm = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0])).permutation(
        len(train_ds))
    plan = torch.from_numpy(perm[:LM_CAPTURE_STEPS * 64].reshape(LM_CAPTURE_STEPS, 64)).to(dev)
    tokens = lm.tokenize_images_to_ids(torch.from_numpy(train_ds.images)).to(dev)
    zeros = torch.zeros(len(train_ds), dtype=torch.int64, device=dev)
    model = lm_train.lm_model(cfg, vocab=cfg.num_levels, seq_len=tokens.shape[1]).to(dev)
    opt = lm_train.lm_optimizer(cfg)
    with mesh.cluster(dev):
        start = st.create_train_state(model, torch.Generator().manual_seed(cfg.seed),
                                      optimizer=opt, device=dev, ema=cfg.ema_decay > 0,
                                      guard=cfg.guard)
        reducer = dp.GradReducer(start.params)
        step_fn = lm_train.make_lm_step(model, cfg, optimizer=opt, steps_per_epoch=steps,
                                        grad_reduce=reducer)
        captured, eager = st.CapturedSegment(step_fn, grad_reduce=reducer), st.make_segment_fn(
            step_fn)
        copy = lambda s: st._tree_map(torch.clone, s)
        got_state, got = captured(copy(start), tokens, zeros, plan, cfg.seed + 1)
        want_state, want = eager(copy(start), tokens, zeros, plan, cfg.seed + 1)
        diff = max([(got - want).abs().max().item()]
                   + [(got_state.params[k] - want_state.params[k]).abs().max().item()
                      for k in want_state.params])
        if diff > LM_CAPTURE_ATOL:
            fail(f"[25] (a) captured vs eager: max |diff| {diff:.3e} > {LM_CAPTURE_ATOL:g}")
        print(f"[25] (a) {LM_CAPTURE_STEPS} steps of train.lm.make_lm_step captured (one CUDA "
              f"graph, the all-reduce inside) vs the eager loop, from the same start: max "
              f"|diff| of losses and "
              f"parameters {diff:.3e} <= {LM_CAPTURE_ATOL:g}")
        for name, fn in (("captured", captured), ("eager", eager)):
            s = copy(start)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                s, _ = fn(s, tokens, zeros, plan, cfg.seed + 1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            report_window(f"[25] (a) {name}:", device_kernel_times(prof), LM_CAPTURE_STEPS,
                          wall, (), card)
            calls = host_launch_calls(prof)
            print(f"[25] (a) {name}: host launch calls {sum(calls.values()) / LM_CAPTURE_STEPS:.2f} "
                  f"a step ({calls})")
    del tokens, zeros, captured, eager
    torch.cuda.empty_cache()

    # (b) --resume-from (a)'s first-epoch checkpoint, against (a)'s two epochs straight
    resumed, r_hist, _, _, _ = train("b_resumed", [
        "--epochs", "2", "--generate", "0", "--max-train-examples", str(LM_TRAIN),
        "--resume-from",
        str(root / "a" / "checkpoints" / checkpoint.versioned_name(steps))])
    straight, s_hist = state, hist
    if not int(resumed.step) == int(straight.step) == 2 * steps:
        fail(f"[25] (b) steps {int(resumed.step)} (resumed), {int(straight.step)} (straight)")
    trees = (("params", resumed.params, straight.params),
             ("m", resumed.velocity["m"], straight.velocity["m"]),
             ("v", resumed.velocity["v"], straight.velocity["v"]))
    diff = max((a[k] - b[k]).abs().max().item() for _, a, b in trees for k in b)
    if diff > RESUME_ATOL:
        fail(f"[25] (b) resumed vs straight: max |diff| {diff:.3e} > {RESUME_ATOL:g}")
    print(f"[25] (b) --resume-from (a)'s first-epoch checkpoint (epoch "
          f"{r_hist.epoch_seconds[0]:.3f} s) vs (a)'s 2 epochs straight (epochs "
          f"{', '.join(f'{t:.3f}' for t in s_hist.epoch_seconds)} s; the first captures the "
          f"segments): params and AdamW moments max |diff| "
          f"{diff:.3e} <= {RESUME_ATOL:g}; test NLL per token {r_hist.test_losses[-1]:.6f} vs "
          f"{s_hist.test_losses[-1]:.6f} [{card}]")

    # (c) the card's file decoded and restored on the CPU, bitwise
    path = root / "a" / "model_lm.ckpt"
    raw = _msgpack.from_bytes(path.read_bytes())
    cpu_ref = st.create_train_state(lm.TransformerLM(), torch.Generator().manual_seed(0),
                                    optimizer=opt)
    got = checkpoint.restore_train_state(str(path), cpu_ref)
    same = all(torch.equal(a[k], b[k].cpu()) for a, b in (
        (got.params, straight.params), (got.velocity["m"], straight.velocity["m"]),
        (got.velocity["v"], straight.velocity["v"])) for k in b)
    if not (same and int(got.step) == int(straight.step)
            and int(got.velocity["count"]) == int(straight.velocity["count"])):
        fail("[25] (c) model_lm.ckpt restored on the CPU differs from the card's final state")
    print(f"[25] (c) {path.name} ({path.stat().st_size} bytes): decoded ({list(raw)}, params "
          f"{sorted(raw['params'])[:3]}..., step {int(raw['step'])} {raw['step'].dtype}), "
          f"restored on the CPU bitwise equal to the card's final params, AdamW moments and "
          f"count")
    return {"path": path, "state": straight}


def tv_bound(p, n: int) -> float:
    """Three times the expected total-variation distance between ``n`` draws' empirical
    distribution and ``p`` (``E|count_x/n - p_x| ≈ sqrt(2 p_x (1 - p_x) / (π n))``, the
    normal approximation of a binomial's mean absolute deviation, halved and summed)."""
    import numpy as np

    return 3.0 * 0.5 * float(np.sum(np.sqrt(2.0 * p * (1.0 - p) / (math.pi * n))))


def spec_phase(dev, card: str, model, params: dict, ckpt: Path, train_ds, test_ds,
               test_ids, compare_streams) -> None:
    """Phase 26: speculative decoding on the card, with [25]'s trained LM.

    (a) ``verify_chunk`` (contiguous) and ``paged_verify_chunk`` (pages of 64 through a
    shuffled table, pages past each slot's reservation on the null page) on four slots
    prefilled to ``SPEC_PROMPTS`` positions with test images, fed the image's next
    ``SPEC_K`` tokens as drafts, in f32, int8 and fp8 planes: row j against
    ``decode_step_slots`` at t + j on a copy of the slot's prefilled planes fed the same
    tokens (within ``SPEC_ATOL``), the rows verify writes bitwise the rows the per-token
    path writes, every other row (and every page but the null page) bitwise unchanged, so
    the rows past ``seq_len`` of the slot at 782 were dropped.
    (b) ``bench_spec_ab``'s chat scenario at its defaults on the paged layout: spec off
    (B6 launches = layers x decode steps), ``ngram``, ``draft-lm`` at the recipe's seeded
    init and ``draft-lm`` trained here by ``train.lm`` (one epoch, 1 layer, embed 32):
    B6 launches and decode-step calls 0 on the spec sides, every spec side's streams equal
    to spec off's up to true ties (``compare_streams``), tokens/s, invocations per token,
    ms per verify tick against ms per decode step in a steady run, accepted tokens per step,
    acceptance rate, the invocation ratio; the JAX tool's gates printed beside them.
    (c) the sampled accept rule on the card: ``SPEC_DRAWS`` draws at temperature 1 on
    (a)'s first verify row and a fixed draft, the first token's distribution against the
    target within ``tv_bound``; then a ``Server`` over an ngram spec engine with a park
    and a resume, every future ``ok``.
    (d) ``serve_loadgen.main`` in process on the trained checkpoint: the open loop at its
    defaults on [12]'s paged layout, then the chat scenario with ``--spec ngram``; their
    summaries' headline keys, every request ``ok``."""
    import argparse
    import types

    import numpy as np
    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch import (
        bench_spec_ab, serve_loadgen, serving,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        paged_attention as paged, quant,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
        MASK_VALUE,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        engine as engine_mod,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        lm as lm_train,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        LMConfig, parse_config,
    )

    t_phase = time.perf_counter()
    root = OUT_DIR / "spec"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    params_dev = {name: p.to(dev) for name, p in params.items()}
    k, s, vocab = SPEC_K, model.seq_len, model.vocab_size

    # (a) verify against sequential decode ------------------------------------------------
    b = len(SPEC_PROMPTS)
    fills = np.asarray(SPEC_PROMPTS)
    streams = test_ids[:b].astype(np.int32)
    prompt = torch.from_numpy(streams).to(dev)
    draft_np = np.zeros((b, k), np.int32)
    for i in range(b):
        row = streams[i, fills[i]:fills[i] + k]
        draft_np[i, :len(row)] = row
    ids_np = streams[np.arange(b), fills - 1]
    inputs = np.concatenate([ids_np[:, None], draft_np], axis=1)       # [b, k+1]
    ids, t = torch.from_numpy(ids_np).to(dev), torch.from_numpy(fills.astype(np.int32)).to(dev)
    draft = torch.from_numpy(draft_np).to(dev)
    window = [list(range(f, min(f + k + 1, s))) for f in fills]      # the rows verify writes
    ps = SERVE_PAGE
    p_max = lm.pages_per_slot(s, ps)
    verify_rows = None
    quantize_rows = quant.quantize_rows
    for layout in ("contiguous", "paged"):
        for kv in (None, "int8", "fp8"):
            base = lm.init_cache(model, b, kv_dtype=kv, device=dev)
            with torch.no_grad():
                for i in range(b):
                    for start, length, size in serving.greedy_chunk_plan(
                            lm.PREFILL_CHUNK_SIZES, 0, int(fills[i])):
                        lm.prefill_chunk(model, params_dev, base, prompt, i, start, length,
                                         start == 0, chunk=size)
            # verify's own quantize-on-write calls, in order (layer 0 k, v, layer 1 k, v)
            quantized: list = []

            def recording(x, qdtype):
                out = quantize_rows(x, qdtype)
                quantized.append(tuple(y.reshape((b, k + 1) + tuple(y.shape[1:]))
                                       for y in out))
                return out

            if layout == "paged":
                perm = torch.randperm(b * p_max, generator=torch.Generator().manual_seed(26))
                table = (1 + perm).reshape(b, p_max).to(torch.int32)
                for i in range(b):              # pages past the reservation: the null page
                    table[i, (int(fills[i]) + k) // ps + 1:] = 0
                table_dev = table.to(dev)
                pool = lm.init_page_pool(model, 1 + b * p_max, page_size=ps, kv_dtype=kv,
                                         device=dev)
                for name, layer in pool.items():
                    for key, x in layer.items():
                        for i in range(b):
                            for j in range(p_max):
                                if int(table[i, j]):
                                    rows = base[name][key][i, j * ps:(j + 1) * ps]
                                    x[int(table[i, j]), :rows.shape[0]] = rows
                before = {n: {key: x.clone() for key, x in layer.items()}
                          for n, layer in pool.items()}
                with torch.no_grad(), patched(quant, "quantize_rows", recording):
                    _, vlp = lm.paged_verify_chunk(model, params_dev, pool, table_dev, ids,
                                                   t, draft, k=k)
                after = pool

                def written(name, key, i, p):
                    return pool[name][key][int(table[i, p // ps]), p % ps]
            else:
                before = {n: {key: x.clone() for key, x in layer.items()}
                          for n, layer in base.items()}
                with torch.no_grad(), patched(quant, "quantize_rows", recording):
                    _, vlp = lm.verify_chunk(model, params_dev, base, ids, t, draft, k=k)
                after = base

                def written(name, key, i, p):
                    return base[name][key][i, p]
            torch.cuda.synchronize()
            err = worst = row_err = 0.0
            same_quant = codes_equal = codes_total = rows_total = 0
            for i in range(b):
                # the slot's prefilled planes: the clone taken before verify (contiguous),
                # or the contiguous cache the pool was filled from (paged)
                src = before if layout == "contiguous" else base
                ref = {n: {key: x[i:i + 1].clone() for key, x in layer.items()}
                       for n, layer in src.items()}
                for j, pos in enumerate(window[i]):
                    with torch.no_grad():
                        _, dlp = lm.decode_step_slots(
                            model, params_dev, ref,
                            torch.tensor([int(inputs[i, j])], device=dev),
                            torch.tensor([pos], dtype=torch.int32, device=dev))
                    diff = (vlp[i, j] - dlp[0]).abs()
                    err = max(err, diff.max().item())
                    worst = max(worst, (diff - SPEC_ATOL * dlp[0].abs()).max().item())
                    for li, name in enumerate(ref):
                        layer = ref[name]
                        rows_total += 1
                        if kv is None:
                            for key in ("k", "v"):
                                row_err = max(row_err, (written(name, key, i, pos)
                                                        - layer[key][0, pos]).abs().max().item())
                            continue
                        for which, key in enumerate(("k", "v")):
                            codes, scales = quantized[2 * li + which]
                            # verify writes quantize_rows' own output, codes and scales
                            same_quant += bool(
                                torch.equal(written(name, key, i, pos), codes[i, j])
                                and torch.equal(written(name, f"{key}_scale", i, pos),
                                                scales[i, j]))
                            got = written(name, key, i, pos)
                            want = layer[key][0, pos]
                            codes_total += got.numel()
                            codes_equal += int((got.view(torch.int8)
                                                == want.view(torch.int8)).sum())
                            deq = lambda x, sc: x.float() * sc[..., None]   # noqa: E731
                            row_err = max(row_err, (
                                deq(got, written(name, f"{key}_scale", i, pos))
                                - deq(want, layer[f"{key}_scale"][0, pos])).abs().max().item())
            tag = f"[26] (a) {layout} kv={kv or 'f32'}"
            if worst > SPEC_ATOL:
                fail(f"{tag}: verify vs sequential decode max |diff| {err:.3e} beyond "
                     f"{SPEC_ATOL:g} + {SPEC_ATOL:g}·|decode|")
            if kv is None and row_err > SPEC_ATOL:
                fail(f"{tag}: rows verify wrote differ from decode's by {row_err:.3e}")
            if kv is not None and same_quant != 2 * rows_total:
                fail(f"{tag}: {2 * rows_total - same_quant} of {2 * rows_total} rows verify "
                     f"wrote are not quantize_rows' own codes and scales")
            untouched = True
            for name, layer in after.items():
                for key, x in layer.items():
                    mask = torch.ones(x.shape[:2], dtype=torch.bool, device=dev)
                    for i in range(b):
                        for pos in window[i]:
                            if layout == "paged":
                                mask[int(table[i, pos // ps]), pos % ps] = False
                            else:
                                mask[i, pos] = False
                    if layout == "paged":
                        mask[0] = False            # the null page takes whatever lands there
                    untouched &= bool(torch.equal(x[mask], before[name][key][mask]))
            if not untouched:
                fail(f"{tag}: verify changed a row outside its window (rows past seq_len "
                     f"must drop)")
            if layout == "contiguous" and kv is None:
                verify_rows = vlp.clone()
            rows_note = (f"written rows within {row_err:.3e} of decode's" if kv is None else
                         f"written rows are quantize_rows' own codes and scales "
                         f"{same_quant}/{2 * rows_total}, codes equal to decode's "
                         f"{codes_equal}/{codes_total}, dequantized within {row_err:.3e}")
            print(f"{tag}: verify over t = {list(SPEC_PROMPTS)}, k = {k} vs "
                  f"decode_step_slots at t + j: max |diff| {err:.3e} (bar {SPEC_ATOL:g} + "
                  f"{SPEC_ATOL:g}·|decode|); {rows_note}; the slot at {SPEC_PROMPTS[-1]}'s "
                  f"{SPEC_PROMPTS[-1] + k + 1 - s} rows past seq_len dropped, every other row "
                  f"unchanged [{card}]")
            del base, before, after
    torch.cuda.empty_cache()

    # (b) the A/B through bench_spec_ab's path --------------------------------------------
    draft_dir = root / "draft"
    t0 = time.perf_counter()
    argv = ["--epochs", "1", "--num-layers", "1", "--embed-dim", str(model.embed_dim // 2),
            "--num-heads", str(model.num_heads), "--generate", "0", "--device", dev.type,
            "--max-train-examples", str(LM_TRAIN),
            "--results-dir", str(draft_dir), "--images-dir", str(draft_dir / "images")]
    _, d_hist = lm_train.main(parse_config(LMConfig, argv), datasets=(train_ds, test_ds))
    torch.cuda.synchronize()
    d_train_s = time.perf_counter() - t0
    print(f"[26] (b) draft LM trained: python -m {PKG}.train.lm {' '.join(argv[:8])} in "
          f"{d_train_s:.1f} s (epoch {d_hist.epoch_seconds[0]:.3f} s), test NLL per token "
          f"{d_hist.test_losses[-1]:.4f} [{card}]")
    args = argparse.Namespace(**SPEC_AB, kv_layout="paged", device=str(dev),
                              draft_checkpoint="")
    trained_args = argparse.Namespace(**vars(args))
    trained_args.draft_checkpoint = str(draft_dir / "model_lm.ckpt")
    sides = [("off", "off", args), ("ngram", "ngram", args),
             ("draft-lm (seeded init)", "draft-lm", args),
             ("draft-lm (trained)", "draft-lm", trained_args)]
    results = {}
    for label, spec, side_args in sides:
        engine = bench_spec_ab.build_side(model, params, side_args, spec=spec)
        torch.cuda.synchronize()
        paged.reset_launch_counts()
        metrics, toks, engine = bench_spec_ab.run_side(model, params, side_args, spec=spec,
                                                       engine=engine)
        torch.cuda.synchronize()
        launches = paged.launch_counts()["paged_attend"]
        if spec == "off":
            if launches != model.num_layers * engine.decode_calls or not launches:
                fail(f"[26] (b) spec off: B6 launches {launches} != {model.num_layers} x "
                     f"{engine.decode_calls} decode steps")
        elif launches or engine.decode_calls or not engine.verify_calls:
            fail(f"[26] (b) {label}: B6 launches {launches}, decode-step calls "
                 f"{engine.decode_calls}, verify calls {engine.verify_calls}: spec mode "
                 f"must verify every tick and never decode")
        chat_calls = (engine.decode_calls, dict(engine.verify_calls))
        # steady ticks: every slot decoding, no prefill pending (a budget long enough that
        # the first slot is still decoding when the last one's prefill drains, even at
        # k + 1 tokens a tick)
        engine.reset_stats()
        engine.admit_many([(i, serving.Request(prompt=test_ids[i, :96].copy(),
                                               max_new_tokens=SPEC_STEADY_NEW, request_id=i))
                           for i in range(args.num_slots)])
        ticks = []
        while engine.num_active:
            busy = engine.num_prefilling
            t1 = time.perf_counter()
            engine.step()
            if not busy and engine.num_active == args.num_slots:
                ticks.append(time.perf_counter() - t1)
        if not ticks:
            fail(f"[26] (b) {label}: no steady tick with every slot decoding")
        records = engine.take_spec_records()
        results[label] = (metrics, toks, launches, float(np.median(ticks)) * 1e3,
                          chat_calls[1], chat_calls[0], records)
        del engine
    off_metrics, off_toks = results["off"][0], results["off"][1]
    for label, (metrics, toks, launches, tick_ms, verify_calls, decode_calls,
                records) in results.items():
        keys = sorted(set(off_toks) | set(toks))
        reqs = [types.SimpleNamespace(request_id=j, prompt=np.asarray(key, np.int32))
                for j, key in enumerate(keys) if key in off_toks and key in toks]
        ties = compare_streams(f"[26] (b) {label}", model, params_dev, reqs,
                               {r.request_id: toks[tuple(r.prompt)].tolist() for r in reqs},
                               {r.request_id: off_toks[tuple(r.prompt)].tolist() for r in reqs})
        if len(reqs) != len(keys) and not ties:
            fail(f"[26] (b) {label}: {len(keys) - len(reqs)} chat turns differ from spec "
                 f"off's without a true tie before them")
        match = bench_spec_ab.token_match_rate(off_toks, toks)
        sp = metrics["spec_stats"] or {}
        ratio = off_metrics["invocations_per_token"] / metrics["invocations_per_token"]
        rate = f"{sp['acceptance_rate']:.4f}" if sp.get("acceptance_rate") is not None else "n/a"
        tick = ("decode step" if label == "off" else
                f"verify tick (draft {np.median([r['draft_wall_s'] for r in records]) * 1e3:.3f}"
                f" ms + verify and fetch "
                f"{np.median([r['verify_wall_s'] for r in records]) * 1e3:.3f} ms)")
        print(f"[26] (b) {label}: {metrics['requests']} chat turns, {metrics['new_tokens']} "
              f"tokens, {metrics['tokens_per_s']:.1f} tokens/s, "
              f"{metrics['invocations_per_token']:.4f} invocations per generated token "
              f"(ratio to off {ratio:.3f}), {tick_ms:.3f} ms per {tick} in a steady run of "
              f"{args.num_slots} slots; accepted tok/step "
              f"{sp.get('accepted_tokens_per_step') or 1.0:.3f}, acceptance rate "
              f"{rate}; B6 launches {launches}, "
              f"decode-step calls {decode_calls}, verify calls {verify_calls}; streams vs "
              f"off: token match {match:.3f}, {ties} diverging at a true tie [{card}]")
        if label != "off":
            print(f"[26] (b) {label}: the JAX tool's gates, readings only: token match "
                  f"{match:.3f} (gate {SPEC_JAX_GATES[0]}), tok/step "
                  f"{sp.get('accepted_tokens_per_step') or 0:.3f} (gate {SPEC_JAX_GATES[1]}), "
                  f"invocation ratio {ratio:.3f} (gate {SPEC_JAX_GATES[2]})")
    del results
    torch.cuda.empty_cache()

    # (c) sampled speculation --------------------------------------------------------------
    logp = verify_rows[0].clone()
    logp[:, vocab - 1] = MASK_VALUE
    order = torch.argsort(logp[0], descending=True)
    fixed = int(order[1])
    gen = torch.Generator(device=dev).manual_seed(26)
    n = SPEC_DRAWS
    tokens, counts = engine_mod.accept_fold(
        logp.expand(n, k + 1, vocab).clone(), torch.full((n, k), fixed, device=dev),
        torch.full((n,), k, device=dev), torch.ones(n, device=dev),
        torch.zeros(n, dtype=torch.long, device=dev), torch.ones(n, device=dev), gen)
    p = torch.softmax(logp[0], dim=-1).double().cpu().numpy()
    emp = np.bincount(tokens[:, 0].cpu().numpy(), minlength=vocab) / n
    tv = 0.5 * float(np.abs(emp - p).sum())
    bound = tv_bound(p, n)
    if tv > bound:
        fail(f"[26] (c) sampled accept rule: total variation {tv:.5f} > {bound:.5f}")
    accepted = (counts - 1).float().mean().item()
    print(f"[26] (c) accept_fold at temperature 1 on the card: {n} draws, draft = the "
          f"second most likely token (p {p[fixed]:.4f}) k = {k}: first-token total variation "
          f"{tv:.5f} against exp(log_probs) (bound {bound:.5f} = 3x its expectation at this "
          f"draw count); {accepted:.4f} drafts accepted a draw [{card}]")
    eng = serving.ContinuousBatchingEngine(model, params, num_slots=4, kv_layout="paged",
                                           page_size=SERVE_PAGE, spec="ngram", spec_k=k,
                                           prefix_cache_entries=16, device=dev)
    server = serving.Server(eng, tenants=serving.parse_tenants(SERVER_TENANTS))
    server.start()
    futures = [server.submit(test_ids[i, :64].copy(), max_new_tokens=200, tenant="free")
               for i in range(4)]
    t0 = time.perf_counter()
    while eng.num_active < 4 or eng.num_prefilling or eng.steps < 2:
        if time.perf_counter() - t0 > 120:
            fail("[26] (c) the free tenant's requests did not fill the slots within 120 s")
        time.sleep(0.001)
    futures += [server.submit(test_ids[4 + i, :64].copy(), max_new_tokens=16, tenant="paid",
                              sampling=serving.SamplingParams(temperature=1.0))
                for i in range(2)]
    done = [f.result(timeout=600) for f in futures]
    server.stop(drain=True, timeout=600)
    if not all(c.ok for c in done) or not eng.preemptions or not eng.resumes:
        fail(f"[26] (c) Server over spec: finishes {[c.finish for c in done]}, "
             f"{eng.preemptions} parks, {eng.resumes} resumes")
    print(f"[26] (c) Server over an ngram spec engine (paged, tenants {SERVER_TENANTS!r}): "
          f"{len(done)} futures ok ({sum(c.new_tokens for c in done)} tokens, two paid "
          f"requests sampled at temperature 1), {eng.preemptions} parks, {eng.resumes} "
          f"resumes, {eng.spec_steps} verify ticks, decode-step calls {eng.decode_calls} "
          f"[{card}]")
    del eng, server

    # (d) the port's serve_loadgen in process -------------------------------------------
    for label, extra in (("open loop", ["--kv-layout", "paged"]),
                         ("chat, --spec ngram", ["--scenario", "chat", "--spec", "ngram"])):
        out = root / f"loadgen_{extra[1]}.json"
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve_loadgen.main(["--checkpoint", str(ckpt), "--summary-json", str(out),
                                     "--device", str(dev)] + extra)
        doc = json.loads(out.read_text())
        if rc != 0 or doc["ok"] != doc["requests"] or not doc["requests"]:
            fail(f"[26] (d) serve_loadgen {label}: rc {rc}, {doc['ok']} of {doc['requests']} ok")
        head = {key: doc[key] for key in ("scenario", "mode", "requests", "ok", "new_tokens",
                                          "tokens_per_s", "ttft_s", "e2e_s",
                                          "decode_invocations", "generated_tokens")}
        head["spec_stats"] = doc["spec_stats"]
        print(f"[26] (d) serve_loadgen {label} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(head)} [{card}]")
    print(f"[26] phase {time.perf_counter() - t_phase:.1f} s [{card}]")


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
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        ComposedConfig, DistributedConfig, SingleProcessConfig,
    )

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------------------
    PHASE_START[1] = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1] device: {kind}; devices: {torch.cuda.device_count()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[1] nvidia-smi name, power.limit: {card}")

    # -- 2. build ----------------------------------------------------------------------
    PHASE_START[2] = time.perf_counter()
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
    PHASE_START[3] = time.perf_counter()
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
    # B1/B2's launch floor: FLOOR_LAUNCHES launches of one kernel captured in one CUDA
    # graph and replayed, at one row and at the main path's 64 rows
    for name, call in (("nll_fwd", lambda xr, yr: fk.nll_fwd(xr, yr)),
                       ("nll_bwd", lambda xr, yr: fk.nll_bwd(xr, yr, ct, 1.0 / len(yr)))):
        floor = {}
        for r in FLOOR_ROWS:
            xr, yr = x[:r].clone(), y[:r].clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(3):
                    call(xr, yr)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(FLOOR_LAUNCHES):
                    call(xr, yr)
            graph.replay()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(FLOOR_REPLAYS):
                graph.replay()
            end.record()
            torch.cuda.synchronize()
            floor[r] = start.elapsed_time(end) / (FLOOR_REPLAYS * FLOOR_LAUNCHES)
            del graph
        times[name]["launch_floor_ms"] = floor
        print(f"[3] {name}: launch floor, {FLOOR_LAUNCHES} launches replayed in one CUDA "
              f"graph ({FLOOR_REPLAYS} replays): "
              + ", ".join(f"{r} row(s) {ms * 1e3:.4f} us a launch" for r, ms in floor.items())
              + f"; bytes bound at 64 rows {times[name]['bound'][0] * 1e3:.6f} us [{card}]")

    # -- 4. trajectory ------------------------------------------------------------------
    PHASE_START[4] = time.perf_counter()
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
    PHASE_START[5] = time.perf_counter()
    t0 = time.perf_counter()
    train_ds, test_ds = load_mnist(str(ROOT / "files"))
    print(f"[5] data ({train_ds.source}): {len(train_ds)} train / {len(test_ds)} test in "
          f"{time.perf_counter() - t0:.2f} s")
    config = SingleProcessConfig(n_epochs=1, use_pallas_kernels=True, device="cuda",
                                 results_dir=str(OUT_DIR), images_dir=str(OUT_DIR / "images"))
    full_steps, tail = divmod(len(train_ds), config.batch_size_train)
    steps = full_steps + (1 if tail else 0)
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    # the epoch without its log-tick checkpoints, as earlier smoke runs timed it; [22] (b)
    # times it with them
    with patched(checkpoint, "make_saver", lambda async_=False, tele=None: NoSaves()):
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
    earlier = {"single_s": epoch_s, "single_steps": steps, "single_launches": launches}

    # -- 6. where a step spends its time ------------------------------------------------
    PHASE_START[6] = time.perf_counter()
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
    PHASE_START[7] = time.perf_counter()
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
    PHASE_START[8] = time.perf_counter()
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
    PHASE_START[9] = time.perf_counter()
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
    PHASE_START[10] = time.perf_counter()
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
    PHASE_START[11] = time.perf_counter()
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
    PHASE_START[12] = time.perf_counter()
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

    def serve(model, params, layout, requests, warmup, hold=None, **engine_kw):
        """A warmed-up engine's ``run`` over ``requests``, with the B6 count set to 0 just
        before it and read just after; (engine, streams, wall s, B6 launches).
        ``engine_kw`` adds or overrides engine options (``kv_dtype``, ``quant_policy``,
        ``num_slots``, ``prefix_cache_entries``); ``hold``, where given, receives the
        engine before its first run (for a spy that reads the engine's slots)."""
        engine = serving.ContinuousBatchingEngine(
            model, params, **(dict(num_slots=SERVE_SLOTS, kv_layout=layout,
                                   page_size=SERVE_PAGE, device=dev) | engine_kw))
        if hold is not None:
            hold.append(engine)
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

    def plain_gap(model, params_dev, stream, fill: int, p: int, kv_dtype=None) -> float:
        """The plain (contiguous) path's top-2 log-prob gap at position ``p`` of
        ``stream``, BOS masked: replay the slot alone — its prompt in the engine's chunk
        plan, then one decode step per position up to ``p`` — in a cache of
        ``kv_dtype``."""
        cache = lm.init_cache(model, 1, kv_dtype=kv_dtype, device=dev)
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
                        plain_streams, kv_dtype=None, flipped=None) -> int:
        """Paged (kernel) streams against contiguous (plain) ones: equal, or diverging at a
        true tie (the plain path's top-2 log-prob gap there below ``TIE_GAP``; the replay
        in a ``kv_dtype`` cache). ``flipped``, where given, maps a request id to the first
        stream position at which its kernel run's int8 activation codes differed from the
        plain version's on the same operands (see [24] (b)): a divergence above the gap
        is allowed only at or after that position of that request. Returns the number of
        divergences."""
        ties = 0
        for req in requests:
            rid = req.request_id
            got, plain = kernel_streams[rid], plain_streams[rid]
            if got == plain:
                continue
            p = next((i for i, (a, b) in enumerate(zip(got, plain)) if a != b),
                     min(len(got), len(plain)))
            gap = (plain_gap(model, params_dev, plain, len(req.prompt), p, kv_dtype)
                   if p < min(len(got), len(plain)) else float("inf"))
            print(f"{tag} request {rid}: streams differ first at position {p} (kernel "
                  f"{got[p] if p < len(got) else None}, plain "
                  f"{plain[p] if p < len(plain) else None}); plain top-2 gap {gap:.3e}")
            first_flip = (flipped or {}).get(rid)
            if not gap < TIE_GAP and (first_flip is None or first_flip > p):
                fail(f"{tag} request {rid}: kernel and plain streams differ at position {p} "
                     f"with a top-2 gap of {gap:.3e} (not a tie below {TIE_GAP:g}; first "
                     f"activation code flip of this request at {first_flip})")
            if not gap < TIE_GAP:
                print(f"{tag} request {rid}: above the tie gap, after this request's first "
                      f"int8 activation code flip at position {first_flip}")
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
    PHASE_START[13] = time.perf_counter()
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
    PHASE_START[14] = time.perf_counter()
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
    PHASE_START[15] = time.perf_counter()
    dconfig = DistributedConfig(epochs=1, device="cuda",
                                results_dir=str(OUT_DIR / "distributed"),
                                images_dir=str(OUT_DIR / "images"))
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
        earlier.update(dp_s=d_epoch_s, dp_steps=int(d_state.step))
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

    # the world-2 run and the world-2 trajectory at once, the world-1 trajectory here
    w2_dir = OUT_DIR / "distributed_w2"
    traj = {1: OUT_DIR / "dp_trajectory_w1.npz", 2: OUT_DIR / "dp_trajectory_w2.npz"}
    w2_fleet = start_fleet([
        "-m", f"{PKG}.train.distributed", "--device", "cuda", "--epochs", "2",
        "--max-train-examples", str(DP_W2_TRAIN), "--max-test-examples", str(DP_W2_TEST),
        "--results-dir", str(w2_dir), "--images-dir", str(w2_dir / "images")])
    traj_fleet = start_fleet([
        "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
              f"chip_smoke.dp_trajectory({str(traj[2])!r})"])
    dp_trajectory(str(traj[1]))
    w2_out = finish_fleet("[15] world 2:", w2_fleet)
    w2_val = [json.loads(l)["loss"] for l in open(w2_dir / "metrics.jsonl")
              if json.loads(l)["kind"] == "test"]
    print(f"[15] world 2 (gloo, two ranks time-slicing one card: a correctness run, not a "
          f"scaling point): val loss by epoch {w2_val}; replicas in sync at atol 0 "
          f"(main()'s closing check)")
    if "Collective backend: gloo (device cuda, 2 rank(s))" not in w2_out:
        fail("[15] the world-2 run did not run gloo on cuda")
    if not (len(w2_val) == 2 and all(map(math.isfinite, w2_val)) and w2_val[1] < w2_val[0]):
        fail(f"[15] the world-2 val loss did not fall: {w2_val}")

    finish_fleet("[15] trajectory world 2:", traj_fleet)
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
    PHASE_START[16] = time.perf_counter()
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
    earlier["bench"] = result

    # -- 17. the hop offset in B4/B5: each kernel against its plain version -------------
    PHASE_START[17] = time.perf_counter()
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
    PHASE_START[18] = time.perf_counter()
    # [19]'s seq=2 runs share world 2's fleet with its ring ops: one fleet start less
    ring_runs = {}
    for label, schedule, causal, window in RING_TRAINERS:
        # the flags of both runs; the seq=2 run adds the zig-zag's. The zig-zag's reference
        # is the one-device causal flash path
        both = (["--causal"] if causal else []) + (
            ["--attention-window", str(window)] if window else [])
        seq_only = ["--zigzag-attention"] if schedule == "zigzag" else []
        stem = f"composed_{label.replace(' ', '_')}"
        ring_runs[label] = (both, seq_only, OUT_DIR / f"{stem}_w1.npz",
                            OUT_DIR / f"{stem}_w2.npz")
    for world in RING_WORLDS:
        path = OUT_DIR / f"ring_ops_w{world}.json"
        runs = [("ring_ops", str(path), list(RING_OPS_SHAPE), 0)]
        if world == 2:
            runs += [("composed", str(w2), ["--mesh", "data=1,seq=2", *both, *seq_only],
                      RING_STEPS) for both, seq_only, _, w2 in ring_runs.values()]
        run_seq_fleet(f"[18] world {world}:", runs, n=world)
        result = check_ring_ops(path, world)
        for row in result["rows"]:
            print(f"[18] world {world} {row['schedule']} causal={row['causal']} window="
                  f"{row['window']} vs one-process flash_attention at {list(RING_OPS_SHAPE)} "
                  f"f32: "
                  f"max |err| out {row['out']:.3e} dq {row['dq']:.3e} dk {row['dk']:.3e} dv "
                  f"{row['dv']:.3e} (out {RING_TOL['out']}, grads {RING_TOL['grad']}); "
                  f"launches per rank = hops x blocks (fwd = dq = dkv): "
                  f"{[c[0] for c in row['counts']]}, at a hop offset "
                  f"{[c[5] for c in row['counts']]}; forward+backward {row['ms']:.3f} ms "
                  f"(gloo ranks time-slicing one card: no scaling point) [{card}]")

    # -- 19. the seq-parallel trainer: train.composed --mesh data=1,seq=2 ---------------
    PHASE_START[19] = time.perf_counter()
    ring_launches = {}
    layers = init_model.num_layers
    # every seq=2 run ran in [18]'s world-2 fleet, one after another on one process group
    for label, schedule, causal, window in RING_TRAINERS:
        both, seq_only, w1, w2 = ring_runs[label]
        composed_trajectory(str(w1), "--mesh", "data=1", *both)      # this process
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

    # -- 20. the captured epoch against the eager loop ----------------------------------
    PHASE_START[20] = time.perf_counter()
    captured_phase(dev, card, train_ds, test_ds, earlier)

    # -- 21. the step's remainder: the card's captured program against the CPU -----------
    PHASE_START[21] = time.perf_counter()
    remainder_phase(dev, card)

    # -- 22. checkpoints on the card: resume, log-tick saves, restore, preemption, plots --
    PHASE_START[22] = time.perf_counter()
    checkpoint_phase(dev, card, train_ds, test_ds, earlier)

    # -- 23. the host-fed data path: the native loader, both host-fed programs, prefetch -
    PHASE_START[23] = time.perf_counter()
    host_fed_phase(dev, card, train_ds, test_ds)

    # -- 24. quantized serving, the prefix cache and the Server at bench_lm's widths ------
    PHASE_START[24] = time.perf_counter()
    from csed_514_project_distributed_training_using_pytorch_tpu_torch import obs
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import quant

    q_model = lm.TransformerLM(**BENCH_LM, dtype=torch.bfloat16)
    q_params = {name: p.to(torch.bfloat16)
                for name, p in q_model.init(torch.Generator().manual_seed(1)).items()}
    q_layers = q_model.num_layers
    q_requests = request_mix(test_ids, QUANT_REQUESTS, BENCH_LM_MAX_NEW, 24)
    print(f"[24] bench_lm widths {BENCH_LM}, bf16 weights, {SERVE_SLOTS} slots, pages of "
          f"{SERVE_PAGE}, paged layout; {QUANT_REQUESTS} greedy requests, prompts "
          f"{min(len(r.prompt) for r in q_requests)}-{max(len(r.prompt) for r in q_requests)}"
          f", max_new_tokens up to {BENCH_LM_MAX_NEW} [{card}]")

    def pool_spy(record: list, check=None):
        """``paged.paged_attend`` wrapped to record what each call is handed (the pool's
        dtype, whether scale pools came along, the pool's storage) and, with ``check``,
        to hold each call's output against the plain version on the same operands."""
        real = paged.paged_attend

        def spy(q, k_pool, v_pool, table, t, **kw):
            record.append((k_pool.dtype, kw.get("k_scale") is not None, k_pool.data_ptr()))
            out = real(q, k_pool, v_pool, table, t, **kw)
            if check is not None:
                check(out, paged.paged_attend_reference(q, k_pool, v_pool, table, t, **kw), t)
            return out

        return patched(paged, "paged_attend", spy)

    # (a) int8 and fp8 KV through B6's quantized branches, against the plain engine
    quant_launches, per_token = {}, {}
    for kv in ("model", "int8", "fp8"):
        seen: list = []
        with pool_spy(seen):
            eng, streams, wall, launches = serve(q_model, q_params, "paged", q_requests,
                                                 warmup, kv_dtype=kv)
        acct = eng.byte_accounting()
        per_token[kv] = acct["decode_bytes_per_token"]
        pool = eng._cache["block_0"]
        pools = {eng._cache[f"block_{i}"]["k"].data_ptr() for i in range(q_layers)}
        if launches != q_layers * eng.steps or not launches:
            fail(f"[24] (a) {kv}: B6 launches {launches} != {q_layers} x {eng.steps}")
        if kv != "model":
            quant_launches[kv] = launches
            want = (quant.resolve_kv_dtype(kv, torch.bfloat16)[0], True)
            if ({(dt, sc) for dt, sc, _ in seen} != {want}
                    or not {ptr for _, _, ptr in seen} <= pools or "k_scale" not in pool):
                fail(f"[24] (a) {kv}: B6 was handed {set(seen)}, not the engine's own "
                     f"{want[0]} pools with their scale pools")
            plain_eng, plain_streams, _, plain_launches = serve(
                q_model, q_params, "contiguous", q_requests, warmup, kv_dtype=kv)
            if plain_launches:
                fail(f"[24] (a) {kv}: the contiguous run launched B6 {plain_launches} times")
            ties = compare_streams(f"[24] (a) {kv}", q_model, eng.params, q_requests, streams,
                                   plain_streams, kv_dtype=kv)
            same = sum(streams[i] == plain_streams[i] for i in plain_streams)
            print(f"[24] (a) kv_dtype={kv}: B6 handed the engine's own {want[0]} pools and "
                  f"their f32 scale pools in all {len(seen)} calls (no dequantized copy); "
                  f"paged (B6) vs contiguous (plain) streams: {same}/{QUANT_REQUESTS} equal, "
                  f"{ties} diverging at a true tie [{card}]")
            del plain_eng
        if sorted(streams) != list(range(QUANT_REQUESTS)):
            fail(f"[24] (a) {kv}: {len(streams)} of {QUANT_REQUESTS} requests completed")
        print(f"[24] (a) kv_dtype={kv}: {eng.steps} decode steps, {eng.generated_tokens} "
              f"tokens in {wall:.4f} s ({eng.generated_tokens / wall:.1f} tokens/s, "
              f"{wall / eng.steps * 1e3:.4f} ms per decode step, prefill included); B6 "
              f"launches {launches} = layers x steps; byte_accounting: KV "
              f"{acct['kv_bytes_resident']} bytes resident ({acct['kv_bytes_per_slot']} a "
              f"slot), decode {acct['decode_bytes_per_token']:.1f} bytes per token "
              f"({per_token[kv] / per_token['model']:.4f} of kv_dtype=model), slots at 1 GiB "
              f"{acct['slots_at_budget']} [{card}]")
        del eng
    torch.cuda.empty_cache()

    # (b) w8 and w8a8 weights: the int8 matmul's routes, then the streams against plain
    acc_shapes = ((8, 256, 1024), (8, 256, 17), (32, 256, 1024), (128, 1024, 256))
    quant.reset_route_counts()
    for m_, k_, n_ in acc_shapes:
        g_cpu = torch.Generator().manual_seed(m_ + k_ + n_)
        xq = torch.randint(-127, 128, (m_, k_), dtype=torch.int8, generator=g_cpu)
        wq = torch.randint(-127, 128, (k_, n_), dtype=torch.int8, generator=g_cpu)
        got = quant.int8_accumulate(xq.to(dev), wq.to(dev)).cpu()
        if not torch.equal(got, xq.int() @ wq.int()):
            fail(f"[24] (b) the int8 accumulator at [{m_}, {k_}] x [{k_}, {n_}] differs from "
                 f"the exact int32 product")
    print(f"[24] (b) int8 x int8 -> int32 on the card at {acc_shapes}: bitwise the CPU's "
          f"int32 product; routes {dict(quant.int8_matmul_routes)}")
    for policy in ("w8", "w8a8"):
        # a spied, untimed run: every B6 call held against the plain version on its own
        # operands and, under w8a8, where the two outputs' int8 activation codes (the
        # output projection quantizes each slot's row) differ, which request and position
        n_flips, errs, seen, hold, first_flip = [0], [0.0], [], [], {}

        def check(out, ref, t, n_flips=n_flips, errs=errs, hold=hold, first_flip=first_flip,
                  policy=policy):
            torch.testing.assert_close(out, ref, atol=PAGED_ATOL, rtol=PAGED_RTOL)
            errs[0] = max(errs[0], (out - ref).abs().max().item())
            if policy != "w8a8":
                return
            rows = out.shape[0]
            per_row = (quant.quantize_rows(out.reshape(rows, -1), torch.int8)[0]
                       != quant.quantize_rows(ref.reshape(rows, -1), torch.int8)[0]).sum(-1)
            eng_ = hold[0]
            for b, (n, pos) in enumerate(zip(per_row.tolist(), t.tolist())):
                req = eng_._requests[b]
                # the step at position pos emits stream[pos]; inactive slots' rows are junk
                if n and eng_._active[b] and any(req is r for r in q_requests):
                    n_flips[0] += n
                    first_flip[req.request_id] = min(first_flip.get(req.request_id, pos), pos)

        quant.reset_route_counts()
        with pool_spy(seen, check):
            eng, streams, _, launches = serve(q_model, q_params, "paged", q_requests, warmup,
                                              hold=hold, quant_policy=policy)
        routes = dict(quant.int8_matmul_routes)
        if launches != q_layers * eng.steps or not launches:
            fail(f"[24] (b) {policy}: B6 launches {launches} != {q_layers} x {eng.steps}")
        if policy == "w8a8" and not (routes["int_mm"] and routes["f32_exact"]):
            fail(f"[24] (b) w8a8 ran the int8 routes {routes}: expected torch._int_mm for "
                 f"the prefill chunks and the exact f32 route for the decode rows")
        del eng, hold[:]
        # the timed run, without the spy: its streams must be the spied run's
        t_eng, t_streams, wall, t_launches = serve(q_model, q_params, "paged", q_requests,
                                                   warmup, quant_policy=policy)
        if t_launches != q_layers * t_eng.steps or t_streams != streams:
            fail(f"[24] (b) {policy}: the timed run (B6 launches {t_launches}, "
                 f"{t_eng.steps} steps) differs from the spied run")
        _, plain_streams, _, _ = serve(q_model, q_params, "contiguous", q_requests, warmup,
                                       quant_policy=policy)
        # w8a8 quantizes every activation row: where B6's output and the plain version's
        # (equal within PAGED_ATOL, checked at every call above) fall on two sides of an
        # int8 rounding boundary, the codes differ by one and the logits move by far more
        # than TIE_GAP; a divergence above the gap is allowed only at or after a flip of
        # its own request
        ties = compare_streams(f"[24] (b) {policy}", q_model, t_eng.params, q_requests,
                               t_streams, plain_streams,
                               flipped=first_flip if policy == "w8a8" else None)
        same = sum(t_streams[i] == plain_streams[i] for i in plain_streams)
        flip_note = (f"; {n_flips[0]} int8 activation codes of live slots differ, in "
                     f"requests {sorted(first_flip)}" if policy == "w8a8" else "")
        print(f"[24] (b) quant_policy={policy}: {t_eng.steps} decode steps, "
              f"{t_eng.generated_tokens} tokens in {wall:.4f} s "
              f"({t_eng.generated_tokens / wall:.1f} tokens/s, {wall / t_eng.steps * 1e3:.4f} "
              f"ms per decode step, prefill included; a run without the spy, its streams the "
              f"spied run's); int8 matmul routes {routes}; every B6 call of the spied run "
              f"within ({PAGED_ATOL:g}, {PAGED_RTOL:g}) of the plain version on its operands "
              f"(max |err| {errs[0]:.3e}{flip_note}); paged (B6) vs contiguous (plain) "
              f"streams: {same}/{QUANT_REQUESTS} equal, {ties} diverging; weights "
              f"{t_eng.byte_accounting()['params_bytes']} bytes [{card}]")
        del t_eng
    torch.cuda.empty_cache()

    # (c) the prefix cache on a shared-prefix mix: every prompt is the same 392 tokens,
    # then a token of its own and a suffix; pages of 64, so a hit of 392 ends mid-page
    prefix = test_ids[0, :SHARED_PREFIX]
    shared = [serving.Request(prompt=np.concatenate(
        [prefix, [i % (q_model.vocab_size - 1)], test_ids[i + 1, SHARED_PREFIX + 1:
                                                        SHARED_PREFIX + 9 + 4 * i]])
        .astype(np.int32), max_new_tokens=32, request_id=i) for i in range(QUANT_REQUESTS)]
    cache_kw = dict(kv_dtype="int8", num_slots=PREFIX_SLOTS)
    c_eng, c_streams, c_wall, c_launches = serve(q_model, q_params, "paged", shared, warmup,
                                                 prefix_cache_entries=QUANT_REQUESTS,
                                                 **cache_kw)
    n_eng, n_streams, n_wall, _ = serve(q_model, q_params, "paged", shared, warmup,
                                        **cache_kw)
    c_stats, c_pages = c_eng.prefix_cache.stats(), c_eng.page_stats()
    if c_launches != q_layers * c_eng.steps:
        fail(f"[24] (c) B6 launches {c_launches} != {q_layers} x {c_eng.steps}")
    if not c_stats["hits"] or not c_pages["cow_copies"]:
        fail(f"[24] (c) prefix cache {c_stats}, {c_pages['cow_copies']} copy-on-writes: "
             f"expected hits and at least one boundary-page copy")
    ties = compare_streams("[24] (c)", q_model, c_eng.params, shared, c_streams, n_streams,
                           kv_dtype="int8")
    print(f"[24] (c) {QUANT_REQUESTS} requests sharing a {SHARED_PREFIX}-token prefix "
          f"through {PREFIX_SLOTS} slots, int8 KV: {c_stats['hits']} hits of "
          f"{c_stats['queries']} lookups ({c_stats['hit_tokens']} tokens), "
          f"{c_pages['cow_copies']} boundary-page copy-on-writes; prefill chunks "
          f"{c_eng.prefill_invocations} against {n_eng.prefill_invocations} without the "
          f"cache ({n_eng.prefill_invocations - c_eng.prefill_invocations} saved), prefill "
          f"tokens {c_eng.prefill_tokens} against {n_eng.prefill_tokens}; run {c_wall:.4f} s "
          f"against {n_wall:.4f} s; streams vs the run without the cache: "
          f"{sum(c_streams[i] == n_streams[i] for i in n_streams)}/{QUANT_REQUESTS} equal, "
          f"{ties} diverging at a true tie [{card}]")
    del c_eng, n_eng
    torch.cuda.empty_cache()

    # (e) B6's int8 and fp8 branches alone, at the serving shape and at R = 8, D = 128
    # (before (d): each profiler window in a process that has not yet run the server's
    # threads)
    quant_times, quant_err = {}, {}
    for kv, dtype in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        quant_err[kv] = 0.0
        for label, g, r, d in (("serving", 2, 4, 32), ("r8_d128", 2, 8, 128)):
            q, k, v, table, t, scales = paged_case(g, r, d, dtype, "random", 2400 + g + r + d)
            out = paged.paged_attend(q, k, v, table, t, seq_len=s_len, **scales)
            want = paged.paged_attend_reference(q, k, v, table, t, seq_len=s_len, **scales)
            torch.cuda.synchronize()
            e = close(f"[24] (e) paged_attend {kv} {label}", out, want, PAGED_ATOL,
                      PAGED_RTOL)
            quant_err[kv] = max(quant_err[kv], e)
            t_kernel = lambda: paged.paged_attend(q, k, v, table, t, seq_len=s_len, **scales)
            tm = dict(ms=timed_ms(t_kernel, PAGED_ITERS, PAGED_WARMUP),
                      plain_ms=timed_ms(lambda: paged.paged_attend_reference(
                          q, k, v, table, t, seq_len=s_len, **scales), PAGED_ITERS,
                          PAGED_WARMUP),
                      library_ms=timed_ms(sdpa_on_view(q, k, v, table, t, 0, scales),
                                          PAGED_ITERS, PAGED_WARMUP),
                      bound=paged_bound(q, k, t, 0, scales))
            # device µs a call: each kernel's mean µs a launch as the profiler recorded it
            # (the profiler drops launch records at times: a window that did not record all
            # 20 launches of both kernels is taken again, at most three times)
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        t_kernel()
                    torch.cuda.synchronize()
                b6_us = [(re.search(r"paged_attend\w*", name).group(0), us, n)
                         for us, n, name in device_kernel_times(prof)
                         if "paged_attend" in name and n]
                if b6_us and all(n == 20 for _, _, n in b6_us):
                    break
            us = (f"{sum(u / n for _, u, n in b6_us):.3f} ("
                  + " + ".join(f"{u / n:.3f} {k} ({n} launches recorded of 20)"
                               for k, u, n in b6_us) + ")"
                  if b6_us else "not measured")
            print(f"[24] (e) paged_attend {kv} q {list(q.shape)} pool [{n_pages}, {ps}, {g}, "
                  f"{d}] + f32 scales, visible rows {visible_rows(t, 0)}: max |err| {e:.3e}; "
                  f"kernel_ms {tm['ms']:.5f}, device us/call {us}, plain_ms "
                  f"{tm['plain_ms']:.5f}, bound_ms {tm['bound'][0]:.3e} ({tm['bound'][1]}; "
                  f"the narrow pool and its scales), {tm['bound'][0] / tm['ms']:.4f} of the "
                  f"bound, sdpa_ms {tm['library_ms']:.5f} (gathered, dequantized view) "
                  f"[{card}]")
            if label == "serving":
                quant_times[f"paged_attend_{kv}"] = tm
            del q, k, v, table, t, scales
    torch.cuda.empty_cache()

    # (d) the Server: 32 requests from 4 submitter threads, two tenants, one preemptible
    rng = np.random.default_rng(25)
    server_reqs = [serving.Request(
        prompt=test_ids[i, :int(rng.integers(1, SHARED_PREFIX))].copy(),
        max_new_tokens=BENCH_LM_MAX_NEW if i < SERVER_REQUESTS // 2 else 16, request_id=i,
        tenant="free" if i < SERVER_REQUESTS // 2 else "paid")
        for i in range(SERVER_REQUESTS)]
    s_kw = dict(num_slots=SERVE_SLOTS, kv_layout="paged", page_size=SERVE_PAGE, device=dev,
                kv_dtype="int8", prefix_cache_entries=SERVER_REQUESTS)
    ref_eng = serving.ContinuousBatchingEngine(q_model, q_params, **s_kw)
    ref_streams = {c.request.request_id: c.tokens.tolist() for c in ref_eng.run(
        [serving.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens, request_id=i)
         for i, r in enumerate(server_reqs)])}
    s_eng = serving.ContinuousBatchingEngine(q_model, q_params, **s_kw)
    s_eng.run(warmup)
    s_eng.reset_stats()
    server_stream = OUT_DIR / "server_24d.jsonl"
    server = serving.Server(s_eng, tenants=serving.parse_tenants(SERVER_TENANTS),
                            telemetry=str(server_stream))
    futures: dict = {}
    lock = threading.Lock()

    def submitter(part):
        for req in part:
            fut = server.submit(req.prompt, max_new_tokens=req.max_new_tokens,
                                tenant=req.tenant)
            with lock:
                futures[req.request_id] = fut

    def submit_from(parts):
        threads = [threading.Thread(target=submitter, args=(part,)) for part in parts]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            if th.is_alive():
                fail("[24] (d) a submitter thread did not finish within 120 s")

    half = SERVER_REQUESTS // 2
    torch.cuda.synchronize()
    paged.reset_launch_counts()
    t0 = time.perf_counter()
    server.start()
    submit_from([server_reqs[0:half:2], server_reqs[1:half:2]])     # the preemptible tenant
    while s_eng.num_active < SERVE_SLOTS or s_eng.steps < 2:
        if time.perf_counter() - t0 > 120:
            fail("[24] (d) the free tenant's requests did not fill the slots within 120 s")
        time.sleep(0.001)
    submit_from([server_reqs[half::2], server_reqs[half + 1::2]])   # the paid tenant
    done = {rid: fut.result(timeout=600) for rid, fut in futures.items()}
    server.stop(drain=True, timeout=600)
    torch.cuda.synchronize()
    s_wall = time.perf_counter() - t0
    s_launches = paged.launch_counts()["paged_attend"]
    got_streams = {rid: comp.tokens.tolist() for rid, comp in done.items()}
    for rid, comp in sorted(done.items()):
        if comp.finish != "ok":
            fail(f"[24] (d) request {rid} resolved with finish={comp.finish!r}")
    if len(done) != SERVER_REQUESTS:
        fail(f"[24] (d) {len(done)} of {SERVER_REQUESTS} futures resolved")
    if not s_eng.preemptions or not s_eng.resumes:
        fail(f"[24] (d) {s_eng.preemptions} parks and {s_eng.resumes} resumes: the paid "
             f"tenant's arrival should have parked a free slot")
    if s_launches != q_layers * s_eng.steps:
        fail(f"[24] (d) B6 launches {s_launches} != {q_layers} x {s_eng.steps}")
    ties = compare_streams("[24] (d)", q_model, s_eng.params, server_reqs, got_streams,
                           ref_streams, kv_dtype="int8")
    hists = {name: obs.LogHistogram.from_json(doc)
             for name, doc in server.latency_histograms().items()}
    lat = {name: (hists[name].quantile(50) * 1e3, hists[name].quantile(95) * 1e3)
           for name in ("ttft_s", "tpot_s", "e2e_s")}
    tenants = server.tenant_summaries()
    print(f"[24] (d) Server: {SERVER_REQUESTS} requests from 4 submitter threads, tenants "
          f"{SERVER_TENANTS!r}, int8 KV, prefix cache: all resolved 'ok' in {s_wall:.3f} s; "
          f"{s_eng.preemptions} parks, {s_eng.resumes} resumes; {s_eng.steps} decode steps, "
          f"B6 launches {s_launches} = layers x steps; streams vs engine.run: "
          f"{sum(got_streams[i] == ref_streams[i] for i in ref_streams)}/{SERVER_REQUESTS} "
          f"equal, {ties} diverging at a true tie [{card}]")
    print(f"[24] (d) latency_histograms p50/p95 ms: TTFT {lat['ttft_s'][0]:.3f}/"
          f"{lat['ttft_s'][1]:.3f}, TPOT {lat['tpot_s'][0]:.4f}/{lat['tpot_s'][1]:.4f}, e2e "
          f"{lat['e2e_s'][0]:.3f}/{lat['e2e_s'][1]:.3f} [{card}]")
    for name, row in sorted(tenants.items()):
        ttft = row["ttft_s"] or {}
        print(f"[24] (d) tenant {name}: {row['requests']} requests, {row['ok']} ok, "
              f"{row['preemptions']} preemptions (decode-ready parks), TTFT p50/p95 "
              f"{ttft.get('p50', float('nan')) * 1e3:.3f}/"
              f"{ttft.get('p95', float('nan')) * 1e3:.3f} ms [{card}]")
    del s_eng, ref_eng, server
    torch.cuda.empty_cache()

    # -- 25. the pixel LM trained on the card, then served through B6 --------------------
    PHASE_START[25] = time.perf_counter()
    trained = lm_phase(dev, card, train_ds, test_ds)

    # (d) the trained checkpoint served: the paged engine (B6) against greedy generate
    t_model = lm.TransformerLM(**SERVE_LM)
    t_params = checkpoint.load_params_or_state(str(trained["path"]),
                                               t_model.init(torch.Generator()))
    t_params_dev = {name: p.to(dev) for name, p in t_params.items()}
    for name, p in trained["state"].params.items():
        if not torch.equal(t_params_dev[name], p):
            fail(f"[25] (d) load_params_or_state's {name} differs from the trained state's")
    t_ids = test_ids[:LM_REQUESTS]
    t_requests = [serving.Request(prompt=t_ids[i, :LM_PROMPT].copy(),
                                  max_new_tokens=SERVE_LM["seq_len"] - LM_PROMPT,
                                  request_id=i) for i in range(LM_REQUESTS)]
    t0 = time.perf_counter()
    gen = lm.generate(t_model, t_params_dev, batch=LM_REQUESTS, temperature=0.0,
                      prompt=torch.from_numpy(t_ids).to(dev), prompt_len=LM_PROMPT).cpu()
    gen_s = time.perf_counter() - t0
    gen_streams = {i: gen[i].tolist() for i in range(LM_REQUESTS)}
    served = {}
    for kv in ("model", "int8", "fp8"):
        eng, streams, wall, launches = serve(t_model, t_params, "paged", t_requests, warmup,
                                             kv_dtype=kv)
        if sorted(streams) != list(range(LM_REQUESTS)):
            fail(f"[25] (d) kv_dtype={kv}: {len(streams)} of {LM_REQUESTS} requests completed")
        if launches != t_model.num_layers * eng.steps or not launches:
            fail(f"[25] (d) kv_dtype={kv}: B6 launches {launches} != "
                 f"{t_model.num_layers} x {eng.steps} decode steps")
        served[kv] = (streams, eng.steps, wall, launches)
        del eng
    streams, n_steps, wall, launches = served["model"]
    ties = compare_streams("[25] (d)", t_model, t_params_dev, t_requests, streams, gen_streams)
    same = sum(streams[i] == gen_streams[i] for i in gen_streams)
    print(f"[25] (d) the trained model_lm.ckpt through load_params_or_state into "
          f"ContinuousBatchingEngine (paged, {SERVE_SLOTS} slots, pages of {SERVE_PAGE}): "
          f"{LM_REQUESTS} greedy requests prompted with the top {LM_PROMPT} tokens of test "
          f"images, {LM_PROMPT} new tokens each: {same}/{LM_REQUESTS} streams equal to "
          f"greedy generate ({gen_s:.3f} s), {ties} diverging at a true tie; B6 launches "
          f"{launches} = {t_model.num_layers} layers x {n_steps} decode steps; "
          f"{wall:.4f} s ({LM_REQUESTS * (SERVE_LM['seq_len'] - LM_PROMPT) / wall:.1f} "
          f"tokens/s, prefill included) [{card}]")
    targets = torch.from_numpy(t_ids).to(dev)
    nll = {kv: lm.decode_nll(t_model, t_params_dev, targets,
                             kv_dtype=None if kv == "model" else kv).item()
           for kv in ("model", "int8", "fp8")}
    for kv in ("int8", "fp8"):
        q_streams, q_steps, q_wall, q_launches = served[kv]
        new = [(a[LM_PROMPT:], b[LM_PROMPT:]) for a, b in
               ((q_streams[i], streams[i]) for i in range(LM_REQUESTS))]
        match = sum(sum(x == y for x, y in zip(a, b)) for a, b in new) / sum(
            len(b) for _, b in new)
        delta = nll[kv] - nll["model"]
        if abs(delta) > NLL_DELTA_BUDGET:
            fail(f"[25] (d) kv_dtype={kv}: teacher-forced decode_nll delta {delta:+.6f} "
                 f"beyond {NLL_DELTA_BUDGET}")
        print(f"[25] (d) kv_dtype={kv} on the trained weights: B6 launches {q_launches} = "
              f"{t_model.num_layers} x {q_steps}; greedy token match against the "
              f"unquantized engine {match:.4f} (the JAX package's budget "
              f"{TOKEN_MATCH_BUDGET}, printed only: one flip cascades through a stream); "
              f"teacher-forced decode_nll {nll[kv]:.6f} vs {nll['model']:.6f}, delta "
              f"{delta:+.6f} (bar |delta| <= {NLL_DELTA_BUDGET}); {q_wall:.4f} s [{card}]")
    del served, t_params_dev
    torch.cuda.empty_cache()

    # (e) the port's bench_lm at its defaults (its main() in this process: one process
    # start less than `python -m <port>.bench_lm`, the same flags and line)
    from csed_514_project_distributed_training_using_pytorch_tpu_torch import bench_lm
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = bench_lm.main([])
    torch.cuda.empty_cache()
    if code != 0:
        fail(f"[25] (e) bench_lm returned {code}")
    lines = [l for l in out.getvalue().splitlines() if l.startswith("{")]
    if len(lines) != 1:
        fail(f"[25] (e) bench_lm printed {len(lines)} JSON lines, not one")
    bench = json.loads(lines[0])
    if bench.get("platform") != "gpu" or bench.get("train_program") != "cuda-graph":
        fail(f"[25] (e) bench_lm ran {bench.get('platform')}, {bench.get('train_program')}")
    print(f"[25] (e) bench_lm ({time.perf_counter() - t0:.1f} s) [{card}]: {lines[0]}")

    # -- 26. speculative decoding, the A/B and the load generator -----------------------
    PHASE_START[26] = time.perf_counter()
    spec_phase(dev, card, t_model, t_params, trained["path"], train_ds, test_ds, test_ids,
               compare_streams)
    torch.cuda.empty_cache()

    # -- 27. the transformer on every trainer and every sequence schedule ----------------
    PHASE_START[27] = time.perf_counter()
    slice16 = transformer_trainers_phase(dev, card, train_ds, test_ds)
    torch.cuda.empty_cache()

    # -- 28. the training meshes ----------------------------------------------------------
    PHASE_START[28] = time.perf_counter()
    slice17 = mesh_phase(dev, card)
    torch.cuda.empty_cache()

    # -- 29. the serve mesh and the telemetry stream --------------------------------------
    PHASE_START[29] = time.perf_counter()
    slice18 = serve_mesh_phase(dev, card, t_model, t_params, trained["path"], test_ids,
                               warmup, serve, compare_streams, request_mix, train_ds,
                               test_ds, server_stream)
    torch.cuda.empty_cache()

    # -- 30. the fault and tracing plane ----------------------------------------------------
    PHASE_START[30] = time.perf_counter()
    slice19 = fault_plane_phase(dev, card, t_model, t_params, trained["path"], test_ids,
                                request_mix, serve, compare_streams, warmup)
    torch.cuda.empty_cache()

    # -- 31. the serving fleet --------------------------------------------------------------
    PHASE_START[31] = time.perf_counter()
    eval_ids = lm.tokenize_images_to_ids(torch.from_numpy(
        test_ds.images[PROMOTE_IDS[0]:PROMOTE_IDS[1]])).numpy()
    slice20 = fleet_phase(dev, card, t_model, t_params, trained["path"], test_ids, serve,
                          compare_streams, warmup, eval_ids)
    torch.cuda.empty_cache()

    # -- 32. the parallelism planner --------------------------------------------------------
    PHASE_START[32] = time.perf_counter()
    slice21 = planner_phase(dev, card, train_ds, test_ds, t_model, t_params)
    torch.cuda.empty_cache()

    # -- 33. the train→serve promotion loop -------------------------------------------------
    PHASE_START[33] = time.perf_counter()
    promote_loop_phase(card)

    # -- 34. the sharded replica behind the router ------------------------------------------
    PHASE_START[34] = time.perf_counter()
    slice23 = sharded_fleet_phase(dev, card, t_model, t_params, trained["path"], test_ids,
                                  serve, compare_streams, warmup)
    torch.cuda.empty_cache()

    # -- 35. result ---------------------------------------------------------------------
    PHASE_START[35] = time.perf_counter()
    replaces = {"nll_fwd": f"{TPU_KERNELS}:53", "nll_bwd": f"{TPU_KERNELS}:69",
                "sgd_momentum": f"{TPU_KERNELS}:156", "flash_fwd_tf32": f"{TPU_ATTENTION}:479",
                "flash_dq_tf32": f"{TPU_ATTENTION}:666", "flash_dkv_tf32": f"{TPU_ATTENTION}:731",
                "flash_fwd_mma": f"{TPU_ATTENTION}:479", "flash_dq_mma": f"{TPU_ATTENTION}:666", "flash_dkv_mma": f"{TPU_ATTENTION}:731",
                "paged_attend": f"{TPU_PAGED}:85"}
    replaces |= {name: f"{TPU_PAGED}:85" for name in quant_times}
    sources = ({name: SOURCE for name in times} | {name: FLASH_SOURCE for name in flash_times}
               | {name: PAGED_SOURCE for name in ("paged_attend", *quant_times)})
    # B6's int8 and fp8 branches: launches on [24] (a)'s serving runs, numbers from (e)
    all_launches |= {f"paged_attend_{kv}": n for kv, n in quant_launches.items()}
    all_err |= {f"paged_attend_{kv}": e for kv, e in quant_err.items()}
    kernels = [{"name": name, "route": "cuda", "source": sources[name],
                "replaces": replaces[name], "launches": all_launches[name],
                "max_abs_err": all_err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"]}
               for name, t in (times | flash_times | paged_times | quant_times).items()]
    for entry in kernels:          # B1/B2's launch floor ([3]), in ms a launch by rows
        if "launch_floor_ms" in times.get(entry["name"], {}):
            entry["launch_floor_ms"] = {str(r): ms for r, ms in
                                        times[entry["name"]]["launch_floor_ms"].items()}
    for entry in kernels:          # each flash kernel's offset form ([17], [19] ring window)
        if entry["name"] in offset_times:
            o = offset_times[entry["name"]]
            entry["offset"] = {
                "q_offsets": list(offsets), "case": "q_offset +C, window 300, non-causal",
                "launches": offset_launches[entry["name"]],
                "max_abs_err": offset_err[entry["name"]], "ms": o["ms"],
                "ms_at_offset_0": o["ms_at_offset_0"], "plain_ms": o["plain_ms"],
                "bound_ms": o["bound"][0], "bound_by": o["bound"][1], "library_ms": None}
    # B1-B5's launches on phase 27's paths beside those of the paths above
    new_paths = {"train.single --model transformer [27] (c)": (
        slice16["single_transformer"], {n: n for n in ("nll_fwd", "nll_bwd", "sgd_momentum")}),
        "composed ulysses seq=2, rank 0 [27] (a)": (
            slice16["ulysses_rank0"],
            dict(zip(("flash_fwd_tf32", "flash_dq_tf32", "flash_dkv_tf32"), counted))),
        "bench_transformer --large --flash [27] (b)": (
            slice16["bench"],
            dict(zip(("flash_fwd_mma", "flash_dq_mma", "flash_dkv_mma"), counted)))}
    tf32 = ("flash_fwd_tf32", "flash_dq_tf32", "flash_dkv_tf32")
    new_paths |= {f"composed {label}, rank 0 [28]": (launches, dict(zip(tf32, counted)))
                  for label, launches in slice17.items()}
    new_paths[f"composed --plan tune, the planned run (grad_accum {slice21['grad_accum']}) "
              f"[32] (b)"] = (slice21["tf32"], dict(zip(tf32, counted)))
    for entry in kernels:
        for path, (counts, names) in new_paths.items():
            if entry["name"] in names:
                entry.setdefault("launches_by_path", {})[path] = counts[names[entry["name"]]]
        if entry["name"] == "paged_attend":      # B6 on each rank's own heads and pages
            entry["serve_mesh"] = slice18
        for path, counts in slice19["b1_b3"].items():     # [30]'s supervised trainers
            if entry["name"] in counts:
                entry.setdefault("launches_by_path", {})[path] = counts[entry["name"]]
        if entry["name"] == "paged_attend":              # [30] (c)'s replica process
            entry.setdefault("launches_by_path", {}).update(slice19["b6"])
        if entry["name"] == "paged_attend":              # [31]'s fleet replicas
            entry["launches_by_path"].update(slice20["b6"])
        if entry["name"] == "paged_attend":              # [34]'s sharded replicas' ranks
            entry["launches_by_path"].update(slice23["b6"])
    print(f"[35] chip_smoke.py {time.perf_counter() - t_start:.1f} s from the device check "
          f"to here, the builds included; seconds by phase: {phase_seconds()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        if PHASE_START:
            print(f"chip_smoke: seconds by phase: {phase_seconds()}", file=sys.stderr)
        raise
