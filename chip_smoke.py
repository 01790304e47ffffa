#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100: builds the hand-written CUDA kernels,
holds each against its plain PyTorch version on the card, and trains the reference CNN for
one epoch through them.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. the device: ``torch.cuda.get_device_name`` and nvidia-smi's name and power limit;
2. build ``csrc/fused_kernels.cu`` with nvcc for sm_90a and report the build seconds;
3. each kernel against its plain version on the card, at the main path's shapes and more,
   with its time, its plain version's time, its bound and, where one PyTorch call computes
   the same function, that call's time (a yardstick only; the port never calls it);
4. a 20-step trajectory with dropout off, kernels against the plain path, on the card, and
   the kernel path on the card against the plain path on the CPU;
5. the whole slice: ``train.single.main`` on cuda with ``use_pallas_kernels=True`` for one
   epoch of the 60k/10k split at batch 64, with the launch counts read around it;
6. where a step spends its time: the train step's wall time with the kernels and with the
   plain path, in turns (plain, kernels, kernels, plain), then a ``torch.profiler`` window
   over the kernel path: device time by kernel, device time per launch of each fused
   kernel, and the device's busy share of the window (the rest is idle, waiting on the
   host);
7. one JSON line with every kernel's numbers, then, last, the JSON result line.

It exits non-zero, and prints no result, when no CUDA device is present or when the port's
package is not beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "results" / "chip_smoke"
TPU_KERNELS = "csed_514_project_distributed_training_using_pytorch_tpu/ops/pallas_kernels.py"
SOURCE = f"{PKG}/csrc/fused_kernels.cu"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores

NLL_SHAPES = ((64, 10), (32, 10), (1, 10), (300, 130), (4096, 1000))
NLL_ATOL, NLL_RTOL = 1e-6, 1e-5
CNN_LEAVES = (250, 10, 5000, 20, 16000, 50, 500, 10)
SGD_REL_TOL = 1e-6             # times max|p|
TRAJECTORY_STEPS = 20
TRAJECTORY_ATOL = 1e-5         # kernels vs plain path, both on the card
CROSS_DEVICE_ATOL = 1e-4       # card vs CPU: conv sums run in another order
LR, MOMENTUM, BATCH = 0.01, 0.5, 64
PROFILE_STEPS = 200            # per timed run of phase 6
PROFILE_WINDOW = 100           # steps under the profiler


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time the card could take: bytes over the memory rate vs ops over the f32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    if not (ROOT / PKG).is_dir():
        fail(f"the port's package {PKG}/ is not beside this script")
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
        load_mnist, mnist,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import Net
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        _build, fused_kernels as fk,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import single
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
        create_train_state, make_eval_fn, make_train_step,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        SingleProcessConfig,
    )

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
    kl = _build.load_library()
    print(f"[2] kernels built in {kl.build_seconds:.2f} s (load total "
          f"{time.perf_counter() - t0:.2f} s): {kl.path.name}")
    for line in kl.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[2] ptxas: {line.strip()}")

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

    print(f"[3] sgd_momentum vs plain, 3 steps: tolerance {SGD_REL_TOL:g} * max|p|")
    for n_leaf in CNN_LEAVES + (1 << 22,):
        p, v, g = (torch.randn(n_leaf, generator=gen, device=dev) for _ in range(3))
        pk, vk, pp, vp = p.clone(), v.clone(), p.clone(), v.clone()
        for _ in range(3):
            fk.sgd_momentum_leaf(pk, vk, g, learning_rate=LR, momentum=MOMENTUM)
            fk.sgd_momentum_leaf_plain(pp, vp, g, learning_rate=LR, momentum=MOMENTUM)
        tol = SGD_REL_TOL * pp.abs().max().item()
        e = max(close(f"sgd p n={n_leaf}", pk, pp, tol, 0.0),
                close(f"sgd v n={n_leaf}", vk, vp, tol, 0.0))
        err["sgd_momentum"] = max(err["sgd_momentum"], e)
    print(f"[3]   8 CNN leaves + one of 2^22: max |err| {err['sgd_momentum']:.3e}")

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
    n_leaves = len(state.params)
    if launches["sgd_momentum"] != steps * n_leaves:
        fail(f"sgd_momentum launches {launches['sgd_momentum']} != {steps} x {n_leaves}")
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
    device_kernels = []
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            device_kernels.append((us, evt.count, evt.key))
    busy_us = sum(k[0] for k in device_kernels)
    print(f"[6] profiled {PROFILE_WINDOW} steps: wall {wall * 1e3:.3f} ms, "
          f"{wall / PROFILE_WINDOW * 1e3:.4f} ms per step [{card}]")
    if busy_us == 0:
        print("[6] the profiler recorded no device time: busy share not measured")
    else:
        n_launch = sum(k[1] for k in device_kernels)
        print(f"[6] device busy {busy_us / 1e3:.3f} ms = {busy_us / 1e6 / wall:.4f} of the "
              f"window (idle {1 - busy_us / 1e6 / wall:.4f}); {n_launch} kernel launches, "
              f"{n_launch / PROFILE_WINDOW:.1f} per step")
        ours = ("nll_fwd_kernel", "nll_bwd_kernel", "sgd_momentum_kernel")
        print("[6]   us/step  launches/step  share  kernel (top 10, then the port's own)")
        for rank, (us, count, name) in enumerate(sorted(device_kernels, reverse=True)):
            if rank < 10 or any(k in name for k in ours):
                print(f"[6]   {us / PROFILE_WINDOW:9.3f}  {count / PROFILE_WINDOW:5.1f}  "
                      f"{us / busy_us:6.3f}  {name[:100]}")
            for kernel in ours:
                if kernel in name:
                    print(f"[6] {kernel}: {us / count:.3f} us of device time per launch "
                          f"[{card}]")

    # -- 7. result ----------------------------------------------------------------------
    replaces = {"nll_fwd": f"{TPU_KERNELS}:53", "nll_bwd": f"{TPU_KERNELS}:69",
                "sgd_momentum": f"{TPU_KERNELS}:156"}
    kernels = [{"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces[name],
                "launches": launches[name], "max_abs_err": err[name], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"]}
               for name, t in times.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
