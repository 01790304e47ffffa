#!/usr/bin/env python3
"""What bounds the flash kernels on the card: builds ``csrc/flash_attention.cu`` as it is
and with one change at a time, then times

1. the bf16 forward (``flash_fwd_mma_kernel``) of each at the ``bench_transformer.py
   --large`` shape ``[16, 2048, 8, 128]``, full and causal, beside
   ``F.scaled_dot_product_attention``;
2. the f32 forward and backward (``flash_fwd_tf32_kernel``, ``flash_dq_tf32_kernel``,
   ``flash_dkv_tf32_kernel``) of each at the composed trainer's shape ``[64, 2048, 4, 16]``,
   in turns, with each build's SASS instruction count for the D = 16 kernels and its
   results against the build as it is.

    python3 flash_probe.py

The changes are diagnostics, never shipped: ``fast_exp`` takes ``__expf`` for the bf16
softmax's exponential (fewer instructions, other roundings), so the gap to the kernel as
built is what the precise ``expf`` costs; ``split_where_read`` splits every f32 operand
into TF32 hi and lo where its fragment is read (as at D = 64 and 128) instead of once
(the own rows held in registers, the walked tiles split as they land), ``cvt_rna``
rounds to TF32 with ``cvt.rna.tf32.f32`` instead of on the bits (the same values), and
``one_acc_set`` sums the f32 forward's P·V at D = 16 into one set of accumulators instead
of 4 (other sums: its forward is compared by its largest difference, not bit for bit), so
the gaps to the kernels as built are what each saves. Each build's ptxas registers and
spills are printed. The builds go to ``results/flash_probe/``; needs one CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "results" / "flash_probe"
SHAPE = (16, 2048, 8, 128)
COMPOSED = (64, 2048, 4, 16)
EXPF = "p[e] = expf(__fsub_rn(x[j][e], m_new[e >> 1]));"
ONCE = "template <int D> constexpr bool kTf32SplitOnce = D == 16;"
BITS = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
CVT = ('  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
       "  return r;")
SETS = "template <int D> constexpr int kTf32FwdAccSets = D == 16 ? 4 : 1;"


def main() -> None:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("flash_probe: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        _build, flash_attention as fa,
    )

    source = (_build.CSRC / "flash_attention.cu").read_text()
    if not all(anchor in source for anchor in (EXPF, ONCE, BITS, SETS)):
        sys.exit("flash_probe: a line the probe changes is not where it expects it")
    variants = {"as_built": source,
                "fast_exp": source.replace(EXPF, EXPF.replace("expf", "__expf")),
                "split_where_read": source.replace(ONCE, ONCE.replace("D == 16", "false")),
                "cvt_rna": source.replace(BITS, CVT),
                "one_acc_set": source.replace(SETS, SETS.replace("D == 16 ? 4 : 1", "1"))}
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        (OUT / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
               str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        lines = proc.communicate()[0].splitlines()
        if proc.returncode:
            sys.exit(f"flash_probe: nvcc failed for {name}:\n" + "\n".join(lines[-40:]))
        for kernel in ("flash_fwd_mma_kernelILi128", "flash_fwd_tf32_kernelILi16",
                       "flash_dq_tf32_kernelILi16", "flash_dkv_tf32_kernelILi16"):
            at = next(i for i, line in enumerate(lines)
                      if "Compiling entry" in line and kernel in line)
            print(f"{name}: {kernel}: "
                  + "; ".join(line.replace("ptxas info    :", "").strip()
                              for line in lines[at + 1:at + 4]))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    b, s, h, d = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(*SHAPE, generator=gen, device=dev).bfloat16() for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for causal in (False, True):
        bhsd = lambda x: x.transpose(1, 2)
        sdpa = timed_ms(lambda: F.scaled_dot_product_attention(bhsd(q), bhsd(k), bhsd(v),
                                                               is_causal=causal))
        for name in variants:
            lib = ctypes.CDLL(str(OUT / f"{name}.so"))
            fwd = lib.flash_fwd
            fwd.argtypes = list(_build.SIGNATURES["flash_attention"]["flash_fwd"])
            fwd.restype = ctypes.c_int
            out = torch.empty_like(q)
            lse = torch.empty((b, h, s), device=dev)
            args = (1, q.data_ptr(), fa._strides(q), k.data_ptr(), fa._strides(k),
                    v.data_ptr(), fa._strides(v), out.data_ptr(), lse.data_ptr(), b, s, h, d,
                    1.0 / math.sqrt(d), int(causal), 0, 0, stream)
            if fwd(*args):
                sys.exit(f"flash_probe: {name} did not launch")
            print(f"{name}: {list(SHAPE)} bf16 causal={causal}: "
                  f"{timed_ms(lambda: fwd(*args)):.5f} ms; SDPA {sdpa:.5f} ms [{card}]")
    del q, k, v

    # 2. the f32 kernels at the composed shape: the SASS of their D = 16 instances, then
    # each build in turns, its results against the build as it is
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    f32_builds = ("as_built", "split_where_read", "cvt_rna", "one_acc_set")
    for name in f32_builds:
        sass = subprocess.run([str(tool), "-sass", str(OUT / f"{name}.so")],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        for kernel in ("flash_fwd_tf32_kernelILi16", "flash_dq_tf32_kernelILi16",
                       "flash_dkv_tf32_kernelILi16"):
            body = sass.split(kernel, 1)[1].split("Function :", 1)[0]
            ops = [m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", body)]
            top = sorted({op: ops.count(op) for op in ops}.items(), key=lambda x: -x[1])[:6]
            print(f"{name}: {kernel}: {len(ops)} SASS instructions (both mask variants); "
                  f"most: {', '.join(f'{op} {n}' for op, n in top)}")
    b, s, h, d = COMPOSED
    q, k, v, do = (torch.randn(*COMPOSED, generator=gen, device=dev) for _ in range(4))
    out, lse = fa.flash_forward(q, k, v)
    delta = fa.flash_delta(out, do)
    common = (0, q.data_ptr(), fa._strides(q), k.data_ptr(), fa._strides(k), v.data_ptr(),
              fa._strides(v), do.data_ptr(), fa._strides(do), lse.data_ptr(),
              delta.data_ptr())
    shape_args = (b, s, h, d, 1.0 / math.sqrt(d), 0, 0, 0, stream)
    fwd_args = (0, q.data_ptr(), fa._strides(q), k.data_ptr(), fa._strides(k), v.data_ptr(),
                fa._strides(v))
    results, times = {}, {name: [] for name in f32_builds}
    for name in f32_builds + f32_builds[::-1]:
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        calls = {}
        for entry in ("flash_fwd", "flash_dq", "flash_dkv"):
            fn = getattr(lib, entry)
            fn.argtypes = list(_build.SIGNATURES["flash_attention"][entry])
            fn.restype = ctypes.c_int
            calls[entry] = fn
        o, l_, dq, dk, dv = (torch.empty_like(x) for x in (q, lse, q, q, q))
        runs = (lambda: calls["flash_fwd"](*fwd_args, o.data_ptr(), l_.data_ptr(), *shape_args),
                lambda: calls["flash_dq"](*common, dq.data_ptr(), *shape_args),
                lambda: calls["flash_dkv"](*common, dk.data_ptr(), dv.data_ptr(), *shape_args))
        if any(run() for run in runs):
            sys.exit(f"flash_probe: {name} did not launch")
        times[name].append(tuple(timed_ms(run) for run in runs))
        results[name] = (o, l_, dq, dk, dv)
    for name in f32_builds:
        fwd, bwd = results[name][:2], results[name][2:]
        same = [all(torch.equal(x, y) for x, y in zip(got, want))
                for got, want in ((fwd, results["as_built"][:2]), (bwd, results["as_built"][2:]))]
        apart = (fwd[0] - results["as_built"][0]).abs().max().item()
        print(f"{name}: {list(COMPOSED)} f32: forward "
              + ", ".join(f"{t[0]:.5f}" for t in times[name]) + " ms, dq "
              + ", ".join(f"{t[1]:.5f}" for t in times[name]) + " ms, dk/dv "
              + ", ".join(f"{t[2]:.5f}" for t in times[name])
              + f" ms; equal to as_built's: forward {same[0]} (out at most {apart:.3e} apart),"
              f" backward {same[1]} [{card}]")


if __name__ == "__main__":
    main()
