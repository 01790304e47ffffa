#!/usr/bin/env python3
"""What bounds the bf16 flash forward (``flash_fwd_mma_kernel``) on the card: builds
``csrc/flash_attention.cu`` as it is and with one change, then times the bf16 forward of
each at the ``bench_transformer.py --large`` shape ``[16, 2048, 8, 128]``, full and causal,
beside ``F.scaled_dot_product_attention``.

    python3 flash_probe.py

The change is a diagnostic, never shipped: ``fast_exp`` takes ``__expf`` for the softmax's
exponential (fewer instructions, other roundings), so the gap to the kernel as built is
what the precise ``expf`` costs. Each build's ptxas registers and spills are printed. The
builds go to ``results/flash_probe/``; needs one CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "results" / "flash_probe"
SHAPE = (16, 2048, 8, 128)
EXPF = "p[e] = expf(__fsub_rn(x[j][e], m_new[e >> 1]));"


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
    if EXPF not in source:
        sys.exit("flash_probe: the softmax's exponential is not where the probe expects it")
    variants = {"as_built": source,
                "fast_exp": source.replace(EXPF, EXPF.replace("expf", "__expf"))}
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
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and "flash_fwd_mma_kernelILi128" in line)
        print(f"{name}: flash_fwd_mma_kernel<128>: "
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
                    1.0 / math.sqrt(d), int(causal), 0, stream)
            if fwd(*args):
                sys.exit(f"flash_probe: {name} did not launch")
            print(f"{name}: {list(SHAPE)} bf16 causal={causal}: "
                  f"{timed_ms(lambda: fwd(*args)):.5f} ms; SDPA {sdpa:.5f} ms [{card}]")


if __name__ == "__main__":
    main()
