"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library of its
own with a plain C interface, loaded with ``ctypes``. The build happens at first use, never
at import, into ``csrc/_build/`` inside the package (listed in ``.gitignore``), under a name
keyed by a hash of the source and the flags: an edited source builds anew, an unchanged one
loads the library already there. A build writes to a temporary name and renames it into
place, so a process never loads a half-written library. ``build`` starts one ``nvcc`` per
source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_S = ctypes.POINTER(ctypes.c_int64)    # three element strides (b, s, h), host memory
# Every pointer and the stream are c_void_p: without argtypes ctypes would pass a Python
# int as a 32-bit int and cut the pointer.
SIGNATURES = {
    "fused_kernels": {
        # logits, labels, nll, rows, cols, stream
        "nll_fwd_f32": (_P, _P, _P, _I, _I, _P),
        # logits, labels, ct, ct_stride, ct_scale, dlogits, rows, cols, stream
        "nll_bwd_f32": (_P, _P, _P, _I64, _F, _P, _I, _I, _P),
        # p, v, g (host arrays of device pointers), n (host int64 array), count, lr,
        # momentum, stream
        "sgd_momentum_multi_f32": (_P, _P, _P, _P, _I, _F, _F, _P),
    },
    "flash_attention": {
        # dtype, q, q_strides, k, k_strides, v, v_strides, out, lse,
        # B, S, H, D, scale, causal, window, q_offset, stream
        "flash_fwd": (_I, _P, _S, _P, _S, _P, _S, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                      _P),
        # dtype, q, k, v, dout (each with strides), lse, delta, dq,
        # B, S, H, D, scale, causal, window, q_offset, stream
        "flash_dq": (_I, _P, _S, _P, _S, _P, _S, _P, _S, _P, _P, _P,
                     _I, _I, _I, _I, _F, _I, _I, _I, _P),
        # as flash_dq, writing dk and dv
        "flash_dkv": (_I, _P, _S, _P, _S, _P, _S, _P, _S, _P, _P, _P, _P,
                      _I, _I, _I, _I, _F, _I, _I, _I, _P),
    },
    "paged_attention": {
        # dtype, q, k_pool, v_pool, k_scale, v_scale (null without scales), table, t, out,
        # workspace (null without a split), B, G, R, D, page_size, P_max, seq_len, window,
        # rows_per_block, n_split, scale, stream
        "paged_attend": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    },
}


@dataclass(frozen=True)
class KernelLibrary:
    """A loaded library and how it was obtained."""

    name: str
    lib: ctypes.CDLL
    path: Path

    def check(self, kernel: str, code: int) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if code:
            msg = getattr(self.lib, f"{self.name}_error_string")(code).decode()
            raise RuntimeError(f"{kernel}: CUDA error {code} ({msg})")


@dataclass(frozen=True)
class BuildResult:
    """One source's build: the library's path, nvcc's seconds (0.0 when an up-to-date
    library was already on disk) and its output (the ptxas register and spill report)."""

    path: Path
    seconds: float
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives, keyed by its source and the flags."""
    source = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{key}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, BuildResult]:
    """Build every named library that is not on disk yet, one ``nvcc`` per source, all
    started together; raise if any fails."""
    started = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[name] = (proc, cmd, tmp, path, time.perf_counter())
    results = {name: BuildResult(library_path(name), 0.0, "") for name in names}
    failures = []
    for name, (proc, cmd, tmp, path, t0) in started.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, path)
        results[name] = BuildResult(path, seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


@functools.cache
def load_library(name: str) -> KernelLibrary:
    """Build (if needed) and load the library of ``csrc/<name>.cu``; one load per process."""
    path = build((name,))[name].path
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return KernelLibrary(name, lib, path)


def launch(library: str, kernel: str, device: torch.device, entry: str, *args) -> None:
    """Call the C entry point ``entry`` of ``library`` with ``args`` and ``device``'s current
    stream, with ``device`` current only for the call (torch keeps owning the thread's
    device), and raise on a CUDA error."""
    kl = load_library(library)
    fn, index = getattr(kl.lib, entry), device.index
    # the stream's raw handle, without building a torch.cuda.Stream object at every launch;
    # the device switch only where it is needed (the CNN step's launches are host-bound)
    if torch.cuda.current_device() == index:
        code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    kl.check(kernel, code)
