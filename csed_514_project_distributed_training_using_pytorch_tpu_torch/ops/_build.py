"""Build and load the hand-written CUDA kernels (``csrc/fused_kernels.cu``).

The source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library with a
plain C interface, loaded with ``ctypes``. The build happens at first use, never at
import, into ``csrc/_build/`` inside the package (listed in ``.gitignore``), under a name
keyed by a hash of the source and the flags: an edited source builds anew, an unchanged one
loads the library already there. The build writes to a temporary name and renames it into
place, so a process never loads a half-written library.
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

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_kernels.cu"
BUILD_DIR = SOURCE.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# Every pointer and the stream are c_void_p: without argtypes ctypes would pass a Python
# int as a 32-bit int and cut the pointer.
_SIGNATURES = {
    # logits, labels, nll, rows, cols, stream
    "nll_fwd_f32": (_P, _P, _P, _I, _I, _P),
    # logits, labels, ct, ct_stride, ct_scale, dlogits, rows, cols, stream
    "nll_bwd_f32": (_P, _P, _P, _I64, _F, _P, _I, _I, _P),
    # p, v, g, n, lr, momentum, stream
    "sgd_momentum_f32": (_P, _P, _P, _I64, _F, _F, _P),
}


@dataclass(frozen=True)
class KernelLibrary:
    """The loaded library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an up-to-date library was already on disk
    build_log: str         # nvcc's output (ptxas register and spill report)

    def check(self, name: str, code: int) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if code:
            msg = self.lib.fused_kernels_error_string(code).decode()
            raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use on a "
                       "machine with the CUDA toolkit")


@functools.cache
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; one load per process."""
    source = SOURCE.read_bytes()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"fused_kernels_{key}.so"
    build_seconds, build_log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{build_log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.fused_kernels_error_string.argtypes = [ctypes.c_int]
    lib.fused_kernels_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, path, build_seconds, build_log)
