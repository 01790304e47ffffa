"""Build the port's native loader (``loader.cc``) with g++: a shared library with a plain C
ABI, loaded with ctypes (no pybind11, no PyTorch headers, no CUDA).

The build happens at first use (``data.native``), never at import, from this package's own
``loader.cc``, into the port's ``csrc/_build/`` (listed in ``.gitignore``, beside the CUDA
kernel libraries), under a name keyed by a hash of the source and the flags: an edited
source builds anew, an unchanged one loads the library already there. g++ writes to a name
of its own process and the result is renamed into place, so two ranks building at once
never load a half-written library. Also runnable directly::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.data._native.build
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

SOURCE = Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = SOURCE.parent.parent.parent / "csrc" / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
LIBS = ("-lz",)


class Built(NamedTuple):
    """The library's path and g++'s seconds (0.0 when it was already on disk)."""

    path: Path
    seconds: float


def library_path() -> Path:
    """Where the library of ``loader.cc`` lives, keyed by its source and the flags."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"nativeloader_{key}.so"


def build() -> Built:
    """Compile ``loader.cc`` unless its library is on disk; raise ``RuntimeError`` when
    g++ is missing or the compile fails (with g++'s output)."""
    path = library_path()
    if path.exists():
        return Built(path, 0.0)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native loader is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return Built(path, time.perf_counter() - t0)


if __name__ == "__main__":
    built = build()
    print(f"built {built.path} in {built.seconds:.2f} s")
