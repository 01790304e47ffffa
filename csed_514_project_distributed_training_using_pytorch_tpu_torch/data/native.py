"""ctypes bindings to the port's native (C++) data-loader runtime in ``data/_native``.

Counterpart of the JAX package's ``data/native.py``, over this package's own copy of
``loader.cc`` (the same C ABI): IDX parsing, pixel normalization, the threaded batch gather
and a threaded prefetching batch queue, the first-party stand-ins for torchvision's MNIST
cache reader (reference ``src/train.py:26-31``) and the DataLoader worker pool
(``num_workers=4, pin_memory=True``, reference ``src/train_dist.py:43-45``). The library
is built with g++ at the first call (``data/_native/build.py``), never at import.

Where the library cannot be built or loaded, or ``CSED514_TPU_NO_NATIVE`` is set,
``available()`` is False and the callers (``data.mnist``, ``data.loader``) take their numpy
paths, which are bit-identical (``tests/test_torch_port_native.py``); ``unavailable_reason``
says why, and the trainers name the path that ran. Every call into the library releases
the interpreter lock (ctypes does for a ``CDLL``), so the prefetcher's workers and a Python
thread that waits on ``nl_prefetcher_next`` overlap.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Iterator

import numpy as np

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data._native import build

DISABLE_ENV = "CSED514_TPU_NO_NATIVE"
ABI_VERSION = 1


@functools.cache
def _loaded() -> tuple[ctypes.CDLL | None, str]:
    """Build (if needed) and load the library once a process: ``(lib, "")``, or ``(None,
    why)`` when it cannot be had."""
    try:
        lib = ctypes.CDLL(str(build.build().path))
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return None, f"{type(e).__name__}: {e}"

    c_ll, c_int, c_float = ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    p_u8 = ctypes.POINTER(ctypes.c_ubyte)
    p_f32 = ctypes.POINTER(c_float)
    p_i32 = ctypes.POINTER(c_int)
    p_ll = ctypes.POINTER(c_ll)
    signatures = {
        "nl_idx_info": ([ctypes.c_char_p, ctypes.POINTER(c_int), p_ll], c_int),
        "nl_idx_read": ([ctypes.c_char_p, p_u8, c_ll], c_int),
        "nl_normalize": ([p_u8, p_f32, c_ll, c_float, c_float, c_int], c_int),
        "nl_gather_f32": ([p_f32, c_ll, c_ll, p_i32, c_ll, p_f32, c_int], c_int),
        "nl_gather_i32": ([p_i32, c_ll, p_i32, c_ll, p_i32], c_int),
        "nl_prefetcher_create": ([p_f32, p_i32, c_ll, c_ll, p_i32, c_ll, c_ll, c_int, c_int],
                                 ctypes.c_void_p),
        "nl_prefetcher_next": ([ctypes.c_void_p, p_f32, p_i32], c_ll),
        "nl_prefetcher_destroy": ([ctypes.c_void_p], None),
        "nl_abi_version": ([], c_int),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    if lib.nl_abi_version() != ABI_VERSION:
        return None, f"ABI version {lib.nl_abi_version()}, expected {ABI_VERSION}"
    return lib, ""


def _lib() -> ctypes.CDLL | None:
    if os.environ.get(DISABLE_ENV):
        return None
    return _loaded()[0]


def available() -> bool:
    """True when the native library is built and loadable (and not switched off)."""
    return _lib() is not None


def unavailable_reason() -> str:
    """Why ``available()`` is False ("" when it is True)."""
    if os.environ.get(DISABLE_ENV):
        return f"{DISABLE_ENV} is set"
    return _loaded()[1]


def path_name() -> str:
    """The host data path the callers take: ``"native"`` or ``"numpy"``."""
    return "native" if available() else "numpy"


def _required() -> ctypes.CDLL:
    lib = _lib()
    if lib is None:
        raise RuntimeError(f"native loader unavailable ({unavailable_reason()})")
    return lib


def _as_ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_idx(path: str) -> np.ndarray:
    """Parse one IDX file (plain or .gz, through zlib's ``gzopen``) into a uint8 array —
    the native counterpart of ``data.mnist._read_idx``."""
    lib = _required()
    ndim = ctypes.c_int(0)
    shape = (ctypes.c_longlong * 4)()
    rc = lib.nl_idx_info(path.encode(), ctypes.byref(ndim), shape)
    if rc != 0:
        raise ValueError(f"nl_idx_info({path!r}) failed with {rc}")
    dims = tuple(shape[i] for i in range(ndim.value))
    out = np.empty(int(np.prod(dims)), dtype=np.uint8)
    rc = lib.nl_idx_read(path.encode(), _as_ptr(out, ctypes.c_ubyte), out.size)
    if rc != 0:
        raise ValueError(f"nl_idx_read({path!r}) failed with {rc}")
    return out.reshape(dims)


def normalize(images_u8: np.ndarray, mean: float, std: float,
              num_threads: int = 4) -> np.ndarray:
    """uint8 ``[N, H, W]`` -> normalized float32 ``[N, H, W, 1]``, threaded over pixels —
    the native counterpart of ``data.mnist._normalize`` (the same operation order)."""
    lib = _required()
    src = np.ascontiguousarray(images_u8, dtype=np.uint8)
    dst = np.empty(src.shape, dtype=np.float32)
    rc = lib.nl_normalize(_as_ptr(src, ctypes.c_ubyte), _as_ptr(dst, ctypes.c_float),
                          src.size, mean, std, num_threads)
    if rc != 0:
        raise ValueError(f"nl_normalize failed with {rc}")
    return dst[..., None]


def gather(images: np.ndarray, labels: np.ndarray, idx: np.ndarray,
           num_threads: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """``(images[idx], labels[idx])`` through the threaded native gather: one DataLoader
    worker's batch assembly. Raises ``IndexError`` on an index out of range."""
    lib = _required()
    images = np.ascontiguousarray(images, dtype=np.float32)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    sample_elems = int(np.prod(images.shape[1:]))
    out_i = np.empty((len(idx),) + images.shape[1:], dtype=np.float32)
    out_l = np.empty(len(idx), dtype=np.int32)
    rc = lib.nl_gather_f32(_as_ptr(images, ctypes.c_float), images.shape[0],
                           sample_elems, _as_ptr(idx, ctypes.c_int), len(idx),
                           _as_ptr(out_i, ctypes.c_float), num_threads)
    if rc == 0:
        rc = lib.nl_gather_i32(_as_ptr(labels, ctypes.c_int), labels.shape[0],
                               _as_ptr(idx, ctypes.c_int), len(idx),
                               _as_ptr(out_l, ctypes.c_int))
    if rc != 0:
        raise IndexError("gather index out of range")
    return out_i, out_l


class Prefetcher:
    """Threaded batch queue over a ``[steps, batch]`` index plan: the ``num_workers``
    prefetch pool (reference ``src/train_dist.py:43-45``) as a first-party C++ component.

    Iterates ``(images[batch], labels[batch])`` in plan order while ``num_workers`` C++
    threads gather ahead into a ring of ``capacity`` slots. Use it as a context manager or
    iterate it to exhaustion; ``close`` stops the workers (also ones blocked on a full
    ring), after which iterating raises ``ValueError``. A plan index out of range raises
    ``IndexError`` at the batch that holds it.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray, plan: np.ndarray, *,
                 num_workers: int = 4, capacity: int = 8):
        self._handle = None
        self._lib = _required()
        # references that keep the buffers alive while the C++ threads read them
        self._images = np.ascontiguousarray(images, dtype=np.float32)
        self._labels = np.ascontiguousarray(labels, dtype=np.int32)
        plan = np.ascontiguousarray(plan, dtype=np.int32)
        if plan.ndim != 2:
            raise ValueError(f"plan must be [steps, batch], got shape {plan.shape}")
        self.steps, self.batch = plan.shape
        self._sample_shape = self._images.shape[1:]
        sample_elems = int(np.prod(self._sample_shape))
        self._handle = self._lib.nl_prefetcher_create(
            _as_ptr(self._images, ctypes.c_float), _as_ptr(self._labels, ctypes.c_int),
            self._images.shape[0], sample_elems, _as_ptr(plan, ctypes.c_int),
            self.steps, self.batch, num_workers, capacity)
        if not self._handle:
            raise RuntimeError("nl_prefetcher_create failed")

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while True:
            if self._handle is None:
                raise ValueError("Prefetcher is closed")
            out_i = np.empty((self.batch,) + self._sample_shape, dtype=np.float32)
            out_l = np.empty(self.batch, dtype=np.int32)
            step = self._lib.nl_prefetcher_next(
                self._handle, _as_ptr(out_i, ctypes.c_float),
                _as_ptr(out_l, ctypes.c_int))
            if step == -1:
                return
            if step == -2:
                raise IndexError("prefetcher: plan index out of range")
            yield out_i, out_l

    def close(self) -> None:
        if self._handle:
            self._lib.nl_prefetcher_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        self.close()
