"""PyTorch port, native loader: the port's own ``data/_native/loader.cc`` through
``data/native.py`` against the JAX package's ``data.native`` and against numpy.

Everything is pinned bitwise: the IDX reader, the normalization (the same operation order
in C++ and numpy), the gather and the prefetcher are integer and byte work, or the same
float32 expression. ``CSED514_TPU_NO_NATIVE=1`` switches the port's callers to their numpy
paths, which must give the same bits. The port builds its library with g++ at first use;
where a machine cannot, the tests that need it skip with the reason the build gave.
"""

import ctypes
import gzip
import os
import struct

import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.data import native as jax_native
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
    BatchLoader,
    iter_plan_batches,
    load_mnist,
    mnist,
    native,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data._native import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def libraries():
    """Both libraries loaded before any test sets ``CSED514_TPU_NO_NATIVE``: the JAX
    package reads the switch once, at its first load."""
    if not native.available():
        pytest.skip(f"the port's native loader is not built here: "
                    f"{native.unavailable_reason()}")
    if not jax_native.available():
        pytest.skip("the JAX package's native loader is not built here")


@pytest.fixture(scope="module")
def dataset():
    x, y = mnist._synthesize_split(300, 99)
    return mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic")


def _write_idx(path, arr: np.ndarray, gz: bool = False) -> str:
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + arr.tobytes())
    return str(path)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("shape", [(64, 28, 28), (100,)], ids=["images", "labels"])
def test_load_idx_matches_jax_native_and_numpy(tmp_path, gz, shape):
    arr = np.random.default_rng(7).integers(0, 256, size=shape, dtype=np.uint8)
    path = _write_idx(tmp_path / ("f.gz" if gz else "f"), arr, gz)
    ours = native.load_idx(path)
    assert ours.dtype == np.uint8 and ours.shape == shape
    np.testing.assert_array_equal(ours, jax_native.load_idx(path))
    np.testing.assert_array_equal(ours, mnist._read_idx(path))
    np.testing.assert_array_equal(ours, arr)


@pytest.mark.parametrize("content", [None, b"\x00\x00\x07\x03" + b"\x00" * 32],
                         ids=["missing", "bad-magic"])
def test_load_idx_rejects_what_jax_native_rejects(tmp_path, content):
    path = tmp_path / "f"
    if content is not None:
        path.write_bytes(content)
    for loader in (native.load_idx, jax_native.load_idx):
        with pytest.raises(ValueError):
            loader(str(path))


@pytest.mark.parametrize("threads", [1, 4])
def test_normalize_matches_jax_native_and_numpy(threads):
    x = np.random.default_rng(3).integers(0, 256, size=(37, 28, 28), dtype=np.uint8)
    ours = native.normalize(x, mnist.MNIST_MEAN, mnist.MNIST_STD, num_threads=threads)
    assert ours.shape == (37, 28, 28, 1) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jax_native.normalize(
        x, mnist.MNIST_MEAN, mnist.MNIST_STD, num_threads=threads))
    np.testing.assert_array_equal(ours, mnist._normalize(x))


@pytest.mark.parametrize("threads", [1, 4])
def test_gather_matches_jax_native_and_fancy_index(dataset, threads):
    idx = np.random.default_rng(5).permutation(len(dataset))[:128].astype(np.int32)
    gi, gl = native.gather(dataset.images, dataset.labels, idx, num_threads=threads)
    ji, jl = jax_native.gather(dataset.images, dataset.labels, idx, num_threads=threads)
    for ours, theirs, want in ((gi, ji, dataset.images[idx]), (gl, jl, dataset.labels[idx])):
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(ours, want)
    for bad in ([0, len(dataset)], [-1]):
        with pytest.raises(IndexError):
            native.gather(dataset.images, dataset.labels, np.array(bad, dtype=np.int32))


@pytest.mark.parametrize("steps,batch,workers,capacity", [
    (23, 32, 3, 4),          # order and content
    (40, 8, 2, 2),           # the ring smaller than the plan
    (5, 300, 4, 8),          # the ring larger than the plan
])
def test_prefetcher_order_matches_jax_native(dataset, steps, batch, workers, capacity):
    plan = np.random.default_rng(steps).integers(0, len(dataset), size=(steps, batch))
    plan = plan.astype(np.int32)
    with native.Prefetcher(dataset.images, dataset.labels, plan, num_workers=workers,
                           capacity=capacity) as pf:
        ours = [(bi.copy(), bl.copy()) for bi, bl in pf]
    with jax_native.Prefetcher(dataset.images, dataset.labels, plan, num_workers=workers,
                               capacity=capacity) as pf:
        theirs = list(pf)
    assert len(ours) == len(theirs) == steps
    for s, ((oi, ol), (ti, tl)) in enumerate(zip(ours, theirs)):
        np.testing.assert_array_equal(oi, ti)
        np.testing.assert_array_equal(ol, tl)
        np.testing.assert_array_equal(oi, dataset.images[plan[s]])
        np.testing.assert_array_equal(ol, dataset.labels[plan[s]])


def test_prefetcher_early_close_and_bad_index(dataset):
    plan = (np.arange(100 * 16, dtype=np.int32) % len(dataset)).reshape(100, 16)
    pf = native.Prefetcher(dataset.images, dataset.labels, plan, num_workers=4, capacity=2)
    it = iter(pf)
    first = next(it)
    np.testing.assert_array_equal(first[1], dataset.labels[plan[0]])
    pf.close()                  # workers blocked on the full ring exit
    with pytest.raises(ValueError, match="closed"):
        next(it)
    bad = np.full((3, 4), len(dataset), dtype=np.int32)
    with native.Prefetcher(dataset.images, dataset.labels, bad) as pf:
        with pytest.raises(IndexError):
            list(pf)
    with pytest.raises(ValueError, match=r"\[steps, batch\]"):
        native.Prefetcher(dataset.images, dataset.labels, plan[0])


def _idx_dir(tmp_path, gz: bool) -> str:
    rng = np.random.default_rng(2)
    arrays = {"train-images-idx3-ubyte": rng.integers(0, 256, (70, 28, 28), dtype=np.uint8),
              "train-labels-idx1-ubyte": rng.integers(0, 10, 70).astype(np.uint8),
              "t10k-images-idx3-ubyte": rng.integers(0, 256, (20, 28, 28), dtype=np.uint8),
              "t10k-labels-idx1-ubyte": rng.integers(0, 10, 20).astype(np.uint8)}
    for stem, arr in arrays.items():
        _write_idx(tmp_path / (stem + (".gz" if gz else "")), arr, gz)
    return str(tmp_path)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_switch_takes_the_numpy_paths_bit_for_bit(tmp_path, monkeypatch, dataset, gz):
    """``CSED514_TPU_NO_NATIVE=1``: the callers take their numpy paths and give the native
    paths' bits (the IDX splits, their normalization, the loader's batches), which are the
    JAX package's."""
    data_dir = _idx_dir(tmp_path, gz)
    loader = BatchLoader(dataset, 64, shuffle=True, seed=4)
    plan = loader.epoch_index_matrix(1)[:, 16:48]
    runs = {}
    for switched in (False, True):
        if switched:
            monkeypatch.setenv(native.DISABLE_ENV, "1")
        assert native.available() is not switched
        assert native.path_name() == ("numpy" if switched else "native")
        loader.set_epoch(1)
        runs[switched] = (load_mnist(data_dir, allow_synthetic=False), list(loader),
                          list(loader.prefetch_iter(1)),
                          list(iter_plan_batches(dataset, plan)))
    assert native.DISABLE_ENV in native.unavailable_reason()
    monkeypatch.delenv(native.DISABLE_ENV)
    jax_splits = jax_mnist.load_mnist(data_dir, allow_synthetic=False)
    for split, other, theirs in zip(runs[False][0], runs[True][0], jax_splits):
        assert split.source == other.source == "idx"
        np.testing.assert_array_equal(split.images, other.images)
        np.testing.assert_array_equal(split.images, theirs.images)
        np.testing.assert_array_equal(split.labels, other.labels)
    for a, b in zip(runs[False][1:], runs[True][1:]):
        assert len(a) == len(b) > 0
        for (ai, al), (bi, bl) in zip(a, b):
            np.testing.assert_array_equal(ai, bi)
            np.testing.assert_array_equal(al, bl)


def test_build_keys_the_library_on_its_source_and_renames_it_into_place(tmp_path,
                                                                        monkeypatch):
    """An edited source builds a library of its own name in the build directory, through a
    temporary name; an unchanged one is loaded as it is; without g++ the build raises and
    the callers' reason says so."""
    default = build.library_path()
    source = tmp_path / "loader.cc"
    source.write_bytes(build.SOURCE.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(build, "SOURCE", source)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    path = build.library_path()
    assert path.parent == tmp_path / "_build" and path.name.startswith("nativeloader_")
    assert path.name != default.name
    first = build.build()
    assert first.path == path and first.seconds > 0.0
    assert os.listdir(tmp_path / "_build") == [path.name]       # no temporary left
    lib = ctypes.CDLL(str(path))
    assert lib.nl_abi_version() == native.ABI_VERSION
    assert build.build() == (path, 0.0)
    source.write_bytes(source.read_bytes() + b"// again\n")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.build()


def test_default_build_directory_is_ignored_by_git():
    rel = os.path.relpath(build.BUILD_DIR, ROOT).replace(os.sep, "/")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        listed = {line.strip().rstrip("/") for line in f}
    assert rel in listed, f"{rel} is not listed in .gitignore"
    assert build.SOURCE.is_file() and build.SOURCE.parent.parent.name == "data"
    # the port's own source, never the JAX package's directory
    assert "pytorch_tpu_torch" in str(build.SOURCE)
    assert "pytorch_tpu_torch" in str(native.build.library_path())
