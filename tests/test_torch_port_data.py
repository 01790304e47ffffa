"""PyTorch port, data slice: MNIST ingest, sampler, index plans and host batches against the
JAX package.

Everything here is pinned bitwise: the synthetic split, normalization, IDX parsing,
sampler plans, epoch index matrices and host batches (iteration with its ragged tail,
``prefetch_iter``, ``iter_plan_batches`` on a column block, the device prefetch on the CPU)
are integer or numpy float work, or copies, that both packages do alike.
"""

import gzip
import struct
import threading

import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.data import loader as jax_loader
from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.parallel import (
    sampler as jax_sampler,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import loader, mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import sampler


def _write_idx(path, array: np.ndarray, *, gz: bool = False) -> None:
    header = struct.pack(">I", (0x08 << 8) | array.ndim)
    header += struct.pack(f">{array.ndim}I", *array.shape)
    payload = header + array.astype(np.uint8).tobytes()
    if gz:
        with gzip.open(str(path) + ".gz", "wb") as f:
            f.write(payload)
    else:
        path.write_bytes(payload)


@pytest.mark.parametrize("n,seed", [(1, 0), (257, 514), (1000, 3)])
def test_synthesize_split_bitwise(n, seed):
    ours = mnist._synthesize_split(n, seed)
    theirs = jax_mnist._synthesize_split(n, seed)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_load_mnist_synthetic_split_bitwise(tmp_path):
    """The seed-514 60k/10k split the card trains on, normalized, bitwise."""
    ours = mnist.load_mnist(str(tmp_path))
    theirs = jax_mnist.load_mnist(str(tmp_path))
    for a, b in zip(ours, theirs):
        assert a.source == b.source == "synthetic"
        assert a.images.dtype == b.images.dtype == np.float32
        assert a.labels.dtype == b.labels.dtype == np.int32
        assert a.images.shape == b.images.shape
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert len(ours[0]) == 60_000 and len(ours[1]) == 10_000


def test_normalize_bitwise():
    x = np.random.default_rng(0).integers(0, 256, size=(17, 28, 28), dtype=np.uint8)
    ours, theirs = mnist._normalize(x), jax_mnist._normalize(x)
    assert ours.shape == (17, 28, 28, 1) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("layout,gz", [("", False), ("", True), ("MNIST/raw", True)])
def test_idx_files_load_bitwise(tmp_path, layout, gz):
    rng = np.random.default_rng(1)
    root = tmp_path / layout if layout else tmp_path
    root.mkdir(parents=True, exist_ok=True)
    arrays = {"train_images": rng.integers(0, 256, (30, 28, 28)),
              "train_labels": rng.integers(0, 10, (30,)),
              "test_images": rng.integers(0, 256, (20, 28, 28)),
              "test_labels": rng.integers(0, 10, (20,))}
    for key, stem in mnist._IDX_FILES.items():
        _write_idx(root / stem, arrays[key], gz=gz)
        found = mnist._find_idx_file(str(tmp_path), stem)
        assert found == jax_mnist._find_idx_file(str(tmp_path), stem)
        np.testing.assert_array_equal(mnist._read_idx(found), jax_mnist._read_idx(found))
    ours = mnist.load_mnist(str(tmp_path))
    theirs = jax_mnist.load_mnist(str(tmp_path))
    for a, b in zip(ours, theirs):
        assert a.source == b.source == "idx"
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_read_idx_rejects_truncated_and_bad_dtype(tmp_path):
    good = tmp_path / "good"
    _write_idx(good, np.zeros((3, 4), np.uint8))
    (tmp_path / "short").write_bytes(good.read_bytes()[:-2])
    with pytest.raises(ValueError, match="size mismatch"):
        mnist._read_idx(str(tmp_path / "short"))
    (tmp_path / "f32").write_bytes(struct.pack(">I", (0x0D << 8) | 1) + struct.pack(">I", 0))
    with pytest.raises(ValueError, match="unsupported IDX dtype"):
        mnist._read_idx(str(tmp_path / "f32"))


def test_load_mnist_without_files_or_synthetic_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        mnist.load_mnist(str(tmp_path), allow_synthetic=False)


def test_truncate_matches():
    x, y = mnist._synthesize_split(50, 9)
    ds = mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic")
    jds = jax_mnist.Dataset(ds.images, ds.labels, ds.source)
    for n in (0, -1, 7, 50, 80):
        a, b = mnist.truncate(ds, n), jax_mnist.truncate(jds, n)
        assert len(a) == len(b)
        np.testing.assert_array_equal(a.images, b.images)


@pytest.mark.parametrize("size,replicas,seed,shuffle", [
    (10, 1, 42, True), (60_000, 1, 1, True), (103, 4, 7, True), (103, 4, 7, False),
    (5, 8, 0, True), (1, 3, 11, True)])
def test_sampler_plans_bitwise(size, replicas, seed, shuffle):
    for rank in range(replicas):
        ours = sampler.ShardedSampler(size, replicas, rank, shuffle, seed)
        theirs = jax_sampler.ShardedSampler(size, replicas, rank, shuffle, seed)
        assert (ours.total_size, ours.num_samples) == (theirs.total_size, theirs.num_samples)
        for epoch in (0, 1, 5):
            np.testing.assert_array_equal(ours.global_permutation(epoch),
                                          theirs.global_permutation(epoch))
            np.testing.assert_array_equal(ours.epoch_indices(epoch),
                                          theirs.epoch_indices(epoch))


def test_sampler_rejects_bad_rank():
    with pytest.raises(ValueError):
        sampler.ShardedSampler(10, num_replicas=2, rank=2)


@pytest.mark.parametrize("n,batch,multiple", [
    (300, 64, 1), (300, 64, 2), (60_000, 64, 10), (640, 64, 3)])
def test_batch_loader_plans_bitwise(n, batch, multiple):
    ds = mnist.Dataset(np.zeros((n, 1, 1, 1), np.float32), np.zeros(n, np.int32), "synthetic")
    jds = jax_mnist.Dataset(ds.images, ds.labels, ds.source)
    ours = loader.BatchLoader(ds, batch, shuffle=True, seed=1)
    theirs = jax_loader.BatchLoader(jds, batch, shuffle=True, seed=1)
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        np.testing.assert_array_equal(ours.epoch_index_matrix(steps_multiple=multiple),
                                      theirs.epoch_index_matrix(steps_multiple=multiple))
        np.testing.assert_array_equal(ours.sampler.epoch_indices(epoch),
                                      theirs.sampler.epoch_indices(epoch))


def test_batch_loader_empty_plans():
    ds = mnist.Dataset(np.zeros((30, 1, 1, 1), np.float32), np.zeros(30, np.int32), "x")
    bl = loader.BatchLoader(ds, 64, shuffle=True)
    assert bl.epoch_index_matrix(1, allow_empty=True).shape == (0, 64)
    with pytest.raises(ValueError, match="no full batch groups"):
        bl.epoch_index_matrix(1)
    with pytest.raises(ValueError):
        loader.BatchLoader(ds, 8, sampler=sampler.ShardedSampler(30), shuffle=True)


# -- host batches: iteration, the ragged tail, the prefetchers ----------------------------


def _pair(n: int, seed: int = 30):
    x, y = mnist._synthesize_split(n, seed)
    ds = mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic")
    return ds, jax_mnist.Dataset(ds.images, ds.labels, ds.source)


def _assert_batches_equal(ours, theirs) -> None:
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    for pairs in zip(ours, theirs):
        (oi, ol), (ti, tl) = ([np.asarray(a) for a in pair] for pair in pairs)
        assert oi.shape == ti.shape and oi.dtype == ti.dtype and ol.dtype == tl.dtype
        np.testing.assert_array_equal(oi, ti)
        np.testing.assert_array_equal(ol, tl)


@pytest.mark.parametrize("n,batch,drop_last", [
    (300, 64, False), (300, 64, True), (256, 64, False), (40, 64, False), (40, 64, True)])
def test_batch_loader_iteration_bitwise(n, batch, drop_last):
    """``__iter__`` (the ragged last batch unless ``drop_last``) and ``__len__`` as the
    JAX loader's, over two epochs of the shuffled order."""
    ds, jds = _pair(n)
    ours = loader.BatchLoader(ds, batch, shuffle=True, seed=2, drop_last=drop_last)
    theirs = jax_loader.BatchLoader(jds, batch, shuffle=True, seed=2, drop_last=drop_last)
    assert len(ours) == len(theirs) == (n // batch if drop_last else -(-n // batch))
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = list(ours)
        assert len(got) == len(ours)
        if got and not drop_last and n % batch:
            assert got[-1][0].shape[0] == n % batch
        _assert_batches_equal(got, theirs)
        _assert_batches_equal(ours.prefetch_iter(epoch), theirs.prefetch_iter(epoch))
    assert ours.pop_wait_s() > 0.0 and ours.pop_wait_s() == 0.0


@pytest.mark.parametrize("columns", [slice(8, 24), slice(0, 32), slice(16, 17)])
def test_iter_plan_batches_on_a_column_block_bitwise(columns):
    """The host-local feed hands ``iter_plan_batches`` a column block of the global plan,
    a view that is not contiguous."""
    ds, jds = _pair(200)
    plan = np.random.default_rng(13).integers(0, 200, size=(9, 32)).astype(np.int32)
    local = plan[:, columns]
    got = list(loader.iter_plan_batches(ds, local))
    _assert_batches_equal(got, jax_loader.iter_plan_batches(jds, local))
    for s, (bi, bl) in enumerate(got):
        np.testing.assert_array_equal(bi, ds.images[local[s]])
        np.testing.assert_array_equal(bl, ds.labels[local[s]])
    assert list(loader.iter_plan_batches(ds, plan[:0])) == []


def test_device_prefetch_on_the_cpu_keeps_order_values_and_stops_early():
    """``prefetch=2`` on the CPU: tensors with the host iterator's values in its order,
    each epoch's reshuffle, and an iterator abandoned mid-epoch stops its worker."""
    ds, _ = _pair(100)
    plain = loader.BatchLoader(ds, 32, shuffle=True, seed=3)
    pre = loader.BatchLoader(ds, 32, shuffle=True, seed=3, prefetch=2, device="cpu")
    for epoch in (0, 1):
        plain.set_epoch(epoch)
        pre.set_epoch(epoch)
        got = list(pre)
        assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for batch in got for t in batch)
        _assert_batches_equal(got, plain)
    it = iter(loader.BatchLoader(ds, 8, prefetch=1, device="cpu"))
    next(it)
    it.close()
    for _ in range(100):
        if not any(t.name == "loader-prefetch" for t in threading.enumerate()):
            break
        threading.Event().wait(0.05)
    assert not any(t.name == "loader-prefetch" for t in threading.enumerate())


def test_device_prefetch_reraises_the_workers_error_and_validates():
    def failing():
        yield np.zeros((2, 1), np.float32), np.zeros(2, np.int32)
        raise IndexError("bad batch")

    it = loader._device_prefetch_iter(failing(), 2, torch.device("cpu"))
    assert next(it)[0].shape == (2, 1)
    with pytest.raises(IndexError, match="bad batch"):
        next(it)
    ds, _ = _pair(32)
    with pytest.raises(ValueError, match="prefetch must be >= 0"):
        loader.BatchLoader(ds, 16, prefetch=-1)
    with pytest.raises(ValueError, match="device="):
        loader.BatchLoader(ds, 16, prefetch=2)
    assert isinstance(next(iter(loader.BatchLoader(ds, 16)))[0], np.ndarray)
