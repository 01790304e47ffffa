"""MNIST ingest for the PyTorch port: IDX parser + deterministic synthetic fallback.

Counterpart of ``csed_514_project_distributed_training_using_pytorch_tpu/data/mnist.py``,
kept as this package's own copy (the port imports nothing of the JAX package). Same
contract, same bits:

- raw IDX files (``train-images-idx3-ubyte[.gz]`` etc.) are parsed from ``<data_dir>`` or
  ``<data_dir>/MNIST/raw`` (torchvision's cache layout), through the native C++ reader
  (``data.native.load_idx``) where it is built, else with numpy, bit for bit alike;
- normalization uses the reference constants (0.1307, 0.3081) once, ahead of time
  (``data.native.normalize``, threaded, where it is built; else numpy);
- with no IDX files, a deterministic MNIST-shaped split (60k/10k, seed 514) is rendered
  from a built-in glyph font. It is bitwise the JAX package's split (pinned in
  ``tests/test_torch_port_data.py``).

Splits stay numpy arrays in NHWC (``[N, 28, 28, 1]``); the trainer moves them to the
device once.
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass

import numpy as np

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import native

MNIST_MEAN = 0.1307
MNIST_STD = 0.3081

_IDX_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}

# 5x7 bitmap glyphs for digits 0-9 (rows of 5 bits, MSB = leftmost pixel).
_GLYPHS = {
    0: (0b01110, 0b10001, 0b10011, 0b10101, 0b11001, 0b10001, 0b01110),
    1: (0b00100, 0b01100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110),
    2: (0b01110, 0b10001, 0b00001, 0b00010, 0b00100, 0b01000, 0b11111),
    3: (0b11111, 0b00010, 0b00100, 0b00010, 0b00001, 0b10001, 0b01110),
    4: (0b00010, 0b00110, 0b01010, 0b10010, 0b11111, 0b00010, 0b00010),
    5: (0b11111, 0b10000, 0b11110, 0b00001, 0b00001, 0b10001, 0b01110),
    6: (0b00110, 0b01000, 0b10000, 0b11110, 0b10001, 0b10001, 0b01110),
    7: (0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b01000, 0b01000),
    8: (0b01110, 0b10001, 0b10001, 0b01110, 0b10001, 0b10001, 0b01110),
    9: (0b01110, 0b10001, 0b10001, 0b01111, 0b00001, 0b00010, 0b01100),
}


@dataclass(frozen=True)
class Dataset:
    """A fully-materialized split: normalized NHWC images + integer labels."""

    images: np.ndarray  # [N, 28, 28, 1] float32, normalized
    labels: np.ndarray  # [N] int32
    source: str         # "idx" (real MNIST files) or "synthetic"

    def __len__(self) -> int:
        return self.images.shape[0]


def truncate(ds: Dataset, n: int) -> Dataset:
    """First-``n``-examples view of a split (``n <= 0`` means the whole split)."""
    if n <= 0 or n >= len(ds):
        return ds
    return Dataset(ds.images[:n], ds.labels[:n], ds.source)


def _read_idx(path: str) -> np.ndarray:
    """Parse one IDX file (optionally gzipped): the classic LeCun IDX layout."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dtype_code = (magic >> 8) & 0xFF
        if dtype_code != 0x08:  # unsigned byte — the only type MNIST uses
            raise ValueError(f"{path}: unsupported IDX dtype 0x{dtype_code:02x}")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    expected = int(np.prod(shape))
    if data.size != expected:
        raise ValueError(f"{path}: IDX payload size mismatch — header {shape} needs "
                         f"{expected} bytes, got {data.size} (truncated download or "
                         f"corrupt file)")
    return data.reshape(shape)


def _find_idx_file(data_dir: str, stem: str) -> str | None:
    for sub in ("", "MNIST/raw"):
        for suffix in ("", ".gz"):
            path = os.path.join(data_dir, sub, stem + suffix)
            if os.path.exists(path):
                return path
    return None


def _normalize(images_u8: np.ndarray) -> np.ndarray:
    """uint8 [N,H,W] -> normalized float32 [N,H,W,1]."""
    x = images_u8.astype(np.float32) / 255.0
    x = (x - MNIST_MEAN) / MNIST_STD
    return x[..., None]


def _synthesize_split(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Render n MNIST-shaped digit images deterministically (vectorized numpy).

    Each sample: a digit glyph upsampled ×2 or ×3 (nearest), placed on a 28×28 canvas at a
    random offset, scaled by a random intensity, plus Gaussian pixel noise. Returns
    (uint8 images [n,28,28], int labels [n]). The draw order is part of the contract:
    changing it changes every image.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n, dtype=np.int64)

    # Glyph bank: [10 digits, 2 scales, 36, 36] uint8 canvases with the glyph centred.
    pad = 36
    bank = np.zeros((10, 2, pad, pad), dtype=np.uint8)
    for d, rows in _GLYPHS.items():
        glyph = np.array([[(r >> (4 - c)) & 1 for c in range(5)] for r in rows],
                         dtype=np.uint8)
        for si, s in enumerate((2, 3)):
            up = np.kron(glyph, np.ones((s, s), dtype=np.uint8)) * 255
            h, w = up.shape
            y0, x0 = (pad - h) // 2, (pad - w) // 2
            bank[d, si, y0:y0 + h, x0:x0 + w] = up

    scales = rng.integers(0, 2, size=n)
    base = bank[labels, scales]  # [n, 36, 36]

    # Random crop of the 28×28 window == random shift of the digit by ±4 px.
    off_y = rng.integers(0, 9, size=n)
    off_x = rng.integers(0, 9, size=n)
    iy = off_y[:, None] + np.arange(28)[None, :]          # [n, 28]
    ix = off_x[:, None] + np.arange(28)[None, :]          # [n, 28]
    imgs = base[np.arange(n)[:, None, None], iy[:, :, None], ix[:, None, :]]

    imgs = imgs.astype(np.float32) * rng.uniform(0.6, 1.0, size=(n, 1, 1)).astype(np.float32)
    imgs += rng.normal(0.0, 12.0, size=imgs.shape).astype(np.float32)
    return np.clip(imgs, 0, 255).astype(np.uint8), labels.astype(np.int64)


def load_mnist(data_dir: str = "files", *, synthetic_seed: int = 514,
               allow_synthetic: bool = True) -> tuple[Dataset, Dataset]:
    """Load (train, test) splits: real IDX files if present, else the synthetic fallback
    (60,000 train / 10,000 test 28×28 grayscale images, normalized)."""
    paths = {k: _find_idx_file(data_dir, stem) for k, stem in _IDX_FILES.items()}
    if all(paths.values()):
        read = native.load_idx if native.available() else _read_idx
        train_x = read(paths["train_images"])
        train_y = read(paths["train_labels"]).astype(np.int64)
        test_x = read(paths["test_images"])
        test_y = read(paths["test_labels"]).astype(np.int64)
        source = "idx"
    elif allow_synthetic:
        train_x, train_y = _synthesize_split(60_000, synthetic_seed)
        test_x, test_y = _synthesize_split(10_000, synthetic_seed + 1)
        source = "synthetic"
    else:
        raise FileNotFoundError(
            f"no MNIST IDX files under {data_dir!r} and synthetic fallback disabled")
    if native.available():
        norm = lambda x: native.normalize(x, MNIST_MEAN, MNIST_STD)
    else:
        norm = _normalize
    train = Dataset(norm(train_x), train_y.astype(np.int32), source)
    test = Dataset(norm(test_x), test_y.astype(np.int32), source)
    return train, test
