"""Plot artifacts: the sample grid and the loss curves (matplotlib, optional).

Counterpart of the JAX package's ``utils/plotting.py`` for the trainers: the 6-digit
sample grid (``images/train_images.png``), the single-process train/test loss curve
(``train_test_curve.png``), the data-parallel one (``train_test_curve_dist.png``), and the
pixel LM's generated digits (``lm_samples.png``, ``lm_completions.png``) and loss curve
(``lm_loss_curve.png``), with the JAX package's file names and figures. Plotting is rank-0 gated. matplotlib is imported
at the first plot, not with the module; without it every function logs one line and
returns None, and training goes on.
"""

from __future__ import annotations

import os

import numpy as np

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data.mnist import (
    MNIST_MEAN,
    MNIST_STD,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.metrics import (
    MetricsHistory,
    is_logging_process,
    log,
)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None (logged) when matplotlib is
    absent."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        log(f"matplotlib is not available ({e}); no plot is written")
        return None
    return plt


def _ensure_dir(path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def _save_grid(images: np.ndarray, titles: list, path: str, **imshow_kw) -> str | None:
    """A digit grid of 3 columns and as many rows as the images need."""
    if not is_logging_process():
        return None
    plt = _pyplot()
    if plt is None:
        return None
    _ensure_dir(path)
    n = len(titles)
    rows = -(-n // 3)
    fig = plt.figure()
    for i in range(n):
        plt.subplot(rows, 3, i + 1)
        plt.tight_layout()
        plt.imshow(np.asarray(images[i, :, :, 0]), cmap="gray", interpolation="none",
                   **imshow_kw)
        plt.title(titles[i])
        plt.xticks([])
        plt.yticks([])
    fig.savefig(path)
    plt.close(fig)
    return path


def save_sample_grid(images: np.ndarray, labels: np.ndarray, path: str,
                     n: int = 6) -> str | None:
    """``n`` example digits with their labels; ``images`` are normalised NHWC and shown
    de-normalised."""
    imgs = np.asarray(images[:n]) * MNIST_STD + MNIST_MEAN
    return _save_grid(imgs, [f"Ground Truth: {int(l)}" for l in labels[:n]], path)


def save_generated_grid(images_raw: np.ndarray, path: str, n: int = 6) -> str | None:
    """``n`` model-generated digits (raw [0, 1] intensity NHWC, the pixel LM's
    ``ids_to_images`` output; samples have no labels)."""
    n = min(n, len(images_raw))
    return _save_grid(np.asarray(images_raw[:n]), [f"Sample {i}" for i in range(n)], path,
                      vmin=0.0, vmax=1.0)


def save_loss_curves(history: MetricsHistory, path: str) -> str | None:
    """The train-loss trajectory and the test-loss points against examples seen."""
    if not is_logging_process():
        return None
    plt = _pyplot()
    if plt is None:
        return None
    _ensure_dir(path)
    fig = plt.figure()
    plt.plot(history.train_counter, history.train_losses, color="blue")
    plt.scatter(history.test_counter, history.test_losses, color="red")
    plt.legend(["Train Loss", "Test Loss"], loc="upper right")
    plt.xlabel("number of training examples seen")
    plt.ylabel("negative log likelihood loss")
    fig.savefig(path)
    plt.close(fig)
    return path
