"""Data: MNIST ingest (and its download), the native C++ loader, batches and index plans."""

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data.download import (
    download_mnist,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data.loader import (
    BatchLoader,
    iter_plan_batches,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data.mnist import (
    MNIST_MEAN,
    MNIST_STD,
    Dataset,
    load_mnist,
    truncate,
)

__all__ = ["MNIST_MEAN", "MNIST_STD", "BatchLoader", "Dataset", "download_mnist",
           "iter_plan_batches", "load_mnist", "truncate"]
