"""Data: MNIST ingest and epoch index plans."""

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data.loader import BatchLoader
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data.mnist import (
    Dataset,
    load_mnist,
    truncate,
)

__all__ = ["BatchLoader", "Dataset", "load_mnist", "truncate"]
