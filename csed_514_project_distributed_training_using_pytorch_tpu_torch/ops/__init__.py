"""Ops: NHWC functional layers, attention, initializers, SGD, and the hand-written CUDA
kernels."""

from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
    full_attention,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.initializers import (
    torch_fan_in_uniform,
    torch_kaiming_uniform,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.nn import (
    conv2d,
    cross_entropy_loss,
    dense,
    dropout,
    dropout2d,
    gelu,
    layer_norm,
    log_softmax,
    max_pool2d,
    nll_loss,
    relu,
)

__all__ = [
    "conv2d", "cross_entropy_loss", "dense", "dropout", "dropout2d", "full_attention",
    "gelu", "layer_norm", "log_softmax", "max_pool2d", "nll_loss", "relu",
    "torch_fan_in_uniform", "torch_kaiming_uniform",
]
