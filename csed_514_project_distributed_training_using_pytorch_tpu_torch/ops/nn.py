"""Core functional NN ops on tensors, NHWC at the public functions.

Counterpart of the JAX package's ``ops/nn.py``: conv2d, max-pool, dense, relu,
log_softmax, the NLL / cross-entropy losses and the two dropouts. Activations are NHWC
(``[batch, height, width, channels]``), conv kernels HWIO and dense kernels ``[in, out]``,
as in the JAX package, so the parity tests compare like with like. Inside, each op hands
PyTorch a permuted *view* (NCHW / OIHW / ``[out, in]``): no copy is made, and cuDNN and
cuBLAS do the work, as XLA does for the JAX package. These are not hand kernels; the
hand kernels of the training path are in ``ops/fused_kernels.py``.

Dropout draws from an explicit ``torch.Generator`` on the tensor's device. It does not
give the JAX package's bits: the two are compared by their statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, padding: str = "VALID") -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC (valid padding by default)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                   stride=stride, padding=padding.lower())
    return out.permute(0, 2, 3, 1)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int | None = None) -> torch.Tensor:
    """Max pooling over the spatial dims of an NHWC tensor (valid padding)."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride if stride is not None else window)
    return out.permute(0, 2, 3, 1)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Affine layer ``x @ w + b`` with ``w: [in, out]`` (one cuBLAS call on the card)."""
    return F.linear(x, w.t(), b)


def relu(x: torch.Tensor) -> torch.Tensor:
    """Rectified linear unit."""
    return torch.relu(x)


def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Numerically-stable log-softmax over ``axis``."""
    return torch.log_softmax(x, dim=axis)


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor, *,
             reduction: str = "mean") -> torch.Tensor:
    """Negative log-likelihood of integer labels under ``log_probs`` (``F.nll_loss``
    semantics; ``reduction="sum"`` is the evaluation's summed form)."""
    picked = torch.gather(log_probs, 1, labels.long()[:, None])[:, 0]
    if reduction == "mean":
        return -picked.mean()
    if reduction == "sum":
        return -picked.sum()
    if reduction == "none":
        return -picked
    raise ValueError(f"unknown reduction {reduction!r}")


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       reduction: str = "mean") -> torch.Tensor:
    """Softmax cross-entropy from unnormalized (or already log-softmaxed) inputs:
    log_softmax is idempotent, so both give the same objective."""
    return nll_loss(log_softmax(logits), labels, reduction=reduction)


def _keep_mask(generator: torch.Generator | None, shape, keep: float,
               device: torch.device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(generator: torch.Generator | None, x: torch.Tensor, rate: float, *,
            deterministic: bool) -> torch.Tensor:
    """Elementwise inverted dropout; ``deterministic=True`` (eval mode) is the identity."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(generator, x.shape, keep, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def dropout2d(generator: torch.Generator | None, x: torch.Tensor, rate: float, *,
              deterministic: bool) -> torch.Tensor:
    """Channelwise (spatial) dropout on NHWC: zeroes whole feature maps."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(generator, (x.shape[0], 1, 1, x.shape[-1]), keep, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))
