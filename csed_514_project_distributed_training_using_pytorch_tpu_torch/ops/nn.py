"""Core functional NN ops on tensors, NHWC at the public functions.

Counterpart of the JAX package's ``ops/nn.py``: conv2d, max-pool, dense, relu,
log_softmax, the NLL / cross-entropy losses, the two dropouts, and the transformer
family's layer_norm and gelu. Activations are NHWC
(``[batch, height, width, channels]``), conv kernels HWIO and dense kernels ``[in, out]``,
as in the JAX package, so the parity tests compare like with like. Inside, each op hands
PyTorch a permuted *view* (NCHW / OIHW / ``[out, in]``): no copy is made, and cuDNN and
cuBLAS do the work, as XLA does for the JAX package. These are not hand kernels; the
hand kernels of the training path are in ``ops/fused_kernels.py``.

Dropout draws from an explicit ``torch.Generator`` on the tensor's device, or from a
``DropoutStream``: counter-based keep-masks computed with integer tensor ops from a key on
the device (the train step's, a function of ``(seed, step, rank)``), so that the same
masks come out on the CPU and on the card, eagerly or replayed from a captured CUDA graph
(a graph cannot reseed a generator from the host at every step). Neither gives the JAX
package's bits: the two are compared by their statistics.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

_M32 = 0xFFFFFFFF


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


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor, *, reduction: str = "mean",
             label_smoothing: float = 0.0) -> torch.Tensor:
    """Negative log-likelihood of integer labels under ``log_probs`` (``F.nll_loss``
    semantics; ``reduction="sum"`` is the evaluation's summed form).

    ``label_smoothing=s`` trains against the smoothed target ``(1−s)·onehot + s/C``
    (torch ``CrossEntropyLoss(label_smoothing=s)``): the per-example loss becomes
    ``(1−s)·nll + s·mean_c(−log_probs)``."""
    picked = torch.gather(log_probs, 1, labels.long()[:, None])[:, 0]
    if label_smoothing:
        smooth = log_probs.mean(dim=-1)
        picked = (1.0 - label_smoothing) * picked + label_smoothing * smooth
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


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer normalization over the last axis with learned scale/shift. Statistics are
    computed in float32 (so bfloat16 activations normalize accurately), then cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * gamma.float() + beta.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Gaussian-error linear unit, tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


_MIX1, _MIX2 = 0x7FEB352D, 0x2C1B3C6D   # odd multipliers below 2^31: for x < 2^32 every
                                         # product stays below 2^63, so int64 never wraps


def mix32(x):
    """A 32-bit integer finalizer (xorshift-multiply, two rounds) on values in
    ``[0, 2^32)``, as int64 tensors or Python ints — the same bits either way."""
    x = x ^ (x >> 16)
    x = (x * _MIX1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MIX2) & _M32
    return x ^ (x >> 16)


@functools.lru_cache(maxsize=64)
def _draw_base(draw: int, numel: int, device: torch.device) -> torch.Tensor:
    """``mix32(mix32(j) ^ mix32(draw))`` for ``j < numel``: the key-free half of a draw's
    bits, made once per (draw, size, device) and read by every step after."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a dropout draw first seen under CUDA graph capture: run the "
                           "step once eagerly first (CapturedSegment's warm-up does)")
    j = torch.arange(numel, dtype=torch.int64, device=device)
    return mix32(mix32(j) ^ mix32(draw))


class DropoutStream:
    """Keep-masks keyed by a 32-bit key held in a 0-d int64 device tensor.

    ``key`` is the tensor or a function that makes it, called at the first draw (a step
    that draws nothing launches nothing for its key). Draw ``c`` (counted on the host: a
    step draws in the same order every time) keeps element ``j`` when
    ``mix32(base_c[j] ^ key) < keep·2^32``, ``base_c = mix32(mix32(j) ^ mix32(c))``
    cached per shape: twelve integer ops on the key's device a draw, no generator state,
    no host sync, the same masks on every device and under CUDA graph replay.

    ``rows=(offset, total)`` draws for a rank that holds rows ``offset ..`` of a leading
    batch dim of ``total`` rows: its mask is those rows of the global batch's mask, as the
    JAX package draws a mask for the global tensor and shards it, so a data-sharded run
    drops what one device would. (One
    xorshift-multiply round instead of ``mix32`` leaves masks of keys a few bits apart
    correlated, up to ±1.)"""

    def __init__(self, key, rows: tuple[int, int] | None = None):
        self._key = key
        self.rows = rows
        self.draws = 0

    def key(self) -> torch.Tensor:
        """The key tensor, made at the first call when it was given as a function."""
        if callable(self._key):
            self._key = self._key()
        return self._key

    def replay_from(self, draws: int) -> "DropoutStream":
        """A stream that draws what this one drew from its draw ``draws`` on: the same key
        (made by this stream, once), its own draw counter. A rematerialized block
        recomputes its masks through one (``models.transformer.remat_call``)."""
        stream = DropoutStream(self.key, self.rows)
        stream.draws = draws
        return stream

    def keep_mask(self, shape, keep: float, device: torch.device) -> torch.Tensor:
        shape = tuple(shape)
        full = shape if self.rows is None else (self.rows[1],) + shape[1:]
        base = _draw_base(self.draws, math.prod(full), torch.device(device))
        if self.rows is not None:        # this rank's rows of the global batch's mask
            row = math.prod(shape[1:])
            base = base[self.rows[0] * row:(self.rows[0] + shape[0]) * row]
        self.draws += 1
        return (mix32(base ^ self.key()) < int(keep * 2.0 ** 32)).view(shape)


def _keep_mask(generator: torch.Generator | DropoutStream | None, shape, keep: float,
               device: torch.device) -> torch.Tensor:
    if isinstance(generator, DropoutStream):
        return generator.keep_mask(shape, keep, device)
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(generator: torch.Generator | DropoutStream | None, x: torch.Tensor,
            rate: float, *, deterministic: bool) -> torch.Tensor:
    """Elementwise inverted dropout; ``deterministic=True`` (eval mode) is the identity."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(generator, x.shape, keep, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def dropout2d(generator: torch.Generator | DropoutStream | None, x: torch.Tensor,
              rate: float, *, deterministic: bool) -> torch.Tensor:
    """Channelwise (spatial) dropout on NHWC: zeroes whole feature maps."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = _keep_mask(generator, (x.shape[0], 1, 1, x.shape[-1]), keep, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))
