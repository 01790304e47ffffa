"""Quantized execution: the dtype/scale policy and every piece of scale math.

Counterpart of the JAX package's ``ops/quant.py``. One module owns quantization, so that
the serving engine's KV cache (``models/lm.py``), the quantized-weight matmuls and the
byte accounting can never disagree about what a scale means.

Two knobs make up a ``QuantPolicy``:

- ``kv_dtype``: the serving KV-cache plane dtype. ``"model"`` (the default) keeps the
  planes in the model's dtype, on the unquantized code path; ``"fp32"``/``"bf16"`` are
  plain-cast planes; ``"int8"`` and ``"fp8"`` (``torch.float8_e4m3fn``) are
  quantize-on-write planes: each written K/V row ``[KV_H, Dh]`` stores one symmetric f32
  scale per head beside its narrow codes (scale planes ``[..., S, KV_H]``), and attention
  reads ``code · scale`` (on the card inside the paged-decode kernel, from the narrow pool).
- ``weights``: ``"off"`` (the kernels untouched), ``"w8"`` (int8 kernels with
  per-output-channel f32 scales, f32 activations) or ``"w8a8"`` (int8 kernels and
  activations quantized per row, an exact ``int8 x int8 -> int32`` product, one f32
  rescale). ``quantize_params`` rewrites only the 2-D ``*_kernel`` tensors into
  ``QuantizedTensor``s; ``dense_any`` dispatches on the type, so a plain tensor takes the
  exact ``ops.dense`` call.

The rounding is the JAX package's: int8 rounds half to even (``torch.round``, as
``jnp.round``) and clips to ±127; fp8 takes ``torch.float8_e4m3fn``'s own cast; an all-zero
row gets scale 1.0.

The ``w8a8`` accumulator is an XLA dot in the reference, not a Pallas kernel, so it goes to
a library call here. ``int8_matmul`` picks a route by device and shape, and counts it in
``int8_matmul_routes``: on CPU tensors an int32 ``torch.matmul`` of the codes; on the card
``torch._int_mm`` where its shape rules hold (more than 16 rows, inner and outer sizes
multiples of 8), else an f32 product of the codes, exact while ``K · 127² < 2²⁴``
(``K <= EXACT_F32_K``): every product and partial sum is an integer below 2²⁴, whatever
the order of the sums (the codes fit TF32's mantissa too). Each route gives the
reference's int32 accumulator bit for bit; the rescale follows in the reference's order,
``acc · xscale · w.scale``.

Accounting is byte-true: ``tree_bytes`` sums ``numel · element_size`` of the live tensors
(int8 planes one byte an element, their f32 scale planes, the int8 kernels and their
scales).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import nn as ops_nn

# Symmetric ranges: int8 uses ±127 (a row and its negation quantize to negations); fp8
# e4m3fn's scale maps a row's amax to the format's largest normal.
INT8_QMAX = 127.0
FP8_QMAX = 448.0

KV_DTYPES = ("model", "fp32", "bf16", "int8", "fp8")
WEIGHT_POLICIES = ("off", "w8", "w8a8")

EXACT_F32_K = int(2 ** 24 // INT8_QMAX ** 2)   # 1040: the f32 route's exact inner size

int8_matmul_routes = {"int32_cpu": 0, "int_mm": 0, "f32_exact": 0}


def reset_route_counts() -> None:
    for key in int8_matmul_routes:
        int8_matmul_routes[key] = 0


def fp8_dtype() -> torch.dtype:
    """The fp8 storage dtype (every torch the port runs on has it)."""
    return torch.float8_e4m3fn


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """The dtype/scale policy of an engine: ``kv_dtype`` one of ``KV_DTYPES``, ``weights``
    one of ``WEIGHT_POLICIES``. The default is a no-op."""

    kv_dtype: str = "model"
    weights: str = "off"

    def __post_init__(self):
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in {KV_DTYPES}")
        if self.weights not in WEIGHT_POLICIES:
            raise ValueError(f"weights {self.weights!r} not in {WEIGHT_POLICIES}")

    @property
    def off(self) -> bool:
        return self.kv_dtype == "model" and self.weights == "off"


def resolve_kv_dtype(spec: str, model_dtype: torch.dtype) -> tuple[torch.dtype, bool]:
    """``(plane_dtype, scaled)`` for a kv_dtype spec; ``scaled`` marks the
    quantize-on-write formats that carry per-head scale planes."""
    if spec == "model":
        return model_dtype, False
    if spec == "fp32":
        return torch.float32, False
    if spec == "bf16":
        return torch.bfloat16, False
    if spec == "int8":
        return torch.int8, True
    if spec == "fp8":
        return fp8_dtype(), True
    raise ValueError(f"unknown kv_dtype {spec!r} (choices: {KV_DTYPES})")


def _qmax(qdtype: torch.dtype) -> float:
    return INT8_QMAX if qdtype == torch.int8 else FP8_QMAX


# ---------------------------------------------------------------------------------------
# Row (KV-cache) quantization: one symmetric scale per last-axis vector
# ---------------------------------------------------------------------------------------


def quantize_rows(x: torch.Tensor, qdtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row quantization over the last axis: ``[..., D]`` -> (``[..., D]``
    codes in ``qdtype``, ``[...]`` f32 scales). ``scale = amax / qmax`` (1.0 for an
    all-zero row); int8 rounds half to even and clips, fp8 takes the format's cast."""
    x = x.float()
    amax = x.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / _qmax(qdtype), torch.ones_like(amax))
    q = x / scale[..., None]
    if qdtype == torch.int8:
        q = torch.clamp(torch.round(q), -INT8_QMAX, INT8_QMAX)
    return q.to(qdtype), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Invert ``quantize_rows``: ``[..., D]`` codes and ``[...]`` scales -> f32."""
    return q.float() * scale[..., None]


# ---------------------------------------------------------------------------------------
# Weight quantization: per-output-channel int8 kernels and the quantized matmuls
# ---------------------------------------------------------------------------------------


class QuantizedTensor:
    """An int8 ``[in, out]`` kernel ``q`` and its ``[out]`` f32 scales; ``mode``
    (``"w8"``/``"w8a8"``) selects the matmul."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, mode: str = "w8"):
        if mode not in ("w8", "w8a8"):
            raise ValueError(f"mode {mode!r} not in ('w8', 'w8a8')")
        self.q = q
        self.scale = scale
        self.mode = mode

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return _tensor_bytes(self.q) + _tensor_bytes(self.scale)

    def dequantize(self) -> torch.Tensor:
        return self.q.float() * self.scale

    def __repr__(self) -> str:
        return f"QuantizedTensor(shape={tuple(self.q.shape)}, mode={self.mode!r})"


def quantize_tensor(w: torch.Tensor, mode: str = "w8") -> QuantizedTensor:
    """Per-output-channel symmetric int8: ``[in, out]`` -> int8 kernel and ``[out]``
    scales (each column by its own amax)."""
    w = w.float()
    amax = w.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / INT8_QMAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -INT8_QMAX, INT8_QMAX).to(torch.int8)
    return QuantizedTensor(q, scale, mode=mode)


def int8_accumulate(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 codes ``xq [..., K]`` and ``wq [K, N]`` on the
    route ``int8_matmul_routes`` counts (module docstring)."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    x2 = xq.reshape(-1, k)
    m, n = x2.shape[0], wq.shape[1]
    if x2.device.type == "cpu":
        int8_matmul_routes["int32_cpu"] += 1
        acc = torch.matmul(x2.to(torch.int32), wq.to(torch.int32))
    elif m > 16 and k % 8 == 0 and n % 8 == 0:
        int8_matmul_routes["int_mm"] += 1
        acc = torch._int_mm(x2.contiguous(), wq.contiguous())
    elif k <= EXACT_F32_K:
        int8_matmul_routes["f32_exact"] += 1
        acc = torch.matmul(x2.float(), wq.float()).to(torch.int32)
    else:
        raise ValueError(f"int8_accumulate: [{m}, {k}] x [{k}, {n}] on {x2.device} fits "
                         f"neither torch._int_mm's shape rules nor the exact f32 route "
                         f"(K <= {EXACT_F32_K})")
    return acc.reshape(*lead, n)


def int8_matmul(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """The quantized matmuls, by ``w.mode``: ``w8`` multiplies f32 activations by the
    upcast int8 kernel and applies the per-column scale to the f32 product; ``w8a8``
    quantizes the activations per row, accumulates ``int8 x int8`` exactly in int32, and
    rescales once, ``acc · xscale · w.scale``."""
    if w.mode == "w8a8":
        xq, xscale = quantize_rows(x, torch.int8)
        acc = int8_accumulate(xq, w.q)
        return acc.float() * xscale[..., None] * w.scale
    return torch.matmul(x.float(), w.q.float()) * w.scale


def dense_any(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """``ops.dense`` that takes a quantized kernel: a plain tensor takes the exact
    ``ops.dense`` call, a ``QuantizedTensor`` its quantized matmul."""
    if isinstance(w, QuantizedTensor):
        out = int8_matmul(x, w).to(x.dtype)
        return out if b is None else out + b
    return ops_nn.dense(x, w, b)


def quantize_params(params: dict, policy: QuantPolicy) -> dict:
    """Rewrite a params dict (the port's flat one, or a nested one) for the policy: every
    2-D ``*_kernel`` tensor becomes a ``QuantizedTensor`` of mode ``policy.weights``;
    everything else is kept as it is. ``weights="off"`` returns ``params`` itself."""
    if policy.weights == "off":
        return params
    mode = policy.weights
    rewritten = 0

    def walk(node):
        nonlocal rewritten
        out = {}
        for name, leaf in node.items():
            if isinstance(leaf, Mapping):
                out[name] = walk(leaf)
            elif name.endswith("_kernel") and getattr(leaf, "ndim", 0) == 2:
                out[name] = quantize_tensor(leaf, mode=mode)
                rewritten += 1
            else:
                out[name] = leaf
        return out

    quantized = walk(params)
    if rewritten == 0:
        raise ValueError("quantize_params found no 2-D *_kernel leaves to quantize — "
                         f"unexpected params tree for policy weights={mode!r}")
    return quantized


# ---------------------------------------------------------------------------------------
# Byte-true accounting
# ---------------------------------------------------------------------------------------


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.size) * int(np.dtype(x.dtype).itemsize)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) dict: ``numel · element_size`` of the real
    buffers, a ``QuantizedTensor`` as its codes plus its scales."""
    if isinstance(tree, Mapping):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, QuantizedTensor):
        return tree.nbytes
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return _tensor_bytes(tree)
    return 0


def cache_layout(cache: dict) -> str:
    """Signature of a KV cache's plane layout: leaf names, dtypes and the shape of one
    layer past its first axis. The prefix cache stores it with every entry, so planes
    written under one layout never install into an engine running another."""
    if not cache:
        return "empty"
    layer = cache[sorted(cache)[0]]
    parts = []
    for name in sorted(layer):
        leaf = layer[name]
        shape = [int(d) for d in leaf.shape[1:]]
        dtype = str(leaf.dtype).removeprefix("torch.")     # numpy's (and JAX's) name
        parts.append(f"{name}:{dtype}{shape}")
    return f"layers={len(cache)};" + ",".join(parts)


__all__ = ["EXACT_F32_K", "FP8_QMAX", "INT8_QMAX", "KV_DTYPES", "QuantPolicy",
           "QuantizedTensor", "WEIGHT_POLICIES", "cache_layout", "dense_any",
           "dequantize_rows", "fp8_dtype", "int8_accumulate", "int8_matmul",
           "int8_matmul_routes", "quantize_params", "quantize_rows", "quantize_tensor",
           "reset_route_counts", "resolve_kv_dtype", "tree_bytes"]
