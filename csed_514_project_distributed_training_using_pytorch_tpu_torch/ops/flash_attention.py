"""Flash attention: CUDA kernels on the card, their plain versions on the CPU.

Counterpart of the JAX package's ``ops/pallas_attention.py``. Each TPU kernel there has a
hand-written CUDA kernel here (``csrc/flash_attention.cu``, built by ``ops/_build.py``)
and, beside it, a plain PyTorch version of the same function:

- ``flash_forward``: out and lse by the online softmax over key tiles (TPU ``_fwd_kernel``);
- ``flash_dq`` (TPU ``_dq_kernel``) and ``flash_dkv`` (TPU ``_dkv_kernel``): the
  gradients by recomputing ``p = exp(q·kᵀ·scale − lse)``; ``flash_backward`` runs both
  after ``Δ = rowsum(dO∘out)``, which it takes in plain torch (``flash_delta``), as the
  JAX package leaves it to XLA.

Every one of them takes a ``q_offset``: the query positions sit ``q_offset`` past the keys'
origin in the masks, any sign, as the TPU kernels' hop offset (``_visibility_mask``). The
ring schedules (``parallel/ring_attention.py``) call them through ``flash_forward_with_lse``
and ``flash_backward_blocks`` with a hop's ``delta·C``.

``flash_attention`` joins them as one ``torch.autograd.Function`` on ``[B, S, H, D]``;
``dispatch_attention`` sends a sequence to it or to the dense ``full_attention`` by the
JAX package's predicate (``dispatch_uses_flash``).

Dispatch is by the device of the tensors alone: CPU tensors take the plain versions (the
CPU tests), CUDA tensors launch the kernels or raise. Nothing falls back. The kernels read
q, k, v and dO through their strides, so a view with a contiguous last dim (q, k, v
sliced out of a fused qkv projection) is taken as it is; a last dim that is not contiguous
raises. Each launch adds one to its counter (``flash_fwd_launches``, ``flash_dq_launches``,
``flash_dkv_launches``), and a launch with a nonzero ``q_offset`` one more to
``offset_launches``, so a run can show that it went through the kernels and their offset
form.

Forward and backward each have two routes, chosen by the operands' dtype alone and counted
alike, all on the tensor cores. float32 operands launch the 3xTF32 kernels
(``flash_fwd_tf32_kernel``, ``flash_dq_tf32_kernel``, ``flash_dkv_tf32_kernel``: each f32
product as three TF32 products, hi·hi + hi·lo + lo·hi, close to f32 accuracy); bfloat16
operands launch ``flash_fwd_mma_kernel``, ``flash_dq_mma_kernel`` and
``flash_dkv_mma_kernel``. The kernels copy their tiles 16 bytes at a time, so every wrapper
raises on an operand whose data pointer or (b, s, h) stride is not 16-byte aligned; such an
operand is neither copied nor sent to another kernel. The views of a fused
``[B, S, 3, H, D]`` projection (``models/transformer.py``) lie at offsets of H·D elements
with strides of multiples of D, so at the head widths the kernels take they are aligned.

The plain versions walk the keys in the kernels' tiles of ``KV_TILE`` with the same
recurrence, masks and roundings (p and ds narrowed to the input type at the products), so
kernel and plain version differ only in the order of f32 sums. ``block`` is validated as
the JAX package validates it and changes nothing else: the CUDA tiling is the port's own.
The JAX package's layout knobs (``native_layout``, ``FLASH_NATIVE_LAYOUT``,
``FLASH_NATIVE_MODE``, ``auto_block``) choose Mosaic layouts and have no counterpart: the
kernels read ``[B, S, H, D]`` in place.
"""

from __future__ import annotations

import ctypes
import math

import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import _build
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
    MASK_VALUE,
    full_attention,
    validate_window,
    visibility_mask,
)

BLOCK = 128            # the JAX package's lane-aligned block: sequence lengths divide by it
FLASH_MIN_SEQ = 2048   # the JAX package's flash/dense crossover (measured on its TPU); the
                       # card's own crossover is measured by chip_smoke.py, not set here
KV_TILE = 64           # the CUDA kernels' query and key tile (kTile in the source)
HEAD_DIMS = (16, 64, 128)   # head widths the kernels are compiled for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # dtype codes of the C interface

flash_fwd_launches = 0
flash_dq_launches = 0
flash_dkv_launches = 0
offset_launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}   # at q_offset != 0


def reset_launch_counts() -> None:
    global flash_fwd_launches, flash_dq_launches, flash_dkv_launches
    flash_fwd_launches = flash_dq_launches = flash_dkv_launches = 0
    offset_launches.update(dict.fromkeys(offset_launches, 0))


def launch_counts() -> dict[str, int]:
    return {"flash_fwd": flash_fwd_launches, "flash_dq": flash_dq_launches,
            "flash_dkv": flash_dkv_launches}


def offset_launch_counts() -> dict[str, int]:
    """The launches of each kernel with a nonzero ``q_offset`` (a part of its count)."""
    return dict(offset_launches)


def _check_block(s: int, block: int) -> None:
    """Sequence/block compatibility, with the JAX package's messages."""
    if block < 128 or block % 128:
        raise ValueError(f"flash block must be a positive multiple of 128, got {block}")
    if s % block:
        raise ValueError(
            f"flash attention requires sequence length divisible by block={block}, "
            f"got {s} (use ops.full_attention for odd lengths)")


def _check_seq(s: int) -> None:
    """The JAX package's ``auto_block`` refusal: a sequence no lane-aligned block tiles."""
    if s % BLOCK:
        raise ValueError(
            f"flash attention requires sequence length divisible by 128, got {s} "
            f"(use ops.full_attention for odd lengths)")


def _check_offset(q_offset: int) -> None:
    """The JAX package's hop-offset check: offsets shift whole blocks (any sign)."""
    if q_offset % BLOCK:
        raise ValueError(
            f"q_offset must be a multiple of block={BLOCK}, got {q_offset}")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: the plain versions' only case."""
    return all(t.device.type == "cpu" for t in tensors)


def _check_operands(name: str, **tensors: torch.Tensor) -> torch.device:
    """Raise unless the ``[B, S, H, D]`` operands are CUDA tensors on one device, of one
    dtype the kernels take, with a contiguous last dim, at a shape the kernels take."""
    first = next(iter(tensors.values()))
    dev, dtype, shape = first.device, first.dtype, first.shape
    if len(shape) != 4:
        raise ValueError(f"{name}: expected [B, S, H, D] operands, got {tuple(shape)}")
    for arg, t in tensors.items():
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected one CUDA device "
                             f"for every operand (the kernel runs on one device)")
        if t.dtype != dtype or t.dtype not in _DTYPES:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}; the kernel takes float32 "
                            f"or bfloat16, the same for every operand")
        if t.shape != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg} must be contiguous in its last dim "
                             f"(strides {t.stride()})")
    b, s, h, d = shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    if s % KV_TILE:
        raise ValueError(f"{name}: sequence length {s} is not a multiple of {KV_TILE}")
    return dev


def _check_aligned(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless each tensor's data pointer, and each ``[B, S, H, D]`` operand's (b, s, h)
    strides over dims longer than 1, are multiples of 16 bytes: the tensor-core kernels
    stage their tiles with 16-byte copies."""
    for arg, t in tensors.items():
        lead = zip(t.stride()[:3], t.shape[:3]) if t.dim() == 4 else ()
        strides = [st * t.element_size() for st, n in lead if n > 1]
        if t.data_ptr() % 16 or any(st % 16 for st in strides):
            raise ValueError(
                f"{name}: {arg} must be 16-byte aligned for the tensor-core kernel "
                f"(data pointer {t.data_ptr()} % 16 = {t.data_ptr() % 16}, strides "
                f"{t.stride()} of {t.element_size()} bytes)")


def _strides(t: torch.Tensor):
    """The (b, s, h) element strides of a ``[B, S, H, D]`` tensor, as the C interface takes
    them."""
    return (ctypes.c_int64 * 3)(*t.stride()[:3])


# =========================================================================================
# Forward
# =========================================================================================


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """``[B, S, H, D]`` -> f32 ``[B, H, S, D]``."""
    return x.float().permute(0, 2, 1, 3)


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, window: int = 0, q_offset: int = 0):
    """Plain version of ``flash_forward``: the kernel's online softmax over key tiles of
    ``KV_TILE``, with its masks and roundings. A key tile that no query of a row sees
    leaves that row's state as it was (p = 0, corr = 1), so walking every tile, as this
    version does, gives what the kernel's walk over the live tiles gives. A row that sees
    no key at all (possible only with a ``q_offset``) keeps out = 0 and lse =
    ``MASK_VALUE``."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = _heads_first(q), _heads_first(k), _heads_first(v)
    m = torch.full((b, h, s, 1), MASK_VALUE, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, s, KV_TILE):
        kt, vt = kf[:, :, k0:k0 + KV_TILE], vf[:, :, k0:k0 + KV_TILE]
        sc = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        vis = None
        if causal or window:
            vis = visibility_mask(s, kt.shape[2], causal=causal, window=window,
                                  device=q.device, k_offset=k0, q_offset=q_offset)
            sc = torch.where(vis, sc, MASK_VALUE)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        if vis is not None:
            p = torch.where(vis, p, 0.0)
        corr = torch.exp(m - m_new)
        acc = acc * corr + torch.matmul(p.to(q.dtype).float(), vt)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out, lse


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, window: int = 0, q_offset: int = 0):
    """``q, k, v: [B, S, H, D]`` -> ``(out [B, S, H, D] in q's dtype, lse f32 [B, H, S])``:
    one launch of the forward kernel (3xTF32 for f32 operands, bf16 for bf16 ones; both on
    the tensor cores). Raises on operands that are not 16-byte aligned, which the main
    path's q, k, v views of the fused qkv projection are. ``q_offset`` shifts the query
    positions against the keys in the masks (``visibility_mask``), any sign."""
    global flash_fwd_launches
    if _on_cpu(q, k, v):
        return flash_forward_plain(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    dev = _check_operands("flash_fwd", q=q, k=k, v=v)
    _check_aligned("flash_fwd", q=q, k=k, v=v)
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    _build.launch("flash_attention", "flash_fwd", dev, "flash_fwd", _DTYPES[q.dtype],
                  q.data_ptr(), _strides(q), k.data_ptr(), _strides(k), v.data_ptr(),
                  _strides(v), out.data_ptr(), lse.data_ptr(), b, s, h, d,
                  1.0 / math.sqrt(d), int(causal), int(window), int(q_offset))
    flash_fwd_launches += 1
    offset_launches["flash_fwd"] += bool(q_offset)
    return out, lse


# =========================================================================================
# Backward (recompute formulation: the residuals are out and lse only)
# =========================================================================================


def flash_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``Δ = rowsum(dO∘out)`` per head in f32, as ``[B, H, S]``: the backward's one plain
    pass, outside the kernels."""
    return (dout.float() * out.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def _backward_plain(q, k, v, lse, delta, dout, *, causal, window, q_offset=0):
    """The plain backward from the statistics lse and Δ (both ``[B, H, S]``)."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    lse, delta = lse[..., None], delta[..., None]                    # [B, H, S, 1]
    qf, kf, vf, dof = (_heads_first(x) for x in (q, k, v, dout))
    dq = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    for k0 in range(0, s, KV_TILE):
        kt, vt = kf[:, :, k0:k0 + KV_TILE], vf[:, :, k0:k0 + KV_TILE]
        sc = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        vis = None
        if causal or window:
            vis = visibility_mask(s, kt.shape[2], causal=causal, window=window,
                                  device=q.device, k_offset=k0, q_offset=q_offset)
            sc = torch.where(vis, sc, MASK_VALUE)
        p = torch.exp(sc - lse)
        if vis is not None:
            p = torch.where(vis, p, 0.0)
        ds = p * (torch.matmul(dof, vt.transpose(-1, -2)) - delta)
        p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
        dq += torch.matmul(ds, kt)
        dk[:, :, k0:k0 + KV_TILE] = torch.matmul(ds.transpose(-1, -2), qf)
        dv[:, :, k0:k0 + KV_TILE] = torch.matmul(p.transpose(-1, -2), dof)
    back = lambda x, dtype: x.to(dtype).permute(0, 2, 1, 3).contiguous()
    return back(dq * scale, q.dtype), back(dk * scale, k.dtype), back(dv, v.dtype)


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                         causal: bool = False, window: int = 0):
    """Plain version of ``flash_backward`` (of both backward kernels): per key tile of
    ``KV_TILE``, p by recompute, ``ds = p∘(dO·vᵀ − Δ)``, p and ds narrowed to the input
    type at the products; ``dq = scale·Σ ds·k``, ``dk = scale·Σ dsᵀ·q``,
    ``dv = Σ pᵀ·dO``."""
    return _backward_plain(q, k, v, lse, flash_delta(out, dout), dout, causal=causal,
                           window=window)


def _check_stats(name: str, q: torch.Tensor, **stats: torch.Tensor) -> None:
    b, s, h, _ = q.shape
    for arg, t in stats.items():
        if (t.shape != (b, h, s) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name}: {arg} must be contiguous f32 [{b}, {h}, {s}] on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _backward_args(q, k, v, dout, lse, delta):
    return (_DTYPES[q.dtype], q.data_ptr(), _strides(q), k.data_ptr(), _strides(k),
            v.data_ptr(), _strides(v), dout.data_ptr(), _strides(dout), lse.data_ptr(),
            delta.data_ptr())


def _shape_args(q, causal, window, q_offset):
    b, s, h, d = q.shape
    return (b, s, h, d, 1.0 / math.sqrt(d), int(causal), int(window), int(q_offset))


def flash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
             lse: torch.Tensor, delta: torch.Tensor, *, causal: bool = False,
             window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """dq ``[B, S, H, D]`` from the statistics lse and Δ (``[B, H, S]`` f32): one launch of
    the dq kernel (3xTF32 for f32 operands, bf16 for bf16 ones; both on the tensor
    cores)."""
    global flash_dq_launches
    if _on_cpu(q, k, v, dout, lse, delta):
        return _backward_plain(q, k, v, lse, delta, dout, causal=causal, window=window,
                               q_offset=q_offset)[0]
    dev = _check_operands("flash_dq", q=q, k=k, v=v, dout=dout)
    _check_stats("flash_dq", q, lse=lse, delta=delta)
    _check_aligned("flash_dq", q=q, k=k, v=v, dout=dout, lse=lse, delta=delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    _build.launch("flash_attention", "flash_dq", dev, "flash_dq",
                  *_backward_args(q, k, v, dout, lse, delta), dq.data_ptr(),
                  *_shape_args(q, causal, window, q_offset))
    flash_dq_launches += 1
    offset_launches["flash_dq"] += bool(q_offset)
    return dq


def flash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
              lse: torch.Tensor, delta: torch.Tensor, *, causal: bool = False,
              window: int = 0, q_offset: int = 0):
    """(dk, dv) ``[B, S, H, D]`` from the statistics lse and Δ: one launch of the dk/dv
    kernel (3xTF32 for f32 operands, bf16 for bf16 ones; both on the tensor cores)."""
    global flash_dkv_launches
    if _on_cpu(q, k, v, dout, lse, delta):
        return _backward_plain(q, k, v, lse, delta, dout, causal=causal, window=window,
                               q_offset=q_offset)[1:]
    dev = _check_operands("flash_dkv", q=q, k=k, v=v, dout=dout)
    _check_stats("flash_dkv", q, lse=lse, delta=delta)
    _check_aligned("flash_dkv", q=q, k=k, v=v, dout=dout, lse=lse, delta=delta)
    dk = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    _build.launch("flash_attention", "flash_dkv", dev, "flash_dkv",
                  *_backward_args(q, k, v, dout, lse, delta), dk.data_ptr(), dv.data_ptr(),
                  *_shape_args(q, causal, window, q_offset))
    flash_dkv_launches += 1
    offset_launches["flash_dkv"] += bool(q_offset)
    return dk, dv


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                   lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = False,
                   window: int = 0, q_offset: int = 0):
    """``(dq, dk, dv)`` in the operands' dtype, each ``[B, S, H, D]``, from the forward's
    out and lse and the output cotangent ``dout``: Δ in plain torch, then the dq kernel and
    the dk/dv kernel (each its plain version on the CPU)."""
    return _dq_dkv(q, k, v, dout, lse, flash_delta(out, dout), causal=causal, window=window,
                   q_offset=q_offset)


def _dq_dkv(q, k, v, dout, lse, delta, **mask):
    """``(dq, dk, dv)`` from the statistics lse and Δ: the dq kernel, then the dk/dv
    kernel."""
    dq = flash_dq(q, k, v, dout, lse, delta, **mask)
    return (dq, *flash_dkv(q, k, v, dout, lse, delta, **mask))


# =========================================================================================
# The ring schedules' building blocks (parallel/ring_attention.py)
# =========================================================================================


def flash_forward_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = False, window: int = 0, q_offset: int = 0):
    """Forward-only flash attention that also returns the per-row log-sum-exp, for the
    ring schedules' exact merge of partial results: ``[B, S, H, D]³ -> (out [B, S, H, D],
    lse f32 [B, H, S])``, no autograd. ``q_offset`` (a multiple of ``BLOCK``, any sign)
    places the queries ``q_offset`` positions past the keys' origin in the causal and
    window masks: the ring hop's offset ``delta·C``. A row that sees no key in this call
    comes back as out 0 and lse ``MASK_VALUE``, which the merge weighs by 0.

    The JAX package has a static ``q_offset`` and a traced ``q_offset_dyn`` (the zig-zag's
    device-dependent offsets). Here the rank is a host int, so both are this one ``int``,
    passed to the kernels as a runtime argument."""
    _check_seq(q.shape[1])
    _check_offset(q_offset)
    return flash_forward(q, k, v, causal=causal, window=window, q_offset=q_offset)


def flash_backward_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor, *,
                          causal: bool = False, window: int = 0, q_offset: int = 0):
    """One flash-backward pass of a query-block set against a key/value-block set, given
    the GLOBAL statistics: ``(dq, dk, dv)`` contributions. ``lse`` and ``delta`` (f32
    ``[B, H, S]``) are those of the full attention row, all keys of every hop, so
    ``p = exp(q·kᵀ·scale − lse)`` is the true softmax coefficient restricted to these keys
    and the contributions sum exactly over hops; a pair masked in this hop gives p = 0.
    ``q_offset`` as in ``flash_forward_with_lse`` (the static and traced offsets of the
    JAX package are this one ``int``). Requires equal q and k block sets."""
    if k.shape != q.shape:
        raise ValueError(
            f"flash_backward_blocks needs equal q/k block sets, got {tuple(q.shape)} vs "
            f"{tuple(k.shape)}")
    _check_seq(q.shape[1])
    _check_offset(q_offset)
    return _dq_dkv(q, k, v, dout, lse, delta, causal=causal, window=window, q_offset=q_offset)


class _FlashAttention(torch.autograd.Function):
    """Forward through ``flash_forward``, backward through ``flash_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_forward(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, causal=ctx.causal,
                                    window=ctx.window)
        return dq, dk, dv, None, None


# =========================================================================================
# Public API on [B, S, H, D], ops.full_attention-compatible
# =========================================================================================


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, block: int | None = None,
                    window: int | None = None) -> torch.Tensor:
    """Drop-in for ``ops.full_attention``: ``[B, S, H, D]`` -> ``[B, S, H, D]``,
    differentiable through the two backward kernels. Requires ``S % 128 == 0`` (or
    ``S % block == 0`` for an explicit ``block``, a multiple of 128), as the JAX package
    does; ``window=W`` is sliding-window attention with ``full_attention``'s semantics,
    and the kernels walk only the key tiles inside the band."""
    s = q.shape[1]
    if block is None:
        _check_seq(s)
    else:
        _check_block(s, block)
    validate_window(window)
    return _FlashAttention.apply(q, k, v, bool(causal), int(window or 0))


def dispatch_uses_flash(s: int) -> bool:
    """The routing predicate behind ``dispatch_attention``: the JAX package's, unchanged."""
    return s >= FLASH_MIN_SEQ and s % 128 == 0


def dispatch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = False, window: int | None = None) -> torch.Tensor:
    """``full_attention``-compatible attention that takes the flash kernels where the JAX
    package does (``dispatch_uses_flash``) and the dense path elsewhere."""
    if not dispatch_uses_flash(q.shape[1]):
        return full_attention(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)
