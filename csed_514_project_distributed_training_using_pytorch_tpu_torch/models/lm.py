"""The autoregressive pixel LM and its serving decode: the contiguous and paged KV caches.

Counterpart of the JAX package's ``models/lm.py``, for the serving slice:

- ``tokenize_images_to_ids``: normalized MNIST images -> ``[B, 784]`` gray-level ids;
- ``TransformerLM``: the decoder-only LM (the port's ``TransformerBlock``s with
  ``causal=True``), ``[B, S]`` ids -> ``[B, S, vocab]`` f32 log-probs, ``shift_right``;
- the contiguous serving cache: ``init_cache`` (per-layer ``[B, S, KV_H, Dh]`` planes),
  ``decode_step_slots`` (one token per slot at per-slot positions), ``prefill_chunk``
  (``chunk`` prompt positions of one slot in one causal forward), ``reset_slots``;
- the paged serving cache: ``pages_per_slot``, ``init_page_pool`` (per-layer
  ``[num_pages, page_size, KV_H, Dh]`` pools), ``pool_page_size``,
  ``paged_prefill_chunk`` (gather one slot's view, ``prefill_chunk`` on it, scatter the
  written rows back, as the JAX package does) and ``paged_decode_step_slots``.

``paged_decode_step_slots`` is where the port departs from the JAX package's code and
follows its design instead: the JAX engine gathers every slot's view, runs the contiguous
step on it and scatters the one written row back (the "pure-XLA gather fallback" of its
``ops/paged_attention.py``); the port writes each slot's new K/V row into the pool at
``(table[b, t // ps], t % ps)`` and then attends through the page table with
``ops.paged_attention.paged_attend`` — the hand-written kernel on the card, its plain
version (the same gather and einsums) on the CPU. The function is the same.

Parameters are a flat dict with the JAX package's names (``block_0.attn.qkv_kernel`` for
``block_0/attn/qkv_kernel``; ``params_from_jax``, the classifier's, flattens an LM tree
too). The serving
functions take activations in f32 whatever the parameters' dtype (a bf16 weight is cast to
f32 where it is used, as JAX promotes it), and keep the caches in the model's dtype. They
update the cache tensors in place (JAX returns new arrays; the port saves the copy) and
return them, so the call shapes match the JAX package's.

Quantized execution (``ops/quant.py``) changes only the plane I/O and the matmuls:
``init_cache``/``init_page_pool`` take a ``kv_dtype``, and int8/fp8 add f32 ``k_scale``/
``v_scale`` planes (``[B, S, KV_H]`` contiguous, ``[num_pages, page_size, KV_H]`` paged).
Every writer (``decode_step_slots``, ``prefill_chunk``, ``paged_decode_step_slots``,
``paged_prefill_chunk``) quantizes each K/V row on write with one scale per KV head. The
contiguous paths read the dequantized planes in plain torch, as the reference's einsums
do; ``paged_decode_step_slots`` hands the narrow pool and its scale pools to
``paged_attend``, so on the card the kernel dequantizes as it reads and no wide copy of
the pool is made. Parameters may hold ``ops.quant.QuantizedTensor`` kernels
(``quant.quantize_params``); a plain tensor takes the exact unquantized call.
"""

from __future__ import annotations

from typing import Callable

import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch import ops
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data.mnist import (
    MNIST_MEAN,
    MNIST_STD,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
    NORMAL,
    ONES,
    ZEROS,
    TransformerBlock,
    _Slots,
    params_from_jax,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    paged_attention,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import quant
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
    MASK_VALUE,
    windowed_attention_fn,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.rotary import (
    apply_rotary,
)

PREFILL_CHUNK_SIZES = (32, 128, 512)   # the serving engine's default static chunk set


def tokenize_images_to_ids(x: torch.Tensor, *, num_levels: int = 16) -> torch.Tensor:
    """``[B, H, W, C]`` normalized images -> ``[B, H·W·C]`` int32 token ids in
    ``[0, num_levels)``: un-normalize to raw [0, 1] intensity, then quantize to
    ``num_levels`` uniform gray levels (the LM reserves id ``num_levels`` for BOS)."""
    raw = x * MNIST_STD + MNIST_MEAN
    ids = torch.clamp(torch.round(raw * (num_levels - 1)), 0, num_levels - 1)
    return ids.reshape(x.shape[0], -1).to(torch.int32)


class TransformerLM(_Slots):
    """Decoder-only LM over pixel tokens: ``[B, S]`` ids -> ``[B, S, vocab]`` log-probs.

    ``vocab_size`` counts the BOS id (``num_levels + 1``). The input is the shift-right
    stream (BOS first); position ``t``'s output predicts the t-th target. ``rope=True``
    rotates q/k and drops the learned ``pos_embed``; ``attention_window`` masks a causal
    sliding window (with the default dense core only). Remat is not ported (ROADMAP A8).
    """

    def __init__(self, vocab_size: int = 17, seq_len: int = 784, embed_dim: int = 64,
                 num_layers: int = 2, num_heads: int = 4, num_kv_heads: int | None = None,
                 mlp_ratio: int = 4, dropout_rate: float = 0.0,
                 attention_fn: Callable = ops.full_attention, attention_window: int = 0,
                 rope: bool = False, dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = ""):
        super().__init__()
        if remat or remat_policy:
            raise ValueError("remat is not ported yet (ROADMAP A8)")
        if attention_window and attention_fn is not ops.full_attention:
            raise ValueError(
                "attention_window composes with the default dense core only — "
                "bake the window into your custom attention_fn instead")
        self.vocab_size, self.seq_len, self.embed_dim = vocab_size, seq_len, embed_dim
        self.num_layers, self.num_heads, self.num_kv_heads = num_layers, num_heads, num_kv_heads
        self.mlp_ratio, self.dropout_rate = mlp_ratio, dropout_rate
        self.attention_window, self.rope, self.dtype = attention_window, rope, dtype
        core = windowed_attention_fn(attention_window) if attention_window else attention_fn
        self._slot("tok_embed", (vocab_size, embed_dim), NORMAL)
        if not rope:
            self._slot("pos_embed", (seq_len, embed_dim), NORMAL)
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                embed_dim, num_heads, num_kv_heads, mlp_ratio=mlp_ratio,
                dropout_rate=dropout_rate, attention_fn=core, causal=True, rope=rope,
                dtype=dtype))
        self._slot("ln_f_scale", (embed_dim,), ONES)
        self._slot("ln_f_bias", (embed_dim,), ZEROS)
        self._slot("head_kernel", (embed_dim, vocab_size), NORMAL)
        self._slot("head_bias", (vocab_size,), ZEROS)
        self._fill_slots()

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def forward(self, ids: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, s = ids.shape
        if s != self.seq_len:
            raise ValueError(f"expected seq_len {self.seq_len}, got {s}")
        cast = lambda w: w.to(self.dtype)
        h = cast(self.tok_embed)[ids.long()]
        if not self.rope:
            h = h + cast(self.pos_embed)[None]
        for i in range(self.num_layers):
            h = getattr(self, f"block_{i}")(h, deterministic, generator)
        h = ops.layer_norm(h, self.ln_f_scale, self.ln_f_bias)
        logits = ops.dense(h, cast(self.head_kernel), cast(self.head_bias))
        return ops.log_softmax(logits.float())

    def shift_right(self, targets: torch.Tensor) -> torch.Tensor:
        """Teacher-forcing input stream ``[BOS, t_0, …, t_{S-2}]`` (BOS = ``vocab - 1``)."""
        bos = torch.full((targets.shape[0], 1), self.vocab_size - 1, dtype=targets.dtype,
                         device=targets.device)
        return torch.cat([bos, targets[:, :-1]], dim=1)


# =========================================================================================
# The serving decode: shared per-layer math
# =========================================================================================


def _dense(params: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """``quant.dense_any`` with the f32 activations: a plain weight (cast to f32 at use)
    takes ``ops.dense``, a ``QuantizedTensor`` its quantized matmul."""
    w = params[f"{name}_kernel"]
    w = w if isinstance(w, quant.QuantizedTensor) else w.float()
    return quant.dense_any(x, w, params[f"{name}_bias"].float())


def _embed(model: TransformerLM, params: dict, ids: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    h = params["tok_embed"].float()[ids.long()]
    if not model.rope:
        h = h + params["pos_embed"].float()[positions.long()]
    return h


def _project(model: TransformerLM, params: dict, i: int, h: torch.Tensor,
             positions: torch.Tensor):
    """Layer ``i``'s pre-LN projections of ``[N, E]`` rows at ``positions [N]``:
    ``q [N, H, Dh]``, ``k, v [N, KV_H, Dh]``, RoPE applied."""
    n, e = h.shape
    nh, kvh, hd = model.num_heads, model.kv_heads, model.head_dim
    p = f"block_{i}."
    x = ops.layer_norm(h, params[p + "ln1_scale"], params[p + "ln1_bias"])
    if kvh == nh:
        qkv = _dense(params, p + "attn.qkv", x)
        q = qkv[:, :e].reshape(n, nh, hd)
        k = qkv[:, e:2 * e].reshape(n, kvh, hd)
        v = qkv[:, 2 * e:].reshape(n, kvh, hd)
    else:
        q = _dense(params, p + "attn.q", x).reshape(n, nh, hd)
        kv = _dense(params, p + "attn.kv", x).reshape(n, 2, kvh, hd)
        k, v = kv[:, 0], kv[:, 1]
    if model.rope:
        q, k = apply_rotary(q, positions), apply_rotary(k, positions)
    return q, k, v


def _block_tail(params: dict, i: int, h: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """The rest of block ``i`` after attention: the output projection's residual, then
    the MLP's."""
    p = f"block_{i}."
    h = h + _dense(params, p + "attn.out", attn)
    x = ops.layer_norm(h, params[p + "ln2_scale"], params[p + "ln2_bias"])
    return h + _dense(params, p + "mlp_down", ops.gelu(_dense(params, p + "mlp_up", x)))


def _head(params: dict, h: torch.Tensor) -> torch.Tensor:
    h = ops.layer_norm(h, params["ln_f_scale"], params["ln_f_bias"])
    return ops.log_softmax(_dense(params, "head", h).float())


def _planes(shape: tuple[int, ...], kv_dtype: str | None, model_dtype: torch.dtype,
            device: torch.device | str) -> dict:
    """One layer's zeroed K/V planes of ``shape`` in ``kv_dtype``'s plane dtype, with f32
    ``k_scale``/``v_scale`` planes of ``shape[:-1]`` for the scaled formats."""
    dtype, scaled = quant.resolve_kv_dtype(kv_dtype or "model", model_dtype)
    planes = {"k": torch.zeros(shape, dtype=dtype, device=device),
              "v": torch.zeros(shape, dtype=dtype, device=device)}
    if scaled:
        planes["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        planes["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return planes


def _kv_rows(layer: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """The rows to write into ``layer``, by leaf name: codes and per-head scales for a
    quantized layer (``k_scale`` present), else ``k``/``v`` cast to the plane dtype."""
    if "k_scale" in layer:
        (kq, ks), (vq, vs) = (quant.quantize_rows(k, layer["k"].dtype),
                              quant.quantize_rows(v, layer["v"].dtype))
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k.to(layer["k"].dtype), "v": v.to(layer["v"].dtype)}


def _read_kv(planes: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """K and V as attention reads them: dequantized when the planes carry scales."""
    if "k_scale" not in planes:
        return planes["k"], planes["v"]
    return (quant.dequantize_rows(planes["k"], planes["k_scale"]),
            quant.dequantize_rows(planes["v"], planes["v_scale"]))


# =========================================================================================
# The contiguous serving cache
# =========================================================================================


def init_cache(model: TransformerLM, batch: int, *, kv_dtype: str | None = None,
               device: torch.device | str = "cpu") -> dict:
    """Zeroed per-layer K/V planes ``[batch, seq_len, KV_H, Dh]`` in ``kv_dtype``'s plane
    dtype (``None``/``"model"``: the model's dtype); int8/fp8 add f32 ``k_scale``/
    ``v_scale`` planes ``[batch, seq_len, KV_H]``."""
    shape = (batch, model.seq_len, model.kv_heads, model.head_dim)
    return {f"block_{i}": _planes(shape, kv_dtype, model.dtype, device)
            for i in range(model.num_layers)}


def decode_step_slots(model: TransformerLM, params: dict, cache: dict, ids_t: torch.Tensor,
                      t: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """One incremental step at per-slot positions: ``ids_t [B]``, ``t [B]`` -> (cache,
    ``[B, vocab]`` f32 log-probs). Each slot's K/V row is written at its own position
    (clamped into ``[0, S)``), then every slot attends over its whole ``[S]`` plane under
    its own ``pos <= t[b]`` (and window) mask (``ops.paged_attention.decode_attention``,
    plain torch). A quantized cache stores each row's codes and per-head scales and is
    read dequantized."""
    b = ids_t.shape[0]
    rows = torch.arange(b, device=ids_t.device)
    safe_t = t.long().clamp(0, model.seq_len - 1)
    h = _embed(model, params, ids_t, safe_t)     # JAX's gather clamps the same way
    for i in range(model.num_layers):
        q, k, v = _project(model, params, i, h, t)
        layer = cache[f"block_{i}"]
        for key, row in _kv_rows(layer, k, v).items():
            layer[key][rows, safe_t] = row
        k_read, v_read = _read_kv(layer)
        qg = q.reshape(b, model.kv_heads, -1, model.head_dim)
        attn = paged_attention.decode_attention(qg, k_read, v_read, t,
                                                window=model.attention_window)
        h = _block_tail(params, i, h, attn.reshape(b, model.embed_dim))
    return cache, _head(params, h)


def prefill_chunk(model: TransformerLM, params: dict, cache: dict, prompt: torch.Tensor,
                  slot: int, start: int, length: int, fresh: bool, *, chunk: int) -> dict:
    """Write ``length`` prompt positions of one slot's planes in one ``[chunk]``-wide
    causal forward: the JAX package's ``prefill_chunk``.

    ``prompt`` is the engine's ``[num_slots, S]`` prompt buffer; the chunk covers
    positions ``start .. start + chunk - 1`` and the first ``length`` of them are real
    (a tail chunk pads up; padded rows compute but their writes are dropped). ``fresh``
    zeroes the slot's planes first. The chunk writes its K/V rows into the slot's full
    ``[S]`` plane and then attends against that plane under ``pos <= position`` (and the
    window), the structure of ``decode_step_slots``, so a row prefilled here is the row
    the per-token path would have cached (quantized on write alike, under a quantized
    cache)."""
    s = model.seq_len
    if not 0 < chunk <= s:
        raise ValueError(f"chunk {chunk} outside (0, {s}]")
    dev = prompt.device
    positions = start + torch.arange(chunk, device=dev)          # [C]
    safe_pos = positions.clamp(0, s - 1)
    row = prompt[slot]
    prev = row[(positions - 1).clamp(0, s - 1)]
    inp = torch.where(positions == 0, model.vocab_size - 1, prev)
    h = _embed(model, params, inp, safe_pos)
    pos_s = torch.arange(s, device=dev)[None]                    # [1, S]
    visible = pos_s <= positions[:, None]
    if model.attention_window:
        visible &= positions[:, None] - pos_s < model.attention_window
    visible = visible[:, None, None, :]                          # [C, 1, 1, S]
    scale = paged_attention.attention_scale(model.head_dim)
    written = safe_pos[:length]
    for i in range(model.num_layers):
        q, k, v = _project(model, params, i, h, positions)
        layer = cache[f"block_{i}"]
        planes = {key: x[slot] for key, x in layer.items()}     # views: [S, KV_H(, Dh)]
        if fresh:
            for x in planes.values():
                x.zero_()
        for key, row in _kv_rows(layer, k, v).items():
            planes[key][written] = row[:length]
        k_read, v_read = _read_kv(planes)
        qg = q.reshape(chunk, model.kv_heads, -1, model.head_dim)
        scores = torch.einsum("cgrd,sgd->cgrs", qg * scale, k_read.float())
        weights = torch.softmax(torch.where(visible, scores, MASK_VALUE), dim=-1)
        attn = torch.einsum("cgrs,sgd->cgrd", weights, v_read.float())
        h = _block_tail(params, i, h, attn.reshape(chunk, model.embed_dim))
    return cache


def reset_slots(cache: dict, fresh: torch.Tensor) -> dict:
    """Zero the K/V rows of the slots where ``fresh`` (``[B]`` bool) is set: slot
    recycling. The mask already hides rows past a slot's position; the wipe keeps a
    recycled slot equal to a fresh ``init_cache``'d one."""
    for layer in cache.values():
        for x in layer.values():
            mask = fresh.reshape(fresh.shape + (1,) * (x.dim() - 1))
            x.copy_(torch.where(mask, torch.zeros((), dtype=x.dtype, device=x.device), x))
    return cache


# =========================================================================================
# The paged serving cache
# =========================================================================================


def pages_per_slot(seq_len: int, page_size: int) -> int:
    """P_max: the page-table width that maps a full-context slot."""
    if not 0 < page_size:
        raise ValueError(f"page_size must be positive, got {page_size}")
    return -(-seq_len // page_size)


def init_page_pool(model: TransformerLM, num_pages: int, *, page_size: int,
                   kv_dtype: str | None = None, device: torch.device | str = "cpu") -> dict:
    """Zeroed per-layer page pools ``[num_pages, page_size, KV_H, Dh]``: ``init_cache``'s
    paged twin, with the same dtype and scale-pool rules (int8/fp8 add f32 ``k_scale``/
    ``v_scale`` pools ``[num_pages, page_size, KV_H]``)."""
    shape = (num_pages, page_size, model.kv_heads, model.head_dim)
    return {f"block_{i}": _planes(shape, kv_dtype, model.dtype, device)
            for i in range(model.num_layers)}


def pool_page_size(pool: dict) -> int:
    """The pool's page size, read off a K plane."""
    return pool["block_0"]["k"].shape[1]


def paged_decode_step_slots(model: TransformerLM, params: dict, pool: dict,
                            table: torch.Tensor, ids_t: torch.Tensor, t: torch.Tensor
                            ) -> tuple[dict, torch.Tensor]:
    """``decode_step_slots`` through a page table: ``pool`` per ``init_page_pool``,
    ``table [B, P_max]`` int32, ``ids_t``/``t [B]`` (int32 ``t`` on the card, as the
    kernel takes it). Per layer: project, write each slot's K/V row (its codes and
    per-head scales, in a quantized pool) at ``(table[b, t'//ps], t' % ps)`` with
    ``t' = clip(t, 0, S - 1)``, then ``paged_attend`` on the pool, with the scale pools
    when there are any: on the card the kernel reads the narrow pool and dequantizes as it
    goes. Slots whose rows are null-mapped (inactive, or mid-prefill at ``t = S - 1``)
    write into the null page and attend over junk the engine discards."""
    b = ids_t.shape[0]
    ps = pool_page_size(pool)
    rows = torch.arange(b, device=ids_t.device)
    safe_t = t.long().clamp(0, model.seq_len - 1)
    pages = table[rows, safe_t // ps].long()
    offs = safe_t % ps
    h = _embed(model, params, ids_t, safe_t)
    for i in range(model.num_layers):
        q, k, v = _project(model, params, i, h, t)
        layer = pool[f"block_{i}"]
        for key, row in _kv_rows(layer, k, v).items():
            layer[key][pages, offs] = row
        qg = q.reshape(b, model.kv_heads, -1, model.head_dim)
        attn = paged_attention.paged_attend(qg, layer["k"], layer["v"], table, t,
                                            window=model.attention_window,
                                            k_scale=layer.get("k_scale"),
                                            v_scale=layer.get("v_scale"),
                                            seq_len=model.seq_len)
        h = _block_tail(params, i, h, attn.reshape(b, model.embed_dim))
    return pool, _head(params, h)


def paged_prefill_chunk(model: TransformerLM, params: dict, pool: dict,
                        table: torch.Tensor, prompt: torch.Tensor, slot: int, start: int,
                        length: int, *, chunk: int) -> dict:
    """``prefill_chunk`` through a page table: gather the one slot's ``[1, S]`` view, run
    the contiguous chunk on it, and scatter the chunk's valid rows to their pages (every
    plane, the scale planes of a quantized pool included). No wipe: a masked row of a
    recycled page never reaches a softmax weight."""
    s = model.seq_len
    row_table = table[slot].long()                               # [P_max]
    view = {name: {key: paged_attention.gather_view(x, row_table[None], s)
                   for key, x in layer.items()}
            for name, layer in pool.items()}
    prefill_chunk(model, params, view, prompt[slot][None], 0, start, length, False,
                  chunk=chunk)
    ps = pool_page_size(pool)
    n = max(0, min(length, s - start))
    written = torch.arange(start, start + n, device=table.device)
    pages, offs = row_table[written // ps], written % ps
    for name, layer in pool.items():
        for key, x in layer.items():
            x[pages, offs] = view[name][key][0, written]
    return pool


__all__ = ["PREFILL_CHUNK_SIZES", "TransformerLM", "decode_step_slots", "init_cache",
           "init_page_pool", "paged_decode_step_slots", "paged_prefill_chunk",
           "pages_per_slot", "params_from_jax", "pool_page_size", "prefill_chunk",
           "reset_slots", "tokenize_images_to_ids"]
