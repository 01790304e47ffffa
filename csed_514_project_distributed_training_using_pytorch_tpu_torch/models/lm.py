"""The autoregressive pixel LM: training, sampling and the serving decode.

Counterpart of the JAX package's ``models/lm.py``:

- ``tokenize_images_to_ids``: normalized MNIST images -> ``[B, 784]`` gray-level ids;
  ``ids_to_images`` back to raw [0, 1] images (for the sample grids);
- ``TransformerLM``: the decoder-only LM (the port's ``TransformerBlock``s with
  ``causal=True``, each rematerialized under ``remat``), ``[B, S]`` ids -> ``[B, S,
  vocab]`` f32 log-probs, ``shift_right``; ``next_token_loss``, the training objective;
- sampling: ``decode_step`` (one position of the whole batch over the contiguous cache,
  reading a static ``prefix_len`` of it), ``filter_logits`` (top-k, top-p),
  ``sample_categorical`` and ``generate`` (``DECODE_SEGMENT``-long segments over a growing
  prefix, greedy or sampled from an explicit ``torch.Generator``, optionally prompted);
  ``decode_nll``, the teacher-forced NLL through the serving decode (the quantized KV
  caches' accuracy probe);
- the contiguous serving cache: ``init_cache`` (per-layer ``[B, S, KV_H, Dh]`` planes),
  ``decode_step_slots`` (one token per slot at per-slot positions), ``prefill_chunk``
  (``chunk`` prompt positions of one slot in one causal forward), ``verify_chunk`` (the
  speculative verify: ``k + 1`` positions of every slot in one forward), ``reset_slots``;
- the paged serving cache: ``pages_per_slot``, ``init_page_pool`` (per-layer
  ``[num_pages, page_size, KV_H, Dh]`` pools), ``pool_page_size``,
  ``paged_prefill_chunk`` and ``paged_verify_chunk`` (gather the view, run the contiguous
  function on it, scatter the written rows back, as the JAX package does) and
  ``paged_decode_step_slots``.

``paged_decode_step_slots`` is where the port departs from the JAX package's code and
follows its design instead: the JAX engine gathers every slot's view, runs the contiguous
step on it and scatters the one written row back (the "pure-XLA gather fallback" of its
``ops/paged_attention.py``); the port writes each slot's new K/V row into the pool at
``(table[b, t // ps], t % ps)`` and then attends through the page table with
``ops.paged_attention.paged_attend`` — the hand-written kernel on the card, its plain
version (the same gather and einsums) on the CPU. The function is the same.

Parameters are a flat dict with the JAX package's names (``block_0.attn.qkv_kernel`` for
``block_0/attn/qkv_kernel``; ``params_from_jax``, the classifier's, flattens an LM tree
too, and ``params_to_jax`` nests it back). Sampled streams cannot match the JAX package's:
its draws come from threefry keys, these from a ``torch.Generator``; greedy streams match
token for token. The serving
functions take activations in f32 whatever the parameters' dtype (a bf16 weight is cast to
f32 where it is used, as JAX promotes it), and keep the caches in the model's dtype. They
update the cache tensors in place (JAX returns new arrays; the port saves the copy) and
return them, so the call shapes match the JAX package's.

On a serve mesh (``tp``, a ``parallel.mesh.Axis`` of size n) every serving function computes
the rank's ``H/n`` query and ``KV_H/n`` KV heads with its shards of the parameters
(``serving.shard.param_shardings``) and reads and writes planes of those heads only; the
embeddings, norms and head replicate (``_project``, ``_row_parallel``, ``_block_tail``).

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
from torch.func import functional_call

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
    params_to_jax,
    run_blocks,
    validate_remat_policy,
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
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    NO_SHARDING,
    Axis,
    ShardContext,
)

PREFILL_CHUNK_SIZES = (32, 128, 512)   # the serving engine's default static chunk set
NO_TP = Axis("model")   # the serving functions' default: every head on this rank
DECODE_SEGMENT = 128   # generate()'s prefix growth: segment j reads min((j+1)·128, S) rows


def tokenize_images_to_ids(x: torch.Tensor, *, num_levels: int = 16) -> torch.Tensor:
    """``[B, H, W, C]`` normalized images -> ``[B, H·W·C]`` int32 token ids in
    ``[0, num_levels)``: un-normalize to raw [0, 1] intensity, then quantize to
    ``num_levels`` uniform gray levels (the LM reserves id ``num_levels`` for BOS)."""
    raw = x * MNIST_STD + MNIST_MEAN
    ids = torch.clamp(torch.round(raw * (num_levels - 1)), 0, num_levels - 1)
    return ids.reshape(x.shape[0], -1).to(torch.int32)


def ids_to_images(ids: torch.Tensor, *, num_levels: int = 16,
                  shape: tuple[int, ...] = (28, 28, 1)) -> torch.Tensor:
    """Invert ``tokenize_images_to_ids`` (up to quantization): token ids -> ``[B, H, W,
    C]`` raw [0, 1] intensity images (for saving sampled digits)."""
    raw = ids.float() / (num_levels - 1)
    return raw.reshape((ids.shape[0],) + tuple(shape))


class TransformerLM(_Slots):
    """Decoder-only LM over pixel tokens: ``[B, S]`` ids -> ``[B, S, vocab]`` log-probs.

    ``vocab_size`` counts the BOS id (``num_levels + 1``). The input is the shift-right
    stream (BOS first); position ``t``'s output predicts the t-th target. ``rope=True``
    rotates q/k and drops the learned ``pos_embed``; ``attention_window`` masks a causal
    sliding window (with the default dense core only); ``remat`` recomputes each block in
    the backward (``models.transformer.remat_call``; ``remat_policy`` ``"save-dots"`` keeps
    the matmul outputs). ``shard`` places the blocks on a model axis (Megatron TP:
    ``models.transformer``); the embeddings, the final LayerNorm and the head replicate.
    The serving functions below take their own ``tp`` axis (the serve mesh,
    ``serving/shard.py``): column-parallel q/k/v over the rank's heads, the attention
    output and MLP down projections row-parallel with one SUM all-reduce each.
    """

    def __init__(self, vocab_size: int = 17, seq_len: int = 784, embed_dim: int = 64,
                 num_layers: int = 2, num_heads: int = 4, num_kv_heads: int | None = None,
                 mlp_ratio: int = 4, dropout_rate: float = 0.0,
                 attention_fn: Callable = ops.full_attention, attention_window: int = 0,
                 rope: bool = False, dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = "",
                 shard: ShardContext = NO_SHARDING):
        super().__init__()
        validate_remat_policy(remat, remat_policy)
        self.shard = shard
        if attention_window and attention_fn is not ops.full_attention:
            raise ValueError(
                "attention_window composes with the default dense core only — "
                "bake the window into your custom attention_fn instead")
        self.vocab_size, self.seq_len, self.embed_dim = vocab_size, seq_len, embed_dim
        self.num_layers, self.num_heads, self.num_kv_heads = num_layers, num_heads, num_kv_heads
        self.mlp_ratio, self.dropout_rate = mlp_ratio, dropout_rate
        self.attention_window, self.rope, self.dtype = attention_window, rope, dtype
        self.remat, self.remat_policy = remat, remat_policy
        core = windowed_attention_fn(attention_window) if attention_window else attention_fn
        self._slot("tok_embed", (vocab_size, embed_dim), NORMAL)
        if not rope:
            self._slot("pos_embed", (seq_len, embed_dim), NORMAL)
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                embed_dim, num_heads, num_kv_heads, mlp_ratio=mlp_ratio,
                dropout_rate=dropout_rate, attention_fn=core, causal=True, rope=rope,
                dtype=dtype, shard=shard))
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
        # the token embedding as a one-hot product: the rows come out exactly, and the
        # table's gradient is a matmul, the same bits every run; a gather's backward sums
        # in an order that changes from run to run (indexing's on the CPU, F.embedding's
        # on the card: lm_probe.py), so two runs of one seed would part in the last bits
        # and drift apart over an epoch
        onehot = torch.nn.functional.one_hot(ids.long(), self.vocab_size).to(self.dtype)
        h = onehot @ cast(self.tok_embed)
        if not self.rope:
            h = h + cast(self.pos_embed)[None]
        h = run_blocks(self, h, deterministic, generator)
        h = ops.layer_norm(h, self.ln_f_scale, self.ln_f_bias)
        logits = ops.dense(h, cast(self.head_kernel), cast(self.head_bias))
        return ops.log_softmax(logits.float())

    def shift_right(self, targets: torch.Tensor) -> torch.Tensor:
        """Teacher-forcing input stream ``[BOS, t_0, …, t_{S-2}]`` (BOS = ``vocab - 1``)."""
        bos = torch.full((targets.shape[0], 1), self.vocab_size - 1, dtype=targets.dtype,
                         device=targets.device)
        return torch.cat([bos, targets[:, :-1]], dim=1)


def next_token_loss(model: TransformerLM, params: dict, targets: torch.Tensor, rng, *,
                    deterministic: bool = False, label_smoothing: float = 0.0
                    ) -> torch.Tensor:
    """The mean next-token NLL over all ``B·S`` positions (the LM's training objective),
    the forward's dropout drawn from ``rng`` (the step's ``DropoutStream``).
    ``label_smoothing`` follows torch ``CrossEntropyLoss`` semantics (the smoothed target
    ``(1−s)·onehot + s/V`` over the vocabulary)."""
    log_probs = functional_call(model, params, (model.shift_right(targets),),
                                {"deterministic": deterministic,
                                 "generator": None if deterministic else rng})
    picked = torch.gather(log_probs, -1, targets.long()[..., None])[..., 0]
    if label_smoothing:
        smooth = log_probs.mean(dim=-1)
        picked = (1.0 - label_smoothing) * picked + label_smoothing * smooth
    return -picked.mean()


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


def _local_heads(model: TransformerLM, tp: Axis) -> tuple[int, int, int]:
    """``(heads, kv_heads, width)`` a rank of the ``tp`` axis computes: its ``1/size`` of
    the query and KV heads, and of the attention width."""
    n = tp.size
    return model.num_heads // n, model.kv_heads // n, model.embed_dim // n


def _project(model: TransformerLM, params: dict, i: int, h: torch.Tensor,
             positions: torch.Tensor, tp: Axis = NO_TP):
    """Layer ``i``'s pre-LN projections of ``[N, E]`` rows at ``positions [N]``:
    ``q [N, H, Dh]``, ``k, v [N, KV_H, Dh]``, RoPE applied. On a ``tp`` axis of size n the
    column-parallel kernels hold this rank's heads (the fused columns split by heads), so
    the projections are ``H/n`` and ``KV_H/n`` heads wide."""
    n = h.shape[0]
    nh, kvh, e = _local_heads(model, tp)
    hd = model.head_dim
    p = f"block_{i}."
    x = ops.layer_norm(h, params[p + "ln1_scale"], params[p + "ln1_bias"])
    if model.kv_heads == model.num_heads:
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


def _row_parallel(params: dict, name: str, x: torch.Tensor, tp: Axis) -> torch.Tensor:
    """A row-parallel projection on a ``tp`` axis of size > 1: this rank's input slice
    times its rows of the kernel, SUMmed over the axis's group, then the replicated bias.
    A ``QuantizedTensor`` keeps its replicated per-column scales after the sum; under
    ``w8a8`` the activation rows take the scale of the whole row (an amax all-reduced MAX)
    and the int32 accumulators are summed, exact, so the result is the unsharded one."""
    w = params[f"{name}_kernel"]
    b = params[f"{name}_bias"].float()
    if not isinstance(w, quant.QuantizedTensor):
        out = x.float() @ w.float()
        collectives.all_reduce_sum_(out, group=tp.group)
        return out + b
    if w.mode == "w8a8":
        amax = x.float().abs().amax(dim=-1)
        collectives.all_reduce_max_(amax, group=tp.group)
        xscale = torch.where(amax > 0, amax / quant.INT8_QMAX, torch.ones_like(amax))
        xq = torch.clamp(torch.round(x.float() / xscale[..., None]), -quant.INT8_QMAX,
                         quant.INT8_QMAX).to(torch.int8)
        acc = quant.int8_accumulate(xq, w.q)
        collectives.all_reduce_sum_(acc, group=tp.group)
        return acc.float() * xscale[..., None] * w.scale + b
    out = torch.matmul(x.float(), w.q.float())
    collectives.all_reduce_sum_(out, group=tp.group)
    return out * w.scale + b


def _block_tail(params: dict, i: int, h: torch.Tensor, attn: torch.Tensor,
                tp: Axis = NO_TP) -> torch.Tensor:
    """The rest of block ``i`` after attention: the output projection's residual, then
    the MLP's. On a ``tp`` axis of size > 1 both row-parallel projections sum over its
    group (``_row_parallel``)."""
    p = f"block_{i}."
    if tp.size == 1:
        h = h + _dense(params, p + "attn.out", attn)
        x = ops.layer_norm(h, params[p + "ln2_scale"], params[p + "ln2_bias"])
        return h + _dense(params, p + "mlp_down", ops.gelu(_dense(params, p + "mlp_up", x)))
    h = h + _row_parallel(params, p + "attn.out", attn, tp)
    x = ops.layer_norm(h, params[p + "ln2_scale"], params[p + "ln2_bias"])
    return h + _row_parallel(params, p + "mlp_down",
                             ops.gelu(_dense(params, p + "mlp_up", x)), tp)


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
               device: torch.device | str = "cpu", tp: Axis = NO_TP) -> dict:
    """Zeroed per-layer K/V planes ``[batch, seq_len, KV_H, Dh]`` in ``kv_dtype``'s plane
    dtype (``None``/``"model"``: the model's dtype); int8/fp8 add f32 ``k_scale``/
    ``v_scale`` planes ``[batch, seq_len, KV_H]``. On a ``tp`` axis the planes hold this
    rank's ``KV_H / size`` heads."""
    shape = (batch, model.seq_len, model.kv_heads // tp.size, model.head_dim)
    return {f"block_{i}": _planes(shape, kv_dtype, model.dtype, device)
            for i in range(model.num_layers)}


def decode_step_slots(model: TransformerLM, params: dict, cache: dict, ids_t: torch.Tensor,
                      t: torch.Tensor, *, tp: Axis = NO_TP) -> tuple[dict, torch.Tensor]:
    """One incremental step at per-slot positions: ``ids_t [B]``, ``t [B]`` -> (cache,
    ``[B, vocab]`` f32 log-probs). Each slot's K/V row is written at its own position
    (clamped into ``[0, S)``), then every slot attends over its whole ``[S]`` plane under
    its own ``pos <= t[b]`` (and window) mask (``ops.paged_attention.decode_attention``,
    plain torch). A quantized cache stores each row's codes and per-head scales and is
    read dequantized. On a ``tp`` axis (the serve mesh) the rank computes its own heads
    with its shards of the parameters and planes (``_project``, ``_block_tail``)."""
    b = ids_t.shape[0]
    _, kvh, e = _local_heads(model, tp)
    rows = torch.arange(b, device=ids_t.device)
    safe_t = t.long().clamp(0, model.seq_len - 1)
    h = _embed(model, params, ids_t, safe_t)     # JAX's gather clamps the same way
    for i in range(model.num_layers):
        q, k, v = _project(model, params, i, h, t, tp)
        layer = cache[f"block_{i}"]
        for key, row in _kv_rows(layer, k, v).items():
            layer[key][rows, safe_t] = row
        k_read, v_read = _read_kv(layer)
        qg = q.reshape(b, kvh, -1, model.head_dim)
        attn = paged_attention.decode_attention(qg, k_read, v_read, t,
                                                window=model.attention_window)
        h = _block_tail(params, i, h, attn.reshape(b, e), tp)
    return cache, _head(params, h)


def prefill_chunk(model: TransformerLM, params: dict, cache: dict, prompt: torch.Tensor,
                  slot: int, start: int, length: int, fresh: bool, *, chunk: int,
                  tp: Axis = NO_TP) -> dict:
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
    _, kvh, e = _local_heads(model, tp)
    for i in range(model.num_layers):
        q, k, v = _project(model, params, i, h, positions, tp)
        layer = cache[f"block_{i}"]
        planes = {key: x[slot] for key, x in layer.items()}     # views: [S, KV_H(, Dh)]
        if fresh:
            for x in planes.values():
                x.zero_()
        for key, row in _kv_rows(layer, k, v).items():
            planes[key][written] = row[:length]
        k_read, v_read = _read_kv(planes)
        qg = q.reshape(chunk, kvh, -1, model.head_dim)
        scores = torch.einsum("cgrd,sgd->cgrs", qg * scale, k_read.float())
        weights = torch.softmax(torch.where(visible, scores, MASK_VALUE), dim=-1)
        attn = torch.einsum("cgrs,sgd->cgrd", weights, v_read.float())
        h = _block_tail(params, i, h, attn.reshape(chunk, e), tp)
    return cache


def _window_rows(model: TransformerLM, t: torch.Tensor, w: int):
    """The verify window's positions ``[B, W]`` (``t[b] + j``), their clamp into
    ``[0, S)``, the rows that lie inside the cache (``positions < S``), and each row's
    write column: its own, or column 0 for a row past ``seq_len``. That is the scatter's
    drop without a host sync (a mask in front of an index would need one): a dropped row
    writes column 0's value onto column 0's target, so every index written twice gets one
    value and nothing lands on a live row."""
    positions = t.long()[:, None] + torch.arange(w, device=t.device)
    valid = positions < model.seq_len
    cols = torch.where(valid, torch.arange(w, device=t.device), 0)
    return positions, positions.clamp(0, model.seq_len - 1), valid, cols


def verify_chunk(model: TransformerLM, params: dict, cache: dict, ids: torch.Tensor,
                 t: torch.Tensor, draft: torch.Tensor, *, k: int, tp: Axis = NO_TP
                 ) -> tuple[dict, torch.Tensor]:
    """Batched k-token verify: score ``k`` draft tokens per slot in one causal forward
    over the slot planes, the JAX package's ``verify_chunk``.

    ``ids [B]`` is each slot's last accepted token, ``t [B]`` its position
    (``decode_step_slots``'s conventions), ``draft [B, k]`` the proposals for positions
    ``t+1 .. t+k``. The chunk's inputs are ``[ids, d_1 .. d_k]`` at positions ``t .. t+k``;
    row ``j``'s log-probs are what decode at position ``t+j`` returns, the target
    distribution after input ``j``. Returns ``(cache, log_probs [B, k+1, V])``; acceptance
    is the caller's.

    The chunk writes all ``k+1`` K/V rows of every slot into its ``[S]`` plane first
    (quantized on write by ``_kv_rows``, the per-token path's own call), then attends
    against the plane under ``pos <= t+j`` (and the window), with decode's einsums. Rows
    past ``seq_len`` are dropped, never clamped onto a live row. Every projection runs on
    the ``[B·W, E]`` rows, the 2-D shape decode uses, so w8a8's per-row activation codes
    are position for position decode's. Rows written for rejected drafts lie past the new
    position and are rewritten before any query can see them."""
    s = model.seq_len
    if not 1 <= k < s:
        raise ValueError(f"k {k} outside [1, {s})")
    w = k + 1
    b = ids.shape[0]
    nh, kvh, e = _local_heads(model, tp)
    hd = model.head_dim
    dev = ids.device
    x = torch.cat([ids.long()[:, None], draft.long()], dim=1)         # [B, W]
    positions, safe_pos, valid, cols = _window_rows(model, t, w)
    write_pos = torch.gather(safe_pos, 1, cols)
    slot_idx = torch.arange(b, device=dev)[:, None].expand(b, w)
    h = _embed(model, params, x.reshape(-1), safe_pos.reshape(-1))     # [B·W, E]
    pos_s = torch.arange(s, device=dev)
    visible = pos_s[None, None] <= positions[:, :, None]               # [B, W, S]
    if model.attention_window:
        visible &= positions[:, :, None] - pos_s[None, None] < model.attention_window
    visible = visible[:, None, :, None, :]                             # [B, 1, W, 1, S]
    scale = paged_attention.attention_scale(hd)
    for i in range(model.num_layers):
        q, kk, v = _project(model, params, i, h, safe_pos.reshape(-1), tp)
        layer = cache[f"block_{i}"]
        for key, row in _kv_rows(layer, kk, v).items():
            row = row.reshape((b, w) + tuple(row.shape[1:]))
            plane = layer[key]
            # column 0's value; where t >= S even column 0 drops: the plane's own row
            own = plane[torch.arange(b, device=dev), safe_pos[:, 0]]
            first = torch.where(valid[:, 0].reshape((b,) + (1,) * (row.dim() - 2)),
                                row[:, 0], own)
            keep = valid.reshape(valid.shape + (1,) * (row.dim() - 2))
            plane[slot_idx, write_pos] = torch.where(keep, row, first[:, None])
        k_read, v_read = _read_kv(layer)
        # [B, G, W·R, D]: decode's einsums with the window's rows stacked on R
        qg = q.reshape(b, w, kvh, nh // kvh, hd).permute(0, 2, 1, 3, 4).reshape(
            b, kvh, -1, hd)
        scores = torch.einsum("bgrd,bsgd->bgrs", qg.float() * scale, k_read.float())
        scores = scores.reshape(b, kvh, w, nh // kvh, s)
        weights = torch.softmax(torch.where(visible, scores, MASK_VALUE), dim=-1)
        attn = torch.einsum("bgrs,bsgd->bgrd", weights.reshape(b, kvh, -1, s),
                            v_read.float())
        attn = attn.reshape(b, kvh, w, nh // kvh, hd).permute(0, 2, 1, 3, 4)
        h = _block_tail(params, i, h, attn.reshape(b * w, e), tp)
    return cache, _head(params, h).reshape(b, w, -1)


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
# Sampling: one position of a batch at a time over the contiguous cache
# =========================================================================================


def decode_step(model: TransformerLM, params: dict, cache: dict, ids_t: torch.Tensor,
                t, *, prefix_len: int | None = None) -> tuple[dict, torch.Tensor]:
    """One incremental step of the whole batch at position ``t`` (an int, or a 0-d
    tensor): ``ids_t [B]`` -> (cache, ``[B, vocab]`` f32 log-probs of position ``t``'s
    prediction), every layer's K/V row written at ``t``.

    ``prefix_len`` (an int, default ``seq_len``) bounds the cache rows attention reads:
    a caller that knows ``t < prefix_len`` (``generate``'s segments) reads
    ``cache[:, :prefix_len]``. Rows past ``t`` inside it are masked, so the math is the
    full-cache step's. A quantized cache raises: its writers are ``decode_step_slots`` and
    ``prefill_chunk``."""
    if "k_scale" in cache.get("block_0", {}):
        raise ValueError("decode_step reads raw K/V planes only — use decode_step_slots/"
                         "prefill_chunk for a quantized cache, or init_cache() without "
                         "kv_dtype")
    pl = model.seq_len if prefix_len is None else prefix_len
    if not 0 < pl <= model.seq_len:
        raise ValueError(f"prefix_len {pl} outside (0, {model.seq_len}]")
    b = ids_t.shape[0]
    t_b = torch.full((b,), int(t), dtype=torch.int64, device=ids_t.device)
    h = _embed(model, params, ids_t, t_b)
    for i in range(model.num_layers):
        q, k, v = _project(model, params, i, h, t_b)
        layer = cache[f"block_{i}"]
        layer["k"][:, t] = k.to(layer["k"].dtype)
        layer["v"][:, t] = v.to(layer["v"].dtype)
        qg = q.reshape(b, model.kv_heads, -1, model.head_dim)
        attn = paged_attention.decode_attention(qg, layer["k"][:, :pl], layer["v"][:, :pl],
                                                t_b, window=model.attention_window)
        h = _block_tail(params, i, h, attn.reshape(b, model.embed_dim))
    return cache, _head(params, h)


@torch.no_grad()
def decode_nll(model: TransformerLM, params: dict, targets: torch.Tensor, *,
               kv_dtype: str | None = None) -> torch.Tensor:
    """The teacher-forced mean next-token NLL of ``targets [B, seq_len]`` scored through
    the serving decode (``decode_step_slots``, one position a step, every cached row
    quantized on write under ``kv_dtype``): the accuracy probe of quantized execution.
    Its difference from the ``kv_dtype=None`` value is the policy's NLL cost."""
    b, s = targets.shape
    if s != model.seq_len:
        raise ValueError(f"expected seq_len {model.seq_len}, got {s}")
    dev = targets.device
    targets = targets.long()
    cache = init_cache(model, b, kv_dtype=kv_dtype, device=dev)
    inputs = model.shift_right(targets)
    picked = []
    for t in range(s):
        cache, logp = decode_step_slots(model, params, cache, inputs[:, t],
                                        torch.full((b,), t, dtype=torch.int32, device=dev))
        picked.append(torch.gather(logp, -1, targets[:, t, None])[:, 0])
    return -torch.stack(picked).mean()


def filter_logits(log_probs: torch.Tensor, *, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Mask ``[..., V]`` logits outside the top-k set and/or the top-p nucleus, as the
    JAX package does.

    ``top_k = 0`` disables the k filter; ``top_p = 1.0`` the nucleus filter. The nucleus
    is the smallest prefix of the probability-sorted vocabulary whose mass reaches
    ``top_p`` (the argmax always survives; ties at the threshold all survive). The two
    compose. Masked entries become ``MASK_VALUE``."""
    if top_k:
        kth = torch.topk(log_probs, top_k, dim=-1).values[..., -1:]
        log_probs = torch.where(log_probs < kth, MASK_VALUE, log_probs)
    if top_p < 1.0:
        sorted_lp = torch.sort(log_probs, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lp, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs            # the mass before j
        kept = before < top_p
        thresh = torch.where(kept, sorted_lp, torch.inf).amin(dim=-1, keepdim=True)
        log_probs = torch.where(log_probs < thresh, MASK_VALUE, log_probs)
    return log_probs


def sample_categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` by the Gumbel-max rule, with noise from
    ``generator`` (on the logits' device)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@torch.no_grad()
def generate(model: TransformerLM, params: dict, generator: torch.Generator | None = None,
             *, batch: int = 1, temperature: float = 1.0, top_k: int = 0,
             top_p: float = 1.0, prompt: torch.Tensor | None = None,
             prompt_len: int = 0) -> torch.Tensor:
    """Sample ``[batch, seq_len]`` int32 token streams from BOS, one position a step, on
    the parameters' device.

    ``temperature <= 0`` decodes greedily (the first maximum, as the JAX package's
    ``argmax``); otherwise each step draws from ``filter_logits(log_probs / temperature,
    top_k=, top_p=)`` with noise from ``generator`` (required then). BOS is masked out of
    every step's choice. The steps run in ``DECODE_SEGMENT``-long segments, segment ``j``
    reading a cache prefix of ``min((j+1)·DECODE_SEGMENT, S)`` rows (``decode_step``'s
    ``prefix_len``), as the JAX package's segmented scan does.

    ``prompt`` (``[batch, seq_len]`` ids) with ``prompt_len = K`` teacher-forces the
    first ``K`` output positions to the prompt (their K/V still fill the cache) and samples
    positions ``K..S-1``: digit completion from the top rows of a real image."""
    if not 0 <= top_k <= model.vocab_size:
        raise ValueError(f"top_k {top_k} outside [0, {model.vocab_size}]")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p {top_p} outside (0, 1]")
    if temperature > 0 and generator is None:
        raise ValueError("sampling at temperature > 0 draws from an explicit "
                         "torch.Generator; pass one (or temperature <= 0 for greedy)")
    dev = params["tok_embed"].device
    s = model.seq_len
    if prompt is None:
        prompt = torch.zeros((batch, s), dtype=torch.int32, device=dev)
        prompt_len = 0
    if not 0 <= prompt_len <= s:
        raise ValueError(f"prompt_len {prompt_len} outside [0, {s}]")
    if tuple(prompt.shape) != (batch, s):
        raise ValueError(f"prompt shape {tuple(prompt.shape)} != (batch, seq_len) = "
                         f"({batch}, {s})")
    prompt = prompt.to(device=dev, dtype=torch.int64)
    cache = init_cache(model, batch, device=dev)
    ids_t = torch.full((batch,), model.vocab_size - 1, dtype=torch.int64, device=dev)
    out = torch.empty((batch, s), dtype=torch.int32, device=dev)
    for start in range(0, s, DECODE_SEGMENT):
        stop = min(start + DECODE_SEGMENT, s)
        for t in range(start, stop):
            cache, log_probs = decode_step(model, params, cache, ids_t, t, prefix_len=stop)
            log_probs[:, model.vocab_size - 1] = MASK_VALUE
            if t < prompt_len:
                nxt = prompt[:, t]
            elif temperature > 0:
                scaled = filter_logits(log_probs / temperature, top_k=top_k, top_p=top_p)
                nxt = sample_categorical(scaled, generator)
            else:
                nxt = torch.argmax(log_probs, dim=-1)
            out[:, t] = nxt
            ids_t = nxt
    return out


# =========================================================================================
# The paged serving cache
# =========================================================================================


def pages_per_slot(seq_len: int, page_size: int) -> int:
    """P_max: the page-table width that maps a full-context slot."""
    if not 0 < page_size:
        raise ValueError(f"page_size must be positive, got {page_size}")
    return -(-seq_len // page_size)


def init_page_pool(model: TransformerLM, num_pages: int, *, page_size: int,
                   kv_dtype: str | None = None, device: torch.device | str = "cpu",
                   tp: Axis = NO_TP) -> dict:
    """Zeroed per-layer page pools ``[num_pages, page_size, KV_H, Dh]``: ``init_cache``'s
    paged twin, with the same dtype and scale-pool rules (int8/fp8 add f32 ``k_scale``/
    ``v_scale`` pools ``[num_pages, page_size, KV_H]``) and the same ``tp`` heads."""
    shape = (num_pages, page_size, model.kv_heads // tp.size, model.head_dim)
    return {f"block_{i}": _planes(shape, kv_dtype, model.dtype, device)
            for i in range(model.num_layers)}


def pool_page_size(pool: dict) -> int:
    """The pool's page size, read off a K plane."""
    return pool["block_0"]["k"].shape[1]


def paged_decode_step_slots(model: TransformerLM, params: dict, pool: dict,
                            table: torch.Tensor, ids_t: torch.Tensor, t: torch.Tensor, *,
                            tp: Axis = NO_TP) -> tuple[dict, torch.Tensor]:
    """``decode_step_slots`` through a page table: ``pool`` per ``init_page_pool``,
    ``table [B, P_max]`` int32, ``ids_t``/``t [B]`` (int32 ``t`` on the card, as the
    kernel takes it). Per layer: project, write each slot's K/V row (its codes and
    per-head scales, in a quantized pool) at ``(table[b, t'//ps], t' % ps)`` with
    ``t' = clip(t, 0, S - 1)``, then ``paged_attend`` on the pool, with the scale pools
    when there are any: on the card the kernel reads the narrow pool and dequantizes as it
    goes. Slots whose rows are null-mapped (inactive, or mid-prefill at ``t = S - 1``)
    write into the null page and attend over junk the engine discards. On a ``tp`` axis
    the kernel runs on this rank's heads and its pool (the table then holds indices into
    that pool: the serve mesh's page range of the rank's slot group)."""
    b = ids_t.shape[0]
    _, kvh, e = _local_heads(model, tp)
    ps = pool_page_size(pool)
    rows = torch.arange(b, device=ids_t.device)
    safe_t = t.long().clamp(0, model.seq_len - 1)
    pages = table[rows, safe_t // ps].long()
    offs = safe_t % ps
    h = _embed(model, params, ids_t, safe_t)
    for i in range(model.num_layers):
        q, k, v = _project(model, params, i, h, t, tp)
        layer = pool[f"block_{i}"]
        for key, row in _kv_rows(layer, k, v).items():
            layer[key][pages, offs] = row
        qg = q.reshape(b, kvh, -1, model.head_dim)
        attn = paged_attention.paged_attend(qg, layer["k"], layer["v"], table, t,
                                            window=model.attention_window,
                                            k_scale=layer.get("k_scale"),
                                            v_scale=layer.get("v_scale"),
                                            seq_len=model.seq_len)
        h = _block_tail(params, i, h, attn.reshape(b, e), tp)
    return pool, _head(params, h)


def paged_prefill_chunk(model: TransformerLM, params: dict, pool: dict,
                        table: torch.Tensor, prompt: torch.Tensor, slot: int, start: int,
                        length: int, *, chunk: int, tp: Axis = NO_TP) -> dict:
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
                  chunk=chunk, tp=tp)
    ps = pool_page_size(pool)
    n = max(0, min(length, s - start))
    written = torch.arange(start, start + n, device=table.device)
    pages, offs = row_table[written // ps], written % ps
    for name, layer in pool.items():
        for key, x in layer.items():
            x[pages, offs] = view[name][key][0, written]
    return pool


def paged_verify_chunk(model: TransformerLM, params: dict, pool: dict,
                       table: torch.Tensor, ids: torch.Tensor, t: torch.Tensor,
                       draft: torch.Tensor, *, k: int, tp: Axis = NO_TP
                       ) -> tuple[dict, torch.Tensor]:
    """``verify_chunk`` through a page table, as the JAX package does it: gather every
    slot's ``[S]`` view (``ops.paged_attention.gather_view``; verify reads every slot's
    cache, as decode does), run the contiguous verify on it, then scatter each slot's
    ``[k+1]`` written rows (codes and scales alike) to ``(table[b, p // ps], p % ps)``.
    Rows past ``seq_len`` are dropped; rows past a slot's reservation land in the null
    page through the table. The paged-decode kernel is not called: the JAX package also
    verifies on the gathered view."""
    s = model.seq_len
    b = ids.shape[0]
    ps = pool_page_size(pool)
    w = k + 1
    view = {name: {key: paged_attention.gather_view(x, table, s) for key, x in layer.items()}
            for name, layer in pool.items()}
    _, log_probs = verify_chunk(model, params, view, ids, t, draft, k=k, tp=tp)
    _, safe_pos, _, cols = _window_rows(model, t, w)
    at = torch.gather(safe_pos, 1, cols)                               # [B, W]
    rows = torch.arange(b, device=ids.device)[:, None].expand(b, w)
    pages, offs = torch.gather(table.long(), 1, at // ps), at % ps
    for name, layer in pool.items():
        for key, x in layer.items():
            x[pages, offs] = view[name][key][rows, at]
    return pool, log_probs


__all__ = ["DECODE_SEGMENT", "PREFILL_CHUNK_SIZES", "TransformerLM", "decode_nll",
           "decode_step", "decode_step_slots", "filter_logits", "generate",
           "ids_to_images", "init_cache", "init_page_pool", "next_token_loss", "NO_TP",
           "paged_decode_step_slots", "paged_prefill_chunk", "paged_verify_chunk",
           "pages_per_slot", "params_from_jax", "params_to_jax", "pool_page_size",
           "prefill_chunk", "reset_slots", "sample_categorical", "tokenize_images_to_ids",
           "verify_chunk"]
