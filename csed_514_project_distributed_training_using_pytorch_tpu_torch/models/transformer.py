"""The transformer classifier family as PyTorch modules.

Counterpart of the JAX package's ``models/transformer.py``: ``TransformerClassifier``
treats an image as a sequence of pixel-chunk tokens (``tokenize_images``) and classifies it
with a pre-LN transformer encoder (``TransformerBlock``: ``x + MHA(LN(x))``, then
``x + MLP(LN(x))``), mean-pooled, emitting f32 log-probabilities — the same call contract
as ``models.cnn.Net``, so ``train/step.py`` runs either.

Parameters keep the JAX package's names and layouts (``block_0.attn.qkv_kernel`` for the
flax path ``block_0/attn/qkv_kernel``; dense kernels ``[in, out]``), so
``params_from_jax`` is a flatten and a copy. They are drawn on the CPU from an explicit
generator (normal(0.02) kernels and position embeddings, zero biases, unit LayerNorm
scales) and stay f32: ``dtype=torch.bfloat16`` casts each weight where it is used, as the
JAX package does. The attention core is pluggable (``attention_fn(q, k, v, *, causal)`` on
``[B, S, H, D]``): the dense ``ops.full_attention`` by default, or the flash kernels
(``ops.flash_attention``).

Rematerialization (``remat``; ``remat_call``) recomputes each block in the backward, as the
JAX package's ``flax.linen.remat`` does: ``torch.utils.checkpoint`` (non-reentrant) around
the block, with the block's parameters passed in (``torch.func.functional_call`` swaps them
back after the forward, so the recomputation must not read them off the module), and the
dropout masks redrawn from the step's ``ops.nn.DropoutStream`` at the draw the block first
made, so the recomputation sees the forward's masks. ``remat_policy`` ``"save-dots"`` keeps
the matmul outputs (``mm``, ``bmm``, ``addmm``) and recomputes the rest (a selective
checkpoint, ``jax.checkpoint_policies.dots_saveable``'s counterpart). A policy changes only
what is saved: the trajectory is bitwise the one without remat.

Not ported yet (ROADMAP A10): the Switch/GShard MoE feed-forward (``num_experts > 0``) and
the expert mesh; each raises ``ValueError``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils import checkpoint as torch_checkpoint

from csed_514_project_distributed_training_using_pytorch_tpu_torch import ops
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.cnn import (
    param_count,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.nn import (
    DropoutStream,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.rotary import (
    apply_rotary,
)

NORMAL, ZEROS, ONES = "normal", "zeros", "ones"   # initializers, by parameter
INIT_STDDEV = 0.02
NUM_HEADS = 4            # the classifier's heads; a K/V head count must divide it


def tokenize_images(x: torch.Tensor, seq_len: int) -> torch.Tensor:
    """``[B, H, W, C]`` images -> ``[B, seq_len, feat]`` pixel-chunk tokens. The flat pixel
    stream is zero-padded up to ``seq_len·ceil(total/seq_len)``, so any seq_len tokenizes
    (at seq_len 2048, 784 pixels give one feature per token and 1264 zero tokens)."""
    b = x.shape[0]
    total = x.shape[1] * x.shape[2] * x.shape[3]
    feat = -(-total // seq_len)
    flat = x.reshape(b, total)
    if total % seq_len:
        flat = nn.functional.pad(flat, (0, seq_len * feat - total))
    return flat.reshape(b, seq_len, feat)


class _Slots(nn.Module):
    """A module whose parameters are slots declared with their initializer: training
    passes a parameter dict through ``torch.func.functional_call``, so the module's own
    tensors are placeholders (filled once, so that a direct call is defined)."""

    def _slot(self, name: str, shape: tuple[int, ...], init: str) -> None:
        self.register_parameter(name, nn.Parameter(torch.empty(shape), requires_grad=False))
        self._inits = {**getattr(self, "_inits", {}), name: init}

    def param_inits(self, prefix: str = "") -> dict[str, tuple[tuple[int, ...], str]]:
        """``{name: (shape, initializer)}`` of every parameter, in definition order."""
        specs = {}
        for name, init in getattr(self, "_inits", {}).items():
            specs[prefix + name] = (tuple(getattr(self, name).shape), init)
        for child_name, child in self.named_children():
            specs.update(child.param_inits(f"{prefix}{child_name}."))
        return specs

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
        """A fresh f32 parameter dict drawn on the CPU from ``generator`` (normal(0.02),
        zeros, ones by parameter), then moved to ``device``."""
        params = {}
        for name, (shape, init) in self.param_inits().items():
            if init == NORMAL:
                t = torch.empty(shape).normal_(0.0, INIT_STDDEV, generator=generator)
            else:
                t = torch.zeros(shape) if init == ZEROS else torch.ones(shape)
            params[name] = t.to(device)
        return params

    def _fill_slots(self) -> None:
        """Give the placeholder parameters values (seed 0), so that a direct call is
        defined."""
        with torch.no_grad():
            for name, value in self.init(torch.Generator().manual_seed(0)).items():
                self.get_parameter(name).copy_(value)


class MultiHeadSelfAttention(_Slots):
    """Multi-head self-attention with a pluggable core.

    MHA (``num_kv_heads`` None or equal to ``num_heads``) uses one fused ``qkv_kernel``;
    grouped-query attention (fewer K/V heads) uses ``q_kernel`` and ``kv_kernel`` and
    repeats each K/V head over its query-head group before the core, after RoPE."""

    def __init__(self, embed_dim: int, num_heads: int, num_kv_heads: int | None = None, *,
                 attention_fn: Callable = ops.full_attention, causal: bool = False,
                 rope: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed dim {embed_dim} not divisible by {num_heads} heads")
        kv_heads = num_kv_heads or num_heads
        if kv_heads < 1 or num_heads % kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by num_kv_heads "
                             f"{kv_heads} (need a positive divisor)")
        self.num_heads, self.kv_heads = num_heads, kv_heads
        self.head_dim = embed_dim // num_heads
        self.attention_fn, self.causal, self.rope, self.dtype = (
            attention_fn, causal, rope, dtype)
        e = embed_dim
        if kv_heads == num_heads:
            self._slot("qkv_kernel", (e, 3 * e), NORMAL)
            self._slot("qkv_bias", (3 * e,), ZEROS)
        else:
            kv_width = 2 * kv_heads * self.head_dim
            self._slot("q_kernel", (e, e), NORMAL)
            self._slot("q_bias", (e,), ZEROS)
            self._slot("kv_kernel", (e, kv_width), NORMAL)
            self._slot("kv_bias", (kv_width,), ZEROS)
        self._slot("out_kernel", (e, e), NORMAL)
        self._slot("out_bias", (e,), ZEROS)

    def _dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w, b = getattr(self, f"{name}_kernel"), getattr(self, f"{name}_bias")
        return ops.dense(x, w.to(self.dtype), b.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, e = x.shape
        h, d = self.num_heads, self.head_dim
        if self.kv_heads == h:
            qkv = self._dense(x, "qkv").reshape(b, s, 3, h, d)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = self._dense(x, "q").reshape(b, s, h, d)
            kv = self._dense(x, "kv").reshape(b, s, 2, self.kv_heads, d)
            k, v = kv[:, :, 0], kv[:, :, 1]
        if self.rope:
            positions = torch.arange(s, device=x.device)
            q, k = apply_rotary(q, positions), apply_rotary(k, positions)
        if self.kv_heads != h:
            rep = h // self.kv_heads
            k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        out = self.attention_fn(q, k, v, causal=self.causal).reshape(b, s, e)
        return self._dense(out, "out")


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy_fn(name: str):
    """A ``--remat-policy`` name as a ``torch.utils.checkpoint`` ``context_fn``, or None
    for the default (save nothing). ``"recompute-all"`` (and ``""``) recomputes the whole
    block; ``"save-dots"`` keeps the matmul outputs and recomputes the elementwise work
    between them."""
    if name in ("", "recompute-all"):
        return None
    if name == "save-dots":
        return functools.partial(torch_checkpoint.create_selective_checkpoint_contexts,
                                 _save_dots)
    raise ValueError(f"unknown remat policy {name!r} — choose "
                     f"'recompute-all' or 'save-dots'")


def validate_remat_policy(remat: bool, remat_policy: str) -> None:
    """The shared fail-fast of every ``--remat-policy`` surface: the policy modifies
    ``--remat`` (alone it does nothing), and the name must be known."""
    if remat_policy:
        if not remat:
            raise ValueError("--remat-policy modifies --remat; add --remat")
        remat_policy_fn(remat_policy)   # raises on unknown names


def remat_call(block: nn.Module, x: torch.Tensor, deterministic: bool, generator, *,
               policy: str = "") -> torch.Tensor:
    """``block(x, deterministic, generator)``, rematerialized: its activations are
    recomputed in the backward instead of saved (all of them, or all but the matmul
    outputs under ``policy="save-dots"``).

    The block's parameters as it reads them now (``functional_call``'s tensors) are
    arguments of the checkpointed function, and a ``DropoutStream`` is replayed from the
    draw the block starts at, so the recomputation sees the forward's parameters and
    masks. A ``torch.Generator`` would draw new masks, so dropout with one raises."""
    names = list(block.param_inits())
    leaves = [_attr(block, n) for n in names]
    stream = generator if isinstance(generator, DropoutStream) else None
    if (stream is None and generator is not None and not deterministic
            and getattr(block, "dropout_rate", 0.0)):
        raise ValueError("remat with dropout needs the step's DropoutStream: a "
                         "torch.Generator would draw other masks in the recomputation")
    start = stream.draws if stream is not None else 0
    replays = []

    def run(x, *leaves):
        g = generator
        if stream is not None:
            g = stream.replay_from(start)
            replays.append(g)
        return functional_call(block, dict(zip(names, leaves)), (x, deterministic, g))

    context_fn = remat_policy_fn(policy)
    kwargs = {"context_fn": context_fn} if context_fn is not None else {}
    out = torch_checkpoint.checkpoint(run, x, *leaves, use_reentrant=False,
                                      preserve_rng_state=False, **kwargs)
    if stream is not None:
        stream.draws = replays[0].draws      # the forward's draws, for the next block
    return out


def _attr(module: nn.Module, dotted: str) -> torch.Tensor:
    for part in dotted.split("."):
        module = getattr(module, part)
    return module


class TransformerBlock(_Slots):
    """Pre-LN encoder block with the dense MLP: ``x + MHA(LN(x))``, ``x + MLP(LN(x))``."""

    def __init__(self, embed_dim: int, num_heads: int, num_kv_heads: int | None = None, *,
                 mlp_ratio: int = 4, dropout_rate: float = 0.1,
                 attention_fn: Callable = ops.full_attention, causal: bool = False,
                 rope: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        e, hidden = embed_dim, mlp_ratio * embed_dim
        self.dropout_rate, self.dtype = dropout_rate, dtype
        self._slot("ln1_scale", (e,), ONES)
        self._slot("ln1_bias", (e,), ZEROS)
        self.attn = MultiHeadSelfAttention(e, num_heads, num_kv_heads,
                                           attention_fn=attention_fn, causal=causal,
                                           rope=rope, dtype=dtype)
        self._slot("ln2_scale", (e,), ONES)
        self._slot("ln2_bias", (e,), ZEROS)
        self._slot("mlp_up_kernel", (e, hidden), NORMAL)
        self._slot("mlp_up_bias", (hidden,), ZEROS)
        self._slot("mlp_down_kernel", (hidden, e), NORMAL)
        self._slot("mlp_down_bias", (e,), ZEROS)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cast = lambda w: w.to(self.dtype)
        h = self.attn(ops.layer_norm(x, self.ln1_scale, self.ln1_bias))
        h = ops.dropout(generator, h, self.dropout_rate, deterministic=deterministic)
        x = x + h
        h = ops.layer_norm(x, self.ln2_scale, self.ln2_bias)
        h = ops.gelu(ops.dense(h, cast(self.mlp_up_kernel), cast(self.mlp_up_bias)))
        h = ops.dense(h, cast(self.mlp_down_kernel), cast(self.mlp_down_bias))
        h = ops.dropout(generator, h, self.dropout_rate, deterministic=deterministic)
        return x + h


class TransformerClassifier(_Slots):
    """Image classifier over a pixel-token sequence, emitting log-probabilities.

    Takes ``[B, 28, 28, 1]`` images (tokenized to ``seq_len`` tokens) or pre-tokenized
    ``[B, seq_len, token_features]`` input; ``token_features`` defaults to what the images
    tokenize to, ``ceil(784 / seq_len)``. Returns ``[B, num_classes]`` f32 log-probs."""

    def __init__(self, num_classes: int = 10, seq_len: int = 16, embed_dim: int = 64,
                 num_layers: int = 2, num_heads: int = NUM_HEADS,
                 num_kv_heads: int | None = None,
                 mlp_ratio: int = 4, dropout_rate: float = 0.1,
                 attention_fn: Callable = ops.full_attention, causal: bool = False,
                 rope: bool = False, dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = "", num_experts: int = 0,
                 expert_mesh: object = None, token_features: int | None = None):
        super().__init__()
        if num_experts > 0 or expert_mesh is not None:
            raise ValueError("the MoE feed-forward (num_experts > 0, the expert mesh) is "
                             "not ported yet (ROADMAP A10)")
        validate_remat_policy(remat, remat_policy)
        self.remat, self.remat_policy = remat, remat_policy
        self.num_classes, self.seq_len, self.embed_dim = num_classes, seq_len, embed_dim
        self.num_layers, self.num_heads, self.num_kv_heads = num_layers, num_heads, num_kv_heads
        self.dropout_rate, self.causal, self.rope, self.dtype = (
            dropout_rate, causal, rope, dtype)
        feat = token_features or math.ceil(28 * 28 / seq_len)
        self._slot("embed_kernel", (feat, embed_dim), NORMAL)
        self._slot("embed_bias", (embed_dim,), ZEROS)
        self._slot("pos_embed", (seq_len, embed_dim), NORMAL)
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                embed_dim, num_heads, num_kv_heads, mlp_ratio=mlp_ratio,
                dropout_rate=dropout_rate, attention_fn=attention_fn, causal=causal,
                rope=rope, dtype=dtype))
        self._slot("ln_f_scale", (embed_dim,), ONES)
        self._slot("ln_f_bias", (embed_dim,), ZEROS)
        self._slot("head_kernel", (embed_dim, num_classes), NORMAL)
        self._slot("head_bias", (num_classes,), ZEROS)
        self._fill_slots()

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if x.dim() == 4:
            x = tokenize_images(x, self.seq_len)
        if x.shape[1] != self.seq_len:
            raise ValueError(f"expected seq_len {self.seq_len}, got {x.shape[1]}")
        cast = lambda w: w.to(self.dtype)
        h = ops.dense(x.to(self.dtype), cast(self.embed_kernel), cast(self.embed_bias))
        h = h + cast(self.pos_embed)[None]
        h = run_blocks(self, h, deterministic, generator)
        h = ops.layer_norm(h, self.ln_f_scale, self.ln_f_bias).mean(dim=1)
        logits = ops.dense(h, cast(self.head_kernel), cast(self.head_bias))
        return ops.log_softmax(logits.float())


def run_blocks(model: nn.Module, h: torch.Tensor, deterministic: bool,
               generator) -> torch.Tensor:
    """``model``'s blocks ``block_0 .. block_{num_layers-1}`` in order, each through
    ``remat_call`` when ``model.remat`` is set."""
    for i in range(model.num_layers):
        block = getattr(model, f"block_{i}")
        if model.remat:
            h = remat_call(block, h, deterministic, generator, policy=model.remat_policy)
        else:
            h = block(h, deterministic, generator)
    return h


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """Flatten the JAX package's nested parameter tree (``block_0/attn/qkv_kernel``, ...)
    into this module's f32 parameter dict (``block_0.attn.qkv_kernel``, ...)."""
    flat = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, dict) or hasattr(value, "items"):
                walk(value, f"{prefix}{key}.")
            else:
                flat[prefix + key] = torch.tensor(np.asarray(value, dtype=np.float32))

    walk(params, "")
    return flat


def params_to_jax(params: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``params_from_jax``: the flat dict as the JAX package's nested tree
    (``block_0.attn.qkv_kernel`` -> ``["block_0"]["attn"]["qkv_kernel"]``) of host numpy
    arrays, every dict's keys in sorted order, as the JAX package's checkpoints hold them.
    The layouts are the same, so the values are bitwise the same."""
    tree: dict = {}
    for name, value in params.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(value.detach().cpu().numpy())

    def ordered(node):
        return {k: ordered(node[k]) if isinstance(node[k], dict) else node[k]
                for k in sorted(node)}

    return ordered(tree)


__all__ = ["MultiHeadSelfAttention", "TransformerBlock", "TransformerClassifier",
           "param_count", "params_from_jax", "params_to_jax", "remat_call",
           "remat_policy_fn", "run_blocks", "tokenize_images", "validate_remat_policy"]
