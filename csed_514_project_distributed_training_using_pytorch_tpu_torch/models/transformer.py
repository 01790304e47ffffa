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

The mesh (``shard``, a ``parallel.mesh.ShardContext``; ``NO_SHARDING`` runs one device,
bitwise the model without a grid):

- under a ``model`` axis of ``n`` ranks each block runs its ``H/n`` local heads and
  ``4E/n`` hidden units (``parallel.tensor_parallel``'s column/row split): Megatron's *f*
  (``collectives.copy_to_group``) before the QKV and MLP-up projections, *g*
  (``collectives.reduce_from_group``) after the attention-out and MLP-down projections,
  and the row-parallel biases added after *g*. The dropouts sit on the replicated
  activations, so every model rank draws the same masks;
- ``num_experts > 0`` makes each block's feed-forward the routed MoE
  (``parallel.expert_parallel.moe_apply``: ``expert_top_k`` 1 is Switch, 2 GShard,
  ``expert_capacity_factor`` its capacity), expert-parallel over the ``expert`` axis.
  The blocks return their load-balance auxiliaries, and the classifier's ``with_aux``
  call sums them for the step (``train.step``'s ``aux_loss_weight``);
- ``shard.fsdp`` names the leaves split over ``data`` (``parallel.fsdp``): the classifier
  gathers its own where it uses them and each block's just before the block runs, inside
  the rematerialized function under ``remat``, so the recomputation gathers again.
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
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
    expert_parallel,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.fsdp import (
    gather_leaf,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    NO_SHARDING,
    ShardContext,
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
    repeats each K/V head over its query-head group before the core, after RoPE. Under a
    model axis the projections hold this rank's heads (query and K/V heads must divide
    by its size) and the core sees only them."""

    def __init__(self, embed_dim: int, num_heads: int, num_kv_heads: int | None = None, *,
                 attention_fn: Callable = ops.full_attention, causal: bool = False,
                 rope: bool = False, dtype: torch.dtype = torch.float32,
                 shard: ShardContext = NO_SHARDING):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed dim {embed_dim} not divisible by {num_heads} heads")
        kv_heads = num_kv_heads or num_heads
        if kv_heads < 1 or num_heads % kv_heads:
            raise ValueError(f"num_heads {num_heads} not divisible by num_kv_heads "
                             f"{kv_heads} (need a positive divisor)")
        m = shard.model.size
        if num_heads % m or kv_heads % m:
            raise ValueError(f"{num_heads} query and {kv_heads} K/V heads do not split over "
                             f"the model axis of {m}")
        self.num_heads, self.kv_heads, self.shard = num_heads, kv_heads, shard
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
        model = self.shard.model
        h, d, kv_heads = (self.num_heads // model.size, self.head_dim,
                          self.kv_heads // model.size)
        if model.size > 1:
            x = collectives.copy_to_group(x, model.group)        # Megatron's f
        if self.kv_heads == self.num_heads:
            qkv = self._dense(x, "qkv").reshape(b, s, 3, h, d)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q = self._dense(x, "q").reshape(b, s, h, d)
            kv = self._dense(x, "kv").reshape(b, s, 2, kv_heads, d)
            k, v = kv[:, :, 0], kv[:, :, 1]
        if self.rope:
            positions = torch.arange(s, device=x.device)
            q, k = apply_rotary(q, positions), apply_rotary(k, positions)
        if kv_heads != h:
            rep = h // kv_heads
            k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        out = self.attention_fn(q, k, v, causal=self.causal).reshape(b, s, h * d)
        if model.size == 1:
            return self._dense(out, "out")
        out = ops.dense(out, self.out_kernel.to(self.dtype))     # the local rows' part
        return collectives.reduce_from_group(out, model.group) + self.out_bias.to(self.dtype)


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
               policy: str = "", prepare: Callable | None = None):
    """``block(x, deterministic, generator)``, rematerialized: its activations are
    recomputed in the backward instead of saved (all of them, or all but the matmul
    outputs under ``policy="save-dots"``).

    The block's parameters as it reads them now (``functional_call``'s tensors) are
    arguments of the checkpointed function, and a ``DropoutStream`` is replayed from the
    draw the block starts at, so the recomputation sees the forward's parameters and
    masks. A ``torch.Generator`` would draw new masks, so dropout with one raises.
    ``prepare(leaves)`` maps the leaves inside the recomputed function (FSDP's gathers,
    which the recomputation then runs again)."""
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
        params = dict(zip(names, leaves))
        if prepare is not None:
            params = prepare(params)
        return functional_call(block, params, (x, deterministic, g))

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
    """Pre-LN encoder block: ``x + MHA(LN(x))``, then ``x + MLP(LN(x))`` with the dense
    MLP, or with ``num_experts > 0`` the routed MoE feed-forward (the expert-stacked
    leaves and the router keep ``expert_parallel``'s names), in which case the block
    returns ``(x, aux)``, its load-balance auxiliary beside it."""

    def __init__(self, embed_dim: int, num_heads: int, num_kv_heads: int | None = None, *,
                 mlp_ratio: int = 4, dropout_rate: float = 0.1,
                 attention_fn: Callable = ops.full_attention, causal: bool = False,
                 rope: bool = False, dtype: torch.dtype = torch.float32,
                 num_experts: int = 0, expert_capacity_factor: float = 1.25,
                 expert_top_k: int = 1, shard: ShardContext = NO_SHARDING):
        super().__init__()
        e, hidden = embed_dim, mlp_ratio * embed_dim
        self.dropout_rate, self.dtype, self.shard = dropout_rate, dtype, shard
        self.num_experts, self.expert_capacity_factor, self.expert_top_k = (
            num_experts, expert_capacity_factor, expert_top_k)
        if hidden % shard.model.size:
            raise ValueError(f"MLP hidden {hidden} does not split over the model axis of "
                             f"{shard.model.size}")
        if num_experts and num_experts % shard.expert.size:
            raise ValueError(f"{num_experts} experts do not split over the expert axis of "
                             f"{shard.expert.size}")
        self._slot("ln1_scale", (e,), ONES)
        self._slot("ln1_bias", (e,), ZEROS)
        self.attn = MultiHeadSelfAttention(e, num_heads, num_kv_heads,
                                           attention_fn=attention_fn, causal=causal,
                                           rope=rope, dtype=dtype, shard=shard)
        self._slot("ln2_scale", (e,), ONES)
        self._slot("ln2_bias", (e,), ZEROS)
        if num_experts > 0:
            self._slot("router_kernel", (e, num_experts), NORMAL)
            self._slot("up_kernel", (num_experts, e, hidden), NORMAL)
            self._slot("up_bias", (num_experts, hidden), ZEROS)
            self._slot("down_kernel", (num_experts, hidden, e), NORMAL)
            self._slot("down_bias", (num_experts, e), ZEROS)
        else:
            self._slot("mlp_up_kernel", (e, hidden), NORMAL)
            self._slot("mlp_up_bias", (hidden,), ZEROS)
            self._slot("mlp_down_kernel", (hidden, e), NORMAL)
            self._slot("mlp_down_bias", (e,), ZEROS)

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        cast = lambda w: w.to(self.dtype)
        model = self.shard.model
        if model.size == 1:
            h = ops.gelu(ops.dense(h, cast(self.mlp_up_kernel), cast(self.mlp_up_bias)))
            return ops.dense(h, cast(self.mlp_down_kernel), cast(self.mlp_down_bias))
        h = collectives.copy_to_group(h, model.group)               # Megatron's f
        h = ops.gelu(ops.dense(h, cast(self.mlp_up_kernel), cast(self.mlp_up_bias)))
        h = ops.dense(h, cast(self.mlp_down_kernel))                 # the local rows' part
        return collectives.reduce_from_group(h, model.group) + cast(self.mlp_down_bias)

    def _moe(self, h: torch.Tensor):
        b, s, e = h.shape
        params = {k: getattr(self, k).to(self.dtype) for k in
                  ("router_kernel", "up_kernel", "up_bias", "down_kernel", "down_bias")}
        shard = self.shard
        routed, aux = expert_parallel.moe_apply(
            params, h.to(self.dtype).reshape(b * s, e),
            capacity_factor=self.expert_capacity_factor, num_selected=self.expert_top_k,
            expert=shard.expert, data=shard.data if shard.tokens_sharded else None)
        return routed.reshape(b, s, e), aux

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None):
        h = self.attn(ops.layer_norm(x, self.ln1_scale, self.ln1_bias))
        h = ops.dropout(generator, h, self.dropout_rate, deterministic=deterministic)
        x = x + h
        h = ops.layer_norm(x, self.ln2_scale, self.ln2_bias)
        aux = None
        if self.num_experts > 0:
            h, aux = self._moe(h)
        else:
            h = self._mlp(h)
        h = ops.dropout(generator, h, self.dropout_rate, deterministic=deterministic)
        return x + h if aux is None else (x + h, aux)


class TransformerClassifier(_Slots):
    """Image classifier over a pixel-token sequence, emitting log-probabilities.

    Takes ``[B, 28, 28, 1]`` images (tokenized to ``seq_len`` tokens) or pre-tokenized
    ``[B, seq_len, token_features]`` input; ``token_features`` defaults to what the images
    tokenize to, ``ceil(784 / seq_len)``. Returns ``[B, num_classes]`` f32 log-probs, and
    with ``with_aux=True`` the blocks' summed MoE auxiliary beside them."""

    def __init__(self, num_classes: int = 10, seq_len: int = 16, embed_dim: int = 64,
                 num_layers: int = 2, num_heads: int = NUM_HEADS,
                 num_kv_heads: int | None = None,
                 mlp_ratio: int = 4, dropout_rate: float = 0.1,
                 attention_fn: Callable = ops.full_attention, causal: bool = False,
                 rope: bool = False, dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = "", num_experts: int = 0,
                 expert_capacity_factor: float = 1.25, expert_top_k: int = 1,
                 shard: ShardContext = NO_SHARDING, token_features: int | None = None):
        super().__init__()
        validate_remat_policy(remat, remat_policy)
        self.num_experts, self.shard = num_experts, shard
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
                rope=rope, dtype=dtype, num_experts=num_experts,
                expert_capacity_factor=expert_capacity_factor, expert_top_k=expert_top_k,
                shard=shard))
        self._slot("ln_f_scale", (embed_dim,), ONES)
        self._slot("ln_f_bias", (embed_dim,), ZEROS)
        self._slot("head_kernel", (embed_dim, num_classes), NORMAL)
        self._slot("head_bias", (num_classes,), ZEROS)
        self._fill_slots()

    def _leaf(self, name: str) -> torch.Tensor:
        """One of the classifier's own leaves as the forward uses it: gathered over
        ``data`` where FSDP splits it."""
        dims = self.shard.fsdp_dims
        return gather_leaf(getattr(self, name), dims.get(name), self.shard.data)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None, with_aux: bool = False):
        if x.dim() == 4:
            x = tokenize_images(x, self.seq_len)
        if x.shape[1] != self.seq_len:
            raise ValueError(f"expected seq_len {self.seq_len}, got {x.shape[1]}")
        w = lambda name: self._leaf(name).to(self.dtype)
        h = ops.dense(x.to(self.dtype), w("embed_kernel"), w("embed_bias"))
        h = h + w("pos_embed")[None]
        aux = []
        h = run_blocks(self, h, deterministic, generator, aux=aux)
        h = ops.layer_norm(h, self._leaf("ln_f_scale"), self._leaf("ln_f_bias")).mean(dim=1)
        logits = ops.dense(h, w("head_kernel"), w("head_bias"))
        out = ops.log_softmax(logits.float())
        return (out, sum(aux)) if with_aux else out


def run_blocks(model: nn.Module, h: torch.Tensor, deterministic: bool,
               generator, *, aux: list | None = None) -> torch.Tensor:
    """``model``'s blocks ``block_0 .. block_{num_layers-1}`` in order, each through
    ``remat_call`` when ``model.remat`` is set. A block's FSDP-split leaves are gathered
    just before it runs (inside the rematerialized function); an MoE block's auxiliary
    is appended to ``aux``."""
    shard = getattr(model, "shard", NO_SHARDING)
    for i in range(model.num_layers):
        block = getattr(model, f"block_{i}")
        dims = {n[len(f"block_{i}."):]: d for n, d in shard.fsdp
                if n.startswith(f"block_{i}.")}
        prepare = None
        if dims:
            prepare = lambda leaves, dims=dims: {
                n: gather_leaf(p, dims.get(n), shard.data) for n, p in leaves.items()}
        if model.remat:
            out = remat_call(block, h, deterministic, generator, policy=model.remat_policy,
                             prepare=prepare)
        elif prepare is not None:
            names = list(block.param_inits())
            out = functional_call(block, prepare({n: _attr(block, n) for n in names}),
                                  (h, deterministic, generator))
        else:
            out = block(h, deterministic, generator)
        if isinstance(out, tuple):
            h, block_aux = out
            if aux is not None:
                aux.append(block_aux)
        else:
            h = out
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
