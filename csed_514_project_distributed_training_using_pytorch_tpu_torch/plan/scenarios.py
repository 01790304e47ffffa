"""Scenarios: one per trainer surface, plus the empirical trial harness.

Counterpart of the JAX package's ``plan/scenarios.py``. A ``Scenario``
(``plan/search.py``) is the bridge between a trainer's config and the abstract cost
model: it pins the model's static stats, the live topology, the batch, and which axes the
trainer can legally execute.

- *Stats.* Parameter bytes are counted exactly from the port's own modules' parameter
  shapes (``param_inits``: the shapes the slots were declared with; nothing is drawn or
  allocated on the device), and the TP-shardable fraction from
  ``parallel.tensor_parallel.spec_for``'s leaf-name rules, so the planner and the trainer
  never disagree about what TP splits. A serving slot's KV bytes are counted from
  ``models.lm.init_cache``'s planes for one slot on the meta device, scale planes
  included.
- *The trial harness* (``--plan tune``) times the trainer's own step on the run's device:
  ``train.composed.build_segment_fn``'s eager segment for the composed trainer (which
  trains eagerly on every device), ``train.step.make_epoch_from_step`` for the LM trainer
  (a CUDA graph on the card, as the trainer runs it). A candidate runs ``TRIAL_STEPS``
  steps over a zero index plan; the warm-up call (the graph's capture on the card) is
  reported as ``compile_s``, then ``TRIAL_REPS`` timed calls, each closed by a host fetch
  of the loss and of a parameter the last update wrote, and the minimum is kept.
  ``flops_per_step`` is ``utils.telemetry.train_step_flops`` of one step. The trial builds
  one-device candidates only: a world of more than one rank never tunes (``plan.resolve``
  degrades ``tune`` to ``auto`` there); any other candidate keeps its analytical
  estimate (None).
- *The trial's model* keeps the JAX rule: the composed trial builds the classifier with
  its default dense core and no ``attention_fn`` (no flash kernel, no window); the flash
  kernels run in the planned run that follows, not in the trial.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan.costs import (
    Candidate,
    ModelStats,
    Topology,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan.search import (
    Scenario,
    ServeScenario,
)

TRIAL_STEPS = 2          # steps per trial call (one segment)
TRIAL_REPS = 2           # timed calls; the minimum is reported

# MNIST geometry the trainers are hard-wired to (data/mnist.py).
_IMAGE_SHAPE = (28, 28, 1)
_LM_SEQ_LEN = 28 * 28
_PARAM_BYTES = 4         # the port's parameters are f32 master weights


def _param_bytes(model) -> tuple[float, float]:
    """(total param bytes, TP-shardable fraction) from the module's declared parameter
    shapes, the shardable set by ``parallel.tensor_parallel.spec_for`` (a leaf split on
    any dim counts whole)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
        tensor_parallel as tp,
    )

    total = sharded = 0.0
    for name, (shape, _) in model.param_inits().items():
        nbytes = float(torch.Size(shape).numel()) * _PARAM_BYTES
        total += nbytes
        if any(e is not None for e in tp.spec_for(name, len(shape))):
            sharded += nbytes
    return total, (sharded / total if total else 0.0)


def _optimizer_mult(optimizer: str, ema: bool) -> float:
    return (2.0 if optimizer == "adamw" else 1.0) + (1.0 if ema else 0.0)


def _transformer_stats(name, model, *, seq_len, embed_dim, num_layers, num_heads,
                       mlp_ratio, dtype_bytes, remat, flash, optimizer_mult) -> ModelStats:
    param_bytes, shardable = _param_bytes(model)
    # Train FLOPs per example: the 6·P·S matmul rule plus the attention score/value
    # einsums (4·S²·E fwd), tripled for backward.
    fwd = 2.0 * param_bytes / 4 * seq_len + 4.0 * num_layers * seq_len ** 2 \
        * embed_dim
    # Resident activations per layer per example: the block's intermediate streams (~attn
    # qkv/out + the mlp_ratio-wide MLP), an order-of-magnitude constant, halved to block
    # inputs under remat.
    act = seq_len * embed_dim * dtype_bytes * (2 if remat else 10 + 2 * mlp_ratio)
    score = 0.0 if flash else num_heads * seq_len ** 2 * 4.0
    return ModelStats(
        name=name, param_bytes=param_bytes, flops_per_example=3.0 * fwd,
        num_layers=num_layers, num_heads=num_heads, seq_len=seq_len,
        embed_dim=embed_dim, dtype_bytes=dtype_bytes,
        act_bytes_per_layer_per_example=act, score_bytes_per_example=score,
        optimizer_mult=optimizer_mult, shardable_fraction=shardable)


def _mlp_ratio(model) -> int:
    """The blocks' MLP width over the embedding width, from the first up-projection."""
    shape = next(shape for name, (shape, _) in model.param_inits().items()
                 if name.endswith("mlp_up_kernel"))
    return shape[1] // model.embed_dim


# --------------------------------------------------------------- trial harness


def _time_segment(segment, state, xs, ys, *, seed: int, flops: float | None,
                  device: torch.device) -> dict:
    """The warm-up call (its seconds are ``compile_s``), then ``TRIAL_REPS`` timed calls
    of ``TRIAL_STEPS`` steps threading the state, each closed by a host fetch of the last
    loss and of a parameter element the last update wrote; the minimum a step."""
    plan = torch.zeros((TRIAL_STEPS, xs.shape[0]), dtype=torch.int64, device=device)
    probe = next(iter(state.params))

    def call(state):
        state, losses = segment(state, xs, ys, plan, seed)
        losses[-1].item()
        state.params[probe].reshape(-1)[0].item()
        return state

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    state = call(state)
    compile_s = time.perf_counter() - t0
    best = None
    for _ in range(TRIAL_REPS):
        t0 = time.perf_counter()
        state = call(state)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return {"step_s": best / TRIAL_STEPS, "compile_s": compile_s, "flops_per_step": flops}


def _trial_config(config, cand: Candidate):
    """The run's config with the candidate's split; dropout, health stats and telemetry
    off (a trial is not a step of the run)."""
    return dataclasses.replace(config, grad_accum=cand.grad_accum, dropout_rate=0.0,
                               health_stats=False, telemetry="")


def _trial_total_steps(config) -> int:
    """The schedule's horizon over the trial's own updates (a cosine schedule needs one
    past its warmup)."""
    return config.warmup_steps + TRIAL_STEPS * (TRIAL_REPS + 1)


def _classifier_trial(config, device: torch.device):
    """The trial of the composed trainer's one-device candidates."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
        TransformerClassifier,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        composed,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
        step_options,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        telemetry as T,
    )

    def trial(cand: Candidate) -> dict | None:
        if cand.num_devices != 1:
            return None          # analytical estimate retained (module doc)
        cfg = _trial_config(config, cand)
        model = TransformerClassifier(
            seq_len=cfg.seq_len, dropout_rate=0.0, causal=cfg.causal,
            dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
            remat=cfg.remat, remat_policy=cfg.remat_policy)
        optimizer, segment = composed.build_segment_fn(
            cfg, model, total_steps=_trial_total_steps(cfg))
        state = create_train_state(model, torch.Generator().manual_seed(0),
                                   optimizer=optimizer, device=device,
                                   ema=cfg.ema_decay > 0)
        xs = torch.zeros((cfg.batch_size,) + _IMAGE_SHAPE, device=device)
        ys = torch.zeros(cfg.batch_size, dtype=torch.int64, device=device)
        step = make_train_step(model, **step_options(cfg, optimizer, None, None),
                               grad_accum=cfg.grad_accum)
        flops = T.train_step_flops(step, state, xs, ys, cfg.seed + 1)
        return _time_segment(segment, state, xs, ys, seed=cfg.seed + 1, flops=flops,
                             device=device)

    return trial


def _lm_trial(config, device: torch.device):
    """The trial of the LM trainer's one-device candidates: the trainer's step with
    its one-rank gradient reduce, as the segment it runs (captured on the card)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
        lm as lm_mod,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
        data_parallel as dp,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        lm as lm_train,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
        create_train_state,
        make_epoch_from_step,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        telemetry as T,
    )

    def trial(cand: Candidate) -> dict | None:
        if cand.num_devices != 1:
            return None
        cfg = _trial_config(config, cand)
        model = lm_mod.TransformerLM(
            vocab_size=cfg.num_levels + 1, seq_len=_LM_SEQ_LEN,
            embed_dim=cfg.embed_dim, num_layers=cfg.num_layers,
            num_heads=cfg.num_heads, dropout_rate=0.0,
            num_kv_heads=cfg.kv_heads or None, rope=cfg.rope,
            dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
            remat=cfg.remat, remat_policy=cfg.remat_policy).to(device)
        optimizer = lm_train.lm_optimizer(cfg)
        state = create_train_state(model, torch.Generator().manual_seed(0),
                                   optimizer=optimizer, device=device,
                                   ema=cfg.ema_decay > 0)
        reducer = dp.GradReducer(state.params) if dist.is_initialized() else None
        steps = _trial_total_steps(cfg)       # the schedule's horizon: epochs x this
        step = lm_train.make_lm_step(model, cfg, optimizer=optimizer,
                                     steps_per_epoch=steps, grad_reduce=reducer)
        segment = make_epoch_from_step(step, grad_reduce=reducer)
        xs = torch.zeros((cfg.batch_size, _LM_SEQ_LEN), dtype=torch.int64, device=device)
        ys = torch.zeros(cfg.batch_size, dtype=torch.int64, device=device)
        flops = T.train_step_flops(
            lm_train.make_lm_step(model, cfg, optimizer=optimizer, steps_per_epoch=steps),
            state, xs, ys, cfg.seed + 1)
        return _time_segment(segment, state, xs, ys, seed=cfg.seed + 1, flops=flops,
                             device=device)

    return trial


# ------------------------------------------------------------------ scenarios


def _topology(topo: Topology | None, device) -> Topology:
    return topo if topo is not None else Topology.detect(device)


def for_composed(config, topo: Topology | None = None, *, device=None) -> Scenario:
    """Scenario for ``train/composed.py``: DP × FSDP × TP × PP over the fixed
    ``TransformerClassifier`` architecture. The stage axis is only offered when the config
    composes with it (the JAX package's rule: not with remat, dropout, flash, zig-zag or
    the sharded checkpoint). ``device`` (default ``config.device``) is where the topology
    is read and the trials run."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
        TransformerClassifier,
    )

    device = torch.device(device if device is not None else config.device)
    topo = _topology(topo, device)
    model = TransformerClassifier(seq_len=config.seq_len, dropout_rate=0.0)
    stats = _transformer_stats(
        "transformer_classifier", model,
        seq_len=config.seq_len, embed_dim=model.embed_dim,
        num_layers=model.num_layers, num_heads=model.num_heads,
        mlp_ratio=_mlp_ratio(model),
        dtype_bytes=2 if config.bf16 else 4, remat=config.remat,
        flash=config.flash_attention,
        optimizer_mult=_optimizer_mult(config.optimizer, config.ema_decay > 0))
    axes = ["data", "model"]
    if not (config.remat or config.dropout_rate or config.zigzag_attention
            or config.flash_attention or config.sharded_checkpoint):
        axes.append("stage")
    return Scenario(run_type="composed", stats=stats, topo=topo,
                    global_batch=config.batch_size, axes=tuple(axes),
                    allow_fsdp=True, allow_grad_accum=True,
                    fixed_grad_accum=config.grad_accum,
                    test_batch=config.batch_size_test,
                    trial=_classifier_trial(config, device))


def for_lm(config, topo: Topology | None = None, *, device=None) -> Scenario:
    """Scenario for ``train/lm.py``: DP × TP over the configured ``TransformerLM`` (the
    LM trainer's mesh supports data/seq/model; the planner searches data/model: a seq
    axis is a context-length decision, not a throughput one)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
        lm as lm_mod,
    )

    device = torch.device(device if device is not None else config.device)
    topo = _topology(topo, device)
    model = lm_mod.TransformerLM(
        vocab_size=config.num_levels + 1, seq_len=_LM_SEQ_LEN,
        embed_dim=config.embed_dim, num_layers=config.num_layers,
        num_heads=config.num_heads, dropout_rate=0.0,
        num_kv_heads=config.kv_heads or None)
    stats = _transformer_stats(
        "transformer_lm", model,
        seq_len=_LM_SEQ_LEN, embed_dim=config.embed_dim,
        num_layers=config.num_layers, num_heads=config.num_heads, mlp_ratio=4,
        dtype_bytes=2 if config.bf16 else 4, remat=config.remat, flash=False,
        optimizer_mult=_optimizer_mult(config.optimizer, config.ema_decay > 0))
    return Scenario(run_type="lm", stats=stats, topo=topo,
                    global_batch=config.batch_size, axes=("data", "model"),
                    allow_fsdp=False, allow_grad_accum=True,
                    fixed_grad_accum=config.grad_accum,
                    trial=_lm_trial(config, device))


def for_cnn(global_batch: int, topo: Topology | None = None, *,
            device="cuda") -> Scenario:
    """Scenario for the reference CNN under plain DP: what a scaling bench validates the
    cost model's predictions against (the paper's own time-vs-machines protocol)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.cnn import (
        Net,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.benchmarks import (
        TRAIN_FLOPS_PER_EXAMPLE,
    )

    topo = _topology(topo, device)
    param_bytes = float(sum(p.numel() for p in Net().parameters())) * _PARAM_BYTES
    # Conv feature maps per example (f32): 24·24·10 + 12·12·10 + 8·8·20 + 4·4·20 + the
    # dense tails, ~36 KB; one "layer" since the planner can't split it.
    stats = ModelStats(
        name="mnist_cnn", param_bytes=param_bytes,
        flops_per_example=float(TRAIN_FLOPS_PER_EXAMPLE), num_layers=1,
        act_bytes_per_layer_per_example=36e3, optimizer_mult=1.0,
        shardable_fraction=0.0)
    return Scenario(run_type="cnn", stats=stats, topo=topo,
                    global_batch=global_batch, axes=("data",),
                    allow_fsdp=False, allow_grad_accum=False)


def for_serve(model, *, num_slots: int, prompt_len: int,
              topo: Topology | None = None, ttft_slo_s: float | None = None,
              kv_dtype: str | None = None, hbm_fraction: float = 0.9,
              measure=None, device="cuda") -> ServeScenario:
    """ServeScenario for a ``models.lm.TransformerLM`` behind the continuous-batching
    engine: param bytes and the TP-shardable fraction from the module's parameter shapes,
    KV bytes per slot from ``models.lm.init_cache``'s planes for ONE slot under
    ``kv_dtype`` (None/``"model"``, ``"int8"``, ``"fp8"``, ...) built on the meta device:
    the quantized layouts' scale planes price themselves, so the planner and the engine's
    ``byte_accounting`` never disagree about what a slot costs. ``measure`` (optional,
    ``(tp, dp) -> tokens/s | None``) hands the final ranking to measurement
    (``plan.search.search_serve``)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
        lm as lm_mod,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import quant
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan.costs import (
        ServeStats,
    )

    topo = _topology(topo, device)
    param_bytes, shardable = _param_bytes(model)
    kv_bytes = float(quant.tree_bytes(lm_mod.init_cache(model, 1, kv_dtype=kv_dtype,
                                                        device="meta")))
    kvh = model.num_kv_heads or model.num_heads
    dtype_bytes = torch.empty((), dtype=model.dtype, device="meta").element_size()
    # Decode forward per token: the 2·P matmul rule plus the attention score/value
    # einsums against the cached prefix (2·2·S·E per layer stack).
    flops_per_token = (2.0 * param_bytes / 4
                       + 4.0 * model.num_layers * model.seq_len * model.embed_dim)
    stats = ServeStats(
        name="transformer_lm_serve", param_bytes=param_bytes,
        kv_bytes_per_slot=kv_bytes,
        prompt_bytes_per_slot=float(model.seq_len * 4),   # int32 prompt row
        flops_per_token=flops_per_token,
        num_layers=model.num_layers, num_heads=model.num_heads,
        num_kv_heads=kvh, seq_len=model.seq_len, embed_dim=model.embed_dim,
        dtype_bytes=dtype_bytes, shardable_fraction=shardable)
    return ServeScenario(stats=stats, topo=topo, num_slots=num_slots,
                         prompt_len=prompt_len, ttft_slo_s=ttft_slo_s,
                         hbm_fraction=hbm_fraction, measure=measure)
