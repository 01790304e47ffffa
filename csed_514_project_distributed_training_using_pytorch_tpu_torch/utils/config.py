"""Configuration of the port's trainers (the single-process CNN trainer, the data-parallel
CNN trainer, the composed transformer trainer and the pixel-LM trainer).

Counterpart of the JAX package's ``utils/config.py``, holding only the knobs this port
implements, with the JAX package's names and defaults (the reference's values), plus
``device``. Every field is a ``--flag``; a flag the port does not implement is an argparse
error, never silently ignored (abbreviations are off for the same reason). The training
step's options (``StepOptions``: optimizer, schedule, clipping, label smoothing, EMA,
gradient accumulation, the guard, the segment program's knobs) are shared by the three
trainers; ``check_step_options`` refuses the values the port does not run.
The run's options (``RunOptions``: checkpoints and resume, plots, profiling, heartbeats and
preemption) are the two CNN trainers'; the composed trainer takes all of them but the plots
(``ResilienceOptions``), as in the JAX package. The model's knobs (``ModelKnobs``:
``--bf16`` and the transformer family's) are shared by the three; ``--model`` is the two CNN
trainers' (``ModelOptions``).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class StepOptions:
    """The training step's options, with the JAX package's names and defaults."""

    optimizer: str = "sgd"            # 'sgd' (the reference's) or 'adamw' (torch AdamW
                                      # semantics; momentum is then unused)
    weight_decay: float = 0.0         # AdamW decoupled weight decay (adamw only)
    lr_schedule: str = "constant"     # 'constant' or 'cosine' (half-period decay over the
                                      # run), evaluated on the device-resident step count
    warmup_steps: int = 0             # linear warmup ramp over the first N updates
    clip_grad_norm: float = 0.0       # clip gradients to this global norm before the
                                      # update (torch clip_grad_norm_ semantics); 0 off
    label_smoothing: float = 0.0      # torch CrossEntropyLoss(label_smoothing=s)
    ema_decay: float = 0.0            # keep an EMA of the params (torch swa_utils
                                      # semantics); eval uses the EMA weights; 0 off
    grad_accum: int = 1               # accumulate gradients over N equal microbatches
                                      # per optimizer step
    guard: bool = False               # the numerical guard: a non-finite or z-score
                                      # verdict inside the step, the identity update on
                                      # a poisoned step (train/step.py::GuardSpec)
    guard_zscore: float = 8.0         # spike threshold: grad norm above
                                      # ema_mean + z*max(ema_std, 0.5*ema_mean)
    anomaly_exit: int = 0             # exit 65 ("poisoned") at the epoch boundary once
                                      # >= N anomalies were detected; 0 never
    skip_steps: str = ""              # half-open step windows "a:b[,c:d]" that take the
                                      # identity update (a supervisor's replay)
    scan_unroll: int = 1              # the JAX scan's unroll; only 1 (a captured segment
                                      # has no loop body to unroll, ROADMAP A4)
    pregather: bool = False           # gather each segment's batches in one index_select
                                      # up front instead of one a step
    health_stats: bool = False        # the segment's health accumulators (grad-norm
                                      # mean/max, loss min/max/mean), emitted as one
                                      # 'health' telemetry event an epoch; needs
                                      # --telemetry
    telemetry: str = ""               # the JSONL run-telemetry stream's path
                                      # (utils/telemetry.py); empty off


def check_scan_unroll(unroll: int) -> None:
    """Raise unless ``unroll`` is 1: the JAX scan's unroll has no counterpart."""
    if unroll != 1:
        raise ValueError(f"--scan-unroll {unroll}: a captured segment has no loop body to "
                         f"unroll (each of its steps is laid out in the CUDA graph); only "
                         f"1 is accepted (ROADMAP A4)")


def check_health_stats(config) -> None:
    """``--health-stats`` writes 'health' telemetry events and nothing else: the JAX
    package's refusal without ``--telemetry``."""
    if config.health_stats and not config.telemetry:
        raise ValueError("--health-stats emits telemetry 'health' events and has no "
                         "other output — pass --telemetry PATH too")


def check_step_options(config: StepOptions) -> None:
    """Raise on the step options the port does not run, naming the ROADMAP item, before a
    trainer touches any data."""
    check_health_stats(config)
    check_scan_unroll(config.scan_unroll)
    if config.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {config.grad_accum}")


@dataclass(frozen=True)
class ResilienceOptions:
    """The run options every image trainer takes, with the JAX package's names and
    defaults: checkpoints and resume, profiling, heartbeats and preemption."""

    resume_from: str = ""             # a checkpoint to resume from (a full train state:
                                      # results_dir/model.ckpt, model_dist.ckpt or a
                                      # versioned store file)
    keep_checkpoints: int = 0         # also keep the last N per-epoch checkpoints under
                                      # results_dir/checkpoints/ with a checksummed
                                      # manifest (utils/checkpoint.py); 0 off
    async_checkpoint: bool = False    # write checkpoints on a background thread (the
                                      # host copy stays on the loop; atomic, coalescing
                                      # overwrites; flushed at exit)
    profile: bool = False             # a torch.profiler trace of the run (rank 0)
    profile_dir: str = "results/profile"
    heartbeat_dir: str = ""           # a per-process liveness file each epoch
                                      # (resilience/heartbeat.py); "" off
    handle_preemption: bool = False   # SIGTERM/SIGINT request a cooperative stop at the
                                      # next epoch boundary: checkpoint, then exit 75
                                      # (resilience/preemption.py)


@dataclass(frozen=True)
class RunOptions(ResilienceOptions):
    """The CNN trainers' run options: ``ResilienceOptions`` and the plots."""

    images_dir: str = "images"        # the sample grid and the loss curves go here


@dataclass(frozen=True)
class ModelKnobs:
    """The model knobs every classifier trainer takes, with the JAX package's names and
    defaults (``models.build_model`` maps them; all but ``bf16`` apply to the transformer
    family only)."""

    bf16: bool = False                # bfloat16 activations, f32 master weights and
                                      # f32 softmax/loss statistics
    remat: bool = False               # recompute each transformer block in the backward
    remat_policy: str = ""            # what remat saves: 'recompute-all' (default) or
                                      # 'save-dots' (the matmul outputs)
    causal: bool = False              # decoder-style (causal) attention
    attention_window: int = 0         # sliding-window attention width; 0 full
    kv_heads: int = 0                 # grouped-query K/V heads (0 = MHA); divides 4
    rope: bool = False                # rotary position embeddings on q/k


@dataclass(frozen=True)
class ModelOptions(ModelKnobs):
    """The CNN trainers' model options: ``--model`` and ``ModelKnobs``."""

    model: str = "cnn"                # 'cnn' (the reference's Net) or 'transformer'
                                      # (models/transformer.py), same data and trainer


def model_options(config: ModelKnobs) -> dict:
    """``models.build_model``'s keyword arguments (the knobs) from a trainer's config."""
    return {f.name: getattr(config, f.name) for f in dataclasses.fields(ModelKnobs)}


@dataclass(frozen=True)
class SingleProcessConfig(StepOptions, RunOptions, ModelOptions):
    """Knobs of the single-process trainer."""

    n_epochs: int = 3
    batch_size_train: int = 64
    batch_size_test: int = 1000
    learning_rate: float = 0.01
    momentum: float = 0.5
    log_interval: int = 10
    seed: int = 1
    data_dir: str = "files"           # MNIST IDX files; the synthetic split without them
    download_data: bool = False       # fetch the MNIST IDX archives into data_dir first
                                      # (torchvision download=True, src/train.py:26-31;
                                      # off by default: it needs the network)
    results_dir: str = "results"      # model.ckpt, metrics.jsonl and the store go here
    max_train_examples: int = 0       # truncate the splits (0 = all)
    max_test_examples: int = 0
    use_pallas_kernels: bool = False  # the fused loss/optimizer kernels
                                      # (ops/fused_kernels.py: CUDA on the card); the
                                      # name is the JAX package's flag
    use_host_pipeline: bool = False   # feed host batches through the native C++
                                      # threaded prefetcher (the DataLoader num_workers=4
                                      # counterpart, src/train_dist.py:43-45), one step a
                                      # batch, instead of the device-resident segments;
                                      # same plan, same math
    device: str = "cuda"              # 'cuda' (the default: raises when no card is
                                      # present) or 'cpu', which must be asked for


@dataclass(frozen=True)
class DistributedConfig(StepOptions, RunOptions, ModelOptions):
    """Knobs of the data-parallel trainer. The world size is not a knob: it comes from the
    launcher's environment (``train.launch``, ``torchrun``)."""

    epochs: int = 6
    global_batch_size: int = 64       # per rank: global // world
    batch_size_test: int = 1000
    learning_rate: float = 0.02
    momentum: float = 0.5
    log_interval: int = 10
    seed: int = 1                     # the parameters' seed, and the dropout masks'
    sampler_seed: int = 42            # the DistributedSampler order's seed
    data_dir: str = "files"           # MNIST IDX files; the synthetic split without them
    download_data: bool = False       # torchvision download=True (src/train_dist.py:
                                      # 22-30); the atomic install makes concurrent
                                      # fetches by co-hosted ranks safe
    results_dir: str = "results"      # rank 0 writes model_dist.ckpt, model_dist.msgpack,
                                      # metrics.jsonl and the store here
    shard_eval: bool = False          # False: every rank evaluates the whole test split
                                      # (the reference's way); True: each rank a block,
                                      # the sums SUM-reduced
    host_local_feed: bool = False     # each rank gathers and feeds only its own block of
                                      # every global batch from host memory (the
                                      # multi-host input path), one step a batch, instead
                                      # of the device-resident split; same plan, same math
    max_train_examples: int = 0       # truncate the splits (0 = all)
    max_test_examples: int = 0
    device: str = "cuda"              # 'cuda' (the default: raises when no card is
                                      # present) or 'cpu', which must be asked for
    fsdp: bool = False                # ZeRO/FSDP: params and optimizer state split over
                                      # the data ranks (parallel/fsdp.py); the same
                                      # trajectory as plain DP


@dataclass(frozen=True)
class ComposedConfig(StepOptions, ResilienceOptions, ModelKnobs):
    """Knobs of the composed trainer (the transformer classifier), with the JAX package's
    defaults. Every mesh of ``data``, ``seq``, ``model``, ``expert`` and ``stage`` trains,
    over a process group of the mesh's product of ranks (``parallel.mesh.ProcessGrid``);
    ``dcn_data`` lays the grid out slice-major on the data axis
    (``parallel.mesh.hybrid_rank_order``)."""

    mesh: str = "data=2,seq=2,model=2"  # named axes (data: DP, seq: ring/Ulysses, model:
                                        # Megatron TP, expert: MoE, stage: pipeline);
                                        # product = the launcher's world
    plan: str = ""                      # automatic parallelism planning (plan/): 'auto'
                                        # picks mesh/fsdp/grad-accum/microbatches from
                                        # the analytical cost model, 'tune' re-ranks
                                        # the top candidates by measured step time, a
                                        # path replays a saved plan JSON; overrides
                                        # --mesh/--fsdp/--grad-accum/
                                        # --pipeline-microbatches. "" changes nothing
    pipeline_microbatches: int = 4      # microbatches a step under a stage axis (bubble
                                        # (S-1)/(M+S-1)); batch/grad_accum must divide
                                        # by it, and the microbatch by the data axis
    pipeline_schedule: str = "gpipe"    # the backward under a stage axis: 'gpipe' or
                                        # '1f1b' (stage inputs saved, stage recomputed)
    moe_top_k: int = 1                  # MoE router: 1 Switch, 2 GShard (expert axis)
    fsdp: bool = False                  # ZeRO x TP: params and optimizer state also
                                        # split over data on each leaf's largest free
                                        # dim (parallel/fsdp.py); not with a stage axis
    dcn_data: int = 0                   # the hybrid ICI x DCN layout: the data axis's
                                        # leading factor strides over N slices of
                                        # contiguous ranks; 0 off
    sharded_checkpoint: bool = False    # also write results/model_composed.ckpt.sharded/
                                        # each epoch: every rank its own blocks, no
                                        # gather; --resume-from takes the directory
    seq_len: int = 16                   # tokens per image (784 pixels zero-padded)
    flash_attention: bool = False       # attention through the flash kernels: the
                                        # ring-of-flash under a seq axis, else where the
                                        # dispatch predicate takes them (S >= 2048)
    zigzag_attention: bool = False      # the load-balanced zig-zag causal ring schedule
                                        # (with --causal; of flash with
                                        # --flash-attention)
    seq_impl: str = "ring"              # the sequence-parallel schedule under a seq
                                        # axis: 'ring' (K/V rotation) or 'ulysses'
                                        # (head-scatter all-to-all; heads % seq == 0)
    epochs: int = 2
    batch_size: int = 64
    batch_size_test: int = 1000
    learning_rate: float = 0.05
    momentum: float = 0.5
    dropout_rate: float = 0.0           # 0 keeps runs comparable across meshes
    seed: int = 1
    data_dir: str = "files"
    download_data: bool = False         # fetch the MNIST IDX archives into data_dir first
    results_dir: str = "results"        # model_composed.ckpt, metrics.jsonl and the
                                        # store go here
    max_train_examples: int = 0         # truncate the splits (0 = all)
    max_test_examples: int = 0
    device: str = "cuda"                # 'cuda' (the default: raises when no card is
                                        # present) or 'cpu', which must be asked for


@dataclass(frozen=True)
class LMConfig:
    """Knobs of the pixel-LM trainer (``train/lm.py``), every field of the JAX package's
    ``LMConfig`` with its default, plus ``device``. Meshes: none (``data`` over the
    process group), or ``data``, ``seq`` and ``model`` axes whose product is the process
    count (the einsum ring, or the einsum zig-zag with ``zigzag_attention``, on seq;
    Megatron TP over the blocks on model); ``plan`` picks the mesh and the gradient
    accumulation (``plan.apply_plan``: data x model)."""

    epochs: int = 2
    batch_size: int = 64                # global batch, split over the data ranks
    num_levels: int = 16                # gray-level vocabulary (BOS id = num_levels)
    embed_dim: int = 64
    num_layers: int = 2
    num_heads: int = 4
    dropout_rate: float = 0.0
    attention_window: int = 0           # sliding-window causal attention width; 0 full
    kv_heads: int = 0                   # grouped-query K/V heads (0 = MHA); divides heads
    mesh: str = ""                      # "" (data over every rank) or data/seq/model
                                        # axes, e.g. "data=2,seq=2", "data=1,model=2"
    plan: str = ""                      # automatic parallelism planning (plan/): 'auto'
                                        # | 'tune' | a saved plan JSON; overrides
                                        # --mesh/--grad-accum. "" changes nothing
    zigzag_attention: bool = False      # the zig-zag causal ring on the seq axis
                                        # (seq_len % (2·seq) == 0)
    rope: bool = False                  # rotary position embeddings (no pos_embed)
    learning_rate: float = 1e-3
    momentum: float = 0.5               # sgd only (adamw is the LM's default)
    optimizer: str = "adamw"
    weight_decay: float = 0.01
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    clip_grad_norm: float = 1.0         # the LM convention; 0 off
    label_smoothing: float = 0.0        # torch label-smoothing semantics
    ema_decay: float = 0.0              # eval and generation then use the EMA weights
    async_checkpoint: bool = False      # write checkpoints on a background thread
    grad_accum: int = 1
    bf16: bool = False                  # bfloat16 activations, f32 master weights
    remat: bool = False                 # recompute each block in the backward
    remat_policy: str = ""              # '' / 'recompute-all' or 'save-dots' (with remat)
    eval_batch: int = 500               # the test NLL's batch (must divide the split)
    generate: int = 6                   # sample this many digits after training (0 off)
    temperature: float = 1.0            # sampling temperature (<= 0 decodes greedily)
    top_k: int = 0                      # sample only the k most likely tokens (0 off)
    top_p: float = 1.0                  # nucleus sampling mass cutoff (1.0 off)
    seed: int = 1
    data_dir: str = "files"
    download_data: bool = False
    corpus: str = ""                    # a token-shard corpus directory (data/stream.py)
                                        # to train on instead of MNIST's pixel streams
    data_throttle_s: float = 0.0        # the stream loader's per-batch brake; 0 off
    results_dir: str = "results"        # model_lm.ckpt, metrics.jsonl and the store
    images_dir: str = "images"          # the sample grids and the loss curve
    resume_from: str = ""               # a per-epoch checkpoint to resume from
    heartbeat_dir: str = ""             # a per-process liveness file each epoch
    handle_preemption: bool = False     # SIGTERM: stop at the next epoch boundary, exit 75
    keep_checkpoints: int = 0           # the keep-last-N versioned store; 0 off
    guard: bool = False                 # the numerical guard (see StepOptions)
    guard_zscore: float = 8.0
    anomaly_exit: int = 0               # exit 65 once >= N anomalies; 0 never
    skip_steps: str = ""                # identity-update windows "a:b[,c:d]"
    telemetry: str = ""                 # the JSONL run-telemetry stream's path; empty off
    health_stats: bool = False          # one 'health' event an epoch; needs --telemetry
    max_train_examples: int = 0
    max_test_examples: int = 0
    device: str = "cuda"                # 'cuda' (the default: raises when no card is
                                        # present) or 'cpu', which must be asked for


def check_lm_config(config: LMConfig) -> None:
    """Raise on the LM trainer's knob values the JAX package refuses, before any data or
    rendezvous work."""
    check_health_stats(config)
    if config.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {config.grad_accum}")
    if config.kv_heads and (config.kv_heads < 0 or config.num_heads % config.kv_heads):
        raise ValueError(f"--kv-heads {config.kv_heads} must be a positive divisor of "
                         f"--num-heads {config.num_heads}")


def _add_args(parser: argparse.ArgumentParser, cfg) -> None:
    for f in dataclasses.fields(cfg):
        arg = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            parser.add_argument(arg, action=argparse.BooleanOptionalAction,
                                default=f.default)
        else:
            parser.add_argument(arg, type=type(f.default), default=f.default)


def parse_config(cls, argv: list[str] | None = None):
    """Build a config of type ``cls`` from CLI args (every field is a ``--flag``)."""
    parser = argparse.ArgumentParser(description=cls.__doc__, allow_abbrev=False)
    _add_args(parser, cls)
    ns = parser.parse_args(argv)
    return cls(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)})
