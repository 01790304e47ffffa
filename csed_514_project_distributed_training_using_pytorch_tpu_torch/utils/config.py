"""Configuration of the port's trainers (the single-process CNN trainer, the data-parallel
CNN trainer and the composed transformer trainer).

Counterpart of the JAX package's ``utils/config.py``, holding only the knobs this port
implements, with the JAX package's names and defaults (the reference's values), plus
``device``. Every field is a ``--flag``; a flag the port does not implement is an argparse
error, never silently ignored (abbreviations are off for the same reason).
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class SingleProcessConfig:
    """Knobs of the single-process trainer."""

    n_epochs: int = 3
    batch_size_train: int = 64
    batch_size_test: int = 1000
    learning_rate: float = 0.01
    momentum: float = 0.5
    optimizer: str = "sgd"            # only 'sgd' (the reference's) is ported
    log_interval: int = 10
    seed: int = 1
    data_dir: str = "files"           # MNIST IDX files; the synthetic split without them
    results_dir: str = "results"      # metrics.jsonl goes here
    use_pallas_kernels: bool = False  # the fused loss/optimizer kernels
                                      # (ops/fused_kernels.py: CUDA on the card); the
                                      # name is the JAX package's flag
    device: str = "cuda"              # 'cuda' (the default: raises when no card is
                                      # present) or 'cpu', which must be asked for


@dataclass(frozen=True)
class DistributedConfig:
    """Knobs of the data-parallel trainer. The world size is not a knob: it comes from the
    launcher's environment (``train.launch``, ``torchrun``)."""

    epochs: int = 6
    global_batch_size: int = 64       # per rank: global // world
    batch_size_test: int = 1000
    learning_rate: float = 0.02
    momentum: float = 0.5
    optimizer: str = "sgd"            # only 'sgd' (the reference's) is ported
    log_interval: int = 10
    seed: int = 1                     # the parameters' seed, and the dropout masks'
    sampler_seed: int = 42            # the DistributedSampler order's seed
    data_dir: str = "files"           # MNIST IDX files; the synthetic split without them
    results_dir: str = "results"      # rank 0 writes metrics.jsonl here
    shard_eval: bool = False          # False: every rank evaluates the whole test split
                                      # (the reference's way); True: each rank a block,
                                      # the sums SUM-reduced
    max_train_examples: int = 0       # truncate the splits (0 = all)
    max_test_examples: int = 0
    device: str = "cuda"              # 'cuda' (the default: raises when no card is
                                      # present) or 'cpu', which must be asked for


@dataclass(frozen=True)
class ComposedConfig:
    """Knobs of the composed trainer (the transformer classifier), with the JAX package's
    defaults. Ported meshes: one device (``--mesh data=1``), or a seq axis alone
    (``--mesh data=1,seq=N``) over a process group of N ranks with
    ``--flash-attention`` (the ring-of-flash)."""

    mesh: str = "data=2,seq=2,model=2"  # the JAX default; it raises (ROADMAP A6/A10)
    seq_len: int = 16                   # tokens per image (784 pixels zero-padded)
    flash_attention: bool = False       # attention through the flash kernels: the
                                        # ring-of-flash under a seq axis, else where the
                                        # dispatch predicate takes them (S >= 2048)
    bf16: bool = False                  # bfloat16 activations, f32 master weights
    causal: bool = False                # decoder-style (causal) attention
    attention_window: int = 0           # sliding-window width; 0 off
    kv_heads: int = 0                   # grouped-query K/V heads (0 = MHA); divides 4
    rope: bool = False                  # rotary position embeddings on q/k
    zigzag_attention: bool = False      # the load-balanced zig-zag causal ring schedule
                                        # (with --flash-attention --causal)
    seq_impl: str = "ring"              # the sequence-parallel schedule: 'ring' only
                                        # ('ulysses' raises, ROADMAP A10)
    epochs: int = 2
    batch_size: int = 64
    batch_size_test: int = 1000
    learning_rate: float = 0.05
    momentum: float = 0.5
    optimizer: str = "sgd"              # only 'sgd' is ported
    dropout_rate: float = 0.0           # 0 keeps runs comparable across meshes
    seed: int = 1
    data_dir: str = "files"
    results_dir: str = "results"        # metrics.jsonl goes here
    max_train_examples: int = 0         # truncate the splits (0 = all)
    max_test_examples: int = 0
    device: str = "cuda"                # 'cuda' (the default: raises when no card is
                                        # present) or 'cpu', which must be asked for


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
