"""Configuration of the port's single-process trainer.

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
