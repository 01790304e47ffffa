"""Parameter initializers matching PyTorch layer defaults, drawn from an explicit generator.

Counterpart of the JAX package's ``ops/initializers.py``. PyTorch's ``nn.Conv2d`` and
``nn.Linear`` default to ``kaiming_uniform_(a=sqrt(5))`` for weights — which reduces to
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) — and the same fan-in bound for biases.

Shapes here are in PyTorch's layout (OIHW conv kernels, ``[out, in]`` dense kernels), the
layout the port's modules store. Values are drawn on the CPU from a CPU generator and then
moved, so one seed gives the same parameters on every device.
"""

from __future__ import annotations

import math

import torch


def _fan_in(shape: tuple[int, ...]) -> int:
    """Fan-in for OIHW conv kernels (in*h*w) and ``[out, in]`` dense kernels."""
    if len(shape) == 2:  # dense [out, in]
        return shape[1]
    if len(shape) == 4:  # conv OIHW
        return shape[1] * shape[2] * shape[3]
    raise ValueError(f"unsupported param shape {shape}")


def _uniform(generator: torch.Generator, shape, bound: float, dtype, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype).uniform_(-bound, bound, generator=generator)
    return out.to(device)


def torch_kaiming_uniform(generator: torch.Generator, shape: tuple[int, ...],
                          dtype: torch.dtype = torch.float32,
                          device: torch.device | str = "cpu") -> torch.Tensor:
    """PyTorch default weight init: ``kaiming_uniform_(a=sqrt(5))`` == U(±1/sqrt(fan_in))."""
    return _uniform(generator, shape, 1.0 / math.sqrt(_fan_in(shape)), dtype, device)


def torch_fan_in_uniform(fan_in: int):
    """PyTorch default bias init: U(±1/sqrt(fan_in)) with fan-in taken from the weight."""
    def init(generator: torch.Generator, shape: tuple[int, ...],
             dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cpu") -> torch.Tensor:
        return _uniform(generator, shape, 1.0 / math.sqrt(fan_in), dtype, device)
    return init
