"""The MNIST CNN (``Net``) as a PyTorch module.

Counterpart of the JAX package's ``models/cnn.py`` — the reference's only model:

    conv(1→10, k5) → maxpool2 → relu → conv(10→20, k5) → Dropout2d → maxpool2 → relu
    → flatten(320) → fc(320→50) → relu → dropout → fc(50→10) → log_softmax

21,840 trainable parameters. Input is NHWC ``[B, 28, 28, 1]`` and output is log-probs, as
in the JAX package. Parameters are stored in PyTorch's layout (OIHW conv kernels,
``[out, in]`` dense kernels, ``conv1.weight``-style names) and fc1's input rows follow the
(C, H, W) flatten order; ``params_from_jax`` carries the JAX package's parameters across,
and ``params_to_jax``, its exact inverse, carries them back (the checkpoints' layout).

Train/eval mode is the ``deterministic`` argument, and dropout draws from the ``generator``
passed in, so a training step's masks are a function of the step alone. ``dtype`` is the
activations' type (``torch.bfloat16`` for ``--bf16``): the input and each weight are cast
where they are used, the parameters stay f32, and the log-softmax runs in f32, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.utils import skip_init

from csed_514_project_distributed_training_using_pytorch_tpu_torch import ops


class Net(nn.Module):
    """MNIST classifier emitting log-probabilities."""

    def __init__(self, num_classes: int = 10, conv_dropout_rate: float = 0.5,
                 fc_dropout_rate: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        self.conv_dropout_rate = conv_dropout_rate   # nn.Dropout2d default p
        self.fc_dropout_rate = fc_dropout_rate       # F.dropout default p
        self.conv1 = skip_init(nn.Conv2d, 1, 10, kernel_size=5)
        self.conv2 = skip_init(nn.Conv2d, 10, 20, kernel_size=5)
        self.fc1 = skip_init(nn.Linear, 320, 50)
        self.fc2 = skip_init(nn.Linear, 50, num_classes)
        # The module's own parameters are slots: training passes its parameter dict
        # through torch.func.functional_call. Fill them anyway, so that calling the module
        # directly is defined.
        self.load_state_dict(self.init(torch.Generator().manual_seed(0)))

    def init(self, generator: torch.Generator,
             device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
        """A fresh parameter dict drawn from ``generator`` with PyTorch's default
        distributions (``ops/initializers.py``), keyed like ``state_dict()``."""
        params = {}
        for name, layer in (("conv1", self.conv1), ("conv2", self.conv2),
                            ("fc1", self.fc1), ("fc2", self.fc2)):
            shape = tuple(layer.weight.shape)
            fan_in = int(np.prod(shape[1:]))
            params[f"{name}.weight"] = ops.torch_kaiming_uniform(generator, shape,
                                                                 device=device)
            params[f"{name}.bias"] = ops.torch_fan_in_uniform(fan_in)(
                generator, (shape[0],), device=device)
        return params

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``x: [B, 28, 28, 1]`` float. Returns ``[B, num_classes]`` log-probs."""
        cast = lambda w: w.to(self.dtype)
        hwio = lambda conv: cast(conv.weight).permute(2, 3, 1, 0)      # OIHW -> HWIO view
        x = x.to(self.dtype)
        x = ops.conv2d(x, hwio(self.conv1), cast(self.conv1.bias))     # [B,24,24,10]
        x = ops.relu(ops.max_pool2d(x, 2))                             # [B,12,12,10]
        x = ops.conv2d(x, hwio(self.conv2), cast(self.conv2.bias))     # [B,8,8,20]
        x = ops.dropout2d(generator, x, self.conv_dropout_rate, deterministic=deterministic)
        x = ops.relu(ops.max_pool2d(x, 2))                             # [B,4,4,20]
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)              # [B,320], (C,H,W)
        x = ops.relu(ops.dense(x, cast(self.fc1.weight).t(), cast(self.fc1.bias)))
        x = ops.dropout(generator, x, self.fc_dropout_rate, deterministic=deterministic)
        x = ops.dense(x, cast(self.fc2.weight).t(), cast(self.fc2.bias))
        return ops.log_softmax(x.float())


def param_count(params) -> int:
    """Total trainable parameter count of a module or a parameter dict (21,840 for ``Net``)."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params.values()
    return sum(p.numel() for p in tensors)


def params_from_jax(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Map the JAX package's ``Net`` parameters (NHWC/HWIO, ``[in, out]`` dense kernels,
    (H, W, C) flatten order) onto this module's ``state_dict`` layout (OIHW,
    ``[out, in]``, (C, H, W) flatten order)."""
    p = {k: np.asarray(v) for k, v in params.items()}
    fc1 = p["fc1_kernel"].reshape(4, 4, 20, 50)          # rows in (H, W, C) order
    fc1 = fc1.transpose(2, 0, 1, 3).reshape(320, 50)     # → (C, H, W) order
    sd = {
        "conv1.weight": p["conv1_kernel"].transpose(3, 2, 0, 1),   # HWIO → OIHW
        "conv1.bias": p["conv1_bias"],
        "conv2.weight": p["conv2_kernel"].transpose(3, 2, 0, 1),
        "conv2.bias": p["conv2_bias"],
        "fc1.weight": fc1.T,                                        # [in,out] → [out,in]
        "fc1.bias": p["fc1_bias"],
        "fc2.weight": p["fc2_kernel"].T,
        "fc2.bias": p["fc2_bias"],
    }
    return {k: torch.tensor(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()}


def params_to_jax(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The exact inverse of ``params_from_jax``: this module's ``state_dict`` layout (OIHW,
    ``[out, in]``, (C, H, W) flatten order) as the JAX package's ``Net`` parameters
    (HWIO, ``[in, out]``, (H, W, C) flatten order), host numpy arrays with their keys in
    sorted order, as the JAX package's checkpoints hold them. Only axes move, so the
    values are bitwise the same."""
    p = {k: v.detach().cpu().numpy() for k, v in params.items()}
    fc1 = p["fc1.weight"].T.reshape(20, 4, 4, 50)          # rows in (C, H, W) order
    fc1 = fc1.transpose(1, 2, 0, 3).reshape(320, 50)       # → (H, W, C) order
    jax_params = {
        "conv1_bias": p["conv1.bias"],
        "conv1_kernel": p["conv1.weight"].transpose(2, 3, 1, 0),   # OIHW → HWIO
        "conv2_bias": p["conv2.bias"],
        "conv2_kernel": p["conv2.weight"].transpose(2, 3, 1, 0),
        "fc1_bias": p["fc1.bias"],
        "fc1_kernel": fc1,
        "fc2_bias": p["fc2.bias"],
        "fc2_kernel": p["fc2.weight"].T,                            # [out,in] → [in,out]
    }
    return {k: np.ascontiguousarray(v) for k, v in jax_params.items()}
