"""Rotary position embeddings (RoPE), half-split layout.

Counterpart of the JAX package's ``ops/rotary.py``: each head-dim pair ``(i, i + D/2)``
rotates by ``pos / base^(2i/D)`` radians, so attention scores depend only on the relative
distance of query and key. Applied to q/k after projection and before the attention core
(``models/transformer.py``), in float32, cast back to the input type.
"""

from __future__ import annotations

import torch


def _angles(positions: torch.Tensor, dim: int, base: float) -> torch.Tensor:
    """``[*pos_shape, dim/2]`` rotation angles for head dim ``dim``."""
    if dim % 2:
        raise ValueError(f"RoPE needs an even head dim, got {dim}")
    exponent = -torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv_freq = torch.pow(torch.tensor(base, dtype=torch.float32, device=positions.device),
                         exponent)
    return positions.float()[..., None] * inv_freq


def apply_rotary(x: torch.Tensor, positions: torch.Tensor, *,
                 base: float = 10000.0) -> torch.Tensor:
    """Rotate ``x: [..., S, H, D]`` by per-position angles (``positions: [S]``, or a 0-d
    tensor for one position on ``[..., H, D]``): ``x1' = x1·cos − x2·sin``,
    ``x2' = x2·cos + x1·sin`` with ``x1, x2`` the first and last D/2 dims."""
    d = x.shape[-1]
    ang = _angles(positions, d, base)                 # [..., D/2]
    if positions.dim():                               # [S] -> broadcast over H
        ang = ang[..., :, None, :]                    # [S, 1, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
