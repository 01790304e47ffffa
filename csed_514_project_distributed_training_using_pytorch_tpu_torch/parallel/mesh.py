"""Mesh specs: the ``--mesh`` string grammar of the composed trainer.

A copy of the JAX package's ``parallel/mesh.py::parse_mesh_spec`` (that module imports
JAX). The port trains on one device so far, so a mesh here only names axes of size 1;
building device meshes is ROADMAP A6/A10.
"""

from __future__ import annotations

_KNOWN_AXES = ("data", "seq", "model", "expert", "stage")


def parse_mesh_spec(spec: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """``"data=2,seq=2,model=2"`` -> (axis names, axis sizes). Order is the user's;
    unknown axis names and non-positive sizes are rejected."""
    names, sizes = [], []
    for part in [p for p in spec.split(",") if p]:
        if "=" not in part:
            raise ValueError(f"mesh axis {part!r} must be name=size")
        name, _, size_s = part.partition("=")
        name = name.strip()
        if name not in _KNOWN_AXES:
            raise ValueError(f"unknown mesh axis {name!r} — choose from {_KNOWN_AXES}")
        if name in names:
            raise ValueError(f"duplicate mesh axis {name!r}")
        try:
            size = int(size_s)
        except ValueError:
            raise ValueError(f"mesh axis size {size_s!r} is not an integer") from None
        if size < 1:
            raise ValueError(f"mesh axis {name} size must be >= 1, got {size}")
        names.append(name)
        sizes.append(size)
    if not names:
        raise ValueError("empty --mesh spec")
    return tuple(names), tuple(sizes)
