"""Run telemetry: the parameter fingerprint.

Counterpart of ``param_fingerprint`` in the JAX package's ``utils/telemetry.py``; the rest
of that module (the event writer, the manifest, compile and epoch events) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch


def param_fingerprint(tree: dict[str, torch.Tensor]) -> float:
    """The state's fingerprint: per-leaf f32 absolute sums, folded on the host in f32.

    Computed on this process's own copy (one host fetch a leaf), never by a collective: a
    reduction across ranks would hand every rank the same value, corruption included, and
    a supervisor comparing the ranks' fingerprints would see nothing. Equal across ranks
    exactly when their replicated parameters are."""
    total = np.float32(0.0)
    for leaf in tree.values():
        data = leaf.detach().cpu().numpy()
        total += np.abs(data.astype(np.float32)).sum(dtype=np.float32)
    return float(total)
