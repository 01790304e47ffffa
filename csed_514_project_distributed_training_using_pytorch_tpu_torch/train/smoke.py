"""Connectivity smoke test — the reference's ``run1.py``/``run2.py`` check.

Counterpart of the JAX package's ``train/smoke.py``: join the process group (rendezvous),
then rotate one value per rank around the ring (``collectives.ring_pass``: rank i's value
must land on rank i+1) and SUM-reduce a vector of ones over the ranks, exercising the
backend's point-to-point and its collective in one run. Every rank runs the same command.

Run (one rank on the card; a world of 2 on the CPU through the launcher)::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.smoke
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.launch \\
        --num-processes 2 -- \\
        -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.smoke \\
        --device cpu
"""

from __future__ import annotations

import argparse

import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    cluster,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
    resolve_device,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import metrics as M


def main(device: str = "cuda") -> bool:
    """Returns True iff the ring pass delivered every value to its neighbour and the
    all-reduce summed every rank's ones."""
    with cluster(resolve_device(device)) as info:
        n, rank = info.process_count, info.process_index
        M.log(f"smoke: {n} process(es), backend {info.backend}, rank 0 on {info.device}")
        value = torch.tensor([float(rank)], device=info.device)    # rank i holds i
        got = collectives.all_gather(collectives.ring_pass(value)).reshape(-1).cpu()
        want = torch.roll(torch.arange(n, dtype=torch.float32), 1)
        summed = collectives.all_reduce_sum(torch.ones(4, device=info.device)).cpu()
        ok = bool(torch.equal(got, want)) and bool((summed == n).all())
        for i in range(n):                         # ≙ 'Rank k has data tensor(1.)'
            M.log(f"Device {i} has data {got[i]:.1f} (expected {want[i]:.1f})")
        M.log(f"smoke: all-reduce of ones over {n} rank(s): {summed.tolist()}")
        M.log(f"smoke: {'OK — rendezvous + ring p2p verified' if ok else 'FAILED'}")
    return ok


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0],
                                     allow_abbrev=False)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default: raises when no card is present) or "
                             "'cpu'")
    raise SystemExit(0 if main(parser.parse_args().device) else 1)
