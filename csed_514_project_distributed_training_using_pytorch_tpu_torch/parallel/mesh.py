"""The process group, and the mesh specs of the composed trainer.

Counterpart of the JAX package's ``parallel/mesh.py`` (that module imports JAX):

- ``initialize_cluster`` joins (or creates) the ``torch.distributed`` process group and
  reports this process's coordinates. Rendezvous follows torch's environment contract
  (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), so the
  port's ``train.launch`` and ``torchrun`` both start it. With none of them set it creates
  a one-rank group on an in-process store, so one code path runs at every world size.
- The data world is the process group itself: one axis, ``data``, of ``process_count``
  ranks, each holding one replica. That is the JAX package's default one-axis mesh
  (``make_mesh``) with a process for each device.
- ``parse_mesh_spec`` is the ``--mesh`` grammar of the composed trainer, and
  ``seq_axis_size`` the meshes it trains: one device, or a ``seq`` axis alone, whose world
  is the process group (one rank a sequence shard, ``parallel/ring_attention.py``). Every
  other mesh of more than one device waits for ROADMAP A6/A10.

The backend is chosen by rule and named in every result: ``nccl`` when the ranks run on
CUDA and each rank on this host has a card of its own (rank r on ``cuda:LOCAL_RANK``);
``gloo`` otherwise, on the CPU or when several ranks share one card (NCCL refuses two ranks
on one device). A failed NCCL rendezvous raises; it is never retried on gloo.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

_KNOWN_AXES = ("data", "seq", "model", "expert", "stage")

# Seconds a rendezvous waits for its peers (and, on gloo, a collective for its partners)
# before it raises: a missing peer fails instead of blocking for ever.
DEFAULT_INITIALIZATION_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class ProcessInfo:
    """This process's coordinates in the data world."""

    process_index: int        # the rank
    process_count: int        # the world size: replicas on the data axis
    device: torch.device      # where this rank's replica lives (cuda:LOCAL_RANK)
    backend: str              # 'nccl' or 'gloo'

    @property
    def is_coordinator(self) -> bool:
        """True on the process that owns rank-gated side effects (metrics files)."""
        return self.process_index == 0


def choose_backend(device_type: str, ranks_on_host: int, device_count: int) -> str:
    """``nccl`` when every rank on this host has a card of its own, ``gloo`` otherwise."""
    return "nccl" if device_type == "cuda" and ranks_on_host <= device_count else "gloo"


def _rank_device(device_type: str, local_rank: int) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _env_coordinates() -> tuple[int, int, int, int] | None:
    """``(rank, world, local_rank, ranks on this host)`` from the environment, or None
    when no launcher set them."""
    env = os.environ
    if "WORLD_SIZE" not in env and "RANK" not in env:
        return None
    missing = [k for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")
               if k not in env]
    if missing:
        raise RuntimeError(f"incomplete rendezvous environment: {missing} not set")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if not 0 <= rank < world:
        raise RuntimeError(f"RANK {rank} out of range for WORLD_SIZE {world}")
    local_rank = int(env.get("LOCAL_RANK", rank))
    return rank, world, local_rank, int(env.get("LOCAL_WORLD_SIZE", world))


def initialize_cluster(device: torch.device | str = "cuda", *,
                       timeout_s: float = DEFAULT_INITIALIZATION_TIMEOUT_S) -> ProcessInfo:
    """Join (or create) the process group for replicas on ``device``'s type and report
    this process's coordinates. Safe to call again: an existing group is reported, not
    re-created.

    ``timeout_s`` bounds the rendezvous; on expiry ``init_process_group`` raises,
    re-raised here with the cluster coordinates attached."""
    device_type = torch.device(device).type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} — use 'cuda' or 'cpu'")
    coords = _env_coordinates()
    rank, world, local_rank, ranks_on_host = coords or (0, 1, 0, 1)
    if dist.is_initialized():
        backend = dist.get_backend()
        rank, world = dist.get_rank(), dist.get_world_size()
        return ProcessInfo(rank, world, _rank_device(device_type, local_rank), backend)
    device_count = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = choose_backend(device_type, ranks_on_host, device_count)
    rank_device = _rank_device(device_type, local_rank)
    kwargs = dict(backend=backend, rank=rank, world_size=world,
                  timeout=datetime.timedelta(seconds=timeout_s))
    if coords is None:
        kwargs["store"] = dist.HashStore()        # a one-rank group needs no rendezvous
    else:
        kwargs["init_method"] = "env://"
    if backend == "nccl":
        torch.cuda.set_device(rank_device)
        kwargs["device_id"] = rank_device         # bind the rank's card; init eagerly
    try:
        dist.init_process_group(**kwargs)
    except Exception as e:
        raise RuntimeError(
            f"cluster rendezvous failed: backend={backend}, rank={rank}, world={world}, "
            f"master={os.environ.get('MASTER_ADDR')}:{os.environ.get('MASTER_PORT')}, "
            f"timeout={timeout_s:g}s — check that every peer is up and reachable") from e
    return ProcessInfo(rank, world, rank_device, backend)


@contextlib.contextmanager
def cluster(device: torch.device | str = "cuda", *,
            timeout_s: float = DEFAULT_INITIALIZATION_TIMEOUT_S):
    """``initialize_cluster`` for the span of a ``with`` block: the group this call
    created is destroyed on the way out, also on an error; a group that was already up
    is left to its owner."""
    owner = not dist.is_initialized()
    info = initialize_cluster(device, timeout_s=timeout_s)
    try:
        yield info
    finally:
        if owner and dist.is_initialized():
            dist.destroy_process_group()


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


def seq_axis_size(spec: str) -> int:
    """The ``seq`` axis size of a ``--mesh`` spec the port trains: every axis but ``seq``
    of size 1 (``data=1``, ``data=1,seq=N``). The seq world is the process count, one rank
    a sequence shard. Any other mesh of more than one device raises."""
    names, sizes = parse_mesh_spec(spec)
    axes = dict(zip(names, sizes))
    others = {name: size for name, size in axes.items() if name != "seq" and size > 1}
    if others:
        raise ValueError(
            f"--mesh {spec} spans {math.prod(sizes)} devices with {others}; this port "
            f"trains on one device or on a seq axis alone (data>1, and data beside seq, "
            f"model, expert, stage: ROADMAP A6/A10) — use --mesh data=1 or data=1,seq=N")
    return axes.get("seq", 1)
