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
- ``parse_mesh_spec`` is the ``--mesh`` grammar of the composed and LM trainers, and
  ``ProcessGrid`` lays the process group out as that mesh: each rank's coordinates and
  its group along each axis (``data``, ``seq``, ``model``, ``expert``, ``stage``), which
  every mesh collective takes (``parallel/collectives.py``). ``shard_slices`` is the one
  rule for which part of a sharded dim a rank holds.
- ``hybrid_rank_order`` is the JAX package's ``make_hybrid_mesh`` as a rank order for
  ``ProcessGrid`` (``--dcn-data``): the ``data`` axis's leading factor strides over
  ``num_slices`` equal, contiguous granules of ranks (one per slice), so that only that
  factor's collectives cross between granules.
- ``device_memory_budget``, ``num_granules`` and ``topology_summary`` are what the
  parallelism planner (``plan/``) prices layouts against: one rank, one device, so the
  device count is the world's size, and the granules are the world's distinct hosts.

The backend is chosen by rule and named in every result: ``nccl`` when the ranks run on
CUDA and each rank on this host has a card of its own (rank r on ``cuda:LOCAL_RANK``);
``gloo`` otherwise, on the CPU or when several ranks share one card (NCCL refuses two ranks
on one device). A failed NCCL rendezvous raises; it is never retried on gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import socket
from dataclasses import dataclass

import numpy as np
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


def mesh_axes(spec: str) -> dict[str, int]:
    """``{axis: size}`` of a ``--mesh`` spec, in the spec's order."""
    names, sizes = parse_mesh_spec(spec)
    return dict(zip(names, sizes))


@dataclass(frozen=True)
class Axis:
    """One axis of the grid as this rank sees it: its size, this rank's index along it,
    the global ranks along it (in axis order, this rank's other coordinates fixed) and
    their ``torch.distributed`` group (None for a size-1 axis: nothing to communicate)."""

    name: str
    size: int = 1
    index: int = 0
    ranks: tuple[int, ...] = (0,)
    group: object = None


def _trivial(name: str, rank: int = 0) -> Axis:
    return Axis(name, 1, 0, (rank,), None)


def hybrid_rank_order(axis_names: tuple[str, ...], axis_shape: tuple[int, ...], *,
                      num_slices: int, dcn_axis: str = "data") -> np.ndarray:
    """The ranks laid out for a multi-slice (ICI x DCN) grid: the JAX package's
    ``make_hybrid_mesh`` over ``prod(axis_shape)`` ranks split into ``num_slices`` equal,
    contiguous granules (its virtual granules: the ranks in order, one slice a block). The
    leading factor of ``dcn_axis`` strides over the slices; its remainder and every other
    axis stay inside a slice. Returns the ``axis_shape`` array of global ranks, whose entry
    at a grid position is the rank that sits there (``make_hybrid_mesh``'s device ids);
    the same errors, in the same words."""
    if dcn_axis not in axis_names:
        raise ValueError(f"dcn_axis {dcn_axis!r} not in axis_names {axis_names}")
    n = math.prod(axis_shape)
    if num_slices < 1 or n % num_slices:
        raise ValueError(f"num_slices {num_slices} must be >= 1 and divide the {n} devices")
    granules = np.arange(n).reshape(num_slices, n // num_slices)
    sizes = {len(g) for g in granules}
    if len(sizes) != 1:
        raise ValueError(f"uneven slices: {sorted(sizes)} devices per granule")
    pos = axis_names.index(dcn_axis)
    if axis_shape[pos] % num_slices:
        raise ValueError(
            f"{dcn_axis} axis size {axis_shape[pos]} must divide by the {num_slices} slices "
            f"(its leading factor is the DCN dimension)")
    per_slice = tuple(axis_shape[:pos]) + (axis_shape[pos] // num_slices,) + tuple(
        axis_shape[pos + 1:])
    if math.prod(per_slice) != sizes.pop():
        raise ValueError(f"per-slice shape {per_slice} != slice device count")
    stacked = np.stack([g.reshape(per_slice) for g in granules], axis=pos)
    return stacked.reshape(axis_shape)


class ProcessGrid:
    """The process group laid out as the ``--mesh`` spec's grid: rank -> coordinates in
    row-major order over the spec's axes (the first axis slowest), as the JAX package's
    ``make_mesh`` reshapes its device list; or, given ``order`` (an array of the spec's
    shape holding every rank once, ``hybrid_rank_order``'s), the rank at each position.
    For every axis of size > 1 one group is built for each slice along it
    (``dist.new_group``, every rank in the same order, once), so
    each rank holds its ``data``, ``seq``, ``model``, ``expert`` and ``stage`` group and
    its index in each; an axis the spec lacks, or of size 1, has no group.

    The spec's product must equal the process group's size: a spec asking for more ranks
    than run raises with the JAX package's words (``make_mesh``), and one asking for fewer
    raises too (the JAX package leaves the other devices idle; a torch rank outside the
    grid would have no coordinates)."""

    def __init__(self, spec: str, *, rank: int | None = None, world: int | None = None,
                 order: np.ndarray | None = None):
        self.spec = spec
        self.names, self.sizes = parse_mesh_spec(spec)
        initialized = dist.is_initialized()
        self.world = world if world is not None else (
            dist.get_world_size() if initialized else 1)
        self.rank = rank if rank is not None else (dist.get_rank() if initialized else 0)
        n = math.prod(self.sizes)
        if n > self.world:
            raise ValueError(f"requested {n} devices, have {self.world}")
        if n != self.world:
            raise ValueError(f"axis_shape {self.sizes} != {self.world} devices — the "
                             f"--mesh product must equal the launcher's world "
                             f"(--num-processes {n})")
        grid = np.arange(self.world) if order is None else np.asarray(order)
        if sorted(grid.reshape(-1).tolist()) != list(range(self.world)):
            raise ValueError(f"rank order {grid.tolist()} must hold every rank of the world "
                             f"({self.world}) once")
        grid = grid.reshape(self.sizes)
        self.order = grid
        position = np.argwhere(grid == self.rank)[0]
        self.coords = dict(zip(self.names, (int(c) for c in position)))
        self.axes: dict[str, Axis] = {}
        for i, name in enumerate(self.names):
            size = self.sizes[i]
            if size == 1:
                self.axes[name] = _trivial(name, self.rank)
                continue
            lines = np.moveaxis(grid, i, -1).reshape(-1, size)
            mine = None
            for line in lines:               # every rank builds every group, in order
                ranks = tuple(int(r) for r in line)
                group = dist.new_group(list(ranks)) if initialized else None
                if self.rank in ranks:
                    mine = (ranks, group)
            self.axes[name] = Axis(name, size, self.coords[name], mine[0], mine[1])

    def axis(self, name: str) -> Axis:
        """The named axis (a trivial size-1 axis when the spec lacks it)."""
        return self.axes.get(name) or _trivial(name, self.rank)

    def size(self, name: str) -> int:
        return self.axis(name).size

    def index(self, name: str) -> int:
        return self.axis(name).index

    def __repr__(self) -> str:
        return f"ProcessGrid({self.spec!r}, rank {self.rank}, coords {self.coords})"


@dataclass(frozen=True)
class ShardContext:
    """What a model's layers need to know of the grid: the ``model`` axis (Megatron TP:
    local heads and hidden units), the ``expert`` axis (the MoE's experts), the ``data``
    axis and whether the batch differs across it (``tokens_sharded``: the training batch
    does, the replicated eval batch does not; the MoE's queues and auxiliary span it), and
    ``fsdp``: ``{parameter name: dim}`` of the leaves split over ``data``, which the model
    gathers where it uses them. ``NO_SHARDING`` (every axis of one rank) is the
    one-device model, bitwise the model without a grid."""

    model: Axis = Axis("model")
    expert: Axis = Axis("expert")
    data: Axis = Axis("data")
    tokens_sharded: bool = True
    fsdp: tuple = ()                     # ((name, dim), ...): hashable, frozen

    @classmethod
    def of(cls, grid: "ProcessGrid", *, fsdp: dict[str, int] | None = None,
           tokens_sharded: bool = True) -> "ShardContext":
        return cls(grid.axis("model"), grid.axis("expert"), grid.axis("data"),
                   tokens_sharded, tuple(sorted((fsdp or {}).items())))

    @property
    def fsdp_dims(self) -> dict[str, int]:
        return dict(self.fsdp)

    def replicated_batch(self) -> "ShardContext":
        """The same context for a batch every data rank holds whole (the eval)."""
        return dataclasses.replace(self, tokens_sharded=False)


NO_SHARDING = ShardContext()


def shard_slices(full_len: int, size: int, index: int, groups: int = 1) -> list[slice]:
    """The ranges of a dim of ``full_len`` that rank ``index`` of ``size`` holds: its
    contiguous ``1/size`` (``groups`` 1, the JAX boxes), or its ``1/size`` of each of
    ``groups`` equal parts (a fused ``qkv`` or ``kv`` column dim, split by heads so that
    each rank holds q, k and v of its own heads)."""
    part = full_len // groups
    w = part // size
    return [slice(g * part + index * w, g * part + (index + 1) * w) for g in range(groups)]


# Nominal per-device budget when neither torch nor the spec table knows the device (the
# CPU, unknown kinds): deterministic rather than a guess per machine, the JAX package's
# value; override with PLAN_HBM_BYTES.
DEFAULT_DEVICE_MEMORY = 16 << 30


def device_kind(device: torch.device | str = "cuda") -> str:
    """The device's name as the spec tables key it: torch's CUDA device name (raises
    without a card), or ``"cpu"``."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def device_memory_budget(device: torch.device | str = "cuda") -> tuple[int, str]:
    """Usable device-memory bytes for one device, with provenance, in the JAX package's
    order of sources: ``"env"`` (the ``PLAN_HBM_BYTES`` override), ``"runtime"`` (on a
    card, the total ``torch.cuda.mem_get_info`` reports for it), ``"spec"`` (the
    per-kind capacity table, ``utils.benchmarks.HBM_CAPACITY_BY_KIND``) or
    ``"nominal"`` (``DEFAULT_DEVICE_MEMORY``)."""
    # Lazy: utils.benchmarks pulls the trainer stack, which imports this module.
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.benchmarks import (
        HBM_CAPACITY_BY_KIND,
        lookup_by_kind,
    )

    if os.environ.get("PLAN_HBM_BYTES"):
        return int(os.environ["PLAN_HBM_BYTES"]), "env"
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1]), "runtime"
    cap = lookup_by_kind(HBM_CAPACITY_BY_KIND, device_kind(device))
    if cap is not None:
        return int(cap), "spec"
    return int(DEFAULT_DEVICE_MEMORY), "nominal"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def num_granules() -> int:
    """How many hosts the process group spans: the boundaries its collectives cross
    between machines (1 without a group, or at one rank). At more than one rank every rank
    must call it: the host names are all-gathered."""
    world = _world()
    if world == 1:
        return 1
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    return len(set(hosts))


def topology_summary(device: torch.device | str = "cuda") -> dict:
    """One-call snapshot of the topology the planner prices layouts against, in the JAX
    package's keys: platform (``"gpu"`` for a card), the device's kind, the device and
    process counts (one device a rank: both the world's size), the per-device memory
    budget and its source, and the granule count. A collective at more than one rank
    (``num_granules``)."""
    device = torch.device(device)
    budget, source = device_memory_budget(device)
    world = _world()
    return {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_kind": device_kind(device),
        "device_count": world,
        "process_count": world,
        "hbm_bytes": budget,
        "hbm_source": source,
        "num_granules": num_granules(),
    }
