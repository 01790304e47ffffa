"""The serve mesh: one replica's engine over TP x slot-DP ranks.

Counterpart of the JAX package's ``serving/shard.py``. There a replica's engine runs its
programs unchanged under GSPMD on an in-replica ``(dp, tp)`` device mesh; here the mesh is
a world of ``tp * dp`` processes laid out by ``parallel.mesh.ProcessGrid`` with the axes
``data`` (slots, outer) and ``model`` (heads, inner), so global rank ``r`` sits where JAX
device ``r`` sits in the ``(dp, tp)`` device array. Each rank runs the engine's programs
on what it holds:

- ``model`` (tensor parallel): the weights split by ``parallel.tensor_parallel``'s leaf
  rules (``param_partition_specs``; the fused qkv and GQA kv columns by heads), so a rank
  projects q/k/v for its own heads, attends over its own KV heads, and the attention
  output and MLP down projections are row-parallel, one SUM all-reduce each on the
  ``model`` group (``models.lm``'s ``tp`` argument). The KV and scale planes hold the
  rank's own KV heads: no collective touches the cache;
- ``data`` (slot data parallel): a rank's planes hold its own slot group (contiguous
  layout) or its own group's page range (paged: ``PagePool(groups=dp)``), and the
  ``[num_slots]`` fetch is an all-gather of the rows' log-probs on the ``data`` group, after
  which every rank runs the same emission tail (greedy, sampling, accept) on the whole
  batch with the same ``torch.Generator`` draws as the unsharded engine.

Host state (slots, positions, the page table, the prefix cache's keys) is the same on
every rank: every rank runs the same host decisions. ``ContinuousBatchingEngine.run``
keeps that by construction (every rank serves the same requests); under a ``Server``
rank 0 owns the queue and the clock, and ``MeshLeader`` broadcasts each decision
(admissions, expiries, parks, steps) that the other ranks replay in ``follow``, one call
at a time whatever thread makes it (the serving loop, a replica's ``stats`` op).
``check_replicas`` raises when the ranks' engines parted; ``rank_counters`` gathers each
rank's B6 launches and decode steps, and ``closing_check`` is the replica check with
both, which a sharded replica runs before its world ends.

This module also keeps the specs (``cache_pspecs``, ``pool_pspecs``, ``plane_pspecs``,
``param_shardings``) from which each rank takes its local box, and ``per_device_bytes``,
what each rank holds, which ``byte_accounting`` gathers into its ``per_chip`` rows.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import zlib

import torch
import torch.distributed as dist

from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import quant
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
    Axis,
    ProcessGrid,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.tensor_parallel import (
    filter_to_grid,
    shard_leaf,
    spec_for,
)

SLOT_AXIS = "data"
HEAD_AXIS = "model"

# The planes' axis names (the JAX package's ``models.lm.KV_PLANE_AXES`` and
# ``PAGE_PLANE_AXES``) and the serve-mesh axis each maps to (None: never split).
KV_PLANE_AXES = {"k": ("slot", "position", "kv_head", "head_dim"),
                 "v": ("slot", "position", "kv_head", "head_dim"),
                 "k_scale": ("slot", "position", "kv_head"),
                 "v_scale": ("slot", "position", "kv_head")}
PAGE_PLANE_AXES = {"k": ("page", "offset", "kv_head", "head_dim"),
                   "v": ("page", "offset", "kv_head", "head_dim"),
                   "k_scale": ("page", "offset", "kv_head"),
                   "v_scale": ("page", "offset", "kv_head")}
_PLANE_AXIS_TO_MESH = {"slot": SLOT_AXIS, "kv_head": HEAD_AXIS, "position": None,
                       "head_dim": None}
_POOL_AXIS_TO_MESH = {"page": SLOT_AXIS, "kv_head": HEAD_AXIS, "offset": None,
                      "head_dim": None}


def parse_shard_spec(spec: str | None) -> tuple[int, int]:
    """``"tp=2,dp=4"`` -> ``(tp, dp)``. Order-free, both keys optional (missing = 1),
    empty/None = the unsharded ``(1, 1)``."""
    tp = dp = 1
    for part in (spec or "").replace(" ", "").split(","):
        if not part:
            continue
        key, _, val = part.partition("=")
        if key not in ("tp", "dp") or not val.isdigit() or int(val) < 1:
            raise ValueError(f"bad shard spec entry {part!r} (want tp=<n>,dp=<n>)")
        if key == "tp":
            tp = int(val)
        else:
            dp = int(val)
    return tp, dp


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """One replica's ranks: ``tp`` over ``HEAD_AXIS`` x ``dp`` over ``SLOT_AXIS``, as the
    process grid ``data=dp,model=tp``."""

    grid: ProcessGrid
    tp: int
    dp: int

    @property
    def num_devices(self) -> int:
        return self.tp * self.dp

    @property
    def model(self) -> Axis:
        return self.grid.axis(HEAD_AXIS)

    @property
    def data(self) -> Axis:
        return self.grid.axis(SLOT_AXIS)

    @property
    def rank(self) -> int:
        return self.grid.rank

    def describe(self) -> dict:
        return {"tp": self.tp, "dp": self.dp, "num_devices": self.num_devices,
                "devices": list(range(self.num_devices))}


def build_serve_mesh(tp: int = 1, dp: int = 1) -> ServeMesh:
    """The ``(dp, tp)`` grid over the process group: ``SLOT_AXIS`` outermost, ``HEAD_AXIS``
    innermost (the row-parallel all-reduces run among neighbouring ranks). The world must
    hold ``tp * dp`` ranks (``ProcessGrid`` raises with the JAX package's words)."""
    if tp < 1 or dp < 1:
        raise ValueError(f"tp/dp must be >= 1, got tp={tp} dp={dp}")
    return ServeMesh(grid=ProcessGrid(f"{SLOT_AXIS}={dp},{HEAD_AXIS}={tp}"), tp=tp, dp=dp)


def validate_engine_mesh(model, num_slots: int, sm: ServeMesh) -> None:
    """The divisibility contract, checked at engine construction: TP must divide both head
    counts (query heads for the column-parallel projections, KV heads for the planes) and
    slot-DP must divide ``num_slots``."""
    kvh = model.num_kv_heads or model.num_heads
    if model.num_heads % sm.tp or kvh % sm.tp:
        raise ValueError(f"tp={sm.tp} must divide num_heads={model.num_heads} and "
                         f"num_kv_heads={kvh}")
    if num_slots % sm.dp:
        raise ValueError(f"dp={sm.dp} must divide num_slots={num_slots}")


def _plane_specs(tree: dict, axes: dict, to_mesh: dict, drop_lead: bool = False) -> dict:
    def spec(name: str, ndim: int) -> tuple:
        names = axes.get(name)
        if names is not None and drop_lead:
            names = names[1:]
        if names is None or len(names) != ndim:
            return (None,) * ndim                 # an unknown leaf replicates
        return tuple(to_mesh[a] for a in names)

    return {layer: {key: spec(key, x.dim()) for key, x in leaves.items()}
            for layer, leaves in tree.items()}


def cache_pspecs(cache: dict) -> dict:
    """The spec of each leaf of an ``init_cache`` tree: k/v ``[slot, position, kv_head,
    head_dim]`` -> ``(data, None, model, None)``; the scale planes ``[slot, position,
    kv_head]`` -> ``(data, None, model)``. Unknown leaves replicate."""
    return _plane_specs(cache, KV_PLANE_AXES, _PLANE_AXIS_TO_MESH)


def pool_pspecs(pool: dict) -> dict:
    """The paged twin of ``cache_pspecs``: k/v ``[page, offset, kv_head, head_dim]`` ->
    ``(data, None, model, None)``; the scale pools -> ``(data, None, model)``."""
    return _plane_specs(pool, PAGE_PLANE_AXES, _POOL_AXIS_TO_MESH)


def plane_pspecs(planes: dict) -> dict:
    """The specs of ONE slot's planes (``cache[slot]``: the slot dim is gone, the head dim
    still splits): a prefix-cache entry's contract."""
    return _plane_specs(planes, KV_PLANE_AXES, _PLANE_AXIS_TO_MESH, drop_lead=True)


def local_box(shape, spec: tuple, sm: ServeMesh) -> tuple[slice, ...]:
    """The range of each dim of a ``shape``-leaf under ``spec`` that this rank holds (a
    contiguous ``1/size`` per split dim, the JAX boxes)."""
    out = []
    for n, axis in zip(shape, spec):
        if axis is None:
            out.append(slice(0, n))
            continue
        ax = sm.grid.axis(axis)
        w = n // ax.size
        out.append(slice(ax.index * w, (ax.index + 1) * w))
    return tuple(out)


def param_specs(params: dict, sm: ServeMesh) -> dict:
    """``{name: spec}`` of the (possibly quantized) serving params by the train-side TP
    rules (``spec_for``) on the serve mesh's axes: the quantized tree keeps the kernel
    names, so one rule set serves both."""
    specs = {k: spec_for(k, len(_shape(p)), axis_name=HEAD_AXIS) for k, p in params.items()}
    return filter_to_grid(specs, sm.grid.names)


def _shape(p) -> tuple:
    return tuple((p.q if isinstance(p, quant.QuantizedTensor) else p).shape)


def param_shardings(params: dict, sm: ServeMesh) -> dict:
    """This rank's shard of every serving parameter. A ``QuantizedTensor``'s codes split
    as its kernel does; the per-column scales of a column-parallel kernel split with its
    columns (by heads for the fused ones), those of a row-parallel kernel replicate, as
    the JAX package's rules leave them."""
    specs = param_specs(params, sm)
    out = {}
    for name, p in params.items():
        spec = specs[name]
        if isinstance(p, quant.QuantizedTensor):
            q = shard_leaf(p.q, spec, sm.grid, name)
            scale = shard_leaf(p.scale, spec[1:], sm.grid, name) if spec[1] else p.scale
            out[name] = quant.QuantizedTensor(q, scale.contiguous(), mode=p.mode)
        else:
            out[name] = shard_leaf(p, spec, sm.grid, name)
    return out


def per_device_bytes(*trees, sm: ServeMesh | None = None) -> dict[int, int]:
    """Resident bytes per rank, keyed by global rank: this rank's buffers counted here,
    every rank's gathered over the process group when ``sm`` spans more than one (a
    collective: every rank calls it). A replicated leaf counts on every rank that holds
    it. One rank's row equals ``quant.tree_bytes`` of its trees exactly: the unsharded
    engine's one-row document."""
    mine = sum(quant.tree_bytes(t) for t in trees)
    if sm is None or sm.num_devices == 1:
        return {0: mine}
    rows = [None] * sm.num_devices
    dist.all_gather_object(rows, mine)
    return {r: int(v) for r, v in enumerate(rows)}


# =========================================================================================
# The leader and its followers: rank 0's host decisions, replayed on every rank
# =========================================================================================


def broadcast_from_leader(obj=None):
    """``obj`` from global rank 0 to every rank (the host decisions are small)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class MeshLeader:
    """Rank 0's handle on a sharded engine, for the ``Server``: every call that changes
    the engine's host state or runs a collective is broadcast to the other ranks first
    (``follow`` replays it there), so all ranks run the same programs on the same state.
    Reads go to the engine. The clock is rank 0's: ``expire`` broadcasts the slots it
    found expired, not the time, and every stamp travels with its call. Calls from
    several threads go one at a time (a broadcast and its call are one unit), so the
    followers replay them in rank 0's order. ``busy_s`` is how long the call in progress
    has run (0 between calls): a rank that hangs holds rank 0 inside one. ``close`` ends
    the followers' loops."""

    def __init__(self, engine):
        self._engine = engine
        self._lock = threading.Lock()
        self._busy_since: float | None = None

    def __getattr__(self, name):
        return getattr(self._engine, name)

    @property
    def tracer(self):
        return self._engine.tracer

    @tracer.setter
    def tracer(self, tracer) -> None:      # rank 0's spans: the followers trace nothing
        self._engine.tracer = tracer

    @property
    def busy_s(self) -> float:
        since = self._busy_since
        return 0.0 if since is None else time.monotonic() - since

    def _call(self, name: str, *args, **kwargs):
        with self._lock:
            self._busy_since = time.monotonic()
            try:
                broadcast_from_leader((name, args, kwargs))
                target = _MESH_FUNCTIONS.get(name)
                if target is not None:
                    return target(self._engine, *args, **kwargs)
                return getattr(self._engine, name)(*args, **kwargs)
            finally:
                self._busy_since = None

    def admit_many(self, admissions, *, now: float | None = None):
        now = time.monotonic() if now is None else now
        return self._call("admit_many", admissions, now=now)

    def admit(self, slot, request, *, now: float | None = None):
        return self.admit_many([(slot, request)], now=now)

    def expire(self, now: float | None = None):
        now = time.monotonic() if now is None else now
        return self._call("expire_slots", self._engine.expired_slots(now), now)

    def park(self, slot: int, *, now: float | None = None):
        now = time.monotonic() if now is None else now
        return self._call("park", slot, now=now)

    def step(self):
        return self._call("step")

    def reset_stats(self):
        return self._call("reset_stats")

    def drop_prefix_cache(self):
        return self._call("drop_prefix_cache")

    def byte_accounting(self, **kwargs):
        return self._call("byte_accounting", **kwargs)

    def rank_counters(self) -> list[dict]:
        return self._call("rank_counters")

    def closing_check(self) -> dict:
        return self._call("closing_check")

    def close(self) -> None:
        with self._lock:
            broadcast_from_leader(None)


def follow(engine) -> None:
    """A follower rank's loop: replay rank 0's ``MeshLeader`` calls on this rank's engine
    until the leader closes. A typed refusal (``KVPagesExhausted``) that the leader's
    caller handles is handled alike here: the engine state after it is the same. The
    records only rank 0's server reads are dropped as they come."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.engine import (
        KVPagesExhausted,
    )

    while True:
        cmd = broadcast_from_leader()
        if cmd is None:
            return
        name, args, kwargs = cmd
        target = _MESH_FUNCTIONS.get(name)
        try:
            if target is not None:
                target(engine, *args, **kwargs)
            else:
                getattr(engine, name)(*args, **kwargs)
        except KVPagesExhausted:
            pass
        engine.take_prefill_records()
        engine.take_spec_records()


def rank_counters(engine) -> list[dict]:
    """Every rank's row, gathered (a collective: every rank calls it): its global rank,
    pid, B6 launches (``ops.paged_attention.launch_counts``: 0 where no kernel launched,
    as on the CPU) and decode steps."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        paged_attention,
    )

    mine = {"rank": dist.get_rank() if dist.is_initialized() else 0, "pid": os.getpid(),
            "b6_launches": paged_attention.launch_counts()["paged_attend"],
            "steps": engine.steps}
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [mine]
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, mine)
    return rows


def closing_check(engine) -> dict:
    """The replica check a sharded replica runs before its world ends (a collective):
    ``check_replicas`` (raises when a rank parted), then every rank's ``rank_counters``
    and resident bytes (``byte_accounting``'s ``per_chip``)."""
    ledger = check_replicas(engine)
    ranks = rank_counters(engine)
    per_chip = engine.byte_accounting()["per_chip"]
    return {"ledger": ledger, "ranks": ranks,
            "per_chip": {str(r): row for r, row in per_chip.items()}}


def check_replicas(engine) -> dict:
    """The closing replica check: every rank's host ledger (counters, and a CRC of every
    finished request's id and tokens) must equal rank 0's; raises naming the ranks that
    parted. Returns this rank's ledger."""
    mine = engine.host_digest()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return mine
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, mine)
    bad = [r for r, row in enumerate(rows) if row != rows[0]]
    if bad:
        raise RuntimeError(f"serve-mesh desync: rank(s) {bad} parted from rank 0 "
                           f"({rows[bad[0]]} vs {rows[0]})")
    return mine


def crc_of(request_id, tokens, prev: int = 0) -> int:
    """``prev`` folded with a finished request's id and tokens: ``host_digest``'s CRC."""
    return zlib.crc32(repr((request_id, [int(x) for x in tokens])).encode(), prev)


# The module functions a ``MeshLeader`` call may name (``fn(engine, ...)`` on every rank),
# beside the engine's own methods.
_MESH_FUNCTIONS = {"rank_counters": rank_counters, "closing_check": closing_check}


__all__ = ["HEAD_AXIS", "KV_PLANE_AXES", "MeshLeader", "PAGE_PLANE_AXES", "SLOT_AXIS",
           "ServeMesh", "broadcast_from_leader", "build_serve_mesh", "cache_pspecs",
           "check_replicas", "closing_check", "crc_of", "follow", "local_box", "param_shardings",
           "param_specs", "parse_shard_spec", "per_device_bytes", "plane_pspecs",
           "pool_pspecs", "rank_counters", "validate_engine_mesh"]
