"""Checkpoints in the JAX package's byte layout: save, restore, resume, the versioned store,
write-behind saves and the params-only export.

Counterpart of the JAX package's ``utils/checkpoint.py``. A file either package writes, the
other reads: for the same state the port writes the same bytes as the JAX
package, through its own msgpack codec (``utils/_msgpack.py``: the subset flax emits, so
no machine needs flax or msgpack).

The layout is the JAX package's state dict (``state_to_jax_dict``):

- top-level keys ``params, velocity, step[, ema][, guard]``: an absent ``ema`` or
  ``guard`` is omitted, not stored as nil;
- ``params``, ``ema`` and the optimizer state in the JAX model's layout, every dict's keys
  in sorted order, as ``jax.device_get`` rebuilds them: the CNN's through
  ``models.cnn.params_to_jax`` (HWIO kernels, ``[in, out]`` dense kernels, (H, W, C)
  flatten order), the transformer family's (the LM's ``model_lm.ckpt``, the classifier's)
  as the nested tree ``models.transformer.params_to_jax`` makes of the flat dict. SGD's
  velocity is a params dict; AdamW's state is ``{"count", "m", "v"}``;
- ``step`` and AdamW's ``count`` as int32 0-d arrays (the port counts in int64);
- ``guard`` as the nine ``GuardState`` fields in field order, f32 and int32.

Every save copies the state to host memory before it returns (the async saver included),
so a captured segment's next replay, which overwrites the state's static buffers, cannot
tear a write. Writes are atomic (tmp + ``os.replace``) and gated to rank 0 (the process
group's rank, else the launcher's ``RANK``). Every file goes through ``_atomic_write``, the
write-behind saver's too, and there an armed ``torn`` fault (``resilience.faults``) cuts
the bytes; the store's manifest keeps the checksum of the whole payload, so the scans skip
the torn file.

The store's manifest carries the data cursor beside each file: the in-memory trainers'
``kind: "epoch"`` cursor (``check_cursor_resume`` warns on a mismatch), or the LM's token
stream's ``kind: "stream"`` cursor (``data.stream.StreamLoader.verify_cursor`` raises on
one); ``cursor_for`` reads either.

The sharded store (``save_train_state_sharded``, ``restore_train_state_sharded``) is the
JAX package's directory format: ``meta.msgpack`` (rank 0: every leaf's global shape and
dtype, or ``{"none": True}`` for an absent ``ema``/``guard``, and the writer count) and
one ``shards_p{rank}.msgpack`` a rank, mapping flat leaf paths (``params/block_0/attn/
qkv_kernel``) to ``{start, data}`` blocks: the global offsets of each range the rank holds
and its data. Every rank writes only what it holds, each block by one replica (the rank
whose coordinates on the leaf's unsplit axes are 0), with no gather. The restore
reassembles the full leaves from any writer's layout by box arithmetic (a region no block
covers raises) onto the standard layout, so a directory from any mesh, of either package,
restores on any other.
"""

from __future__ import annotations

import glob
import hashlib
import itertools
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
    cnn,
    transformer,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.optim import (
    is_adam_state,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
    tensor_parallel as tp,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import faults
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
    GuardState,
    TrainState,
    _tree_leaves,
    _tree_map,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    _msgpack,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.metrics import (
    is_logging_process,
)

_CNN_KEYS = frozenset(("conv1.weight", "conv1.bias", "conv2.weight", "conv2.bias",
                       "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"))
_JAX_CNN_KEYS = frozenset(("conv1_bias", "conv1_kernel", "conv2_bias", "conv2_kernel",
                           "fc1_bias", "fc1_kernel", "fc2_bias", "fc2_kernel"))
# the dtypes the JAX package's GuardState holds, field by field
_GUARD_DTYPES = {"ema_mean": np.float32, "ema_sq": np.float32}


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file exists but its bytes do not decode (or do not match their recorded
    checksum): the torn-write signature, as opposed to a missing file or a state of another
    structure. A torn write means "fall back one checkpoint"."""


def _atomic_write(path: str, data: bytes) -> None:
    if faults.active():
        data = faults.mangle_write(path, data)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _decode_msgpack(path: str):
    """Read and decode ``path``; a stream that does not decode raises
    ``CheckpointCorrupt`` naming the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _msgpack.from_bytes(data)
    except (ValueError, TypeError, OverflowError) as e:
        raise CheckpointCorrupt(
            f"checkpoint {path} is corrupt — {len(data)} bytes failed to decode "
            f"({type(e).__name__}: {e}); likely a torn/partial write, not a format "
            f"mismatch") from e


# -- the layout -------------------------------------------------------------------------


def _params_to_jax(params: dict[str, torch.Tensor]) -> dict:
    """The CNN's layout by its keys, else the transformer family's nested tree."""
    if set(params) == _CNN_KEYS:
        return cnn.params_to_jax(params)
    return transformer.params_to_jax(params)


def _count_to_jax(count) -> np.ndarray:
    return np.asarray(int(count), dtype=np.int32)


def state_to_jax_dict(state: TrainState) -> dict:
    """The JAX package's serialization form of ``state`` as host numpy arrays (see the
    module docstring): the dict whose msgpack is the checkpoint file."""
    velocity = state.velocity
    if is_adam_state(velocity):
        velocity = {"count": _count_to_jax(velocity["count"]),
                    "m": _params_to_jax(velocity["m"]), "v": _params_to_jax(velocity["v"])}
    else:
        velocity = _params_to_jax(velocity)
    out = {"params": _params_to_jax(state.params), "velocity": velocity,
           "step": _count_to_jax(state.step)}
    if state.ema is not None:
        out["ema"] = _params_to_jax(state.ema)
    if state.guard is not None:
        out["guard"] = _guard_to_jax(state.guard)
    return out


def _guard_to_jax(guard: GuardState) -> dict[str, np.ndarray]:
    return {f: np.asarray(getattr(guard, f).detach().cpu().numpy(),
                          dtype=_GUARD_DTYPES.get(f, np.int32))
            for f in GuardState._fields}


def _tensor_like(value, ref: torch.Tensor, where: str) -> torch.Tensor:
    arr = np.asarray(value)
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"checkpoint {where} has shape {tuple(arr.shape)}, the state "
                         f"{tuple(ref.shape)}")
    return torch.from_numpy(arr.copy()).to(device=ref.device, dtype=ref.dtype)


def _params_from_raw(raw: dict, ref: dict[str, torch.Tensor], where: str) -> dict:
    if not isinstance(raw, dict):
        raise ValueError(f"checkpoint {where} is a {type(raw).__name__}, not a params dict")
    if set(ref) == _CNN_KEYS:
        if set(raw) != _JAX_CNN_KEYS:
            raise ValueError(f"checkpoint {where} has keys {sorted(raw)}, the CNN's are "
                             f"{sorted(_JAX_CNN_KEYS)}")
        ported = cnn.params_from_jax(raw)
    else:
        ported = transformer.params_from_jax(raw)
        if set(ported) != set(ref):
            raise ValueError(f"checkpoint {where} holds {sorted(set(ported) - set(ref))[:4]} "
                             f"beyond the model's and lacks "
                             f"{sorted(set(ref) - set(ported))[:4]}")
    return {k: _tensor_like(ported[k], r, f"{where}/{k}") for k, r in ref.items()}


def state_from_jax_dict(raw: dict, reference_state: TrainState) -> TrainState:
    """The inverse of ``state_to_jax_dict``: a decoded checkpoint onto fresh tensors shaped,
    typed and placed like ``reference_state`` (whose optional fields the checkpoint must
    match; ``restore_train_state`` reconciles them first)."""
    ref = reference_state
    device = next(iter(ref.params.values())).device
    for field in ("ema", "guard"):
        if (getattr(ref, field) is None) != (raw.get(field) is None):
            raise ValueError(f"checkpoint and state disagree on '{field}'")
    params = _params_from_raw(raw["params"], ref.params, "params")
    if is_adam_state(ref.velocity):
        v = raw["velocity"]
        if not (isinstance(v, dict) and set(v) == {"count", "m", "v"}):
            raise ValueError("the state's optimizer is AdamW; the checkpoint's velocity "
                             "is not AdamW's {count, m, v}")
        velocity = {"m": _params_from_raw(v["m"], ref.velocity["m"], "velocity/m"),
                    "v": _params_from_raw(v["v"], ref.velocity["v"], "velocity/v"),
                    "count": _tensor_like(v["count"], ref.velocity["count"],
                                          "velocity/count")}
    else:
        velocity = _params_from_raw(raw["velocity"], ref.velocity, "velocity")
    step = torch.tensor(int(np.asarray(raw["step"])), dtype=torch.int64, device=device)
    ema = (None if ref.ema is None
           else _params_from_raw(raw["ema"], ref.ema, "ema"))
    guard = None
    if ref.guard is not None:
        if set(raw["guard"]) != set(GuardState._fields):
            raise ValueError(f"checkpoint guard has fields {sorted(raw['guard'])}")
        guard = GuardState(*(_tensor_like(raw["guard"][f], getattr(ref.guard, f),
                                          f"guard/{f}") for f in GuardState._fields))
    return TrainState(params, velocity, step, ema, guard)


def _host_copy(state: TrainState) -> TrainState:
    """Copies of every tensor of ``state`` in host memory (a device-to-host copy on the
    card, a clone on the CPU): what a write may hold while training goes on."""
    if not isinstance(state.step, torch.Tensor):
        state = state._replace(step=torch.tensor(int(state.step)))
    return _tree_map(lambda t: t.detach().to("cpu", copy=True), state)


# -- save and restore -------------------------------------------------------------------


def save_train_state(path: str, state: TrainState) -> None:
    """The full checkpoint (the reference's model.pth + optimizer.pth pair as one file).
    Rank-0 gated; a no-op elsewhere."""
    if not is_logging_process():
        return
    _atomic_write(path, _msgpack.packb(state_to_jax_dict(_host_copy(state))))


def restore_train_state(path: str, reference_state: TrainState) -> TrainState:
    """Restore ``path`` onto fresh tensors shaped like ``reference_state`` (e.g. a freshly
    initialised state, on the device to train on).

    ``ema`` reconciles across ``--ema-decay``: a checkpoint without it restores into an
    EMA reference with the EMA seeded from its params; one with it restores into a plain
    reference without it. ``guard`` likewise across ``--guard``: a checkpoint without it
    keeps the reference's fresh detector state; one with it restoring into a plain
    reference drops it. Raises ``CheckpointCorrupt`` (naming the path) when the bytes do
    not decode.

    The returned tensors are new: a captured segment built before the restore copies them
    into its static buffers at its next call, and one captured after reads them."""
    raw = _decode_msgpack(path)
    if not (isinstance(raw, dict) and "params" in raw and "step" in raw):
        raise ValueError(f"{path} is not a train-state checkpoint (a params-only export? "
                         f"read it with load_params)")
    ref = reference_state
    if ref.ema is not None and raw.get("ema") is None:
        raw["ema"] = raw["params"]
    elif ref.ema is None:
        raw.pop("ema", None)
    if ref.guard is not None and raw.get("guard") is None:
        raw["guard"] = _guard_to_jax(ref.guard)
    elif ref.guard is None:
        raw.pop("guard", None)
    return state_from_jax_dict(raw, ref)


def _emit_checkpoint_event(tele, **kw) -> None:
    """One ``checkpoint`` telemetry event through ``tele`` (a ``TelemetryWriter``, or
    None: nothing)."""
    if tele is None or not tele.enabled:
        return
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        telemetry,
    )
    tele.emit(telemetry.checkpoint_event(**kw))


def restore_for_resume(path: str, reference_state: TrainState, *, process_index: int,
                       process_count: int, steps_per_epoch: int, tele=None):
    """The data-parallel trainer's resume prologue: rank 0 restores, then broadcasts the
    full state to every rank over the process group (checkpoints are rank-0 writes, so
    without a shared filesystem only rank 0 can read one back), and the start epoch is
    derived from the step count.

    Returns ``(state, start_epoch, warning)``, ``warning`` a log-worthy message when the
    step is not a whole number of this config's epochs (a mid-epoch checkpoint, or one
    written under another batch size). ``tele`` records the restore as a ``checkpoint``
    event."""
    t0 = time.perf_counter()
    if os.path.isdir(path):
        # every rank reads the sharded directory (shared filesystem): no broadcast
        state, kind = restore_train_state_sharded(path, reference_state), "sharded"
    else:
        state, kind = reference_state, "full"
        if process_index == 0:
            state = restore_train_state(path, state)
        if process_count > 1:
            for leaf in _tree_leaves(state):
                collectives.broadcast_(leaf, src=0)
    _emit_checkpoint_event(tele, op="restore", path=path, kind=kind,
                           wall_s=time.perf_counter() - t0, step=int(state.step))
    return _derive_resume_epoch(state, steps_per_epoch)


def _derive_resume_epoch(state: TrainState, steps_per_epoch: int):
    spe = max(steps_per_epoch, 1)
    step = int(state.step)
    start_epoch = step // spe
    warning = None
    if step % spe:
        warning = (f"checkpoint step {step} is not a multiple of steps_per_epoch {spe} — "
                   f"a mid-epoch checkpoint, or one written under a different batch size; "
                   f"resuming at epoch {start_epoch} replays the partial epoch")
    return state, start_epoch, warning


# -- the sharded store -------------------------------------------------------------------


def _flatten(tree, prefix: str = "") -> dict:
    """A nested state dict -> ``{"a/b/c": leaf}``; a None subtree stays a None leaf."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _param_of(key: str) -> str | None:
    """The parameter name whose layout a flat state key follows (params, the SGD
    velocity, AdamW's moments, the EMA), or None for the scalars (step, count, guard)."""
    for head in ("params/", "ema/", "velocity/m/", "velocity/v/", "velocity/"):
        if key.startswith(head):
            rest = key[len(head):]
            return None if rest == "count" else rest.replace("/", ".")
    return None


def save_train_state_sharded(dir_path: str, state: TrainState, specs: dict[str, tuple],
                             grid) -> None:
    """The JAX package's distributed checkpoint (the module docstring): every rank writes
    the blocks it holds of ``state``, this rank's shards, laid out by ``specs``
    (``{parameter name: spec}``, the standard names) over ``grid``. A collective only in
    that every rank writes its file; rank 0 also writes the meta file and removes the
    shard files of a larger earlier writer."""
    flat = _flatten(state_to_jax_dict(_host_copy(state)))
    flat.setdefault("ema", None)
    flat.setdefault("guard", None)
    meta, shards = {}, {}
    for key, leaf in flat.items():
        if leaf is None:
            meta[key] = {"none": True}
            continue
        leaf = np.asarray(leaf)
        name = _param_of(key)
        spec = specs.get(name, (None,) * leaf.ndim) if name else (None,) * leaf.ndim
        shape = [n * grid.size(a) if a else n for n, a in zip(leaf.shape, spec)]
        meta[key] = {"shape": shape, "dtype": leaf.dtype.name}
        if any(grid.index(ax) for ax in grid.names if ax not in spec):
            continue                           # another replica writes these blocks
        ranges = tp.held_ranges(name or key, shape, spec, grid)
        blocks = []
        for pieces in itertools.product(*(list(enumerate(r)) for r in ranges)):
            start = [sl.start for _, sl in pieces]
            local = tuple(slice(j * (sl.stop - sl.start), (j + 1) * (sl.stop - sl.start))
                          for j, sl in pieces)
            blocks.append({"start": np.asarray(start, np.int64),
                           "data": np.ascontiguousarray(leaf[local])})
        shards[key] = blocks
    os.makedirs(dir_path, exist_ok=True)
    if grid.rank == 0:
        _atomic_write(os.path.join(dir_path, "meta.msgpack"),
                      _msgpack.packb({"meta": meta, "process_count": grid.world}))
        for old in glob.glob(os.path.join(dir_path, "shards_p*.msgpack")):
            idx = os.path.basename(old)[len("shards_p"):-len(".msgpack")]
            if idx.isdigit() and int(idx) >= grid.world:
                os.remove(old)
    _atomic_write(os.path.join(dir_path, f"shards_p{grid.rank}.msgpack"),
                  _msgpack.packb(shards))


def _box_subtract(box: tuple, cut: tuple) -> list:
    """Axis-aligned box difference ``box \\ cut`` as disjoint boxes (per-dim half-open
    ``(lo, hi)`` ranges; a 0-d box is removed by any cut): clip the cut to the box; if
    they are disjoint the box survives whole, else slice off the slabs below and above
    the cut dim by dim, shrinking toward the (covered) intersection."""
    inter = [(max(lo, clo), min(hi, chi)) for (lo, hi), (clo, chi) in zip(box, cut)]
    if any(lo >= hi for lo, hi in inter):
        return [box]
    pieces, cur = [], list(box)
    for d, (ilo, ihi) in enumerate(inter):
        lo, hi = cur[d]
        if lo < ilo:
            pieces.append(tuple(cur[:d]) + ((lo, ilo),) + tuple(cur[d + 1:]))
        if ihi < hi:
            pieces.append(tuple(cur[:d]) + ((ihi, hi),) + tuple(cur[d + 1:]))
        cur[d] = (ilo, ihi)
    return pieces


def restore_train_state_sharded(dir_path: str, reference_state: TrainState) -> TrainState:
    """Reassemble a sharded checkpoint directory (either package's, any writer's layout)
    onto fresh tensors in the standard layout, shaped and placed like
    ``reference_state``. Every writer's shard file must be present (the recorded writer
    count pins the file set, so a larger earlier run's stale files are never read); a
    region no block covers raises. ``ema`` and ``guard`` reconcile across the flags as
    ``restore_train_state``'s do."""
    raw_meta = _decode_msgpack(os.path.join(dir_path, "meta.msgpack"))
    meta, count = raw_meta["meta"], int(raw_meta["process_count"])
    none_keys = {k for k, m in meta.items() if m.get("none")}
    meta = {k: m for k, m in meta.items() if k not in none_keys}
    full = {k: np.zeros(m["shape"], np.dtype(m["dtype"])) for k, m in meta.items()}
    files = [os.path.join(dir_path, f"shards_p{i}.msgpack") for i in range(count)]
    missing = [f for f in files if not os.path.exists(f)]
    if missing:
        raise FileNotFoundError(
            f"sharded checkpoint {dir_path} was written by {count} process(es) but "
            f"{len(missing)} shard file(s) are absent (e.g. {os.path.basename(missing[0])})"
            f" — shared filesystem required")
    uncovered = {k: ([] if 0 in m["shape"] else [tuple((0, n) for n in m["shape"])])
                 for k, m in meta.items()}
    for path in files:
        for key, blocks in _decode_msgpack(path).items():
            for blk in blocks:
                start, data = np.asarray(blk["start"]), np.asarray(blk["data"])
                cut = tuple((int(a), int(a) + n) for a, n in zip(start, data.shape))
                full[key][tuple(slice(lo, hi) for lo, hi in cut)] = data
                uncovered[key] = [piece for box in uncovered[key]
                                  for piece in _box_subtract(box, cut)]
    short = [k for k, boxes in uncovered.items() if boxes]
    if short:
        raise ValueError(f"sharded checkpoint {dir_path} is missing blocks for {short[:3]}"
                         f"{'...' if len(short) > 3 else ''} — were all processes' shard "
                         f"files written and visible?")
    raw = _unflatten({**full, **{k: None for k in none_keys}})
    ref = reference_state
    if ref.ema is not None and raw.get("ema") is None:
        raw["ema"] = raw["params"]
    elif ref.ema is None:
        raw.pop("ema", None)
    if ref.guard is not None and raw.get("guard") is None:
        raw["guard"] = _guard_to_jax(ref.guard)
    elif ref.guard is None:
        raw.pop("guard", None)
    return state_from_jax_dict(raw, ref)


# -- the versioned store ----------------------------------------------------------------
#
# The overwrite-in-place policy above is one torn write away from having no resume
# artifact. The versioned store keeps per-epoch files named by step, a checksummed manifest,
# keep-last-N GC, and a newest-valid scan that skips a torn write.

MANIFEST_NAME = "manifest.json"
_VERSIONED_PREFIX, _VERSIONED_SUFFIX = "ckpt_", ".msgpack"


def versioned_name(step: int) -> str:
    return f"{_VERSIONED_PREFIX}{int(step):08d}{_VERSIONED_SUFFIX}"


def load_manifest(dir_path: str) -> dict:
    """The store's manifest (``{"version": 1, "entries": [...]}``; each entry
    ``file``/``step``/``sha256``/``bytes``/``unix_time``, and ``health`` and ``cursor``
    where stamped). Missing or unreadable: an empty manifest."""
    try:
        with open(os.path.join(dir_path, MANIFEST_NAME)) as f:
            man = json.load(f)
        if isinstance(man.get("entries"), list):
            return man
    except (OSError, ValueError):
        pass
    return {"version": 1, "entries": []}


def save_versioned(dir_path: str, state: TrainState, *, keep: int = 3,
                   health: dict | None = None, cursor: dict | None = None,
                   tele=None) -> str | None:
    """Write ``state`` as ``ckpt_{step:08d}.msgpack`` into the store: the file (atomic),
    then the manifest (atomic: file, step, sha256, bytes, time), then GC of everything past
    the newest ``keep`` steps, strictly after the manifest stops naming them. Rank-0 gated
    (returns None elsewhere). The checksum is of the in-memory payload, so a torn write
    mismatches its own entry and ``newest_valid_checkpoint`` skips it.

    ``health`` stamps the entry with the guard's verdict (``{"clean", "anomalies",
    "skipped", "step", "fingerprint"}``; ``newest_healthy_checkpoint`` prefers clean
    stamps); ``cursor`` the data position (``{"version", "kind": "epoch", "seed",
    "epoch", "batch", "step"}`` for the in-memory trainers; ``cursor_for``).

    Synchronous even beside ``--async-checkpoint``: the preemption contract needs this
    checkpoint durable at the boundary."""
    if not is_logging_process():
        return None
    t0 = time.perf_counter()
    keep = max(int(keep), 1)
    data = _msgpack.packb(state_to_jax_dict(_host_copy(state)))
    step = int(state.step)
    name = versioned_name(step)
    path = os.path.join(dir_path, name)
    _atomic_write(path, data)
    manifest = load_manifest(dir_path)
    entries = [e for e in manifest["entries"] if e.get("file") != name]
    entry = {"file": name, "step": step, "sha256": hashlib.sha256(data).hexdigest(),
             "bytes": len(data), "unix_time": time.time()}
    if health is not None:
        entry["health"] = dict(health)
    if cursor is not None:
        entry["cursor"] = dict(cursor)
    entries.append(entry)
    entries.sort(key=lambda e: e["step"])
    dropped, entries = entries[:-keep], entries[-keep:]
    _atomic_write(os.path.join(dir_path, MANIFEST_NAME),
                  json.dumps({"version": 1, "entries": entries}, indent=1).encode())
    for e in dropped:
        try:
            os.remove(os.path.join(dir_path, e["file"]))
        except OSError:
            pass
    _emit_checkpoint_event(tele, op="save", path=path, kind="full", nbytes=len(data),
                           wall_s=time.perf_counter() - t0, step=step)
    return path


def manifest_entry_for(path: str) -> dict | None:
    """The manifest entry of one store file, or None for a file no manifest lists."""
    name = os.path.basename(path)
    for entry in load_manifest(os.path.dirname(path) or ".")["entries"]:
        if entry.get("file") == name:
            return entry
    return None


def cursor_for(path: str) -> dict | None:
    """The data cursor stamped beside this checkpoint, or None."""
    entry = manifest_entry_for(path)
    return dict(entry["cursor"]) if entry and entry.get("cursor") else None


def check_cursor_resume(path: str, *, seed: int, step: int,
                        start_epoch: int | None = None) -> str | None:
    """Cross-check a resume target's ``kind: "epoch"`` cursor against what the trainer is
    about to do: a log-worthy warning on a mismatch (the permutation is re-derived from
    ``(seed, epoch)`` regardless, so a mismatch means the resuming config disagrees with
    the saving one), None when consistent or when there is no such cursor."""
    cursor = cursor_for(path)
    if not cursor or cursor.get("kind") != "epoch":
        return None
    problems = []
    if int(cursor.get("seed", seed)) != int(seed):
        problems.append(f"cursor seed {cursor.get('seed')} != config seed {seed} "
                        f"(the resumed epochs will reshuffle)")
    if int(cursor.get("step", step)) != int(step):
        problems.append(f"cursor step {cursor.get('step')} != checkpoint step "
                        f"{step} (manifest drifted from its file)")
    if (start_epoch is not None and cursor.get("epoch") is not None
            and int(cursor["epoch"]) != int(start_epoch)):
        problems.append(f"cursor epoch {cursor['epoch']} != derived start epoch "
                        f"{start_epoch} (a different batch size than the saving "
                        f"run?)")
    if not problems:
        return None
    return ("resume cursor mismatch for " + os.path.basename(path) + ": "
            + "; ".join(problems))


def _entry_verifies(dir_path: str, entry: dict) -> bool:
    try:
        with open(os.path.join(dir_path, entry.get("file", "")), "rb") as f:
            data = f.read()
    except OSError:
        return False
    return hashlib.sha256(data).hexdigest() == entry.get("sha256")


def newest_valid_checkpoint(dir_path: str) -> str | None:
    """The newest store file whose bytes verify: against the manifest's sha256 where there
    is a manifest, by decoding otherwise. Torn and missing files are skipped."""
    if not os.path.isdir(dir_path):
        return None
    entries = sorted(load_manifest(dir_path)["entries"], key=lambda e: e["step"],
                     reverse=True)
    if entries:
        for e in entries:
            if _entry_verifies(dir_path, e):
                return os.path.join(dir_path, e["file"])
        return None
    names = sorted((f for f in os.listdir(dir_path)
                    if f.startswith(_VERSIONED_PREFIX) and f.endswith(_VERSIONED_SUFFIX)),
                   reverse=True)
    for name in names:
        path = os.path.join(dir_path, name)
        try:
            _decode_msgpack(path)
            return path
        except (CheckpointCorrupt, OSError):
            continue
    return None


def newest_healthy_checkpoint(dir_path: str, *,
                              before_step: int | None = None) -> str | None:
    """The newest store file not stamped ``clean: false`` (clean and unstamped entries
    rank by step), optionally strictly before ``before_step``; when none survives, the
    newest valid one. Checksums verify as in ``newest_valid_checkpoint``."""
    if not os.path.isdir(dir_path):
        return None
    entries = sorted(load_manifest(dir_path)["entries"], key=lambda e: e["step"],
                     reverse=True)
    if not entries:
        return newest_valid_checkpoint(dir_path)
    for e in entries:
        if before_step is not None and e.get("step", 0) >= before_step:
            continue
        if (e.get("health") or {}).get("clean") is False:
            continue
        if _entry_verifies(dir_path, e):
            return os.path.join(dir_path, e["file"])
    return newest_valid_checkpoint(dir_path)


# -- savers -----------------------------------------------------------------------------


class AsyncCheckpointer:
    """Write-behind saves: the calling thread copies the state to host memory (the only
    cost it pays, as the JAX package's ``device_get``), a background thread lays it out,
    encodes and writes it.

    Writes to the same path coalesce: while one is in flight a newer state replaces the
    queued one (only the newest matters for an overwrite target). Writes stay atomic and
    rank-0 gated; ``flush()`` drains the queue and re-raises the first background error.
    A context manager (exit flushes). ``tele`` makes each completed write a ``checkpoint``
    event (bytes, write seconds, the queued states it coalesced away), from the worker
    thread (the writer is thread-safe)."""

    def __init__(self, tele=None):
        self._pending: dict[str, TrainState] = {}    # path -> newest host state
        self._coalesced: dict[str, int] = {}         # path -> overwrites since its write
        self._tele = tele
        self._lock = threading.Lock()
        self._work: queue.Queue = queue.Queue()      # paths with pending data
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None

    def _worker(self) -> None:
        while True:
            path = self._work.get()
            if path is None:
                return
            with self._lock:
                state = self._pending.pop(path, None)
                coalesced = self._coalesced.pop(path, 0)
            if state is None:                        # coalesced away
                continue
            try:
                t0 = time.perf_counter()
                data = _msgpack.packb(state_to_jax_dict(state))
                _atomic_write(path, data)
                _emit_checkpoint_event(self._tele, op="save", path=path, kind="full",
                                       nbytes=len(data), wall_s=time.perf_counter() - t0,
                                       step=int(state.step), background=True,
                                       coalesced=coalesced)
            except BaseException as e:               # surfaced by flush()
                with self._lock:
                    if self._error is None:
                        self._error = e

    def save_train_state(self, path: str, state: TrainState) -> None:
        """``save_train_state`` without the encode and the disk wait."""
        if not is_logging_process():
            return
        host = _host_copy(state)                     # before the next replay
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="async-checkpoint")
            self._thread.start()
        with self._lock:
            queued = path in self._pending
            if queued:
                self._coalesced[path] = self._coalesced.get(path, 0) + 1
            self._pending[path] = host
        if not queued:
            self._work.put(path)

    def flush(self) -> None:
        """Block until every queued write is durable; re-raise a background error."""
        if self._thread is not None:
            self._work.put(None)
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
        return False


class SyncSaver:
    """The synchronous saver with ``AsyncCheckpointer``'s call surface, so a trainer holds
    one saver either way; ``tele`` makes each save a ``checkpoint`` event."""

    def __init__(self, tele=None):
        self._tele = tele

    def save_train_state(self, path: str, state: TrainState) -> None:
        t0 = time.perf_counter()
        save_train_state(path, state)
        if self._tele is not None and self._tele.enabled:
            _emit_checkpoint_event(self._tele, op="save", path=path, kind="full",
                                   nbytes=os.path.getsize(path),
                                   wall_s=time.perf_counter() - t0, step=int(state.step))

    def flush(self) -> None:
        """Writes are already durable."""


def make_saver(async_: bool = False, tele=None):
    """The trainers' saver: write-behind or synchronous, both flush()-able, both emitting
    ``checkpoint`` telemetry events through ``tele``."""
    return AsyncCheckpointer(tele=tele) if async_ else SyncSaver(tele=tele)


# -- the params-only export -------------------------------------------------------------


def save_params(path: str, params: dict[str, torch.Tensor]) -> None:
    """The final params-only export (the reference's rank-0 ``torch.save(model.state_dict(),
    'model.pt')``), in the JAX layout. Rank-0 gated."""
    if not is_logging_process():
        return
    _atomic_write(path, _msgpack.packb(_params_to_jax(params)))


def load_params(path: str, reference_params: dict[str, torch.Tensor]) -> dict:
    """A ``save_params`` export onto fresh tensors shaped and placed like
    ``reference_params``."""
    return _params_from_raw(_decode_msgpack(path), reference_params, "params")


def load_params_or_state(path: str, reference_params: dict[str, torch.Tensor]) -> dict:
    """Model params from ``path``, either a full train-state checkpoint or a params-only
    export."""
    raw = _decode_msgpack(path)
    if isinstance(raw, dict) and "params" in raw:
        raw = raw["params"]
    return _params_from_raw(raw, reference_params, "params")
