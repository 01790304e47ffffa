"""Replica roles and the prefill->decode KV-handoff protocol (no ``torch`` at import).

The port's counterpart of the JAX package's ``serving/tiers.py``, speaking its handoff
wire byte for byte. Disaggregated serving splits a fleet into a **prefill tier**
(compute-bound: chew through prompt chunks, never hold a decode slot hostage) and a
**decode tier** (memory-bound: slots, KV residency, token streaming). The router steers by
request phase — a long-prompt request prefills on a prefill-tier replica, then its
finished KV planes move prefill->decode and the decode-tier replica admits the request as
a full prefix-cache hit, skipping its own prefill. Disaggregation is an OPTIMIZATION,
never a dependency: any step of it failing (no prefill capacity, a mid-handoff kill, a
CRC fault) falls back to classic local prefill on a decode/unified replica, with zero
requests lost.

The handoff rides the prefix cache: the prefill engine snapshots a finished prompt's
planes into its cache, and the decode engine installs planes from its cache. This module
is the wire between the two: a codec that turns one slot's plane tree into a JSON-safe,
CRC-stamped payload, and the always-framed socket protocol the replicas speak to each
other (``kv_handoff`` -> ``kv_handoff_ack``). Plane bytes move replica to replica; the
router only brokers WHICH decode replica receives them and imports this module for role
parsing, so it imports no ``torch``: ``encode_planes`` reads a torch tensor's bytes
through the tensor it is handed, and ``decode_planes`` imports ``torch`` when it runs.

On the wire each plane carries the dtype's numpy name (``float32``, ``bfloat16``,
``int8``, ``float8_e4m3fn``; torch's names less the ``torch.`` prefix), its shape, its
crc32 and its raw bytes in base64, so a payload is the same dict whichever package encoded
it. ``decode_planes`` rebuilds CPU tensors with ``torch.frombuffer``; bf16 and fp8 need no
``ml_dtypes``.

Layout safety is signature equality: both ends compute ``ops.quant.cache_layout`` over
their OWN engine's cache and the handoff carries the sender's signature — a decode engine
running a different KV dtype rejects the planes (they would be reinterpreted garbage),
exactly the prefix cache's own layout guard.
"""

from __future__ import annotations

import base64
import json
import socket
import zlib

import numpy as np

from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    wire as wire_mod,
)

# Replica roles. ``unified`` is the classic do-everything replica (the default
# — a fleet with no tier flags behaves byte-identically to pre-tier builds).
ROLE_UNIFIED = "unified"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLES = (ROLE_UNIFIED, ROLE_PREFILL, ROLE_DECODE)


def parse_tier_spec(spec: str | None) -> list[str]:
    """``"prefill:1,decode:2"`` -> ``["prefill", "decode", "decode"]`` — the
    per-index role list a fleet launcher assigns replicas by position.
    Empty/None -> ``[]`` (an untiered fleet). Roles must be known; counts must
    be positive."""
    roles: list[str] = []
    for part in (spec or "").replace(" ", "").split(","):
        if not part:
            continue
        role, _, count = part.partition(":")
        count = count or "1"
        if role not in ROLES or not count.isdigit() or int(count) < 1:
            raise ValueError(f"bad tier spec entry {part!r} "
                             f"(want role:count, role in {ROLES})")
        roles.extend([role] * int(count))
    return roles


def parse_shard_spec(spec: str | None) -> tuple[int, int]:
    """``"tp=2,dp=4"`` -> ``(tp, dp)``: the torch-free twin of
    ``serving.shard.parse_shard_spec`` for the router and the load generator, which
    validate and forward the flag; only a serve-mesh process builds the mesh."""
    tp = dp = 1
    for part in (spec or "").replace(" ", "").split(","):
        if not part:
            continue
        key, _, val = part.partition("=")
        if key not in ("tp", "dp") or not val.isdigit() or int(val) < 1:
            raise ValueError(f"bad shard spec entry {part!r} "
                             f"(want tp=<n>,dp=<n>)")
        if key == "tp":
            tp = int(val)
        else:
            dp = int(val)
    return tp, dp


# -----------------------------------------------------------------------------------------
# Plane codec: one slot's KV plane tree <-> a JSON-safe, CRC-stamped payload
# -----------------------------------------------------------------------------------------


def _flatten(tree, prefix=""):
    """Deterministic (sorted-key, '/'-joined) flatten of a nested-dict plane
    tree, with enough structure to rebuild the exact tree on the far side."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(_flatten(tree[key], f"{prefix}{key}/"))
        return out
    return [(prefix[:-1], tree)]


def _unflatten(entries: dict) -> dict:
    tree: dict = {}
    for path, leaf in entries.items():
        node = tree
        *parents, name = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


def _leaf_bytes(leaf) -> tuple[str, list[int], bytes]:
    """``(dtype name, shape, raw bytes)`` of one plane: a torch tensor (on any device) by
    its bytes viewed as uint8, anything else through ``np.asarray``. The dtype name is
    numpy's, which torch's is less its ``torch.`` prefix."""
    if hasattr(leaf, "element_size") and hasattr(leaf, "numel"):
        import torch

        t = leaf.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return str(t.dtype).removeprefix("torch."), [int(d) for d in t.shape], raw
    arr = np.asarray(leaf)
    return arr.dtype.name, list(arr.shape), arr.tobytes()


def _tensor_from(raw: bytes, dtype: str, shape: list[int]):
    """A CPU tensor of ``dtype`` (a numpy name) and ``shape`` over a copy of ``raw``."""
    import torch

    torch_dtype = getattr(torch, dtype, None)
    if not isinstance(torch_dtype, torch.dtype):
        raise ValueError(f"handoff plane dtype {dtype!r} has no torch counterpart")
    if not raw:
        return torch.empty(shape, dtype=torch_dtype)
    return torch.frombuffer(bytearray(raw), dtype=torch_dtype).reshape(shape)


def encode_planes(planes: dict, *, layout: str | None = None) -> dict:
    """One slot's plane tree as a JSON-safe handoff payload: per-leaf
    base64 raw bytes each stamped with its own ``crc32`` (defense in depth —
    the framed wire CRCs the whole message, the per-plane CRCs localize WHICH
    plane a fault hit), plus the sender's plane-layout signature and the total
    raw byte count (the telemetry/accounting number, pre-base64)."""
    entries = []
    total = 0
    for path, leaf in _flatten(planes):
        dtype, shape, raw = _leaf_bytes(leaf)
        total += len(raw)
        entries.append({
            "path": path,
            "dtype": dtype,
            "shape": shape,
            "crc32": zlib.crc32(raw),
            "data": base64.b64encode(raw).decode("ascii"),
        })
    return {"layout": layout, "bytes": total, "planes": entries}


def decode_planes(payload: dict, *, layout: str | None = None) -> dict:
    """Rebuild the plane tree (CPU tensors) from :func:`encode_planes` output, verifying
    every per-plane CRC and (when ``layout`` is given) the sender's layout
    signature. Raises :class:`serving.wire.WireCorrupt` on a CRC mismatch and
    ``ValueError`` on a layout mismatch — distinct faults: damage is retried
    by the connection owner, incompatibility falls back to local prefill."""
    if layout is not None and payload.get("layout") != layout:
        raise ValueError(
            f"plane layout mismatch: sender {payload.get('layout')!r} != "
            f"receiver {layout!r}")
    leaves = {}
    for entry in payload["planes"]:
        raw = base64.b64decode(entry["data"])
        crc = zlib.crc32(raw)
        if crc != entry["crc32"]:
            raise wire_mod.WireCorrupt(
                f"handoff plane {entry['path']!r} crc mismatch "
                f"(want {entry['crc32']:#010x}, got {crc:#010x})")
        leaves[entry["path"]] = _tensor_from(raw, entry["dtype"], entry["shape"])
    return _unflatten(leaves)


# -----------------------------------------------------------------------------------------
# The replica<->replica handoff socket protocol (always framed — both ends are
# new in this build, so unlike the router wire there is no legacy mode to
# negotiate away from)
# -----------------------------------------------------------------------------------------


def ship_planes(host: str, port: int, *, request_id, tokens, payload: dict,
                timeout_s: float = 10.0) -> dict:
    """Prefill side: open a connection to a decode replica's handoff
    listener, send one framed ``kv_handoff`` message, await the framed ack,
    close. Returns the ack dict (``{"op": "kv_handoff_ack", "id", "ok", ...}``).
    Socket/timeout faults surface as ``OSError``; a corrupt ack as
    :class:`WireCorrupt` — the caller (the prefill replica's ship thread)
    reports either to the router as ``prefill_failed`` and the router falls
    back to local prefill."""
    msg = {"op": "kv_handoff", "id": request_id,
           "tokens": [int(t) for t in tokens], **payload}
    with socket.create_connection((host, port), timeout=timeout_s) as sock:
        sock.sendall(wire_mod.encode_msg(msg, framed=True))
        dec = wire_mod.FrameDecoder()
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                raise OSError("handoff peer closed before ack")
            frames = dec.feed(chunk)
            if frames:
                return json.loads(frames[0])


def read_handoff(sock, *, max_bytes: int | None = None) -> dict | None:
    """Decode side: read exactly one framed message off an accepted handoff
    connection (None on clean EOF before a complete frame). ``max_bytes``
    (default: the wire's frame cap) bounds a runaway peer."""
    dec = wire_mod.FrameDecoder()
    while True:
        chunk = sock.recv(65536)
        if not chunk:
            return None
        frames = dec.feed(chunk)
        if frames:
            return json.loads(frames[0])
        if max_bytes is not None and dec.pending > max_bytes:
            raise wire_mod.WireCorrupt(
                f"handoff message exceeds {max_bytes} bytes")


def send_ack(sock, *, request_id, ok: bool, nbytes: int = 0,
             reason: str | None = None) -> None:
    """Decode side: the framed ack closing one handoff exchange."""
    msg = {"op": "kv_handoff_ack", "id": request_id, "ok": bool(ok),
           "bytes": int(nbytes)}
    if reason:
        msg["reason"] = reason
    sock.sendall(wire_mod.encode_msg(msg, framed=True))
