"""Hardened wire plumbing for the router↔replica TCP protocol.

The port's own copy of the JAX package's ``serving/wire.py`` (plain Python; the port
imports nothing of that package): the same frames, CRC and negotiation, so the port's
router and replicas speak to the JAX package's byte for byte.

The fleet protocol was born as newline-delimited JSON: one object per line,
both directions, self-synchronizing on ``\\n`` and trivially debuggable with
``nc``. What it could NOT do is *detect* damage: a single corrupt byte inside
a line is an untyped ``json.JSONDecodeError`` somewhere deep in an io thread,
and a truncated line (the peer died mid-write, a proxy cut the stream) is
silently glued to the next one. Gray failures live exactly there — DESIGN.md
§23. This module is the shared hardening layer both ends speak:

- **framing** — ``MAGIC(2) | length(4, big-endian) | crc32(4) | payload`` per
  message. The CRC turns "a flipped bit somewhere" into a typed
  :class:`WireCorrupt` at the frame boundary; the magic + length sanity check
  turns a desynchronized stream (torn frame, half a message) into the same
  typed fault instead of an unbounded buffer or a garbage parse. Framing is
  **negotiated, never assumed**: the replica's newline-JSON ``hello``
  advertises ``"caps": ["framed1"]``, and the router opts in by replying a
  newline-JSON ``hello_ack`` carrying the same capability — only then do both
  directions switch to frames. A legacy peer (a pre-framing router that sends
  its first op directly, or a replica whose hello carries no caps) keeps the
  byte-identical newline protocol forever — pinned in tests.
- **decoders** — incremental, allocation-light push parsers for both modes.
  ``LineDecoder`` is the legacy splitter (complete lines only — a partial
  trailing line stays buffered, the ``fleet_top`` tailer rule).
  ``FrameDecoder`` validates magic/length/CRC and raises :class:`WireCorrupt`
  with a reason string; the connection owner rejects-and-reconnects (the
  ledger drain on reconnect is what makes a lost completion safe — the
  at-least-once machinery replays it).
- **decorrelated-jitter backoff** — ``next = min(cap, uniform(base, prev*3))``
  (the AWS "decorrelated jitter" schedule). A fleet-wide blip that fails every
  replica at once must not produce a synchronized restart storm N backoffs
  later; jitter decorrelates the retry instants while the seeded RNG keeps
  every schedule reproducible for tests.

Plain stdlib: the router imports this and must never touch a device.
"""

from __future__ import annotations

import json
import random
import struct
import zlib

# The capability token the replica's hello advertises and the router's
# hello_ack echoes. Versioned: a future frame format bumps the suffix and
# negotiation picks the newest token both sides know.
CAP_FRAMED = "framed1"

# Frame layout: MAGIC | payload length | crc32(payload) | payload.
MAGIC = b"\xf7\xc7"
_HEADER = struct.Struct("!2sII")

# A frame claiming more than this is a desynchronized stream, not a message
# (the biggest real message — a warm replay of hot prefixes — is ~100 KiB).
MAX_FRAME_BYTES = 64 << 20


class WireCorrupt(Exception):
    """Typed wire damage: bad magic, insane length, or a CRC mismatch.

    The contained, retried fault the hardening exists for — the connection
    owner closes the socket and reconnects (draining its ledger), it never
    lets the damage surface as an anonymous stack-trace death."""


def encode_frame(payload: bytes) -> bytes:
    """One message as a wire frame. ``payload`` is the JSON bytes WITHOUT a
    trailing newline (the frame boundary replaces it)."""
    return _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload


def encode_msg(obj: dict, *, framed: bool) -> bytes:
    """The mode-aware message encoder both peers write through: the SAME JSON
    bytes either newline-terminated (legacy) or framed. One owner for the
    dump call keeps the payload bytes identical across modes — the framed
    path wraps the legacy line's bytes, it never re-serializes differently."""
    payload = json.dumps(obj).encode()
    if framed:
        return encode_frame(payload)
    return payload + b"\n"


def write_msg(wfile, lock, obj: dict, *, framed: bool) -> None:
    """The locked, mode-aware message write BOTH peers' senders share: encode,
    write, flush under ``lock``, and normalize the closed-file ``ValueError``
    (a late completion racing teardown) into ``OSError`` — the one exception
    type every connection-level caller already handles. One owner, so the
    framing/teardown contract can never drift between the router's and the
    replica's half of the wire."""
    data = encode_msg(obj, framed=framed)
    try:
        with lock:
            wfile.write(data)
            wfile.flush()
    except ValueError as e:          # "write to closed file" == conn down
        raise OSError(str(e)) from e


class LineDecoder:
    """Incremental newline-JSON splitter: ``feed(chunk)`` returns the COMPLETE
    lines that arrived (bytes, newline stripped); a trailing partial line
    stays buffered until its newline arrives. A partial line exceeding
    ``MAX_FRAME_BYTES`` raises :class:`WireCorrupt` — a peer streaming bytes
    with no newline forever must become a typed fault, not unbounded buffer
    growth (the same cap the framed mode enforces via its length field)."""

    def __init__(self) -> None:
        self._buf = b""

    @property
    def pending(self) -> int:
        """Bytes buffered without a message boundary — the 'half a line,
        forever' signal the replica's stall deadline watches."""
        return len(self._buf)

    def feed(self, chunk: bytes) -> list[bytes]:
        self._buf += chunk
        out = []
        while True:
            line, sep, rest = self._buf.partition(b"\n")
            if not sep:
                break
            self._buf = rest
            if line:
                out.append(line)
        if len(self._buf) > MAX_FRAME_BYTES:
            raise WireCorrupt(
                f"unterminated line exceeds {MAX_FRAME_BYTES} bytes "
                f"(newline-free stream)")
        return out


class FrameDecoder:
    """Incremental frame parser: ``feed(chunk)`` returns complete payloads and
    raises :class:`WireCorrupt` on bad magic / insane length / CRC mismatch.
    After a corrupt frame the stream position is untrustworthy by definition
    (the length field itself may be damaged), so the decoder does NOT try to
    resynchronize — the connection owner tears down and reconnects."""

    def __init__(self) -> None:
        self._buf = b""

    @property
    def pending(self) -> int:
        return len(self._buf)

    def feed(self, chunk: bytes) -> list[bytes]:
        self._buf += chunk
        out = []
        while len(self._buf) >= _HEADER.size:
            magic, length, crc = _HEADER.unpack_from(self._buf)
            if magic != MAGIC:
                raise WireCorrupt(
                    f"bad frame magic {magic!r} (stream desynchronized)")
            if length > MAX_FRAME_BYTES:
                raise WireCorrupt(
                    f"frame length {length} exceeds {MAX_FRAME_BYTES} "
                    f"(length field damaged?)")
            if len(self._buf) < _HEADER.size + length:
                break
            payload = self._buf[_HEADER.size:_HEADER.size + length]
            self._buf = self._buf[_HEADER.size + length:]
            actual = zlib.crc32(payload)
            if actual != crc:
                raise WireCorrupt(
                    f"frame crc mismatch (want {crc:#010x}, got "
                    f"{actual:#010x}, {length} bytes)")
            out.append(payload)
        return out


def hello_wants_framing(hello: dict) -> bool:
    """True when a replica's hello advertises the framed capability (the
    router-side half of the negotiation)."""
    caps = hello.get("caps")
    return isinstance(caps, (list, tuple)) and CAP_FRAMED in caps


def make_hello_ack() -> dict:
    """The router's opt-in line: newline-JSON (the last legacy-mode message on
    a framed connection), echoing the capability it accepts."""
    return {"op": "hello_ack", "caps": [CAP_FRAMED]}


class JitterBackoff:
    """Seeded decorrelated-jitter backoff schedule (AWS style):
    ``next = min(cap, uniform(base, prev * 3))``, starting at ``base``.

    Deterministic given ``seed`` — tests pin the schedule — while distinct
    seeds (one per replica index) decorrelate a fleet-wide restart storm:
    after a blip that fails every replica at the same instant, the retry
    instants spread instead of thundering back in lockstep. ``reset()``
    re-arms after a success (a healthy stretch forgives the history)."""

    def __init__(self, base_s: float, cap_s: float, *, seed: int = 0):
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self._rng = random.Random(seed)
        self._prev = 0.0

    def next(self) -> float:
        if self.base_s <= 0:
            return 0.0
        if self._prev <= 0:
            self._prev = self.base_s
        else:
            self._prev = min(self.cap_s,
                             self._rng.uniform(self.base_s, self._prev * 3.0))
        return self._prev

    def reset(self) -> None:
        self._prev = 0.0
