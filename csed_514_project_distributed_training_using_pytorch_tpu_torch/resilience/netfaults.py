"""Deterministic network-fault injection: a seeded in-process TCP chaos proxy.

The port's own copy of the JAX package's ``resilience/netfaults.py`` (plain Python; the
port imports nothing of that package): the same grammar, schedules and seeded positions.

``resilience/faults.py`` made every PROCESS failure the fleet claims to
survive injectable on demand (kill/preempt/freeze/stall/torn). This module is
the same doctrine for the WIRE: the router↔replica TCP stream is the one
transport the serve path owns, and "a corrupt byte", "a truncated completion
line", "a link that adds 800ms", "a connection that just closes" are the gray
failures DESIGN.md §23 exists for. Each is injectable, deterministically,
between any router and replica — by routing the connection through a
:class:`ChaosProxy` whose per-connection schedule comes from a spec string.

Spec grammar (``;``-separated, ``kind:key=value[,key=value...]`` — the
``RESILIENCE_FAULTS`` shape; the env var here is ``NETWORK_FAULTS``)::

    NETWORK_FAULTS="delay:replica=1,dir=s2c,ms=800,count=20;corrupt:replica=0,after=5"

Kinds (all applied to forwarded stream units — on this protocol's loopback
sockets with TCP_NODELAY and message-at-a-time writers, one recv'd unit is in
practice one protocol message, which is what makes counter-based schedules
reproducible):

``delay``
    sleep ``ms`` milliseconds before forwarding each matching unit from index
    ``after`` for ``count`` units (``count=0`` = every unit from ``after`` on)
    — the 10x straggler: the replica computes at full speed, the LINK is slow.
``stall``
    one-time ``secs`` sleep before forwarding unit ``after`` — a wedged
    middlebox; long enough, it trips the receiver's recv deadline.
``drop``
    close both directions when unit ``after`` arrives — the silent connection
    reset that must surface as a typed reconnect + ledger drain, never a hang.
``corrupt``
    flip one byte (seeded position) in units ``[after, after+count)`` — the
    flipped-bit-in-flight that framing's CRC (or the newline parser's typed
    reject) must contain.
``truncate``
    forward only the first half of unit ``after``, then close — the torn
    line/frame a peer's death mid-write leaves on the stream.

Trigger keys: ``replica`` (the proxy's id — the router runs one proxy per
replica, id = replica index; unset = every proxy), ``conn`` (connection
ordinal within the proxy, 0-based across reconnects; unset = every
connection), ``dir`` (``c2s`` router→replica, ``s2c`` replica→router,
default both), ``after`` (units forwarded in the matching direction before
firing, default 0), ``count`` (delay/corrupt repetition, default 1; ``0`` on
``delay`` = forever), ``ms`` (delay), ``secs`` (stall, default 5).

Determinism rules (the chaos-harness contract, pinned in tests): schedules
are COUNTER-based per (connection, direction) — no wall clocks, no
probabilities; the only randomness is the corrupt-byte position, drawn from
``random.Random(seed ^ proxy_id ^ conn)`` so a rerun with the same seed
damages the same offsets. Everything is plain stdlib: the proxy lives in the
router's process, which must never touch a device.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import random
import socket
import threading
import time

ENV_VAR = "NETWORK_FAULTS"

KINDS = ("delay", "stall", "drop", "corrupt", "truncate")
DIRS = ("c2s", "s2c", "both")
DEFAULT_STALL_SECS = 5.0


@dataclasses.dataclass(frozen=True)
class NetFault:
    kind: str
    replica: int | None = None   # proxy id to match (router: replica index)
    conn: int | None = None      # connection ordinal within the proxy
    dir: str = "both"            # which direction the schedule watches
    after: int = 0               # units forwarded before the fault fires
    count: int = 1               # delay/corrupt: units affected (0 = forever)
    ms: float = 0.0              # delay per unit, milliseconds
    secs: float = DEFAULT_STALL_SECS  # stall sleep


@functools.lru_cache(maxsize=8)
def parse(spec: str) -> tuple[NetFault, ...]:
    """Parse a spec string (see module docstring). Unknown kinds/keys raise —
    a typo'd chaos spec must fail the harness loudly, not silently run an
    unfaulted fleet and report it as the chaos leg."""
    faults = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition(":")
        if kind not in KINDS:
            raise ValueError(f"unknown netfault kind {kind!r} "
                             f"(known: {', '.join(KINDS)})")
        kwargs: dict = {"kind": kind}
        for kv in filter(None, rest.split(",")):
            key, _, value = kv.partition("=")
            if key in ("replica", "conn", "after", "count"):
                kwargs[key] = int(value)
            elif key in ("ms", "secs"):
                kwargs[key] = float(value)
            elif key == "dir":
                if value not in DIRS:
                    raise ValueError(f"netfault dir must be one of {DIRS}, "
                                     f"got {value!r}")
                kwargs[key] = value
            else:
                raise ValueError(f"unknown netfault key {key!r} in {part!r}")
        faults.append(NetFault(**kwargs))
    return tuple(faults)


def from_env() -> tuple[NetFault, ...]:
    return parse(os.environ.get(ENV_VAR, ""))


class _ConnSchedule:
    """One direction of one proxied connection: applies the matching faults to
    a stream of units, counting as it goes."""

    def __init__(self, faults, proxy_id: int, conn: int, direction: str,
                 seed: int, on_fault):
        self.faults = [f for f in faults
                       if (f.replica is None or f.replica == proxy_id)
                       and (f.conn is None or f.conn == conn)
                       and f.dir in (direction, "both")]
        self.proxy_id = proxy_id
        self.conn = conn
        self.direction = direction
        self.on_fault = on_fault
        self._rng = random.Random(seed ^ (proxy_id << 8) ^ conn)
        self._n = 0

    def _fired(self, f: NetFault, unit: int, **extra) -> None:
        if self.on_fault is not None:
            self.on_fault({"kind": f.kind, "replica": self.proxy_id,
                           "conn": self.conn, "dir": self.direction,
                           "unit": unit, **extra})

    def apply(self, unit: bytes) -> tuple[bytes | None, bool]:
        """Transform one unit. Returns ``(data, close)``: ``data`` to forward
        (None = nothing) and whether to tear the connection down after."""
        n = self._n
        self._n += 1
        close = False
        for f in self.faults:
            if f.kind == "delay":
                if n >= f.after and (f.count == 0 or n < f.after + f.count):
                    self._fired(f, n, ms=f.ms)
                    time.sleep(f.ms / 1000.0)
            elif f.kind == "stall":
                if n == f.after:
                    self._fired(f, n, secs=f.secs)
                    time.sleep(f.secs)
            elif f.kind == "drop":
                if n == f.after:
                    self._fired(f, n)
                    return None, True
            elif f.kind == "corrupt":
                if n >= f.after and n < f.after + max(f.count, 1) and unit:
                    pos = self._rng.randrange(len(unit))
                    self._fired(f, n, pos=pos)
                    unit = unit[:pos] + bytes([unit[pos] ^ 0xFF]) \
                        + unit[pos + 1:]
            elif f.kind == "truncate":
                if n == f.after:
                    self._fired(f, n, kept=len(unit) // 2)
                    return unit[:len(unit) // 2], True
        return unit, close


class ChaosProxy:
    """A TCP forwarder between one client (the router) and one target (a
    replica) that applies a seeded fault schedule to the stream. In-process:
    ``start()`` binds a loopback port and returns it; every accepted
    connection gets two pump threads (one per direction) and its own
    counter-based schedules. ``stop()`` tears everything down."""

    def __init__(self, target_port: int, spec: str = "", *, proxy_id: int = 0,
                 seed: int = 0, on_fault=None):
        self.target_port = int(target_port)
        self.faults = parse(spec) if spec else from_env()
        self.proxy_id = int(proxy_id)
        self.seed = int(seed)
        self.on_fault = on_fault
        self.port = 0
        self.conns = 0
        self._lsock: socket.socket | None = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def start(self) -> int:
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(8)
        self._lsock.settimeout(0.2)
        self.port = self._lsock.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"chaos-accept-{self.proxy_id}")
        t.start()
        self._threads.append(t)
        return self.port

    def stop(self) -> None:
        self._stop.set()
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                upstream = socket.create_connection(
                    ("127.0.0.1", self.target_port), timeout=5.0)
            except OSError:
                client.close()
                continue
            # The ordinal counts ESTABLISHED pairs only: while the target is
            # still binding its port, the client's connect-retry loop churns
            # accepted-then-failed sockets, and burning ordinals on those
            # would make `conn=` schedules land on a nondeterministic
            # connection.
            conn_id = self.conns
            self.conns += 1
            for s in (client, upstream):
                try:
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                except OSError:
                    pass
            for direction, src, dst in (("c2s", client, upstream),
                                        ("s2c", upstream, client)):
                sched = _ConnSchedule(self.faults, self.proxy_id, conn_id,
                                      direction, self.seed, self.on_fault)
                t = threading.Thread(
                    target=self._pump, args=(src, dst, sched, client, upstream),
                    daemon=True,
                    name=f"chaos-{self.proxy_id}-{conn_id}-{direction}")
                t.start()
                self._threads.append(t)

    def _pump(self, src, dst, sched: _ConnSchedule, client, upstream) -> None:
        try:
            try:
                src.settimeout(0.2)
            except OSError:          # the other direction already closed both ends
                return
            while not self._stop.is_set():
                try:
                    unit = src.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not unit:
                    break
                data, close = sched.apply(unit)
                if data:
                    try:
                        dst.sendall(data)
                    except OSError:
                        break
                if close:
                    break
        finally:
            # One side down tears both down: half-open proxied connections
            # would leave the peers disagreeing about liveness — the exact
            # ambiguity the fleet's typed faults exist to remove.
            for s in (client, upstream):
                try:
                    s.close()
                except OSError:
                    pass
