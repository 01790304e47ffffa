"""Deterministic fault injection: the failure modes the resilience layer survives, on
demand.

The port's own copy of the JAX package's ``resilience/faults.py`` (plain Python; the port
imports nothing of that package), with its grammar, kinds, defaults and messages, so one
``RESILIENCE_FAULTS`` value arms either package's processes alike. Every failure mode the
supervisor, the trainers and the serving replica claim to survive is injectable,
deterministically, from the environment: the faulting process is another process than the
one that arranged it, and a launcher's children inherit the environment.

``RESILIENCE_FAULTS`` holds ``;``-separated specs, each ``kind:key=value[,key=value...]``::

    RESILIENCE_FAULTS="kill:proc=1,step=8,flag=/tmp/f;torn:match=ckpt_00000008"

Tick kinds (host side, applied at a resilience tick: a trainer's epoch boundary,
``RunHooks.epoch_tick``, or the serving engine's per-step hook ``engine.on_step``, which
the replica process points at ``on_tick``, so there ``step=N`` means "after N decode
steps"):

``kill``
    ``os._exit(exit)`` at the first tick where the trigger holds: a hard crash (no atexit,
    no flushes).
``preempt``
    ``SIGTERM`` to the ticking process itself: the cooperative-stop path
    (``resilience/preemption.py``; the replica exits 75).
``freeze``
    the heartbeat stops (``heartbeat_frozen``) while the process runs on: hung, not slow.
``torn``
    a matching checkpoint write is truncated to half its bytes (``mangle_write``, called
    by ``utils.checkpoint._atomic_write``, the one path every saver writes through, the
    write-behind saver included), so the manifest's checksum refuses it.
``stall``
    the ticking thread sleeps ``secs`` seconds (default 5): a wedged host step.

Grad-poison kinds, folded into the training step (``train/step.py``) when the step is
built, env-gated, so an unarmed build adds no operation:

``nan``
    every gradient leaf becomes NaN at exactly ``step=``.
``spike``
    every gradient leaf is multiplied by ``scale=`` (default 1e6) at exactly ``step=``.
``bitflip``
    one element of each gradient leaf whose JAX tree path (``jax.tree_util.keystr`` of the
    JAX package's parameter tree, e.g. ``['conv1_kernel']`` or
    ``['block_0']['attn']['qkv_kernel']``) contains ``leaf=`` is set to ``scale=``
    (default 1e15) at exactly ``step=``: the element that is ``flat[0]`` of the JAX leaf.

Poison kinds fire at ``step ==`` exactly, as a device operation on the device-resident step
(``torch.where``), inside a captured CUDA graph too: a replayed step reproduces its poison,
which is what makes ``--skip-steps`` a complete cure. Tick kinds fire at step/epoch ``>=``
the threshold.

Trigger keys: ``proc`` (the process index to match; default: every process), ``step`` /
``epoch`` (tick kinds: fire when the tick's value is >= the threshold; unset =
immediately; rejected on ``torn``; poison kinds require ``step``), ``match`` (path
substring, ``torn`` only, required there), ``exit`` (``kill``'s exit code, default 41),
``secs`` (``stall``, default 5), ``scale`` (``spike``'s multiplier, ``bitflip``'s value),
``leaf`` (``bitflip``'s path substring, required there), ``flag`` (a marker-file path:
the fault fires at most once per process, the marker being created with a per-process
suffix, so a restarted run that replays the step does not fire again; tick kinds only).

The process index that ``proc`` matches and that suffixes ``flag``: the index a process set
with ``set_process_index`` (the replica process sets its ``--replica-id``, which both
packages' routers pass), else ``RANK`` (the port's launcher, ``train/launch.py``; a
router's one-process replica fleet is rank 0 of 1, its index in ``FLEET_PROCESS_ID``),
else ``JAX_PROCESS_ID`` (what the JAX package's launcher and router set), else 0.

With ``RESILIENCE_FAULTS`` unset, ``active()`` is one dict lookup and every hook returns at
once.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import signal
import sys
import time

ENV_VAR = "RESILIENCE_FAULTS"

#: Grad-poison kinds: compiled into the train step (exact-step equality), not
#: applied on the host tick path.
POISON_KINDS = ("nan", "spike", "bitflip")

KINDS = ("kill", "preempt", "freeze", "torn", "stall") + POISON_KINDS
DEFAULT_KILL_EXIT = 41
DEFAULT_STALL_SECS = 5.0
DEFAULT_SPIKE_SCALE = 1e6
DEFAULT_BITFLIP_VALUE = 1e15


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    proc: int | None = None     # None: any process
    step: int | None = None     # tick kinds: fire when step >= this;
    #                             poison kinds: fire when step == this
    epoch: int | None = None    # fire when tick epoch >= this
    flag: str = ""              # marker file: fire at most once per process
    exit: int = DEFAULT_KILL_EXIT
    match: str = ""             # path substring (torn)
    secs: float = DEFAULT_STALL_SECS   # stall sleep length
    scale: float = 0.0          # spike multiplier / bitflip planted value
    leaf: str = ""              # bitflip: grad-leaf path substring to corrupt


def active() -> bool:
    """True iff fault injection is armed (the zero-cost gate every hook checks)."""
    return bool(os.environ.get(ENV_VAR))


@functools.lru_cache(maxsize=8)
def _parse(spec: str) -> tuple[Fault, ...]:
    faults = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition(":")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {ENV_VAR} "
                             f"(known: {', '.join(KINDS)})")
        kwargs: dict = {"kind": kind}
        for kv in filter(None, rest.split(",")):
            key, _, value = kv.partition("=")
            if key in ("proc", "step", "epoch", "exit"):
                kwargs[key] = int(value)
            elif key in ("secs", "scale"):
                kwargs[key] = float(value)
            elif key in ("flag", "match", "leaf"):
                kwargs[key] = value
            else:
                raise ValueError(f"unknown fault key {key!r} in {ENV_VAR} spec {part!r}")
        if kind in POISON_KINDS and "scale" not in kwargs:
            kwargs["scale"] = (DEFAULT_BITFLIP_VALUE if kind == "bitflip"
                               else DEFAULT_SPIKE_SCALE)
        fault = Fault(**kwargs)
        if fault.kind in POISON_KINDS:
            # Poison fires INSIDE the compiled step at one exact step — the
            # trigger must be fully data-independent of the host tick path.
            if fault.step is None:
                raise ValueError(f"{fault.kind} faults fire at one exact step "
                                 f"inside the compiled program — add step= to "
                                 f"{part!r}")
            if fault.epoch is not None or fault.flag:
                raise ValueError(f"{fault.kind} faults trigger by exact step "
                                 f"equality in-program — epoch=/flag= do not "
                                 f"apply to {part!r}")
            if fault.kind == "bitflip" and not fault.leaf:
                raise ValueError(f"bitflip needs a leaf= grad-path substring: "
                                 f"{part!r}")
        if fault.kind == "torn":
            # Torn faults fire on the WRITE path, which has no tick step/epoch to
            # compare against — a step/epoch key would silently never trigger.
            if fault.step is not None or fault.epoch is not None:
                raise ValueError(f"torn faults trigger by path match, not by tick "
                                 f"— drop step/epoch from {part!r}")
            if not fault.match:
                raise ValueError(f"torn fault needs a match= path substring: {part!r}")
        faults.append(fault)
    return tuple(faults)


def get_faults() -> tuple[Fault, ...]:
    return _parse(os.environ.get(ENV_VAR, ""))


_PROCESS_INDEX: int | None = None


def set_process_index(index: int | None) -> None:
    """Fix this process's index for ``proc`` and ``flag`` (the replica process: its
    ``--replica-id``); None returns to the environment's."""
    global _PROCESS_INDEX
    _PROCESS_INDEX = None if index is None else int(index)


def _proc_index() -> int:
    """This process's index by the module docstring's rule; a single process is 0."""
    if _PROCESS_INDEX is not None:
        return _PROCESS_INDEX
    for name in ("RANK", "JAX_PROCESS_ID"):
        value = os.environ.get(name)
        if value:
            return int(value)
    return 0


def _triggered(f: Fault, *, step: int | None, epoch: int | None) -> bool:
    if f.proc is not None and f.proc != _proc_index():
        return False
    if f.step is not None and (step is None or step < f.step):
        return False
    if f.epoch is not None and (epoch is None or epoch < f.epoch):
        return False
    return True


def _claim_once(f: Fault) -> bool:
    """True iff this firing is allowed. A ``flag`` marker file (suffixed per process,
    so fleet peers fire independently) is claimed exclusively — a restart that replays
    the trigger sees the marker and stays quiet."""
    if not f.flag:
        return True
    path = f"{f.flag}.p{_proc_index()}"
    try:
        with open(path, "x") as fh:
            fh.write(f"{f.kind} fired (pid {os.getpid()})\n")
        return True
    except FileExistsError:
        return False


def grad_poisons() -> tuple[Fault, ...]:
    """The armed grad-poison faults that match this process: what ``train/step.py`` folds
    into the step when it is built. Empty (one dict lookup) when injection is unarmed,
    so the step has the same operations as without this module."""
    if not active():
        return ()
    return tuple(f for f in get_faults() if f.kind in POISON_KINDS
                 and (f.proc is None or f.proc == _proc_index()))


def on_tick(*, step: int | None = None, epoch: int | None = None) -> None:
    """A resilience tick (a trainer's epoch boundary, a replica's engine step): apply any
    armed kill, preempt or stall fault."""
    if not active():
        return
    for f in get_faults():
        if not _triggered(f, step=step, epoch=epoch):
            continue
        if f.kind == "kill" and _claim_once(f):
            print(f"[faults] kill: process {_proc_index()} exiting {f.exit} "
                  f"at step {step}", file=sys.stderr, flush=True)
            sys.stderr.flush()
            os._exit(f.exit)        # a hard crash: no atexit, no flushes
        elif f.kind == "preempt" and _claim_once(f):
            print(f"[faults] preempt: SIGTERM to process {_proc_index()} "
                  f"at step {step}", file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGTERM)
        elif f.kind == "stall" and _claim_once(f):
            print(f"[faults] stall: process {_proc_index()} sleeping "
                  f"{f.secs:.1f}s at step {step}", file=sys.stderr, flush=True)
            time.sleep(f.secs)


def heartbeat_frozen(*, step: int | None = None, epoch: int | None = None) -> bool:
    """True while a ``freeze`` fault holds — the heartbeat writer then skips its beat
    (the process is alive but looks dead to the supervisor, by design)."""
    if not active():
        return False
    return any(f.kind == "freeze" and _triggered(f, step=step, epoch=epoch)
               for f in get_faults())


def mangle_write(path: str, data: bytes) -> bytes:
    """Apply any armed ``torn`` fault to a pending write: matching paths get their
    payload truncated to half (the torn-write artifact checksum validation must catch).
    Called by the checkpoint writer's ``_atomic_write`` only when ``active()``."""
    if not active():
        return data
    for f in get_faults():
        if (f.kind == "torn" and f.match and f.match in path
                and _triggered(f, step=None, epoch=None) and _claim_once(f)):
            print(f"[faults] torn: truncating write to {path} "
                  f"({len(data)} -> {len(data) // 2} bytes)",
                  file=sys.stderr, flush=True)
            return data[:len(data) // 2]
    return data
