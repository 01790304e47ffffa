"""Local multi-process launcher — run one command as N rendezvous'd processes.

Counterpart of the JAX package's ``train/launch.py`` (this package's own copy; that module
imports no JAX but belongs to the JAX package). The launch contract: **every process runs
the same command**, and its coordinates arrive in torch's environment contract
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), which ``parallel.mesh.initialize_cluster`` reads — the variables
``torchrun`` sets too — plus ``FLEET_PROCESS_ID`` (``Fleet(process_id_base=)``). All
processes run on this host; rank 0 hosts the rendezvous store on ``--port`` (default: a
free port, found by binding port 0; a port this process handed out stays reserved for a
while, so fleets and replica ports picked together never share one).

Usage (a world of 2 on the CPU)::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.launch \\
        --num-processes 2 -- \\
        -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.smoke \\
        --device cpu

Everything after ``--`` is passed to ``python`` in each process. Exit status is 0 iff every
process exits 0. Under ``--fail-fast`` (the default) the first nonzero child exit SIGTERMs
the rest of the fleet at once — peers blocked on a dead partner's rendezvous or collective
are torn down, not waited out; ``--no-fail-fast`` lets every child run to its own exit (the
first nonzero code is still reported). ``--timeout`` bounds the whole fleet's wall time:
on expiry every child is killed and the launcher exits 124.
"""

from __future__ import annotations

import argparse
import collections
import os
import socket
import subprocess
import sys
import threading
import time

# Ports ``_free_port`` handed out lately: the caller binds one some time after the probe
# socket closed, so until then the kernel may hand the same port to the next probe.
_RECENT_PORTS: collections.deque = collections.deque(maxlen=4096)
_PORTS_LOCK = threading.Lock()

# Seconds the rest of a world may take to follow a rank that exited 0 (a drained or
# stopped replica's followers leave their loop and exit on their own).
WORLD_CLEAN_EXIT_GRACE_S = 10.0


def _free_port() -> int:
    """A free local port, never one this process handed out lately."""
    with _PORTS_LOCK:
        while True:
            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            if port not in _RECENT_PORTS:
                _RECENT_PORTS.append(port)
                return port


def _child_env(base: dict, *, port: int, num_processes: int, rank: int,
               process_id: int | None = None) -> dict:
    env = dict(base)
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(num_processes), RANK=str(rank), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(num_processes),
               FLEET_PROCESS_ID=str(rank if process_id is None else process_id))
    return env


class Fleet:
    """A running fleet as one unit: spawn, poll, teardown."""

    def __init__(self, command: list[str], *, num_processes: int,
                 port: int | None = None, env: dict | None = None,
                 process_id_base: int = 0, whole: bool = False):
        """``process_id_base`` offsets the children's fleet-wide identity,
        ``FLEET_PROCESS_ID`` = base + rank: the serving router runs one fleet per
        replica (so replicas crash and restart one by one), and the offset keeps each
        replica's index. ``RANK``/``WORLD_SIZE`` stay the fleet's own (0 of 1 for a
        replica), so no child of a base > 0 looks to ``torch.distributed`` like a rank
        outside its world. A replica's fault ``proc=`` and heartbeat index come from its
        ``--replica-id`` (``faults.set_process_index``), which the router passes.

        ``whole=True`` makes the processes one unit, as a sharded replica's world of
        ranks is: every rank's ``FLEET_PROCESS_ID`` is the base itself, and the first
        rank to exit ends the world. A watcher thread tears the other ranks down at once
        (or, when that first exit was 0, after ``WORLD_CLEAN_EXIT_GRACE_S`` for them to
        follow), so no rank is left waiting out a collective on a dead peer, and
        ``poll`` reports the first rank's exit code, never that of a rank the teardown
        ended."""
        self.port = port or _free_port()
        self.whole = whole
        base = dict(os.environ if env is None else env)
        self.procs = [
            subprocess.Popen([sys.executable, *command],
                             env=_child_env(base, port=self.port,
                                            num_processes=num_processes, rank=i,
                                            process_id=process_id_base + (0 if whole
                                                                          else i)))
            for i in range(num_processes)
        ]
        self._first_failure: int | None = None
        self.first_exit: tuple[int, int] | None = None     # (rank, code), whole only
        self._exit_lock = threading.Lock()
        if whole:
            threading.Thread(target=self._watch, daemon=True,
                             name="fleet-world-watch").start()

    def _note_first_exit(self) -> tuple[int, int] | None:
        """A world's first exit, recorded once: the watcher's poll, or ``poll``'s when
        the whole world ended between two of the watcher's."""
        with self._exit_lock:
            if self.first_exit is None:
                for rank, p in enumerate(self.procs):
                    rc = p.poll()
                    if rc is not None:
                        self.first_exit = (rank, rc)
                        if rc != 0:
                            self._first_failure = rc
                        break
            return self.first_exit

    def _watch(self) -> None:
        """A world's watcher: wait for the first rank to exit, then end the rest."""
        while self._note_first_exit() is None:
            time.sleep(0.02)
        if self.first_exit[1] == 0:
            deadline = time.monotonic() + WORLD_CLEAN_EXIT_GRACE_S
            while self.running and time.monotonic() < deadline:
                time.sleep(0.02)
        self.terminate(grace=2.0)

    def poll(self) -> int | None:
        """Reap finished children; return the first nonzero exit code observed so far
        (sticky), or None while none has failed. A whole world's is the exit code of
        its first rank to exit, when that was not 0."""
        if self.whole:
            self._note_first_exit()
            return self._first_failure
        for p in self.procs:
            rc = p.poll()
            if rc is not None and rc != 0 and self._first_failure is None:
                self._first_failure = rc
        return self._first_failure

    @property
    def running(self) -> bool:
        return any(p.poll() is None for p in self.procs)

    def send_signal(self, sig) -> None:
        """Deliver ``sig`` to every live child (a supervisor forwarding a preemption)."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass

    def terminate(self, grace: float = 10.0) -> None:
        """SIGTERM every live child, give the fleet ``grace`` seconds together to exit,
        then SIGKILL stragglers and reap everything — a hung or failed peer leaves no
        process behind."""
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + grace
        for p in self.procs:
            try:
                p.wait(timeout=max(0.01, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def launch(command: list[str], *, num_processes: int, port: int | None = None,
           timeout: float | None = None, fail_fast: bool = True,
           env: dict | None = None) -> int:
    """Spawn ``python <command>`` ``num_processes`` times with the rendezvous environment
    (over ``env``, default this process's); returns the first nonzero child exit code,
    else 0. Output streams through the inherited stdout/stderr (rank-0 gating in
    ``utils.metrics.log`` keeps it single-voiced).

    ``fail_fast`` (default): the first nonzero exit tears the fleet down at once.
    ``fail_fast=False`` lets every child run to its own exit first. Either way ``timeout``
    bounds the total wall time (exit 124, the coreutils ``timeout`` convention)."""
    fleet = Fleet(command, num_processes=num_processes, port=port, env=env)
    deadline = None if timeout is None else time.monotonic() + timeout
    result: int | None = None
    try:
        while fleet.running:
            rc = fleet.poll()
            if rc is not None and fail_fast:
                result = rc
                break
            if deadline is not None and time.monotonic() > deadline:
                result = 124
                break
            time.sleep(0.05)
        if result is None:       # clean drain, or --no-fail-fast ran everyone to exit
            result = fleet.poll()
    finally:
        fleet.terminate()
    return result or 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n", 1)[0],
        usage="python -m ....train.launch --num-processes N [options] -- <python args>")
    parser.add_argument("--num-processes", type=int, default=2)
    parser.add_argument("--port", type=int, default=None,
                        help="rendezvous port (default: pick a free one)")
    parser.add_argument("--timeout", type=float, default=None,
                        help="wall-clock seconds before the whole fleet is killed "
                             "(exit 124); default: wait for ever")
    parser.add_argument("--fail-fast", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="SIGTERM the rest of the fleet the moment any child "
                             "exits nonzero; --no-fail-fast lets every child run to its "
                             "own exit")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="everything after -- is run as: python <command>")
    args = parser.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        parser.error("no command given — pass e.g. `-- -m <module> [args]`")
    if args.num_processes < 1:
        parser.error(f"--num-processes must be >= 1, got {args.num_processes}")
    return launch(command, num_processes=args.num_processes, port=args.port,
                  timeout=args.timeout, fail_fast=args.fail_fast)


if __name__ == "__main__":
    raise SystemExit(main())
