"""Local multi-process launcher — run one command as N rendezvous'd processes.

Counterpart of the JAX package's ``train/launch.py`` (this package's own copy; that module
imports no JAX but belongs to the JAX package). The launch contract: **every process runs
the same command**, and its coordinates arrive in torch's environment contract
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), which ``parallel.mesh.initialize_cluster`` reads — the variables
``torchrun`` sets too. All processes run on this host; rank 0 hosts the rendezvous store on
``--port`` (default: a free port, found by binding port 0).

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
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child_env(base: dict, *, port: int, num_processes: int, rank: int) -> dict:
    env = dict(base)
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(num_processes), RANK=str(rank), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(num_processes))
    return env


class Fleet:
    """A running fleet as one unit: spawn, poll, teardown."""

    def __init__(self, command: list[str], *, num_processes: int,
                 port: int | None = None, env: dict | None = None):
        self.port = port or _free_port()
        base = dict(os.environ if env is None else env)
        self.procs = [
            subprocess.Popen([sys.executable, *command],
                             env=_child_env(base, port=self.port,
                                            num_processes=num_processes, rank=i))
            for i in range(num_processes)
        ]
        self._first_failure: int | None = None

    def poll(self) -> int | None:
        """Reap finished children; return the first nonzero exit code observed so far
        (sticky), or None while none has failed."""
        for p in self.procs:
            rc = p.poll()
            if rc is not None and rc != 0 and self._first_failure is None:
                self._first_failure = rc
        return self._first_failure

    @property
    def running(self) -> bool:
        return any(p.poll() is None for p in self.procs)

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
