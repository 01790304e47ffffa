"""Run a training fleet under the resilience supervisor: crash → restart from the
newest valid checkpoint, hang → teardown + restart, SIGTERM → cooperative preemption.

The port's counterpart of the JAX package's ``tools/fleet_supervise.py``, with its flags
(less ``--platform`` and ``--devices-per-process``: a child picks its device with its own
``--device``, on the card by default).

The command after ``--`` is what each fleet process runs (same contract as
``train.launch``: every process gets the same command plus rendezvous env). Give the
trainer the resilience flags and the supervisor the matching dirs::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.fleet_supervise \\
        --num-processes 1 --max-restarts 3 --heartbeat-timeout 300 \\
        --checkpoint-dir results/checkpoints --heartbeat-dir results/heartbeats \\
        --telemetry results/supervisor.jsonl -- \\
        -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single \\
        --use-pallas-kernels --n-epochs 6 --keep-checkpoints 3 --handle-preemption

Kill a worker mid-run (``kill -9 <pid>``, or arm ``RESILIENCE_FAULTS`` — see
``resilience/faults.py``) and watch the supervisor tear the fleet down and resume it
from the last checkpoint whose checksum verifies. SIGTERM the supervisor itself to
preempt the whole run: it forwards the signal, the trainers stop at the next epoch
boundary with a durable checkpoint, and everything exits 75 ("preempted, resumable").

A ``--guard`` trainer that trips its ``--anomaly-exit`` policy exits 65
("poisoned": the math failed, not the process) — the supervisor then rolls back
to the newest HEALTHY (health-stamped-clean) checkpoint and restarts with a
``--skip-steps`` window covering the poisoned steps; repeated poison widens the
window, scattered poison arms cross-replica fingerprint verification.

Exit status: 0 on success, 75 when preempted, otherwise the fleet's failing exit code.
``obs.goodput.decompose`` joins the supervisor's telemetry (restart events) with the
trainers' streams.
"""

from __future__ import annotations

import argparse
import sys

from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience.supervisor import (
    SupervisorConfig,
    supervise,
)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n", 1)[0],
        usage="python -m ....fleet_supervise [options] -- <python args>")
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--port", type=int, default=None,
                   help="coordinator port (default: a free one per attempt)")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="restart budget (attempts = restarts + 1)")
    p.add_argument("--backoff", type=float, default=1.0,
                   help="restart backoff seconds (doubles per restart)")
    p.add_argument("--backoff-max", type=float, default=30.0)
    p.add_argument("--checkpoint-dir", default="",
                   help="versioned checkpoint store (trainer --keep-checkpoints) to "
                        "resume from; newest VALID checkpoint wins, torn writes are "
                        "skipped")
    p.add_argument("--heartbeat-dir", default="",
                   help="fleet liveness dir; auto-appended to the child command")
    p.add_argument("--heartbeat-timeout", type=float, default=0.0,
                   help="seconds of beat staleness that counts as hung (0 off); "
                        "set comfortably above one epoch's wall time")
    p.add_argument("--attempt-timeout", type=float, default=0.0,
                   help="wall-clock bound per attempt (0 = unbounded)")
    p.add_argument("--fingerprint-verify", action="store_true",
                   help="compare cross-replica heartbeat param fingerprints "
                        "(--guard trainers emit them): a mismatch at the same "
                        "step is classified 'desync' and rolled back like "
                        "poison. Auto-armed when poison lands at scattered "
                        "steps")
    p.add_argument("--telemetry", default="",
                   help="supervisor JSONL (restart events) path")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="everything after -- runs as: python <command>")
    args = p.parse_args(argv)
    command = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not command:
        p.error("no command given — pass e.g. `-- -m <module> [args]`")

    cfg = SupervisorConfig(
        num_processes=args.num_processes, port=args.port,
        max_restarts=args.max_restarts, backoff_s=args.backoff,
        backoff_max_s=args.backoff_max, checkpoint_dir=args.checkpoint_dir,
        heartbeat_dir=args.heartbeat_dir,
        heartbeat_timeout_s=args.heartbeat_timeout,
        attempt_timeout_s=args.attempt_timeout, telemetry=args.telemetry,
        fingerprint_verify=args.fingerprint_verify)
    result = supervise(command, cfg)
    print(f"[supervisor] {result.status}: exit {result.exit_code}, "
          f"{result.attempts} attempt(s), {result.restarts} restart(s)")
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())
