"""PyTorch port, a sharded replica's world as one unit (``train.launch.Fleet(whole=True)``,
``serving/replica.py --shard``, gloo on the CPU):

- SIGTERM to the world gives 75 on every rank; a ``drain`` gives 0 on every rank, its
  ack carrying both ranks' counters from the closing replica check;
- a whole fleet reports its first rank's exit code and ends the others at once (the
  follower's code, not the teardown's), lets the others follow a clean exit, and gives
  every rank the base's ``FLEET_PROCESS_ID``;
- ``_free_port`` never hands out one port twice (a world's rendezvous port and its
  replica's ``--port`` come from it together);
- the router reads a replica's world from its command; the replica refuses ``--shard``
  with ``--echo`` or a tier.
"""

import json
import os
import pathlib
import signal
import socket
import time

import pytest

from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import replica
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import (
    _shard_world,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.launch import (
    Fleet,
    _free_port,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
MODEL = ["--seq-len", "32", "--embed-dim", "32", "--num-layers", "1", "--num-heads", "2",
         "--num-slots", "4", "--prefill-chunks", "4,8", "--shard", "tp=2"]


def child_env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = f"{ROOT}:{env['PYTHONPATH']}" if env.get("PYTHONPATH") else str(ROOT)
    env.pop("RESILIENCE_FAULTS", None)
    return env


def hello(port: int, timeout: float = 120.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=1.0)
            break
        except OSError:
            assert time.monotonic() < deadline, "the world never listened"
            time.sleep(0.1)
    sock.settimeout(60.0)
    lines = sock.makefile("rb")
    return sock, lines, json.loads(lines.readline())


def wait_ended(fleet: Fleet, timeout: float = 30.0) -> list[int]:
    deadline = time.monotonic() + timeout
    while fleet.running:
        assert time.monotonic() < deadline, "the world did not end"
        time.sleep(0.05)
    return [p.returncode for p in fleet.procs]


def test_sigterm_gives_75_on_every_rank_and_drain_gives_0():
    worlds = []
    for _ in range(2):
        port = _free_port()
        cmd = ["-m", f"{PKG}.serving.replica", "--port", str(port), "--device", "cpu", *MODEL]
        worlds.append((Fleet(cmd, num_processes=2, whole=True, env=child_env()), port))
    try:
        (drained, p0), (termed, p1) = worlds
        sock0, lines0, h0 = hello(p0)
        _, _, h1 = hello(p1)
        assert h0["pid"] == drained.procs[0].pid and h1["pid"] == termed.procs[0].pid
        sock0.sendall(b'{"op": "drain", "id": 7}\n')
        ack = json.loads(lines0.readline())
        termed.send_signal(signal.SIGTERM)
        assert wait_ended(drained) == [0, 0] and drained.poll() is None
        assert wait_ended(termed) == [75, 75] and termed.poll() == 75
    finally:
        for fleet, _ in worlds:
            fleet.terminate(grace=2.0)
    assert ack["op"] == "drained" and ack["id"] == 7
    assert [(r["rank"], r["pid"]) for r in ack["ranks"]] == [
        (i, p.pid) for i, p in enumerate(drained.procs)]


def _script_fleet(tmp_path, codes_after: list[tuple[int, float]], base: int) -> Fleet:
    """A whole fleet of ``python -c`` ranks: rank i writes its FLEET_PROCESS_ID, sleeps
    ``codes_after[i][1]`` seconds, then exits ``codes_after[i][0]``."""
    code = ("import os, sys, time; r = int(os.environ['RANK']); "
            f"spec = {codes_after!r}; "
            f"open(os.path.join({str(tmp_path)!r}, f'id{{r}}'), 'w')"
            ".write(os.environ['FLEET_PROCESS_ID']); "
            "time.sleep(spec[r][1]); sys.exit(spec[r][0])")
    return Fleet(["-c", code], num_processes=len(codes_after), whole=True,
                 process_id_base=base, env=child_env())


def test_a_whole_fleet_reports_its_first_exit_and_ends_the_rest(tmp_path):
    fleet = _script_fleet(tmp_path, [(0, 60.0), (3, 0.5), (0, 60.0)], base=5)
    t0 = time.monotonic()
    codes = wait_ended(fleet)
    assert time.monotonic() - t0 < 10.0                 # not the 60 s the others sleep
    assert fleet.first_exit == (1, 3) and fleet.poll() == 3
    assert codes[1] == 3 and codes[0] != 0 and codes[2] != 0
    assert [(tmp_path / f"id{r}").read_text() for r in range(3)] == ["5", "5", "5"]


def test_a_whole_fleet_lets_its_ranks_follow_a_clean_exit(tmp_path):
    fleet = _script_fleet(tmp_path, [(0, 0.0), (0, 1.0)], base=0)
    assert wait_ended(fleet) == [0, 0]
    assert fleet.first_exit == (0, 0) and fleet.poll() is None


def test_free_port_hands_out_no_port_twice():
    ports = [_free_port() for _ in range(300)]
    assert len(set(ports)) == len(ports)


def test_the_router_reads_a_replicas_world_from_its_command():
    assert _shard_world(["-m", "x", "--num-slots", "4"]) == 1
    assert _shard_world(["-m", "x", "--shard", "tp=2"]) == 2
    assert _shard_world(["-m", "x", "--shard=tp=2,dp=2"]) == 4


@pytest.mark.parametrize("argv,words", [
    (["--echo", "--shard", "tp=2"], "needs a real engine"),
    (["--tier", "prefill", "--shard", "tp=2"], "installs planes on one rank"),
    (["--shard", "tp=0"], "bad shard spec")])
def test_the_replica_refuses_a_shard_it_cannot_serve(argv, words, capsys):
    with pytest.raises(SystemExit):
        replica.main(["--port", "0", "--device", "cpu", *argv])
    assert words in capsys.readouterr().err
