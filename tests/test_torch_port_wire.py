"""PyTorch port, the fleet's wire (``serving/wire.py``), the chaos proxy
(``resilience/netfaults.py``) and the replica process (``serving/replica.py``), against the
JAX package.

The framing, decoders, backoff schedule and chaos schedules give equal bytes, sequences and
errors. The port's and the JAX package's ``--echo`` replicas exchange byte-identical lines
over one untraced script (the pid and the measured latencies aside). A port engine replica
on the CPU returns the JAX engine's greedy tokens for the same parameters. The JAX
package's ``Router`` drives two port echo replicas through a mid-flight ``kill`` with zero
loss. Each case starts at most one replica process per package (two for the router).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu.models import lm as jax_lm
from csed_514_project_distributed_training_using_pytorch_tpu.resilience import (
    netfaults as jax_netfaults,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving import wire as jax_wire
from csed_514_project_distributed_training_using_pytorch_tpu.serving.engine import (
    ContinuousBatchingEngine as JaxEngine,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving.router import Router
from csed_514_project_distributed_training_using_pytorch_tpu.serving.scheduler import (
    Request as JaxRequest,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.lm import (
    params_from_jax,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import netfaults
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import wire
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
JAX_PKG = "csed_514_project_distributed_training_using_pytorch_tpu"
ECHO = ["--echo", "--num-levels", "8", "--seq-len", "32", "--num-slots", "4",
        "--max-pending", "8"]
SUBMIT = {"op": "submit", "id": 42, "prompt": [3, 1, 4], "max_new_tokens": 3,
          "temperature": 0.0, "top_k": 0, "top_p": 1.0, "timeout_s": None}


@pytest.fixture(autouse=True)
def _child_pythonpath(monkeypatch):
    existing = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", f"{ROOT}:{existing}" if existing else ROOT)


# -- the framing and the schedules --------------------------------------------------------


def test_frames_and_messages_are_the_same_bytes():
    msgs = [{"op": "hello", "replica": 1, "caps": ["framed1"]}, SUBMIT,
            {"op": "done", "id": 7, "tokens": list(range(40)), "ttft_s": 0.125,
             "e2e_s": 1e-07, "finish": "ok", "payload": "\n\x00é"}]
    for m in msgs:
        for framed in (False, True):
            assert wire.encode_msg(m, framed=framed) == jax_wire.encode_msg(m, framed=framed)
    payload = json.dumps(msgs[2]).encode()
    assert wire.encode_frame(payload) == jax_wire.encode_frame(payload)
    assert (wire.MAGIC, wire.CAP_FRAMED, wire.MAX_FRAME_BYTES) == (
        jax_wire.MAGIC, jax_wire.CAP_FRAMED, jax_wire.MAX_FRAME_BYTES)
    assert wire.make_hello_ack() == jax_wire.make_hello_ack()
    for hello in ({"caps": ["framed1"]}, {"caps": []}, {}, {"caps": "framed1"}):
        assert wire.hello_wants_framing(hello) == jax_wire.hello_wants_framing(hello)


def _decode_all(mod, cls, chunks):
    dec, out = getattr(mod, cls)(), []
    try:
        for c in chunks:
            out += dec.feed(c)
    except mod.WireCorrupt as e:
        return out, ("WireCorrupt", str(e))
    return out, dec.pending


@pytest.mark.parametrize("damage", ["none", "crc", "magic", "length", "split"])
def test_decoders_agree_on_clean_and_damaged_streams(damage):
    stream = b"".join(wire.encode_msg({"op": "x", "i": i, "t": "\n" * i}, framed=True)
                      for i in range(5))
    if damage == "crc":
        stream = stream[:30] + bytes([stream[30] ^ 0xFF]) + stream[31:]
    elif damage == "magic":
        stream = b"\x00" + stream[1:]
    elif damage == "length":
        stream = stream[:2] + (1 << 30).to_bytes(4, "big") + stream[6:]
    chunks = ([stream[i:i + 7] for i in range(0, len(stream), 7)] if damage == "split"
              else [stream])
    assert _decode_all(wire, "FrameDecoder", chunks) == _decode_all(
        jax_wire, "FrameDecoder", chunks)
    lines = [b'{"a": 1}\n{"b"', b': 2}\n\n{"c": 3']
    assert _decode_all(wire, "LineDecoder", lines) == _decode_all(
        jax_wire, "LineDecoder", lines)


def test_jitter_backoff_sequences_match():
    for seed, base, cap in ((0, 0.1, 2.0), (7, 0.5, 30.0), (3, 0.0, 1.0)):
        a, b = wire.JitterBackoff(base, cap, seed=seed), jax_wire.JitterBackoff(
            base, cap, seed=seed)
        got = [a.next() for _ in range(12)]
        assert got == [b.next() for _ in range(12)]
        a.reset(), b.reset()
        assert [a.next() for _ in range(3)] == [b.next() for _ in range(3)]


@pytest.mark.parametrize("spec", [
    "delay:replica=1,dir=s2c,ms=800,count=20;corrupt:after=5;truncate:conn=0,dir=c2s,after=3",
    "stall:secs=0.5,after=2;drop:replica=0,after=4", "corrupt:count=3,dir=both",
    "explode:replica=1", "delay:widget=1", "delay:dir=sideways", "corrupt:after=x"])
def test_netfault_grammar_matches_jax(spec):
    def parsed(mod):
        mod.parse.cache_clear()
        try:
            return [tuple(vars(f).values()) for f in mod.parse(spec)]
        except ValueError as e:
            return ("ValueError", str(e))
    assert parsed(netfaults) == parsed(jax_netfaults)


def test_chaos_schedules_damage_the_same_bytes():
    spec = "corrupt:after=1,count=3;truncate:replica=2,after=5;drop:conn=1,after=2"
    units = [bytes([i]) * (10 + 3 * i) for i in range(7)]
    for proxy_id, conn, direction in ((0, 0, "s2c"), (2, 0, "c2s"), (0, 1, "s2c")):
        fired = ([], [])
        runs = []
        for mod, log in zip((netfaults, jax_netfaults), fired):
            sched = mod._ConnSchedule(mod.parse(spec), proxy_id, conn, direction, 11,
                                      log.append)
            runs.append([sched.apply(u) for u in units])
        assert runs[0] == runs[1] and fired[0] == fired[1]


# -- the replica process ----------------------------------------------------------------


def _spawn(module_pkg, extra, *, env=None, timeout=60.0):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", f"{module_pkg}.serving.replica",
                             "--port", str(port), *extra],
                            env=env or dict(os.environ), cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return proc, port, socket.create_connection(("127.0.0.1", port), timeout=0.5)
        except OSError:
            if proc.poll() is not None:
                raise RuntimeError(f"replica died: {proc.returncode} "
                                   f"{proc.stderr.read().decode()[-2000:]}")
            time.sleep(0.05)
    raise RuntimeError("replica never listened")


class _Peer:
    """A raw protocol peer: newline JSON until ``framed`` is set."""

    def __init__(self, sock):
        self.sock, self.framed = sock, False
        self.lines, self.frames = wire.LineDecoder(), wire.FrameDecoder()
        self.raw: list[bytes] = []

    def send(self, obj, *, raw: bytes | None = None):
        self.sock.sendall(raw if raw is not None else wire.encode_msg(obj,
                                                                      framed=self.framed))

    def recv(self, timeout=60.0) -> bytes:
        self.sock.settimeout(timeout)
        dec = self.frames if self.framed else self.lines
        while not self.raw:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise OSError("eof")
            self.raw += dec.feed(chunk)
        return self.raw.pop(0)


def _normalize(line: bytes) -> bytes:
    """The fields that differ between two runs of one script: the pid, the latencies."""
    doc = json.loads(line)
    for key in ("pid", "ttft_s", "e2e_s", "queue_wait_s", "tpot_s"):
        if doc.get(key) is not None:
            doc[key] = 0.0
    return json.dumps(doc).encode()


SCRIPT = [SUBMIT, {"op": "submit", "id": 43, "prompt": [], "max_new_tokens": 2,
                   "temperature": 0.0, "top_k": 0, "top_p": 1.0, "timeout_s": 5.0},
          {"op": "submit", "id": 9, "prompt": [1]}, b"\x00\xff{{{ not json\n",
          {"op": "stats", "id": 1}, {"op": "warm", "id": 2, "prompts": [[1, 2], [3]]}]


def _run_script(pkg):
    proc, _, sock = _spawn(pkg, ECHO + ["--replica-id", "3"])
    try:
        peer = _Peer(sock)
        out = [peer.recv()]
        for msg in SCRIPT:
            if isinstance(msg, bytes):
                peer.send(None, raw=msg)
            else:
                peer.send(msg)
            out.append(peer.recv())
        peer.send({"op": "stop"})
        assert proc.wait(timeout=30) == 0
    finally:
        sock.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return out


def test_echo_replicas_exchange_byte_identical_lines():
    ours, theirs = _run_script(PKG), _run_script(JAX_PKG)
    assert len(ours) == len(SCRIPT) + 1
    assert [_normalize(x) for x in ours] == [_normalize(x) for x in theirs]
    hello, done = json.loads(ours[0]), json.loads(ours[1])
    assert list(hello) == ["op", "replica", "num_slots", "max_pending", "pid", "caps"]
    assert hello["replica"] == 3 and wire.MAGIC not in b"".join(ours)
    assert list(done) == ["op", "id", "tokens", "finish", "prompt_len", "new_tokens",
                          "ttft_s", "e2e_s"]
    assert done["tokens"] == [3, 1, 4, 0, 1, 2]


def test_framed_replica_chaos_corrupt_kill_and_sigterm(tmp_path):
    """One port echo replica: negotiated to frames, a ``ChaosProxy`` ``corrupt`` fault on
    its replies surfaces as a typed ``WireCorrupt`` and the replica serves the next
    connection; a traced submit leaves a ``decode`` span; SIGTERM exits 75. A second
    (started only for the kill) exits 41 at ``kill:step=N`` mid-request."""
    env = dict(os.environ, RESILIENCE_FAULTS="kill:proc=5,step=4")
    proc, port, sock = _spawn(PKG, ECHO + ["--trace", str(tmp_path / "r.jsonl")], env=env)
    killed, _, ksock = _spawn(PKG, ECHO + ["--replica-id", "5"], env=env)
    proxy = netfaults.ChaosProxy(port, "corrupt:dir=s2c,after=1,conn=1", seed=3)
    try:
        peer = _Peer(sock)
        assert wire.hello_wants_framing(json.loads(peer.recv()))
        peer.send(wire.make_hello_ack())
        peer.framed = True
        peer.send(dict(SUBMIT, trace_id="abc"))
        assert json.loads(peer.recv())["tokens"] == [3, 1, 4, 0, 1, 2]
        sock.close()
        # through the proxy: connection 0 clean, connection 1 damaged after its hello
        proxy_port = proxy.start()
        for conn in (0, 1):
            with socket.create_connection(("127.0.0.1", proxy_port), timeout=5) as s:
                p = _Peer(s)
                p.recv()
                p.send(wire.make_hello_ack())
                p.framed = True
                p.send(SUBMIT)
                if conn == 0:
                    assert json.loads(p.recv())["id"] == 42
                else:
                    with pytest.raises(wire.WireCorrupt, match="crc mismatch"):
                        p.recv()
        with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
            p = _Peer(s)
            p.recv()
            p.send(SUBMIT)                                  # a legacy peer, still served
            assert json.loads(p.recv())["finish"] == "ok"
        kpeer = _Peer(ksock)
        kpeer.recv()
        kpeer.send(dict(SUBMIT, max_new_tokens=8))
        assert killed.wait(timeout=30) == 41
        assert proc.poll() is None
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 75
    finally:
        proxy.stop()
        for p in (proc, killed):
            if p.poll() is None:
                p.kill()
                p.wait()
    spans = [json.loads(line) for line in open(tmp_path / "r.jsonl")]
    assert [s["name"] for s in spans] == ["decode"] and spans[0]["trace_id"] == "abc"
    assert spans[0]["proc"] == "replica0" and spans[0]["new_tokens"] == 3


SMALL = dict(vocab_size=9, seq_len=64, embed_dim=32, num_layers=2, num_heads=4)


def test_engine_replica_greedy_tokens_match_the_jax_engine(tmp_path):
    jm = jax_lm.TransformerLM(**SMALL)
    jp = jm.init({"params": jax.random.PRNGKey(0)},
                 jnp.zeros((1, SMALL["seq_len"]), jnp.int32))["params"]
    ckpt = str(tmp_path / "lm.msgpack")
    checkpoint.save_params(ckpt, params_from_jax(jp))
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, 8, size=int(rng.integers(1, 20))).tolist(),
             int(rng.integers(4, 12))) for _ in range(6)]
    proc, _, sock = _spawn(PKG, [
        "--device", "cpu", "--checkpoint", ckpt, "--num-levels", "8", "--seq-len", "64",
        "--embed-dim", "32", "--num-layers", "2", "--num-heads", "4", "--num-slots", "4",
        "--prefill-chunks", "8,16", "--kv-layout", "paged", "--page-size", "8",
        "--warmup", "0"], timeout=120)
    try:
        peer = _Peer(sock)
        peer.recv()
        for i, (prompt, n) in enumerate(reqs):
            peer.send({"op": "submit", "id": i, "prompt": prompt, "max_new_tokens": n,
                       "temperature": 0.0, "top_k": 0, "top_p": 1.0, "timeout_s": None})
        done = [json.loads(peer.recv(timeout=120)) for _ in reqs]
        peer.send({"op": "stop"})
        assert proc.wait(timeout=60) == 0
    finally:
        sock.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    got = {d["id"]: d["tokens"] for d in done}
    assert all(d["finish"] == "ok" for d in done)
    assert list(done[0]) == ["op", "id", "tokens", "finish", "prompt_len", "new_tokens",
                             "queue_wait_s", "ttft_s", "tpot_s", "e2e_s"]
    eng = JaxEngine(jm, jp, num_slots=4, prefill_chunk_sizes=(8, 16))
    want = eng.run([JaxRequest(prompt=np.asarray(p, np.int32), max_new_tokens=n,
                               request_id=i) for i, (p, n) in enumerate(reqs)])
    assert got == {c.request.request_id: c.tokens.tolist() for c in want}


def _echo_expected(prompt, max_new, *, seq_len=32, levels=8):
    total = min(len(prompt) + max_new, seq_len)
    base = int(np.sum(prompt)) if len(prompt) else 0
    return list(prompt) + [(base + i) % levels for i in range(total - len(prompt))]


def test_jax_router_drives_port_replicas_through_a_kill_with_zero_loss(tmp_path,
                                                                       monkeypatch):
    """The JAX package's fleet router over two port ``--echo`` replicas: replica 1 is
    killed mid-decode (``kill:proc=1,step=5``, matched by its replica id); its ledger
    drains back, every request completes ``ok`` and token-identical, and the replica
    restarts."""
    monkeypatch.setenv("RESILIENCE_FAULTS", f"kill:proc=1,step=5,flag={tmp_path / 'kill'}")
    cmd = ["-m", f"{PKG}.serving.replica", *ECHO, "--echo-delay-s", "0.05"]
    router = Router(cmd, num_replicas=2, platform="cpu", max_restarts=2,
                    heartbeat_dir=str(tmp_path / "hb"), heartbeat_timeout_s=30.0,
                    backoff_s=0.2, telemetry=str(tmp_path / "router.jsonl")).start()
    try:
        assert router.wait_ready(timeout=120)
        rng = np.random.default_rng(3)
        reqs = [(rng.integers(0, 7, size=1 + i % 5).astype(np.int32), 6) for i in range(12)]
        futs = [router.submit(p, max_new_tokens=n) for p, n in reqs]
        comps = [f.result(timeout=120) for f in futs]
        assert all(c.ok for c in comps)
        for (prompt, n), comp in zip(reqs, comps):
            assert comp.tokens.tolist() == _echo_expected(prompt.tolist(), n)
        assert any(c.redispatches > 0 for c in comps)
        deadline = time.monotonic() + 60
        while router.replicas[1].restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert router.replicas[1].restarts >= 1
    finally:
        summ = router.stop(timeout=60)
    assert summ["ok"] == 12 and summ["timeout"] == 0 and summ["redispatches"] >= 1
    assert os.path.exists(f"{tmp_path / 'kill'}.p1")      # the port replica's own marker
