"""PyTorch port, the fleet with engine replicas on the CPU at a tiny width (``--device
cpu``: 2 layers, embed 32, seq 64), against the JAX package's engine at the same
parameters (carried over with ``params_from_jax``):

- two paged unified replicas behind the port's ``Router``, replica 1 killed mid-decode:
  zero lost, one restart, and every stream equal to the port's in-process paged engine's
  and to the JAX engine's greedy stream;
- a contiguous ``prefill`` + ``decode`` pair: every request handed off, the streams the
  unified ones, and the decode tier serving each as a full prefix-cache hit (0 prefill
  tokens).
"""

import os
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu.models import lm as jax_lm
from csed_514_project_distributed_training_using_pytorch_tpu.serving.engine import (
    ContinuousBatchingEngine as JaxEngine,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving.scheduler import (
    Request as JaxRequest,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    ContinuousBatchingEngine,
    Request,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import Router
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import checkpoint

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
SMALL = dict(vocab_size=9, seq_len=64, embed_dim=32, num_layers=2, num_heads=4)
FLAGS = ["--num-levels", "8", "--seq-len", "64", "--embed-dim", "32", "--num-layers", "2",
         "--num-heads", "4", "--num-slots", "4", "--prefill-chunks", "8,16", "--warmup", "0"]


@pytest.fixture(autouse=True)
def _child_pythonpath(monkeypatch):
    existing = os.environ.get("PYTHONPATH", "")
    monkeypatch.setenv("PYTHONPATH", f"{ROOT}:{existing}" if existing else str(ROOT))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("RESILIENCE_FAULTS", raising=False)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The JAX model's seeded parameters, saved in the port's checkpoint format."""
    jm = jax_lm.TransformerLM(**SMALL)
    jp = jm.init({"params": jax.random.PRNGKey(1)},
                 jnp.zeros((1, SMALL["seq_len"]), jnp.int32))["params"]
    ckpt = str(tmp_path_factory.mktemp("fleet_engine") / "lm.msgpack")
    params = lm.params_from_jax(jp)
    checkpoint.save_params(ckpt, params)
    return jm, jp, params, ckpt


def _streams(model, reqs, layout: str) -> tuple[dict, dict]:
    """The port's in-process engine (``layout``) and the JAX engine, greedy."""
    jm, jp, params, _ = model
    port = ContinuousBatchingEngine(lm.TransformerLM(**SMALL), params, num_slots=4,
                                    prefill_chunk_sizes=(8, 16), kv_layout=layout,
                                    page_size=8, device="cpu")
    ours = port.run([Request(prompt=p, max_new_tokens=n, request_id=i)
                     for i, (p, n) in enumerate(reqs)])
    theirs = JaxEngine(jm, jp, num_slots=4, prefill_chunk_sizes=(8, 16)).run(
        [JaxRequest(prompt=p, max_new_tokens=n, request_id=i)
         for i, (p, n) in enumerate(reqs)])
    return ({c.request.request_id: c.tokens.tolist() for c in ours},
            {c.request.request_id: c.tokens.tolist() for c in theirs})


def _router(tmp_path, ckpt, extra, **kw):
    return Router(["-m", f"{PKG}.serving.replica", "--checkpoint", ckpt, *FLAGS, *extra],
                  num_replicas=2, device="cpu", heartbeat_dir=str(tmp_path / "hb"),
                  heartbeat_timeout_s=60.0, backoff_s=0.2,
                  telemetry=str(tmp_path / "router.jsonl"), **kw)


def test_paged_replicas_survive_a_kill_with_the_engines_streams(tmp_path, monkeypatch,
                                                                model):
    monkeypatch.setenv("RESILIENCE_FAULTS", f"kill:proc=1,step=6,flag={tmp_path / 'kill'}")
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, 8, size=int(rng.integers(1, 20))).astype(np.int32),
             int(rng.integers(8, 17))) for _ in range(8)]
    router = _router(tmp_path, model[3], ["--kv-layout", "paged", "--page-size", "8"]).start()
    try:
        assert router.wait_ready(timeout=180)
        comps = [f.result(timeout=180) for f in [router.submit(p, max_new_tokens=n)
                                                  for p, n in reqs]]
        deadline = time.monotonic() + 60
        while router.replicas[1].restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        summ = router.stop(timeout=120)
    assert all(c.ok for c in comps) and any(c.redispatches for c in comps)
    assert summ["ok"] == 8 and summ["replica_restarts"] == 1
    got = {i: c.tokens.tolist() for i, c in enumerate(comps)}
    port, jax_streams = _streams(model, reqs, "paged")
    assert got == port == jax_streams


def test_a_tiered_pair_hands_off_with_full_prefix_hits(tmp_path, model):
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, 8, size=int(rng.integers(8, 31))).astype(np.int32),
             int(rng.integers(4, 12))) for _ in range(6)]
    router = _router(tmp_path, model[3], [],
                     replica_extra_args=[["--tier", "prefill"], ["--tier", "decode"]]).start()
    try:
        assert router.wait_ready(timeout=180)
        comps = [router.submit(p, max_new_tokens=n).result(timeout=180) for p, n in reqs]
    finally:
        summ = router.stop(timeout=120)
    assert all(c.ok and c.disagg for c in comps)
    assert summ["handoffs"] == 6 and summ["handoff_failures"] == 0
    # one slot's contiguous f32 planes a handoff: 2 layers x (k, v) x 64 x 4 heads x 8
    assert summ["handoff_bytes"] == 6 * 2 * 2 * 64 * 4 * 8 * 4
    decode = summ["per_replica"][1]["stats"]["engine"]
    assert decode["prefill_tokens"] == 0
    assert decode["prefix_cache"]["hits"] == 6
    assert decode["prefix_cache"]["hit_tokens"] == sum(len(p) for p, _ in reqs)
    got = {i: c.tokens.tolist() for i, c in enumerate(comps)}
    port, jax_streams = _streams(model, reqs, "contiguous")
    assert got == port == jax_streams
