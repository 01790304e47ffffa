"""PyTorch port, the prefix cache (``serving/prefix_cache.py``) against the JAX package's.

The same insert/lookup sequence goes through both ``PrefixCache``s (numpy planes on the
JAX side, torch planes of the same shapes and dtypes on the port's): the hits, the hit
lengths and the whole ledger (queries, hits, insertions, evictions, measured bytes,
layout rejects) are equal at every step. Then both engines serve the same shared-prefix
mix with the cache on, in the contiguous and the paged layout, f32 and int8 KV: the
streams, the cache's ledger and, paged, the allocator's refcounts and free lists after the
boundary pages' copy-on-write are bitwise the JAX engine's; and the streams equal the
port's own without the cache. All integer bookkeeping and greedy tokens: no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.models import lm as jax_lm
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    engine as jax_engine,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    prefix_cache as jax_prefix,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    scheduler as jax_scheduler,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.lm import (
    params_from_jax,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    ContinuousBatchingEngine,
    PrefixCache,
    Request,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.prefix_cache import (
    common_prefix_len,
)

SMALL = dict(vocab_size=9, seq_len=64, embed_dim=32, num_layers=2, num_heads=4)
CHUNKS = (8, 16)          # the smallest chunk (8) is the partial-hit floor


@pytest.mark.parametrize("a,b", [([], [1]), ([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [1, 2]),
                                 ([4, 2], [1, 2]), ([1, 2, 5, 6], [1, 2, 7, 6])])
def test_common_prefix_len_matches_jax(a, b):
    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
    assert common_prefix_len(a, b) == jax_prefix.common_prefix_len(a, b)


@pytest.mark.parametrize("budget", [dict(capacity=3), dict(capacity=50, capacity_bytes=200)],
                         ids=["entries", "bytes"])
def test_prefix_cache_ledger_matches_jax(budget):
    """A random walk of inserts (two layouts, int8 and f32 planes) and lookups with a
    partial-hit floor: equal hits and ledgers at every step, evictions by count or by
    measured bytes, and ``on_evict`` fired for the same entries."""
    rng = np.random.default_rng(0)
    evicted = {"jax": [], "port": []}
    jc = jax_prefix.PrefixCache(layout="a", on_evict=lambda p: evicted["jax"].append(
        int(p["tag"][0])), **budget)
    tc = PrefixCache(layout="a", on_evict=lambda p: evicted["port"].append(
        int(p["tag"][0])), **budget)
    base = rng.integers(0, 8, size=24).astype(np.int32)
    for step in range(120):
        n = int(rng.integers(1, 24))
        tokens = base[:n].copy()
        if rng.random() < 0.5:
            tokens[int(rng.integers(0, n)):] = rng.integers(0, 8)
        layout = "a" if rng.random() < 0.8 else "b"
        if rng.random() < 0.5:
            dtype = (np.int8, torch.int8) if rng.random() < 0.5 else (np.float32, torch.float32)
            shape = (int(rng.integers(1, 5)), 4)
            jplanes = {"k": np.zeros(shape, dtype[0]), "tag": np.array([step])}
            tplanes = {"k": torch.zeros(shape, dtype=dtype[1]), "tag": np.array([step])}
            jc.insert(tokens, jplanes, layout=layout)
            tc.insert(tokens, tplanes, layout=layout)
        else:
            floor = int(rng.integers(1, 6))
            jhit, jp = jc.lookup(tokens, min_len=floor, layout=layout)
            thit, tp = tc.lookup(tokens, min_len=floor, layout=layout)
            assert thit == jhit
            assert (tp is None) == (jp is None)
            if tp is not None:
                assert int(tp["tag"][0]) == int(jp["tag"][0])
        assert tc.stats() == jc.stats() and len(tc) == len(jc)
    assert tc.stats()["evictions"] > 0 and tc.stats()["layout_rejects"] > 0
    tc.clear()
    jc.clear()
    assert evicted["port"] == evicted["jax"] and tc.stats() == jc.stats()


def _pair(cfg):
    jm = jax_lm.TransformerLM(**SMALL, **cfg)
    jp = jm.init({"params": jax.random.PRNGKey(0)},
                 jnp.zeros((1, SMALL["seq_len"]), jnp.int32))["params"]
    return jm, jp, lm.TransformerLM(**SMALL, **cfg), params_from_jax(jp)


def _shared_prefix_requests(cls):
    """Seven requests sharing a 20-token prefix (a mid-page boundary under pages of 8),
    with suffixes of 0-15 tokens; the fifth repeats the first's prompt (a full hit)."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, 8, size=20).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 8, size=int(rng.integers(0, 16)))
                               .astype(np.int32)]) for _ in range(7)]
    prompts[4] = prompts[0].copy()
    return [cls(prompt=p, max_new_tokens=int(rng.integers(1, 12)), request_id=i)
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefix_cache_engine_ledgers_and_streams_match_jax(layout, kv):
    jm, jp, tm, params = _pair(dict(num_kv_heads=2))
    kw = dict(num_slots=3, kv_layout=layout, page_size=8, kv_dtype=kv,
              prefill_chunk_sizes=CHUNKS, prefix_cache_entries=3)
    je = jax_engine.ContinuousBatchingEngine(jm, jp, **kw)
    want = {c.request.request_id: c.tokens.tolist()
            for c in je.run(_shared_prefix_requests(jax_scheduler.Request))}
    te = ContinuousBatchingEngine(tm, params, device="cpu", **kw)
    got = {c.request.request_id: c.tokens.tolist()
           for c in te.run(_shared_prefix_requests(Request))}
    assert got == want
    stats = te.prefix_cache.stats()
    assert stats == je.prefix_cache.stats()
    assert stats["hits"] >= 3 and stats["evictions"] >= 1
    assert te.plane_layout == je.plane_layout
    assert (te.steps, te.prefill_invocations, te.prefill_tokens) == (
        je.steps, je.prefill_invocations, je.prefill_tokens)
    if layout == "paged":
        assert te.page_stats() == je.page_stats() and te.cow_copies >= 1
        assert te._pagepool._ref == je._pagepool._ref       # entries still hold pages
        assert te._pagepool._free == je._pagepool._free
        assert te.page_stats()["in_use"] > 0
        te.reset_stats()                                     # eviction returns them all
        je.reset_stats()
        assert te._pagepool._ref == je._pagepool._ref and te.page_stats()["in_use"] == 0
    plain = ContinuousBatchingEngine(tm, params, device="cpu",
                                     **{**kw, "prefix_cache_entries": 0})
    assert {c.request.request_id: c.tokens.tolist()
            for c in plain.run(_shared_prefix_requests(Request))} == got
    assert plain.prefill_tokens > te.prefill_tokens


def test_prefix_cache_needs_chunked_prefill_and_a_matching_layout():
    tm = lm.TransformerLM(**SMALL)
    params = tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="chunked-prefill"):
        ContinuousBatchingEngine(tm, params, num_slots=2, prefill_chunk_sizes=(),
                                 prefix_cache_entries=2, device="cpu")
    # an entry written under f32 planes never installs into an int8 engine
    f32 = ContinuousBatchingEngine(tm, params, num_slots=2, prefix_cache_entries=2,
                                   prefill_chunk_sizes=CHUNKS, device="cpu")
    f32.run([Request(prompt=np.arange(12, dtype=np.int32) % 8, max_new_tokens=2)])
    i8 = ContinuousBatchingEngine(tm, params, num_slots=2, prefix_cache_entries=2,
                                  prefill_chunk_sizes=CHUNKS, kv_dtype="int8", device="cpu")
    i8.prefix_cache = f32.prefix_cache
    i8.run([Request(prompt=np.arange(12, dtype=np.int32) % 8, max_new_tokens=2)])
    assert f32.prefix_cache.stats()["layout_rejects"] == 1
    assert f32.prefix_cache.stats()["hits"] == 0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
