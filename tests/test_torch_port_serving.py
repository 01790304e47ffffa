"""PyTorch port, the serving engine against the JAX package's.

The same requests go through ``ContinuousBatchingEngine`` of both packages on transferred
parameters (``models.transformer.params_from_jax``), at ``tests/test_serving.py``'s
``SMALL`` widths, through fewer slots than requests (its ``_mixed_requests`` mix), in the
contiguous and the paged layout; the port's paged step attends through
``ops.paged_attention.paged_attend`` (its plain version on the CPU). Greedy token streams
must be equal bit for bit; so must the page allocator's ledgers, which are integer
bookkeeping. ``filter_logits_per_slot`` must mask the same entries with the same values
(f32 cumulative sums in another order: the test's random rows keep every kept/masked
decision far from the ``top_p`` boundary).
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
    pagepool as jax_pagepool,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    scheduler as jax_scheduler,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving.spec import (
    drafter as jax_drafter,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
    params_from_jax,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    ContinuousBatchingEngine,
    KVPagesExhausted,
    PagePool,
    PagePoolExhausted,
    Request,
    SamplingParams,
    filter_logits_per_slot,
    greedy_chunk_plan,
    pages_for,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.spec import (
    NGramDrafter,
)

SMALL = dict(vocab_size=9, seq_len=16, embed_dim=32, num_layers=2, num_heads=4)


def _pair(cfg):
    jm = jax_lm.TransformerLM(**SMALL, **cfg)
    jp = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16), jnp.int32))["params"]
    return jm, jp, lm.TransformerLM(**SMALL, **cfg), params_from_jax(jp)


def _mixed_requests(cls, n, seed=0, **kw):
    """``tests/test_serving.py``'s mix: varying prompt lengths and output budgets."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(0, SMALL["seq_len"] // 2))
        reqs.append(cls(prompt=rng.integers(0, SMALL["vocab_size"] - 1,
                                            size=plen).astype(np.int32),
                        max_new_tokens=int(rng.integers(1, SMALL["seq_len"])),
                        request_id=i, **kw))
    return reqs


def _streams(completions):
    return {c.request.request_id: c.tokens.tolist() for c in completions}


# -----------------------------------------------------------------------------------------
# The page allocator
# -----------------------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 2])
def test_pagepool_random_walk_matches_jax(groups):
    """The same random walk of alloc/ref/unref (refusals and bad frees included) through
    both allocators: the same pages, the same errors, equal ledgers at every step."""
    rng = np.random.default_rng(groups)
    jp = jax_pagepool.PagePool(24, page_size=4, groups=groups)
    tp = PagePool(24, page_size=4, groups=groups)
    held: list[int] = []
    for _ in range(400):
        op, group = int(rng.integers(0, 4)), int(rng.integers(0, groups))
        n, page = int(rng.integers(0, 6)), int(rng.integers(0, 24))
        outcomes = []
        for pool, exhausted in ((jp, jax_pagepool.PagePoolExhausted),
                                (tp, PagePoolExhausted)):
            try:
                if op == 0:
                    outcomes.append(pool.alloc(n, group=group))
                elif op == 1 and held:
                    pool.ref(held[:2])
                    outcomes.append("ref")
                elif op == 2 and held:
                    pool.unref(held[-1:])
                    outcomes.append("unref")
                else:
                    pool.unref([page])                       # often a bad free
                    outcomes.append("unref page")
            except (exhausted, ValueError) as err:
                outcomes.append((type(err).__name__, str(err)))
        assert outcomes[0] == outcomes[1]
        if op == 0 and isinstance(outcomes[0], list):
            held.extend(outcomes[0])
        elif op == 2 and outcomes[0] == "unref":
            held.pop()
        assert tp.stats() == jp.stats()
        assert tp._ref == jp._ref and tp._free == jp._free
    assert pages_for(13, 4) == jax_pagepool.pages_for(13, 4) == 4


# -----------------------------------------------------------------------------------------
# Sampling filters and the chunk plan
# -----------------------------------------------------------------------------------------


def test_filter_logits_per_slot_matches_jax():
    rng = np.random.default_rng(7)
    log_probs = rng.normal(size=(6, 9)).astype(np.float32) * 2.0
    top_k = np.array([0, 1, 3, 9, 2, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.5, 0.3, 0.05], np.float32)
    want = np.asarray(jax_engine.filter_logits_per_slot(
        jnp.asarray(log_probs), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = filter_logits_per_slot(torch.from_numpy(log_probs), torch.from_numpy(top_k),
                                 torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(got == jax_engine.MASK_VALUE,
                                  want == jax_engine.MASK_VALUE)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sizes,start,end", [((32, 128, 512), 0, 392), ((8,), 3, 16),
                                             ((4, 8, 16), 0, 15), ((16,), 0, 0)])
def test_chunk_plan_matches_jax(sizes, start, end):
    assert greedy_chunk_plan(sizes, start, end) == jax_drafter.greedy_chunk_plan(
        sizes, start, end)


# -----------------------------------------------------------------------------------------
# The engine: greedy streams against the JAX engine's
# -----------------------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("cfg,n_req", [(dict(), 8), (dict(num_kv_heads=2), 4),
                                       (dict(attention_window=5), 4), (dict(rope=True), 4)],
                         ids=["mha", "gqa", "window", "rope"])
def test_engine_greedy_streams_equal_jax(cfg, n_req, layout):
    """Through 3 slots, so slots (and pages) are freed and reused mid-stream; the paged
    engines with 4-token pages. The streams, the step and token counters, and (paged)
    the allocator's ledger after the run are the JAX engine's."""
    jm, jp, tm, params = _pair(cfg)
    kw = dict(num_slots=3, kv_layout=layout, page_size=4)
    je = jax_engine.ContinuousBatchingEngine(jm, jp, **kw)
    want = _streams(je.run(_mixed_requests(jax_scheduler.Request, n_req)))
    te = ContinuousBatchingEngine(tm, params, device="cpu", **kw)
    got = _streams(te.run(_mixed_requests(Request, n_req)))
    assert got == want
    assert (te.steps, te.generated_tokens, te.prefill_invocations, te.prefill_tokens) == (
        je.steps, je.generated_tokens, je.prefill_invocations, je.prefill_tokens)
    if layout == "paged":
        jstats, tstats = je.page_stats(), te.page_stats()
        assert tstats == jstats and tstats["in_use"] == 0


def test_prefill_as_decode_streams_equal_jax():
    """``prefill_chunk_sizes=()``: prompts teacher-forced through the decode step."""
    jm, jp, tm, params = _pair({})
    je = jax_engine.ContinuousBatchingEngine(jm, jp, num_slots=3, prefill_chunk_sizes=())
    te = ContinuousBatchingEngine(tm, params, num_slots=3, prefill_chunk_sizes=(),
                                  device="cpu")
    reqs = lambda cls: _mixed_requests(cls, 5, seed=1)
    assert _streams(te.run(reqs(Request))) == _streams(je.run(reqs(jax_scheduler.Request)))
    assert te.steps == je.steps


# -----------------------------------------------------------------------------------------
# Backpressure, sampling, expiry, refusals
# -----------------------------------------------------------------------------------------


def test_small_pool_refuses_then_run_requeues_and_drains():
    """A 9-page pool (8 usable 2-token pages) under three requests that need 4 pages each:
    ``admit_many`` binds two and raises ``KVPagesExhausted`` for the third; ``run``
    requeues it and drains, with the streams of a pool large enough for all."""
    tm = lm.TransformerLM(**SMALL)
    params = tm.init(torch.Generator().manual_seed(0))
    reqs = lambda: [Request(prompt=np.arange(i, i + 3, dtype=np.int32) % 8,
                            max_new_tokens=5, request_id=i) for i in range(3)]
    small = ContinuousBatchingEngine(tm, params, num_slots=3, kv_layout="paged",
                                     page_size=2, num_pages=9, device="cpu")
    with pytest.raises(KVPagesExhausted) as err:
        small.admit_many(list(enumerate(reqs())))
    assert [s for s, _ in err.value.admitted] == [0, 1]
    assert [r.request_id for r in err.value.refused] == [2]
    assert (err.value.needed, err.value.free) == (4, 0)
    assert small.free_slots() == [2]
    small = ContinuousBatchingEngine(tm, params, num_slots=3, kv_layout="paged",
                                     page_size=2, num_pages=9, device="cpu")
    got = _streams(small.run(reqs()))
    big = ContinuousBatchingEngine(tm, params, num_slots=3, kv_layout="paged",
                                   page_size=2, device="cpu")
    assert got == _streams(big.run(reqs()))
    assert small.page_stats()["refusals"] >= 1 and small.page_stats()["in_use"] == 0
    tiny = ContinuousBatchingEngine(tm, params, num_slots=1, kv_layout="paged",
                                    page_size=2, num_pages=3, device="cpu")
    with pytest.raises(KVPagesExhausted):        # cannot fit one request: surfaced
        tiny.run(reqs()[:1])


def _top_k_sets(tm, params, tokens, k):
    """Per position, the ``k`` most likely ids under the teacher-forced forward (BOS
    masked), to check where sampled tokens may land."""
    ids = torch.zeros((1, 16), dtype=torch.int64)
    ids[0, :len(tokens)] = torch.as_tensor(tokens)
    lp = torch.func.functional_call(tm, params, (tm.shift_right(ids),))[0]
    lp[:, -1] = -1e30
    return [set(torch.topk(lp[p], k).indices.tolist()) for p in range(len(tokens))]


def test_temperature_tokens_stay_in_top_k_and_repeat_for_a_seed():
    tm = lm.TransformerLM(**SMALL)
    params = tm.init(torch.Generator().manual_seed(1))
    sampling = SamplingParams(temperature=1.5, top_k=3, top_p=0.95)
    reqs = lambda: _mixed_requests(Request, 6, seed=2, sampling=sampling)

    def serve(layout, seed):
        engine = ContinuousBatchingEngine(tm, params, num_slots=3, kv_layout=layout,
                                          page_size=4, seed=seed, device="cpu")
        return _streams(engine.run(reqs()))

    a = serve("paged", 0)
    assert a == serve("paged", 0) == serve("contiguous", 0)
    assert serve("paged", 1) != a
    for req in reqs():
        stream, plen = a[req.request_id], len(req.prompt)
        assert stream[:plen] == req.prompt.tolist()
        allowed = _top_k_sets(tm, params, stream, 3)
        assert all(stream[p] in allowed[p] for p in range(plen, len(stream)))


def test_expire_returns_partial_streams():
    tm = lm.TransformerLM(**SMALL)
    engine = ContinuousBatchingEngine(tm, tm.init(torch.Generator().manual_seed(0)),
                                      num_slots=2, kv_layout="paged", page_size=4,
                                      device="cpu")
    engine.admit(0, Request(prompt=np.arange(5, dtype=np.int32), max_new_tokens=10,
                            deadline_s=100.0))
    engine.admit(1, Request(prompt=np.arange(3, dtype=np.int32), max_new_tokens=10))
    engine.step()
    engine.step()
    done = engine.expire(now=101.0)
    assert [c.finish for c in done] == ["timeout"] and done[0].tokens[:5].tolist() == list(
        range(5))
    assert engine.free_slots() == [0] and engine.num_active == 1


@pytest.mark.parametrize("kw,match", [(dict(spec="turbo"), "unknown spec mode"),
                                      (dict(drafter=NGramDrafter()),
                                       "never enabled implicitly"),
                                      ("mesh", "tp=3 must divide num_heads=4")],
                         ids=["spec", "drafter", "mesh"])
def test_unported_engine_options_raise(kw, match):
    """What the engine refuses is what the JAX engine refuses: an unknown speculative mode,
    a drafter without ``spec`` (``tests/test_torch_port_spec.py``), and a serve mesh whose
    tp does not divide the heads (``validate_engine_mesh``, at construction; the mesh
    itself is ported: ``tests/test_torch_port_serve_mesh.py``)."""
    if kw == "mesh":
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
            ProcessGrid,
        )
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
            shard,
        )
        kw = dict(mesh=shard.ServeMesh(grid=ProcessGrid("data=1,model=1"), tp=3, dp=1))
    tm = lm.TransformerLM(**SMALL)
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingEngine(tm, tm.init(torch.Generator().manual_seed(0)),
                                 num_slots=2, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(prefix_cache_entries=4), dict(kv_dtype="int8"),
                                dict(quant_policy="w8")],
                         ids=["prefix_cache", "kv_int8", "w8"])
def test_ported_engine_options_are_accepted(kw):
    """The quantization and prefix-cache options (ported from ROADMAP A9): each builds,
    takes effect, and serves."""
    tm = lm.TransformerLM(**SMALL)
    engine = ContinuousBatchingEngine(tm, tm.init(torch.Generator().manual_seed(0)),
                                      num_slots=2, device="cpu", **kw)
    if "prefix_cache_entries" in kw:
        assert engine.prefix_cache.capacity == 4
    if "kv_dtype" in kw:
        assert engine._cache["block_0"]["k"].dtype == torch.int8
        assert "k_scale" in engine.plane_layout
    if "quant_policy" in kw:
        assert type(engine.params["head_kernel"]).__name__ == "QuantizedTensor"
    done = engine.run([Request(prompt=np.arange(5, dtype=np.int32), max_new_tokens=3)])
    assert [c.finish for c in done] == ["ok"] and len(done[0].tokens) == 8


def test_engine_validation_matches_jax():
    tm = lm.TransformerLM(**SMALL)
    params = tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="paged KV layout"):
        ContinuousBatchingEngine(tm, params, num_slots=2, kv_layout="paged",
                                 prefill_chunk_sizes=(), device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        ContinuousBatchingEngine(tm, params, num_slots=2, kv_layout="ragged", device="cpu")
    engine = ContinuousBatchingEngine(tm, params, num_slots=2, device="cpu")
    with pytest.raises(ValueError, match="fills the model's seq_len"):
        engine.validate(Request(prompt=np.zeros(16, np.int32), max_new_tokens=1))
    with pytest.raises(ValueError, match="top_k"):
        engine.validate(Request(prompt=np.zeros(2, np.int32), max_new_tokens=1,
                                sampling=SamplingParams(top_k=10)))
    assert engine.validate(Request(prompt=np.zeros(12, np.int32), max_new_tokens=9)) == 16
    if not torch.cuda.is_available():      # the card is the default; the CPU is asked for
        with pytest.raises(ValueError, match="device='cpu'"):
            ContinuousBatchingEngine(tm, params, num_slots=2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
