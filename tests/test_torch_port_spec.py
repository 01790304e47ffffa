"""PyTorch port, speculative decoding against the JAX package.

At ``tests/test_spec.py``'s ``SMALL`` widths (vocab 9, seq 16, embed 32, 2 layers, 4 heads)
on the JAX package's initial parameters (``models.lm.params_from_jax``), with inputs made
by numpy:

- ``verify_chunk`` and ``paged_verify_chunk`` against the JAX functions, for MHA, GQA, a
  window and RoPE, f32 and int8 planes: log-probs within 1e-5 + 1e-5·|jax|, the written
  planes equal (f32 within 1e-5; int8 codes exactly, scales within 1e-5 relative), the
  rows past ``seq_len`` dropped and every row outside the window untouched, bitwise;
- the greedy spec engine (the n-gram drafter and a constant drafter, ``spec_k = 3``, 3
  slots, 6 requests so slots recycle mid-stream) token for token against the JAX spec
  engine's streams and the port's sequential ``generate``, in both layouts, never running
  the decode step; int8 KV with w8 weights and the prefix cache under spec against the
  engine without spec; a park and resume under spec; the draft LM with the target's own
  parameters accepting every draft;
- the constructor's and the draft LM's refusals with the JAX package's words; the n-gram
  proposals equal the JAX drafter's on random histories;
- the accept rule's sampled distribution against the exact target on fixed log-probs, with
  a total-variation bound derived from the draw count (below).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.models import lm as jax_lm
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    engine as jax_engine,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving.spec import (
    draft_lm as jax_draft_lm,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving.spec import (
    drafter as jax_drafter,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.lm import (
    params_from_jax,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
    MASK_VALUE,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    ContinuousBatchingEngine,
    Parked,
    Request,
    SamplingParams,
    engine as port_engine,
    filter_logits_per_slot,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.spec import (
    Drafter,
    DraftLMDrafter,
    NGramDrafter,
    greedy_chunk_plan,
)

SMALL = dict(vocab_size=9, seq_len=16, embed_dim=32, num_layers=2, num_heads=4)
CONFIGS = [dict(), dict(num_kv_heads=2), dict(attention_window=5), dict(rope=True)]
CONFIG_IDS = ["mha", "gqa", "window", "rope"]
RTOL = ATOL = 1e-5
_PAIRS: dict = {}


def _pair(cfg=None):
    """The JAX LM and its parameters, and the port's LM with them (made once each)."""
    cfg = cfg or {}
    key = tuple(sorted(cfg.items()))
    if key not in _PAIRS:
        jm = jax_lm.TransformerLM(**SMALL, **cfg)
        jp = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16), jnp.int32))["params"]
        _PAIRS[key] = (jm, jp, lm.TransformerLM(**SMALL, **cfg), params_from_jax(jp))
    return _PAIRS[key]


def _random_planes(rng, shape, kv):
    """One layer's random planes: f32 rows, or int8 codes with positive f32 scales."""
    if kv == "int8":
        return {"k": rng.integers(-127, 128, size=shape).astype(np.int8),
                "v": rng.integers(-127, 128, size=shape).astype(np.int8),
                "k_scale": rng.uniform(0.001, 0.02, size=shape[:-1]).astype(np.float32),
                "v_scale": rng.uniform(0.001, 0.02, size=shape[:-1]).astype(np.float32)}
    return {"k": rng.normal(size=shape).astype(np.float32),
            "v": rng.normal(size=shape).astype(np.float32)}


def _assert_planes(got: dict, want: dict):
    for name in want:
        for key, w in want[name].items():
            g = got[name][key].numpy()
            if w.dtype == np.int8:
                np.testing.assert_array_equal(g, w, err_msg=f"{name}.{key}")
            else:
                np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=f"{name}.{key}")


def _verify_inputs(rng, k, b=3):
    ids = rng.integers(0, 8, size=b).astype(np.int32)
    draft = rng.integers(0, 8, size=(b, k)).astype(np.int32)
    # slot 1 mid-context; slot 2 at 14: rows 16 and 17 lie past seq_len 16 and drop
    t = np.array([0, 6, 14], np.int32)[:b]
    return ids, t, draft


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_verify_chunk_matches_jax(cfg, kv):
    jm, jp, tm, params = _pair(cfg)
    rng = np.random.default_rng(11)
    k = 3
    shape = (3, 16, tm.kv_heads, tm.head_dim)
    planes = {f"block_{i}": _random_planes(rng, shape, kv) for i in range(2)}
    ids, t, draft = _verify_inputs(rng, k)
    jcache, jlp = jax_lm.verify_chunk(
        jm, jp, {n: {key: jnp.asarray(x) for key, x in layer.items()}
                 for n, layer in planes.items()},
        jnp.asarray(ids), jnp.asarray(t), jnp.asarray(draft), k=k)
    tcache = {n: {key: torch.from_numpy(x.copy()) for key, x in layer.items()}
              for n, layer in planes.items()}
    tcache, tlp = lm.verify_chunk(tm, params, tcache, torch.from_numpy(ids),
                                  torch.from_numpy(t), torch.from_numpy(draft), k=k)
    assert tlp.shape == (3, k + 1, 9)
    want = np.asarray(jlp)
    np.testing.assert_allclose(tlp.numpy(), want, atol=ATOL, rtol=RTOL)
    _assert_planes(tcache, {n: {key: np.asarray(x) for key, x in layer.items()}
                            for n, layer in jcache.items()})
    # rows outside [t, min(t + k, S - 1)] are the input's, bit for bit
    written = np.zeros((3, 16), bool)
    for b in range(3):
        written[b, t[b]:min(t[b] + k + 1, 16)] = True
    for n, layer in planes.items():
        for key, x in layer.items():
            np.testing.assert_array_equal(tcache[n][key].numpy()[~written], x[~written])


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_paged_verify_chunk_matches_jax(cfg, kv):
    """A random pool and a shuffled table, slot 2's last page mapped to the null page
    (rows past its reservation land there): log-probs and the whole pool."""
    jm, jp, tm, params = _pair(cfg)
    rng = np.random.default_rng(12)
    k, ps, p_max = 3, 4, 4
    shape = (1 + 3 * p_max, ps, tm.kv_heads, tm.head_dim)
    pool = {f"block_{i}": _random_planes(rng, shape, kv) for i in range(2)}
    table = (1 + rng.permutation(3 * p_max)).reshape(3, p_max).astype(np.int32)
    table[1, 3] = 0                          # past slot 1's reservation: the null page
    ids, t, draft = _verify_inputs(rng, k)
    jpool, jlp = jax_lm.paged_verify_chunk(
        jm, jp, {n: {key: jnp.asarray(x) for key, x in layer.items()}
                 for n, layer in pool.items()},
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(t), jnp.asarray(draft), k=k)
    tpool = {n: {key: torch.from_numpy(x.copy()) for key, x in layer.items()}
             for n, layer in pool.items()}
    tpool, tlp = lm.paged_verify_chunk(tm, params, tpool, torch.from_numpy(table),
                                       torch.from_numpy(ids), torch.from_numpy(t),
                                       torch.from_numpy(draft), k=k)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=ATOL, rtol=RTOL)
    _assert_planes(tpool, {n: {key: np.asarray(x) for key, x in layer.items()}
                           for n, layer in jpool.items()})


def test_verify_chunk_rows_equal_sequential_decode():
    """Row j of one verify pass is ``decode_step_slots`` at t + j fed the same tokens,
    and the planes the two write are the same (int8: the same ``quantize_rows`` call)."""
    _, _, tm, params = _pair()
    rng = np.random.default_rng(13)
    k = 4
    for kv in (None, "int8"):
        ids, t, draft = _verify_inputs(rng, k, b=2)
        a = lm.init_cache(tm, 2, kv_dtype=kv)
        b = lm.init_cache(tm, 2, kv_dtype=kv)
        _, vlp = lm.verify_chunk(tm, params, a, torch.from_numpy(ids), torch.from_numpy(t),
                                 torch.from_numpy(draft), k=k)
        inputs = np.concatenate([ids[:, None], draft], axis=1)
        for j in range(k + 1):
            _, dlp = lm.decode_step_slots(tm, params, b, torch.from_numpy(inputs[:, j]),
                                          torch.from_numpy(t + j))
            np.testing.assert_allclose(vlp[:, j].numpy(), dlp.numpy(), atol=ATOL, rtol=RTOL)
        for name in a:
            for key in a[name]:
                x, y = a[name][key], b[name][key]
                if x.dtype == torch.int8:
                    assert torch.equal(x, y), (kv, name, key)
                else:
                    torch.testing.assert_close(x, y, atol=ATOL, rtol=RTOL)


# -----------------------------------------------------------------------------------------
# The engine
# -----------------------------------------------------------------------------------------


class _ConstDrafter(Drafter):
    """Always proposes ``k`` copies of one token: acceptance happens exactly where the
    target agrees, and every disagreement exercises the correction path."""

    name = "const"

    def __init__(self, token: int):
        self.token = int(token)

    def propose(self, slot, tokens, last, k):
        return np.full((k,), self.token, np.int32)


class _JaxConst(jax_drafter.Drafter):
    name = "const"

    def propose(self, slot, tokens, last, k):
        return np.full((k,), 2, np.int32)


def _requests(cls, n=6, seed=3, sampling=None):
    """``tests/test_spec.py``'s mix: prompt lengths 0..7, budgets 1..15."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(0, 8))
        kw = {} if sampling is None else {"sampling": sampling}
        reqs.append(cls(prompt=rng.integers(0, 8, size=plen).astype(np.int32),
                        max_new_tokens=int(rng.integers(1, 16)), request_id=i, **kw))
    return reqs


def _streams(completions):
    return {c.request.request_id: c.tokens.tolist() for c in completions}


def _generate(tm, params, req):
    """The port's sequential greedy ``generate`` of one request, cut to its length."""
    p = len(req.prompt)
    prompt = torch.zeros((1, 16), dtype=torch.int32)
    prompt[0, :p] = torch.from_numpy(req.prompt)
    out = lm.generate(tm, params, batch=1, temperature=0.0, prompt=prompt, prompt_len=p)
    return out[0, :min(p + req.max_new_tokens, 16)].tolist()


_JAX_STREAMS: dict = {}


def _jax_spec_streams(spec):
    if spec not in _JAX_STREAMS:
        jm, jp, _, _ = _pair()
        kw = dict(spec="ngram") if spec == "ngram" else dict(spec="const",
                                                             drafter=_JaxConst())
        je = jax_engine.ContinuousBatchingEngine(jm, jp, num_slots=3, spec_k=3, **kw)
        _JAX_STREAMS[spec] = (_streams(je.run(_requests(jax_engine.Request))),
                              je.spec_stats(), je.take_spec_records())
    return _JAX_STREAMS[spec]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("spec", ["ngram", "const"])
def test_spec_engine_streams_equal_jax_and_generate(spec, layout):
    _, _, tm, params = _pair()
    want, jax_stats, jax_records = _jax_spec_streams(spec)
    kw = dict(spec="ngram") if spec == "ngram" else dict(spec="const",
                                                         drafter=_ConstDrafter(2))
    te = ContinuousBatchingEngine(tm, params, num_slots=3, spec_k=3, kv_layout=layout,
                                  page_size=4, device="cpu", **kw)
    reqs = _requests(Request)
    got = _streams(te.run(reqs))
    assert got == want
    for req in reqs:
        assert got[req.request_id] == _generate(tm, params, req)
    stats = te.spec_stats()
    assert stats.keys() == jax_stats.keys() and stats["mode"] == spec and stats["k"] == 3
    assert stats["proposed"] > 0 and stats["accepted"] <= stats["proposed"]
    records = te.take_spec_records()
    assert records and records[0].keys() == jax_records[0].keys()
    assert te.take_spec_records() == []
    assert te.decode_calls == 0 and te.verify_calls == {3: te.steps} and te.steps > 0
    assert sum(r["emitted"] for r in records) == te.generated_tokens


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_spec_composes_with_int8_kv_w8_and_the_prefix_cache(layout):
    """Verify writes int8 rows through the per-token path's quantizer, so an int8 + w8
    spec engine emits the int8 + w8 engine's streams, the prefix cache live on both."""
    _, _, tm, params = _pair()
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 8, size=6).astype(np.int32)
    reqs = [Request(prompt=np.concatenate([shared, rng.integers(
        0, 8, size=int(rng.integers(0, 4))).astype(np.int32)]),
        max_new_tokens=int(rng.integers(1, 6)), request_id=i) for i in range(6)]

    def run(**kw):
        eng = ContinuousBatchingEngine(tm, params, num_slots=2, kv_dtype="int8",
                                       quant_policy="w8", prefix_cache_entries=4,
                                       prefill_chunk_sizes=(4,), kv_layout=layout,
                                       page_size=4, device="cpu", **kw)
        return eng, _streams(eng.run(list(reqs)))

    _, plain = run()
    eng, spec = run(spec="ngram", spec_k=3)
    assert spec == plain
    assert eng.prefix_cache.stats()["hits"] > 0 and eng.decode_calls == 0


def test_spec_park_and_resume_continue_token_for_token():
    """A slot parked mid-stream under spec and re-admitted (through the prefix cache)
    continues as the unparked run does; the drafter hears of the release."""
    _, _, tm, params = _pair()
    released = []

    class Spy(NGramDrafter):
        def on_release(self, slot):
            released.append(slot)

    req = Request(prompt=np.array([1, 2, 3, 1, 2], np.int32), max_new_tokens=10,
                  request_id=0)
    eng = ContinuousBatchingEngine(tm, params, num_slots=2, spec="ngram", spec_k=3,
                                   drafter=Spy(), prefix_cache_entries=4, device="cpu")
    eng.admit(0, req)
    eng.step()
    eng.step()
    parked = eng.park(0)
    assert isinstance(parked, Parked) and released == [0]
    eng.admit(1, parked)
    done = []
    while eng.num_active:
        done += eng.step()
    assert done[0].tokens.tolist() == _generate(tm, params, req)
    assert eng.resumes == 1 and eng.decode_calls == 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_draft_lm_with_the_target_params_accepts_every_draft(layout):
    _, _, tm, params = _pair()
    drafter = DraftLMDrafter(tm, params, chunk_sizes=(8,))
    eng = ContinuousBatchingEngine(tm, params, num_slots=3, spec="draft-lm", spec_k=3,
                                   drafter=drafter, kv_layout=layout, page_size=4,
                                   device="cpu")
    reqs = _requests(Request, seed=11)
    got = _streams(eng.run(reqs))
    for req in reqs:
        assert got[req.request_id] == _generate(tm, params, req)
    st = eng.spec_stats()
    assert st["proposed"] > 0 and st["accepted"] == st["proposed"]
    assert st["acceptance_rate"] == 1.0 and eng.steps < eng.generated_tokens
    assert drafter.step_calls == 4 * eng.steps and eng.decode_calls == 0


@pytest.mark.parametrize("field", ["vocab_size", "seq_len"])
def test_draft_lm_refuses_another_tokenizer_with_jax_words(field):
    other = {**SMALL, field: 12 if field == "vocab_size" else 20}
    jm = jax_lm.TransformerLM(**other)
    jp = jm.init({"params": jax.random.PRNGKey(0)},
                 jnp.zeros((1, other["seq_len"]), jnp.int32))["params"]
    with pytest.raises(ValueError) as want:
        jax_draft_lm.DraftLMDrafter(jm, jp, chunk_sizes=(8,)).bind(
            num_slots=2, vocab_size=9, seq_len=16)
    tm = lm.TransformerLM(**other)
    _, _, target, params = _pair()
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(target, params, num_slots=2, spec="draft-lm", spec_k=2,
                                 drafter=DraftLMDrafter(tm, params_from_jax(jp)),
                                 device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["unknown", "draft-lm", "spec_k", "chunked", "off",
                                  "mismatch"])
def test_spec_constructor_refusals_match_jax(case):
    jm, jp, tm, params = _pair()
    kw = {"unknown": dict(spec="turbo"), "draft-lm": dict(spec="draft-lm"),
          "spec_k": dict(spec="ngram", spec_k=0),
          "chunked": dict(spec="ngram", prefill_chunk_sizes=()),
          "off": dict(spec="off", drafter="const"),
          "mismatch": dict(spec="ngram", drafter="const")}[case]
    with pytest.raises(ValueError) as want:
        jax_engine.ContinuousBatchingEngine(
            jm, jp, num_slots=1, **{**kw, **({"drafter": _JaxConst()}
                                             if "drafter" in kw else {})})
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(tm, params, num_slots=1, device="cpu",
                                 **{**kw, **({"drafter": _ConstDrafter(2)}
                                             if "drafter" in kw else {})})
    assert str(got.value) == str(want.value)


def test_drafter_refusing_out_of_vocab_proposals():
    _, _, tm, params = _pair()
    eng = ContinuousBatchingEngine(tm, params, num_slots=1, spec="const", spec_k=2,
                                   drafter=_ConstDrafter(9), device="cpu")
    with pytest.raises(ValueError, match="outside"):
        eng.run([Request(prompt=np.array([1, 2], np.int32), max_new_tokens=4)])


@pytest.mark.parametrize("max_n,min_n", [(3, 1), (2, 2), (4, 1)])
def test_ngram_proposals_match_jax(max_n, min_n):
    rng = np.random.default_rng(max_n * 10 + min_n)
    ours, theirs = NGramDrafter(max_n=max_n, min_n=min_n), jax_drafter.NGramDrafter(
        max_n=max_n, min_n=min_n)
    for _ in range(300):
        hist = rng.integers(0, 4, size=int(rng.integers(0, 40))).tolist()
        k = int(rng.integers(1, 6))
        last = hist[-1] if hist else 8
        np.testing.assert_array_equal(ours.propose(0, hist, last, k),
                                      theirs.propose(0, hist, last, k))
    with pytest.raises(ValueError) as got:
        NGramDrafter(max_n=2, min_n=3)
    with pytest.raises(ValueError) as want:
        jax_drafter.NGramDrafter(max_n=2, min_n=3)
    assert str(got.value) == str(want.value)


def test_chunk_plan_has_one_owner():
    assert port_engine.greedy_chunk_plan is greedy_chunk_plan
    assert greedy_chunk_plan((4, 8), 0, 13) == jax_drafter.greedy_chunk_plan((4, 8), 0, 13)


# -----------------------------------------------------------------------------------------
# The sampled accept rule
# -----------------------------------------------------------------------------------------

DRAWS = 40_000


def tv_bound(p: np.ndarray, n: int) -> float:
    """Three times the expected total-variation distance between ``n`` draws' empirical
    distribution and ``p``: ``E|count_x/n - p_x| ≈ sqrt(2 p_x (1 - p_x) / (π n))`` (the
    normal approximation of a binomial's mean absolute deviation), halved and summed. At
    40,000 draws over 9 ids this is about 0.01."""
    return 3.0 * 0.5 * float(np.sum(np.sqrt(2.0 * p * (1.0 - p) / (math.pi * n))))


@pytest.mark.parametrize("case", ["draft_likely", "draft_unlikely", "draft_filtered",
                                  "no_draft", "top_p"])
def test_sampled_accept_fold_emits_the_target_distribution(case):
    """``accept_fold`` at temperature 1 on one fixed ``[k+1, V]`` row of log-probs
    repeated over ``DRAWS`` slots, one fixed draft: the first emitted token's empirical
    distribution against ``p = softmax(filter_logits_per_slot(log_probs))``, within
    ``tv_bound(p, DRAWS)``; every accepted draft is a draft token."""
    rng = np.random.default_rng(21)
    k, v = 3, 9
    logits = rng.normal(size=(k + 1, v)).astype(np.float32) * 1.5
    logp = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    logp[:, v - 1] = MASK_VALUE                               # BOS, as the engine masks it
    top_k = {"draft_filtered": 3}.get(case, 0)
    top_p = 0.8 if case == "top_p" else 1.0
    order = torch.argsort(logp[0], descending=True)
    draft_tok = {"draft_likely": order[0], "draft_unlikely": order[5],
                 "draft_filtered": order[6]}.get(case, order[1])
    draft = torch.full((DRAWS, k), int(draft_tok), dtype=torch.long)
    dlen = torch.full((DRAWS,), 0 if case == "no_draft" else k, dtype=torch.long)
    temp = torch.ones(DRAWS)
    gen = torch.Generator().manual_seed(5)
    tokens, counts = port_engine.accept_fold(
        logp.expand(DRAWS, k + 1, v).clone(), draft, dlen, temp,
        torch.full((DRAWS,), top_k, dtype=torch.long), torch.full((DRAWS,), top_p), gen)
    p = torch.softmax(filter_logits_per_slot(logp[:1], torch.tensor([top_k]),
                                             torch.tensor([top_p])), dim=-1)[0].numpy()
    emp = np.bincount(tokens[:, 0].numpy(), minlength=v) / DRAWS
    tv = 0.5 * float(np.abs(emp - p.astype(np.float64)).sum())
    assert tv <= tv_bound(p, DRAWS), (tv, tv_bound(p, DRAWS))
    assert (counts >= 1).all() and (counts <= k + 1).all()
    if case == "no_draft":
        assert (counts == 1).all()
    accepted = counts - 1
    for j in range(k):
        rows = accepted > j
        assert (tokens[rows, j] == draft_tok).all()
    # greedy rows in the same batch take the argmax prefix rule
    g_tokens, g_counts = port_engine.accept_fold(
        logp.expand(4, k + 1, v).clone(), draft[:4], dlen[:4], None, None, None, gen)
    assert (g_tokens == logp.argmax(-1)).all()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
