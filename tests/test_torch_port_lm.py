"""PyTorch port, the pixel LM and its serving decode against the JAX package.

The JAX package's initial parameters are carried across with
``models.lm.params_from_jax``; inputs are made with numpy and handed to both, at
``tests/test_serving.py``'s ``SMALL`` widths in four configurations: MHA, GQA, a sliding
window and RoPE.

Tolerances: token ids bitwise; float32 log-probs and cache rows within atol 1e-5 (the same
arithmetic, f32 sums in another order, over two layers and up to 16 decode steps whose
rows feed the later ones). The training and sampling half: ``next_token_loss`` and
``decode_nll`` within 1e-5 absolute plus 1e-5 relative; ``decode_step`` at every position
within 1e-5 of the full forward and of the JAX package's ``decode_step``; greedy
``generate`` token for token, a divergence allowed only at a true tie (the top-2 log-prob
gap of the port's own teacher-forced forward at the first differing position below
``TIE_GAP`` = 1e-5, the rule of ``tests/test_torch_port_quant.py``); ``filter_logits``
the same masks (random rows whose every kept/masked decision lies more than 1e-4 from the
``top_p`` boundary, checked, so f32 sums in another order cannot flip one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.models import lm as jax_lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.lm import (
    params_from_jax,
)

ATOL = 1e-5
SMALL = dict(vocab_size=9, seq_len=16, embed_dim=32, num_layers=2, num_heads=4)
CONFIGS = [dict(), dict(num_kv_heads=2), dict(attention_window=5), dict(rope=True)]
CONFIG_IDS = ["mha", "gqa", "window", "rope"]


_PAIRS = {}


def _pair(cfg):
    """The JAX LM and its parameters, and the port's LM with those parameters: made once
    a configuration for the module (the JAX init compiles once), read only."""
    key = tuple(sorted(cfg.items()))
    if key not in _PAIRS:
        jm = jax_lm.TransformerLM(**SMALL, **cfg)
        jp = jm.init({"params": jax.random.PRNGKey(0)},
                     jnp.zeros((1, 16), jnp.int32))["params"]
        _PAIRS[key] = (jm, jp, lm.TransformerLM(**SMALL, **cfg), params_from_jax(jp))
    return _PAIRS[key]


def _jcache(tree):
    """A JAX cache/pool tree as numpy, keyed like the port's."""
    return {name: {k: np.asarray(v) for k, v in layer.items()} for name, layer in tree.items()}


def _tcache(tree):
    return {name: {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
            for name, layer in tree.items()}


def _assert_cache_close(got, want):
    assert got.keys() == want.keys()
    for name in want:
        for key in want[name]:
            np.testing.assert_allclose(got[name][key].numpy(), want[name][key], atol=ATOL,
                                       err_msg=f"{name}.{key}")


def test_tokenize_images_to_ids_is_bitwise():
    """On the synthetic test split (the images ``chip_smoke.py`` serves)."""
    x = mnist._normalize(mnist._synthesize_split(64, 7)[0])
    want = np.asarray(jax_lm.tokenize_images_to_ids(jnp.asarray(x)))
    got = lm.tokenize_images_to_ids(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (64, 784)
    np.testing.assert_array_equal(got.numpy(), want)
    assert jax_mnist.MNIST_MEAN == mnist.MNIST_MEAN and jax_mnist.MNIST_STD == mnist.MNIST_STD


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_params_and_forward_match_jax(cfg):
    jm, jp, tm, params = _pair(cfg)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: shape for k, (shape, _) in tm.param_inits().items()}
    ids = np.random.default_rng(1).integers(0, 8, size=(3, 16)).astype(np.int32)
    want = np.asarray(jm.apply({"params": jp}, jm.shift_right(jnp.asarray(ids))))
    tin = tm.shift_right(torch.from_numpy(ids))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jm.shift_right(jnp.asarray(ids))))
    got = torch.func.functional_call(tm, params, (tin,))
    assert got.dtype == torch.float32 and got.shape == (3, 16, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_seeded_init_is_reproducible():
    tm = lm.TransformerLM(**SMALL)
    a = tm.init(torch.Generator().manual_seed(3))
    b = tm.init(torch.Generator().manual_seed(3))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["tok_embed"].std()) == pytest.approx(0.02, rel=0.3)
    assert torch.equal(a["ln_f_scale"], torch.ones(32))


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_decode_step_slots_sweep_matches_jax(cfg):
    """Three slots at staggered per-slot positions over the whole context: log-probs at
    every step and the final cache planes."""
    jm, jp, tm, params = _pair(cfg)
    rng = np.random.default_rng(2)
    stream = rng.integers(0, 8, size=(3, 16)).astype(np.int32)
    offsets = np.array([0, 2, 5])
    jcache, tcache = jax_lm.init_cache(jm, 3), lm.init_cache(tm, 3)
    for step in range(16 + 5):
        t = np.clip(step - offsets, 0, 15).astype(np.int32)
        ids = stream[np.arange(3), t]
        jcache, jlp = jax_lm.decode_step_slots(jm, jp, jcache, jnp.asarray(ids),
                                               jnp.asarray(t))
        tcache, tlp = lm.decode_step_slots(tm, params, tcache, torch.from_numpy(ids),
                                           torch.from_numpy(t))
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=ATOL,
                                   err_msg=f"step {step}")
    _assert_cache_close(tcache, _jcache(jcache))


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_prefill_chunk_planes_match_jax(cfg):
    """A 13-token prompt of slot 1 in two chunks of 8 (the second padded), on a cache whose
    other slots hold rows: the planes after each chunk, and ``fresh`` wiping the slot."""
    jm, jp, tm, params = _pair(cfg)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 8, size=(3, 16)).astype(np.int32)
    junk = {f"block_{i}": {k: rng.normal(size=(3, 16, tm.kv_heads, 8)).astype(np.float32)
                           for k in ("k", "v")} for i in range(2)}
    jcache = {n: {k: jnp.asarray(v) for k, v in layer.items()} for n, layer in junk.items()}
    tcache = _tcache(junk)
    for start, length, fresh in ((0, 8, True), (8, 5, False)):
        jcache = jax_lm.prefill_chunk(jm, jp, jcache, jnp.asarray(prompt), jnp.int32(1),
                                      jnp.int32(start), jnp.int32(length),
                                      jnp.asarray(fresh), chunk=8)
        lm.prefill_chunk(tm, params, tcache, torch.from_numpy(prompt), 1, start, length,
                         fresh, chunk=8)
        _assert_cache_close(tcache, _jcache(jcache))
    assert torch.equal(tcache["block_0"]["k"][1, 13:], torch.zeros(3, tm.kv_heads, 8))


def test_reset_slots_matches_jax():
    rng = np.random.default_rng(4)
    planes = {"block_0": {"k": rng.normal(size=(3, 16, 4, 8)).astype(np.float32),
                          "v": rng.normal(size=(3, 16, 4, 8)).astype(np.float32)}}
    fresh = np.array([False, True, False])
    want = jax_lm.reset_slots({n: {k: jnp.asarray(v) for k, v in layer.items()}
                               for n, layer in planes.items()}, jnp.asarray(fresh))
    got = lm.reset_slots(_tcache(planes), torch.from_numpy(fresh))
    for key in ("k", "v"):
        np.testing.assert_array_equal(got["block_0"][key].numpy(),
                                      np.asarray(want["block_0"][key]))


def _random_pool(rng, tm, num_pages, ps):
    return {f"block_{i}": {k: rng.normal(size=(num_pages, ps, tm.kv_heads, 8)).astype(
        np.float32) for k in ("k", "v")} for i in range(2)}


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_paged_decode_step_slots_matches_jax(cfg):
    """A random pool (every page holds rows) and a shuffled table: the port writes each
    slot's row into the pool and attends through the table (``paged_attend``'s plain
    version here); JAX gathers views, runs the contiguous step and scatters the row back.
    Log-probs and the whole pool after three steps."""
    jm, jp, tm, params = _pair(cfg)
    rng = np.random.default_rng(5)
    ps, p_max = 4, 4
    pool = _random_pool(rng, tm, 1 + 3 * p_max, ps)
    table = (1 + rng.permutation(3 * p_max)).reshape(3, p_max).astype(np.int32)
    jpool = {n: {k: jnp.asarray(v) for k, v in layer.items()} for n, layer in pool.items()}
    tpool = _tcache(pool)
    t = np.array([0, 6, 13], np.int32)
    for step in range(3):
        ids = rng.integers(0, 9, size=3).astype(np.int32)
        jpool, jlp = jax_lm.paged_decode_step_slots(jm, jp, jpool, jnp.asarray(table),
                                                    jnp.asarray(ids), jnp.asarray(t))
        tpool, tlp = lm.paged_decode_step_slots(tm, params, tpool, torch.from_numpy(table),
                                                torch.from_numpy(ids), torch.from_numpy(t))
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=ATOL,
                                   err_msg=f"step {step}")
        t = t + 1
    _assert_cache_close(tpool, _jcache(jpool))


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_paged_prefill_chunk_matches_jax(cfg):
    """One slot's 11-token prompt in chunks of 8 through a shuffled table."""
    jm, jp, tm, params = _pair(cfg)
    rng = np.random.default_rng(6)
    ps, p_max = 4, 4
    pool = _random_pool(rng, tm, 1 + 3 * p_max, ps)
    table = (1 + rng.permutation(3 * p_max)).reshape(3, p_max).astype(np.int32)
    prompt = rng.integers(0, 8, size=(3, 16)).astype(np.int32)
    jpool = {n: {k: jnp.asarray(v) for k, v in layer.items()} for n, layer in pool.items()}
    tpool = _tcache(pool)
    for start, length in ((0, 8), (8, 3)):
        jpool = jax_lm.paged_prefill_chunk(jm, jp, jpool, jnp.asarray(table),
                                           jnp.asarray(prompt), jnp.int32(2),
                                           jnp.int32(start), jnp.int32(length), chunk=8)
        lm.paged_prefill_chunk(tm, params, tpool, torch.from_numpy(table),
                               torch.from_numpy(prompt), 2, start, length, chunk=8)
    _assert_cache_close(tpool, _jcache(jpool))


def test_pool_helpers_and_unported_kv_dtypes():
    tm = lm.TransformerLM(**SMALL, num_kv_heads=2)
    assert lm.pages_per_slot(784, 64) == jax_lm.pages_per_slot(784, 64) == 13
    assert lm.pages_per_slot(16, 5) == jax_lm.pages_per_slot(16, 5) == 4
    pool = lm.init_page_pool(tm, 7, page_size=4)
    assert pool["block_1"]["v"].shape == (7, 4, 2, 8) and lm.pool_page_size(pool) == 4
    assert lm.init_cache(tm, 3)["block_0"]["k"].shape == (3, 16, 2, 8)
    assert lm.PREFILL_CHUNK_SIZES == jax_lm.PREFILL_CHUNK_SIZES
    with pytest.raises(ValueError, match="page_size"):
        lm.pages_per_slot(16, 0)
    # int8/fp8 planes: the JAX package's dtypes and scale planes
    jm = jax_lm.TransformerLM(**SMALL, num_kv_heads=2)
    for kv in ("int8", "fp8"):
        for got, want in ((lm.init_cache(tm, 2, kv_dtype=kv),
                           jax_lm.init_cache(jm, 2, kv_dtype=kv)),
                          (lm.init_page_pool(tm, 4, page_size=4, kv_dtype=kv),
                           jax_lm.init_page_pool(jm, 4, page_size=4, kv_dtype=kv))):
            assert {n: {k: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
                        for k, x in layer.items()} for n, layer in got.items()} == {
                n: {k: (tuple(x.shape), str(x.dtype)) for k, x in layer.items()}
                for n, layer in want.items()}
    for fn in (lambda: lm.init_cache(tm, 2, kv_dtype="int4"),
               lambda: lm.init_page_pool(tm, 4, page_size=4, kv_dtype="fp16")):
        with pytest.raises(ValueError, match="unknown kv_dtype"):
            fn()
    with pytest.raises(ValueError, match="remat"):
        lm.TransformerLM(**SMALL, remat_policy="save-dots")


# -- the training and sampling half ------------------------------------------------------

RTOL = 1e-5
TIE_GAP = 1e-5


def test_ids_to_images_and_params_to_jax_are_bitwise():
    ids = np.random.default_rng(7).integers(0, 16, size=(3, 784)).astype(np.int32)
    want = np.asarray(jax_lm.ids_to_images(jnp.asarray(ids), num_levels=16))
    got = lm.ids_to_images(torch.from_numpy(ids), num_levels=16)
    assert got.shape == (3, 28, 28, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    for cfg in CONFIGS:
        _, jp, _, params = _pair(cfg)
        want = jax.device_get(jp)
        got = lm.params_to_jax(params)

        def same(a, b, where=""):
            assert isinstance(a, dict) == isinstance(b, dict), where
            if isinstance(b, dict):
                assert list(a) == sorted(b), where            # keys in sorted order
                for k in b:
                    same(a[k], b[k], f"{where}/{k}")
            else:
                assert a.dtype == np.float32 and a.shape == b.shape, where
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=where)

        same(got, want)


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_next_token_loss_matches_jax(cfg, smoothing):
    jm, jp, tm, params = _pair(cfg)
    targets = np.random.default_rng(8).integers(0, 8, size=(4, 16)).astype(np.int32)
    want = float(jax_lm.next_token_loss(jm, jp, jnp.asarray(targets), None,
                                        deterministic=True, label_smoothing=smoothing))
    got = lm.next_token_loss(tm, params, torch.from_numpy(targets), None,
                             deterministic=True, label_smoothing=smoothing)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_decode_step_matches_the_full_forward_and_jax(cfg):
    """Teacher-forced: every position's log-probs against the port's full forward and the
    JAX package's ``decode_step`` (reading the whole cache, and a 12-row prefix where
    ``t < 12``), then the cache planes."""
    jm, jp, tm, params = _pair(cfg)
    targets = np.random.default_rng(9).integers(0, 8, size=(2, 16)).astype(np.int32)
    inputs = tm.shift_right(torch.from_numpy(targets))
    ref = torch.func.functional_call(tm, params, (inputs,))
    jinputs = np.asarray(jm.shift_right(jnp.asarray(targets)))
    jcache, tcache = jax_lm.init_cache(jm, 2), lm.init_cache(tm, 2)
    for t in range(16):
        prefix = 12 if t < 12 else None
        jcache, jlp = jax_lm.decode_step(jm, jp, jcache, jnp.asarray(jinputs[:, t]),
                                         jnp.asarray(t, jnp.int32), prefix_len=prefix)
        tcache, tlp = lm.decode_step(tm, params, tcache, inputs[:, t], t, prefix_len=prefix)
        np.testing.assert_allclose(tlp.numpy(), ref[:, t].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=f"position {t} vs the full forward")
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=ATOL, rtol=RTOL,
                                   err_msg=f"position {t} vs JAX")
    _assert_cache_close(tcache, _jcache(jcache))
    with pytest.raises(ValueError, match="prefix_len"):
        lm.decode_step(tm, params, tcache, inputs[:, 0], 0, prefix_len=17)
    with pytest.raises(ValueError, match="raw K/V planes"):
        lm.decode_step(tm, params, lm.init_cache(tm, 2, kv_dtype="int8"), inputs[:, 0], 0)


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
def test_decode_nll_matches_jax(kv):
    jm, jp, tm, params = _pair(dict(num_kv_heads=2))
    targets = np.random.default_rng(10).integers(0, 8, size=(3, 16)).astype(np.int32)
    want = float(jax_lm.decode_nll(jm, jp, jnp.asarray(targets), kv_dtype=kv))
    got = lm.decode_nll(tm, params, torch.from_numpy(targets), kv_dtype=kv)
    np.testing.assert_allclose(got.item(), want, atol=ATOL, rtol=RTOL)
    if kv is None:        # the serving decode's NLL is the training loss's
        loss = lm.next_token_loss(tm, params, torch.from_numpy(targets), None,
                                  deterministic=True)
        np.testing.assert_allclose(got.item(), loss.item(), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="seq_len"):
        lm.decode_nll(tm, params, torch.zeros(2, 15, dtype=torch.int32))


def _top2_gap(tm, params, stream, p):
    """The top-2 log-prob gap of position ``p``'s prediction under the port's own
    teacher-forced forward of ``stream`` (BOS masked, as ``generate`` masks it)."""
    lp = torch.func.functional_call(tm, params, (tm.shift_right(
        torch.as_tensor(stream, dtype=torch.int64)[None]),))[0, p].clone()
    lp[tm.vocab_size - 1] = float("-inf")
    top2 = lp.topk(2).values
    return (top2[0] - top2[1]).item()


def assert_greedy_streams_equal_up_to_ties(got, want, tm, params, first: int = 0):
    """Row by row: equal, or a first divergence at a true tie. Returns the ties."""
    ties = 0
    for row, (a, b) in enumerate(zip(got, want)):
        if np.array_equal(a, b):
            continue
        p = int(np.flatnonzero(a != b)[0])
        assert p >= first, f"row {row} differs at forced position {p}"
        gap = _top2_gap(tm, params, a, p)
        assert gap < TIE_GAP, f"row {row}: streams differ at {p} with a top-2 gap of {gap:.3e}"
        ties += 1
    return ties


@pytest.mark.parametrize("prompted", [False, True], ids=["bos", "prompt"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_greedy_generate_matches_jax(cfg, prompted):
    jm, jp, tm, params = _pair(cfg)
    prompt = np.random.default_rng(11).integers(0, 8, size=(3, 16)).astype(np.int32)
    kw = dict(prompt_len=7) if prompted else {}
    want = np.asarray(jax.jit(lambda key: jax_lm.generate(
        jm, jp, key, batch=3, temperature=0.0,
        prompt=jnp.asarray(prompt) if prompted else None, **kw))(jax.random.PRNGKey(0)))
    got = lm.generate(tm, params, batch=3, temperature=0.0,
                      prompt=torch.from_numpy(prompt) if prompted else None, **kw)
    assert got.dtype == torch.int32 and got.shape == (3, 16)
    got = got.numpy()
    assert got.max() < tm.vocab_size - 1                         # BOS never emitted
    if prompted:
        np.testing.assert_array_equal(got[:, :7], prompt[:, :7])
    assert_greedy_streams_equal_up_to_ties(got, want, tm, params, first=7 if prompted else 0)


def test_greedy_generate_over_two_decode_segments_matches_jax():
    """seq 144: a 128-row segment, then the full cache (``DECODE_SEGMENT`` growth)."""
    assert lm.DECODE_SEGMENT == jax_lm.DECODE_SEGMENT == 128
    shape = {**SMALL, "seq_len": 144}
    jm = jax_lm.TransformerLM(**shape)
    jp = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 144), jnp.int32))["params"]
    tm, params = lm.TransformerLM(**shape), params_from_jax(jp)
    prompt = np.random.default_rng(12).integers(0, 8, size=(2, 144)).astype(np.int32)
    want = np.asarray(jax.jit(lambda key: jax_lm.generate(
        jm, jp, key, batch=2, temperature=0.0, prompt=jnp.asarray(prompt),
        prompt_len=100))(jax.random.PRNGKey(0)))
    got = lm.generate(tm, params, batch=2, temperature=0.0,
                      prompt=torch.from_numpy(prompt), prompt_len=100).numpy()
    assert_greedy_streams_equal_up_to_ties(got, want, tm, params, first=100)


def test_sampled_generate_statistics_and_argument_checks():
    """Sampling cannot match JAX's threefry draws: it is held by its statistics. A fixed
    ``torch.Generator`` seed repeats its streams; ``top_k=1`` and a vanishing nucleus are
    greedy; at temperature 1 the first token's empirical distribution over 4,000 streams
    lies within 0.05 total variation of the model's softmax."""
    _, _, tm, params = _pair({})
    greedy = lm.generate(tm, params, batch=3, temperature=0.0)
    draw = lambda seed, **kw: lm.generate(tm, params, torch.Generator().manual_seed(seed),
                                          batch=3, **kw)
    assert torch.equal(draw(5), draw(5)) and not torch.equal(draw(5), draw(6))
    for kw in (dict(top_k=1), dict(top_p=1e-6)):
        assert torch.equal(draw(5, **kw), greedy)
    assert torch.equal(draw(5, top_k=tm.vocab_size, top_p=1.0), draw(5))
    first = torch.func.functional_call(tm, params, (torch.full((1, 16), 8),))[0, 0].clone()
    first[tm.vocab_size - 1] = float("-inf")
    probs = torch.softmax(first, -1)
    gen = torch.Generator().manual_seed(0)
    lp = first.expand(4000, -1)
    counts = torch.bincount(lm.sample_categorical(lp, gen), minlength=tm.vocab_size)
    tv = 0.5 * (counts / 4000 - probs).abs().sum().item()
    assert tv < 0.05, tv
    with pytest.raises(ValueError, match="top_k"):
        lm.generate(tm, params, batch=1, temperature=0.0, top_k=tm.vocab_size + 1)
    with pytest.raises(ValueError, match="top_p"):
        lm.generate(tm, params, batch=1, temperature=0.0, top_p=0.0)
    with pytest.raises(ValueError, match="torch.Generator"):
        lm.generate(tm, params, batch=1, temperature=1.0)
    with pytest.raises(ValueError, match="prompt_len"):
        lm.generate(tm, params, batch=2, temperature=0.0,
                    prompt=torch.zeros(2, 16, dtype=torch.int32), prompt_len=17)
    with pytest.raises(ValueError, match="prompt shape"):
        lm.generate(tm, params, batch=2, temperature=0.0,
                    prompt=torch.zeros(1, 16, dtype=torch.int32), prompt_len=3)


def test_filter_logits_masks_match_jax():
    lp = np.log(np.array([[0.5, 0.25, 0.15, 0.07, 0.03]], np.float32))
    cases = [dict(top_k=2), dict(top_p=0.7), dict(top_p=0.76), dict(top_k=4, top_p=0.7),
             dict()]
    rng = np.random.default_rng(13)
    rows = (rng.normal(size=(64, 17)) * 2.0).astype(np.float32)
    for top_p in (0.3, 0.6, 0.9):
        # the premise: no kept/masked decision within 1e-4 of the top_p boundary
        srt = np.sort(rows.astype(np.float64), axis=-1)[:, ::-1]
        prob = np.exp(srt - srt.max(-1, keepdims=True))
        prob /= prob.sum(-1, keepdims=True)
        before = np.cumsum(prob, -1) - prob
        assert np.abs(before - top_p).min() > 1e-4
    for x in (lp, rows):
        for kw in cases + [dict(top_k=3), dict(top_p=0.3), dict(top_p=0.6, top_k=5),
                           dict(top_p=0.9)]:
            want = np.asarray(jax_lm.filter_logits(jnp.asarray(x), **kw))
            got = lm.filter_logits(torch.from_numpy(x), **kw).numpy()
            np.testing.assert_array_equal(got, want, err_msg=str(kw))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
