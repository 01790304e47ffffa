"""PyTorch port, the pixel LM and its serving decode against the JAX package.

The JAX package's initial parameters are carried across with
``models.lm.params_from_jax``; inputs are made with numpy and handed to both, at
``tests/test_serving.py``'s ``SMALL`` widths in four configurations: MHA, GQA, a sliding
window and RoPE.

Tolerances: token ids bitwise; float32 log-probs and cache rows within atol 1e-5 (the same
arithmetic, f32 sums in another order, over two layers and up to 16 decode steps whose
rows feed the later ones).
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


def _pair(cfg):
    """The JAX LM and its parameters, and the port's LM with those parameters."""
    jm = jax_lm.TransformerLM(**SMALL, **cfg)
    jp = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16), jnp.int32))["params"]
    return jm, jp, lm.TransformerLM(**SMALL, **cfg), params_from_jax(jp)


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
        lm.TransformerLM(**SMALL, remat=True)
