"""PyTorch port, quantized execution (``ops/quant.py``) against the JAX package's.

The same numpy inputs go through both packages' ``ops.quant`` and, on parameters carried
across with ``models.lm.params_from_jax``, through both ``models.lm`` serving decodes and
both ``ContinuousBatchingEngine``s with the same ``kv_dtype`` and ``quant_policy``.

Tolerances: the codes and scales of ``quantize_rows``/``quantize_tensor`` bitwise (the
same IEEE f32 divisions, round half to even, clip, the fp8 cast); the ``w8a8`` int32
accumulator bitwise (an exact integer product on either side) and its rescaled output
within 1e-6 relative (the same f32 products, in the same order); ``w8`` within 1e-5
(f32 matmul sums in another order); ``tree_bytes`` and ``cache_layout`` equal; the LM's
log-probs through a quantized cache within atol 1e-5 (as ``test_torch_port_lm.py``);
greedy engine streams token for token, a divergence allowed only at a true tie (the top-2
log-prob gap of the port's own replay below ``TIE_GAP`` = 1e-5, the rule of
``chip_smoke.py``), since a K/V element within an ulp of a rounding boundary may round to
neighbouring codes on the two sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.models import lm as jax_lm
from csed_514_project_distributed_training_using_pytorch_tpu.ops import quant as jax_quant
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    engine as jax_engine,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    scheduler as jax_scheduler,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch import ops
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.lm import (
    params_from_jax,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import quant
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    ContinuousBatchingEngine,
    Request,
    greedy_chunk_plan,
)

TIE_GAP = 1e-5
SMALL = dict(vocab_size=9, seq_len=64, embed_dim=32, num_layers=2, num_heads=4)
CONFIGS = [dict(), dict(num_kv_heads=2), dict(attention_window=12), dict(rope=True)]
CONFIG_IDS = ["mha", "gqa", "window", "rope"]
QDTYPES = {"int8": (torch.int8, jnp.int8), "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


def _pair(cfg):
    jm = jax_lm.TransformerLM(**SMALL, **cfg)
    jp = jm.init({"params": jax.random.PRNGKey(0)},
                 jnp.zeros((1, SMALL["seq_len"]), jnp.int32))["params"]
    return jm, jp, lm.TransformerLM(**SMALL, **cfg), params_from_jax(jp)


def _bits(x) -> np.ndarray:
    """The raw bytes of a torch or JAX array (fp8 codes compared bit for bit)."""
    a = x.view(torch.uint8).numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _rows(qmax: float) -> np.ndarray:
    """``[3, 6, 16]`` f32 rows: random ones, an all-zero row, a row whose amax maps to
    +qmax exactly and one to -qmax exactly (amax = qmax · 2^-6, so scale = 2^-6), and, for
    int8, a row of half-way values (k + 0.5 codes under that exact scale)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 6, 16)).astype(np.float32) * 3.0
    x[0, 0] = 0.0
    x[0, 1] = rng.uniform(-1, 1, 16).astype(np.float32)
    x[0, 1, 5] = qmax / 64
    x[0, 2] = rng.uniform(-1, 1, 16).astype(np.float32)
    x[0, 2, 9] = -qmax / 64
    ties = np.array([0.5, 1.5, 2.5, -0.5, -2.5, -3.5, 10.5, 11.5, 126.5, -126.5, 64.5,
                     7.0, -8.0, 0.0, 3.25, qmax], np.float32)
    x[0, 3] = ties / 64
    x[1, 4] = x[1, 4] * 1e-30                                 # subnormal-scale row
    return x


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_rows_is_bitwise(kind):
    tdt, jdt = QDTYPES[kind]
    x = _rows(quant.INT8_QMAX if kind == "int8" else quant.FP8_QMAX)
    jq, js = jax_quant.quantize_rows(jnp.asarray(x), jdt)
    tq, ts = quant.quantize_rows(torch.from_numpy(x), tdt)
    assert tq.dtype == tdt and ts.dtype == torch.float32 and ts.shape == (3, 6)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0] == 1.0 and not tq[0, 0].float().any()     # the zero row
    edge = tq[0, 1:3].float().abs().amax(dim=-1)
    assert edge.tolist() == [quant._qmax(tdt)] * 2            # amax -> exactly ±qmax
    if kind == "int8":                                        # half to even
        assert tq[0, 3, :10].tolist() == [0, 2, 2, 0, -2, -4, 10, 12, 126, -126]
    np.testing.assert_array_equal(
        quant.dequantize_rows(tq, ts).numpy(), np.asarray(jax_quant.dequantize_rows(jq, js)))


def test_quantize_tensor_is_bitwise():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(64, 48)).astype(np.float32) * 0.2
    w[:, 3] = 0.0                                             # a zero column: scale 1.0
    w[:, 7] = np.arange(64, dtype=np.float32) - 31.5          # ties under scale 32/127
    jt = jax_quant.quantize_tensor(jnp.asarray(w), mode="w8a8")
    tt = quant.quantize_tensor(torch.from_numpy(w), mode="w8a8")
    assert tt.mode == "w8a8" and tt.q.dtype == torch.int8 and tuple(tt.shape) == (64, 48)
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(tt.scale.numpy(), np.asarray(jt.scale))
    assert tt.nbytes == jt.nbytes
    np.testing.assert_array_equal(tt.dequantize().numpy(), np.asarray(jt.dequantize()))
    with pytest.raises(ValueError, match="mode"):
        quant.QuantizedTensor(tt.q, tt.scale, mode="w4")


@pytest.mark.parametrize("shape", [(8, 256, 96), (33, 1024, 17), (5, 64, 9)],
                         ids=["decode", "mlp_down", "head"])
def test_w8a8_accumulator_is_bitwise_and_output_close(shape):
    m, k, n = shape
    rng = np.random.default_rng(k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    jw = jax_quant.quantize_tensor(jnp.asarray(w), mode="w8a8")
    tw = quant.quantize_tensor(torch.from_numpy(w), mode="w8a8")
    jxq, _ = jax_quant.quantize_rows(jnp.asarray(x), jnp.int8)
    want_acc = np.asarray(jax.lax.dot_general(jxq, jw.q, (((1,), (0,)), ((), ())),
                                              preferred_element_type=jnp.int32))
    txq, _ = quant.quantize_rows(torch.from_numpy(x), torch.int8)
    quant.reset_route_counts()
    acc = quant.int8_accumulate(txq, tw.q)
    assert quant.int8_matmul_routes == {"int32_cpu": 1, "int_mm": 0, "f32_exact": 0}
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    got = quant.int8_matmul(torch.from_numpy(x), tw).numpy()
    want = np.asarray(jax_quant.int8_matmul(jnp.asarray(x), jw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the card's f32 route for K <= 1040: an f32 product of the codes is the int32 sum
    if k <= quant.EXACT_F32_K:
        exact = torch.matmul(txq.float(), tw.q.float()).to(torch.int32)
        np.testing.assert_array_equal(exact.numpy(), want_acc)


def test_exact_f32_route_bound():
    """At K = EXACT_F32_K every |partial sum| stays below 2^24, the f32 integer range:
    the extreme codes' product is still the exact integer."""
    k = quant.EXACT_F32_K
    assert k * 127 ** 2 < 2 ** 24 <= (k + 1) * 127 ** 2
    x = torch.full((1, k), 127, dtype=torch.int8)
    w = torch.full((k, 1), -127, dtype=torch.int8)
    assert torch.matmul(x.float(), w.float()).to(torch.int32).item() == -k * 127 ** 2


@pytest.mark.parametrize("lead", [(7,), (2, 3)])
def test_w8_matches_jax(lead):
    rng = np.random.default_rng(9)
    x = rng.normal(size=lead + (64,)).astype(np.float32)
    w = rng.normal(size=(64, 40)).astype(np.float32) * 0.1
    b = rng.normal(size=(40,)).astype(np.float32)
    jw = jax_quant.quantize_tensor(jnp.asarray(w), mode="w8")
    tw = quant.quantize_tensor(torch.from_numpy(w), mode="w8")
    want = np.asarray(jax_quant.dense_any(jnp.asarray(x), jw, jnp.asarray(b)))
    got = quant.dense_any(torch.from_numpy(x), tw, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # a plain tensor takes the exact ops.dense call
    plain = quant.dense_any(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert torch.equal(plain, ops.dense(torch.from_numpy(x), torch.from_numpy(w),
                                        torch.from_numpy(b)))


@pytest.mark.parametrize("mode", ["off", "w8", "w8a8"])
def test_quantize_params_matches_jax(mode):
    _, jp, _, params = _pair(dict(num_kv_heads=2))
    policy = quant.QuantPolicy(weights=mode)
    got = quant.quantize_params(params, policy)
    want = jax_quant.quantize_params(jp, jax_quant.QuantPolicy(weights=mode))
    if mode == "off":
        assert got is params
        return
    flat = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if hasattr(value, "items"):
                walk(value, f"{prefix}{key}.")
            else:
                flat[prefix + key] = value

    walk(want, "")
    assert got.keys() == flat.keys()
    for name, leaf in got.items():
        ref = flat[name]
        if isinstance(leaf, quant.QuantizedTensor):
            assert isinstance(ref, jax_quant.QuantizedTensor) and leaf.mode == ref.mode
            np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(ref.q))
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(ref.scale))
        else:
            assert name.endswith(("_bias", "_scale", "_embed")), name
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref))
    assert quant.tree_bytes(got) == jax_quant.tree_bytes(want)
    with pytest.raises(ValueError, match="no 2-D"):
        quant.quantize_params({"tok_embed": params["tok_embed"]}, policy)


def test_policy_validation_matches_jax():
    for kw in (dict(kv_dtype="int4"), dict(weights="w4")):
        with pytest.raises(ValueError):
            jax_quant.QuantPolicy(**kw)
        with pytest.raises(ValueError):
            quant.QuantPolicy(**kw)
    assert quant.KV_DTYPES == jax_quant.KV_DTYPES
    assert quant.WEIGHT_POLICIES == jax_quant.WEIGHT_POLICIES
    assert quant.QuantPolicy().off and not quant.QuantPolicy(kv_dtype="fp8").off
    assert quant.fp8_dtype() == torch.float8_e4m3fn


@pytest.mark.parametrize("kv", ["model", "fp32", "bf16", "int8", "fp8"])
def test_tree_bytes_and_cache_layout_match_jax(kv):
    cfg = dict(num_kv_heads=2)
    jm, _, tm, _ = _pair(cfg)
    for got, want in ((lm.init_cache(tm, 3, kv_dtype=kv), jax_lm.init_cache(jm, 3, kv_dtype=kv)),
                      (lm.init_page_pool(tm, 9, page_size=8, kv_dtype=kv),
                       jax_lm.init_page_pool(jm, 9, page_size=8, kv_dtype=kv))):
        assert quant.cache_layout(got) == jax_quant.cache_layout(want)
        assert quant.tree_bytes(got) == jax_quant.tree_bytes(want)
    assert quant.cache_layout({}) == jax_quant.cache_layout({}) == "empty"


# -----------------------------------------------------------------------------------------
# The LM's serving decode through a quantized cache
# -----------------------------------------------------------------------------------------


def _np_tree(tree):
    return {n: {k: np.asarray(v) for k, v in layer.items()} for n, layer in tree.items()}


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_quantized_prefill_and_decode_match_jax(cfg, kv):
    """A 40-token prompt in chunks of 32 into slot 1 of a fresh quantized cache, then six
    decode steps of three slots (``w8a8`` weights): log-probs within atol 1e-5, the scale
    planes within 1e-6 relative, and the dequantized planes within atol 1e-5 (a code may
    sit one step apart where an element lies within an ulp of a rounding boundary)."""
    jm, jp, tm, params = _pair(cfg)
    jq = jax_quant.quantize_params(jp, jax_quant.QuantPolicy(weights="w8a8"))
    tq = quant.quantize_params(params, quant.QuantPolicy(weights="w8a8"))
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 8, size=(3, SMALL["seq_len"])).astype(np.int32)
    jc, tc = jax_lm.init_cache(jm, 3, kv_dtype=kv), lm.init_cache(tm, 3, kv_dtype=kv)
    for start, length, size in greedy_chunk_plan((32,), 0, 40):
        jc = jax_lm.prefill_chunk(jm, jq, jc, jnp.asarray(prompt), jnp.int32(1),
                                  jnp.int32(start), jnp.int32(length),
                                  jnp.asarray(start == 0), chunk=size)
        lm.prefill_chunk(tm, tq, tc, torch.from_numpy(prompt), 1, start, length,
                         start == 0, chunk=size)
    t = np.array([0, 40, 20], np.int32)
    for step in range(6):
        ids = rng.integers(0, 9, size=3).astype(np.int32)
        jc, jlp = jax_lm.decode_step_slots(jm, jq, jc, jnp.asarray(ids), jnp.asarray(t))
        _, tlp = lm.decode_step_slots(tm, tq, tc, torch.from_numpy(ids), torch.from_numpy(t))
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5,
                                   err_msg=f"step {step}")
        t = t + 1
    want = _np_tree(jc)
    for name, layer in tc.items():
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(layer[key].numpy(), want[name][key], rtol=1e-6)
        for key in ("k", "v"):
            got = quant.dequantize_rows(layer[key], layer[key + "_scale"]).numpy()
            ref = want[name][key].astype(np.float32) * want[name][key + "_scale"][..., None]
            np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=f"{name}.{key}")


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_paged_decode_matches_jax(kv):
    """The paged step hands the narrow pool and its scale pools to ``paged_attend`` (the
    plain version on the CPU); JAX gathers, runs the contiguous step and scatters."""
    cfg = dict(num_kv_heads=2)
    jm, jp, tm, params = _pair(cfg)
    rng = np.random.default_rng(12)
    ps, p_max = 8, 8
    tpool = lm.init_page_pool(tm, 1 + 3 * p_max, page_size=ps, kv_dtype=kv)
    for layer in tpool.values():                       # every page holds quantized rows
        for key in ("k", "v"):
            rows = torch.from_numpy(rng.normal(size=tuple(layer[key].shape)).astype(
                np.float32))
            layer[key], layer[key + "_scale"] = quant.quantize_rows(rows, layer[key].dtype)
    jpool = {n: {k: jnp.asarray(v.view(torch.uint8).numpy()).view(QDTYPES[kv][1])
                 if v.dtype == torch.float8_e4m3fn else jnp.asarray(v.numpy())
                 for k, v in layer.items()} for n, layer in tpool.items()}
    table = (1 + rng.permutation(3 * p_max)).reshape(3, p_max).astype(np.int32)
    t = np.array([0, 30, 63], np.int32)
    for step in range(3):
        ids = rng.integers(0, 9, size=3).astype(np.int32)
        jpool, jlp = jax_lm.paged_decode_step_slots(jm, jp, jpool, jnp.asarray(table),
                                                    jnp.asarray(ids), jnp.asarray(t))
        _, tlp = lm.paged_decode_step_slots(tm, params, tpool, torch.from_numpy(table),
                                            torch.from_numpy(ids), torch.from_numpy(t))
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5,
                                   err_msg=f"step {step}")
        t = np.minimum(t + 1, 63)
    want = _np_tree(jpool)
    for name, layer in tpool.items():
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(layer[key].numpy(), want[name][key], rtol=1e-6)


# -----------------------------------------------------------------------------------------
# The engine: greedy streams against the JAX engine with the same policy
# -----------------------------------------------------------------------------------------


def _requests(cls, n=4, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(0, 40))
        reqs.append(cls(prompt=rng.integers(0, 8, size=plen).astype(np.int32),
                        max_new_tokens=int(rng.integers(1, 24)), request_id=i))
    return reqs


def _top2_gap(tm, params, kv, stream, fill, p, chunk_sizes) -> float:
    """The port's own top-2 log-prob gap (BOS masked) at position ``p`` of ``stream``,
    replayed alone on the contiguous path: its prompt in the engine's chunk plan, then
    one decode step a position."""
    cache = lm.init_cache(tm, 1, kv_dtype=kv)
    prompt = torch.zeros((1, tm.seq_len), dtype=torch.int32)
    prompt[0, :fill] = torch.as_tensor(stream[:fill])
    for start, length, size in greedy_chunk_plan(chunk_sizes, 0, fill):
        lm.prefill_chunk(tm, params, cache, prompt, 0, start, length, start == 0, chunk=size)
    for pos in range(fill, p + 1):
        ids = stream[pos - 1] if pos else tm.vocab_size - 1
        _, lp = lm.decode_step_slots(tm, params, cache, torch.tensor([ids]),
                                     torch.tensor([pos], dtype=torch.int32))
    lp = lp[0].clone()
    lp[tm.vocab_size - 1] = float("-inf")
    top2 = lp.topk(2).values
    return (top2[0] - top2[1]).item()


def assert_streams_equal_up_to_ties(got, want, requests, tm, params, kv, chunk_sizes):
    """Equal streams, or a first divergence at a true tie (``TIE_GAP``). Returns the
    number of ties."""
    assert sorted(got) == sorted(want)
    ties = 0
    for req in requests:
        a, b = got[req.request_id], want[req.request_id]
        if a == b:
            continue
        assert len(a) == len(b)
        p = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = _top2_gap(tm, params, kv, a, len(req.prompt), p, chunk_sizes)
        assert gap < TIE_GAP, (f"request {req.request_id}: streams differ at {p} with a "
                               f"top-2 gap of {gap:.3e}")
        ties += 1
    return ties


# the contiguous layout's cases here, the paged layout's in test_torch_port_quant_paged.py
# (the same test, split over two files so that two workers share its JAX engine builds)
@pytest.mark.parametrize("layout", ["contiguous"])
@pytest.mark.parametrize("policy", ["off", "w8", "w8a8"])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_quantized_engine_streams_equal_jax(cfg, kv, policy, layout):
    """Four requests through 3 slots (slots and pages freed and reused mid-stream), pages
    of 8: the streams (up to true ties), the counters, the byte accounting and, paged,
    the allocator's ledger after the run are the JAX engine's."""
    check_engine_streams(cfg, kv, policy, layout)


def check_engine_streams(cfg, kv, policy, layout):
    """The body of ``test_quantized_engine_streams_equal_jax`` for one case."""
    jm, jp, tm, params = _pair(cfg)
    kw = dict(num_slots=3, kv_layout=layout, page_size=8, kv_dtype=kv, quant_policy=policy)
    je = jax_engine.ContinuousBatchingEngine(jm, jp, **kw)
    want = {c.request.request_id: c.tokens.tolist()
            for c in je.run(_requests(jax_scheduler.Request))}
    te = ContinuousBatchingEngine(tm, params, device="cpu", **kw)
    reqs = _requests(Request)
    got = {c.request.request_id: c.tokens.tolist() for c in te.run(reqs)}
    assert_streams_equal_up_to_ties(got, want, reqs, tm, te.params, kv,
                                    te.prefill_chunk_sizes)
    assert (te.steps, te.prefill_invocations, te.prefill_tokens) == (
        je.steps, je.prefill_invocations, je.prefill_tokens)
    assert te.plane_layout == je.plane_layout
    jb, tb = je.byte_accounting(), te.byte_accounting()
    assert tb == {**jb, "per_chip": {0: jb["per_chip"][min(jb["per_chip"])]}}
    if layout == "paged":
        assert te.page_stats() == je.page_stats() and te.page_stats()["in_use"] == 0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
