"""PyTorch port, the paged-decode attention: the plain version against the JAX package.

The same numpy inputs go through both packages, with the cases of
``tests/test_paged_attention.py``: a random pool and a shuffled per-slot table, unowned
pages, MHA and GQA, a sliding window, int8 and fp8 codes with scales from the JAX
package's ``quant.quantize_rows``, ``t = 0`` and ``t = S - 1``. The port's
``paged_attend`` takes its plain version for CPU tensors (the CUDA kernel is held against
that plain version on the card, ``tests/test_torch_port_cuda.py``).

Tolerances: the port's ``paged_attend_reference`` against JAX's within atol 1e-6 + rtol
1e-6 (the same gather, einsums and softmax in another framework: f32 sums in another
order); against the JAX Pallas kernel in interpret mode within atol 1e-5 + rtol 1e-5, the
bound the JAX package's own test holds its kernel to (its online softmax reorders the
sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.ops import quant as jax_quant
from csed_514_project_distributed_training_using_pytorch_tpu.ops import (
    paged_attention as jax_paged,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    paged_attention as paged,
)

REF_TOL = dict(rtol=1e-6, atol=1e-6)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)


def _torch(x):
    """A JAX array (or numpy array) as a torch tensor of the same dtype and bits."""
    a = np.asarray(x)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _setup(seed, *, b=3, g=2, rep=2, d=8, ps=4, s=16, qdtype=None, shuffle=True):
    """A random pool and a per-slot table covering the full context (the JAX test's
    ``_setup``), with spare pages no slot owns; ``qdtype`` quantizes the pools with the
    JAX package's ``quantize_rows``. Returns the JAX operands, then the torch ones."""
    rng = np.random.default_rng(seed)
    p_max = s // ps
    num_pages = 1 + b * p_max + 2          # null + slots + spares
    k_pool = rng.normal(size=(num_pages, ps, g, d)).astype(np.float32)
    v_pool = rng.normal(size=(num_pages, ps, g, d)).astype(np.float32)
    k_pool, v_pool = jnp.asarray(k_pool), jnp.asarray(v_pool)
    scales = {}
    if qdtype is not None:
        k_pool, ks = jax_quant.quantize_rows(k_pool, qdtype)
        v_pool, vs = jax_quant.quantize_rows(v_pool, qdtype)
        scales = dict(k_scale=ks, v_scale=vs)
    ids = np.arange(1, 1 + b * p_max)
    if shuffle:
        rng.shuffle(ids)                   # non-contiguous page assignment
    table = jnp.asarray(ids.reshape(b, p_max).astype(np.int32))
    q = jnp.asarray(rng.normal(size=(b, g, rep, d)).astype(np.float32))
    t = jnp.asarray(rng.integers(0, s, size=b).astype(np.int32))
    jax_args = (q, k_pool, v_pool, table, t)
    torch_args = tuple(_torch(x) for x in jax_args)
    return jax_args, torch_args, scales, {k: _torch(v) for k, v in scales.items()}


QDTYPES = [None, jnp.int8, jnp.float8_e4m3fn]
QDTYPE_IDS = ["fp32", "int8", "fp8"]


@pytest.mark.parametrize("window", [0, 5], ids=["full", "window"])
@pytest.mark.parametrize("qdtype", QDTYPES, ids=QDTYPE_IDS)
@pytest.mark.parametrize("rep", [1, 2], ids=["mha", "gqa"])
def test_reference_matches_jax_reference(window, qdtype, rep):
    jargs, targs, jsc, tsc = _setup(0, rep=rep, qdtype=qdtype)
    want = jax_paged.paged_attend_reference(*jargs, seq_len=16, window=window, **jsc)
    got = paged.paged_attend_reference(*targs, seq_len=16, window=window, **tsc)
    assert got.dtype == torch.float32 and got.shape == (3, 2, rep, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REF_TOL)


@pytest.mark.parametrize("window", [0, 5], ids=["full", "window"])
@pytest.mark.parametrize("qdtype", QDTYPES, ids=QDTYPE_IDS)
@pytest.mark.parametrize("rep", [1, 2, 4, 8], ids=["mha", "gqa2", "gqa4", "gqa8"])
def test_plain_version_matches_jax_kernel(window, qdtype, rep):
    """``paged_attend`` on CPU tensors (its plain version over the table's whole
    ``P_max·ps`` view) against the JAX Pallas kernel in interpret mode, at any number of
    query rows per KV head (the card's kernel takes any R too)."""
    jargs, targs, jsc, tsc = _setup(1, rep=rep, qdtype=qdtype)
    want = jax_paged.paged_attend(*jargs, window=window, **jsc)
    before = paged.launch_counts()
    got = paged.paged_attend(*targs, window=window, **tsc)
    assert paged.launch_counts() == before          # CPU tensors launch nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_reset_launch_counts_zeroes_the_count():
    paged.paged_attend_launches = 5
    assert paged.launch_counts() == {"paged_attend": 5}
    paged.reset_launch_counts()
    assert paged.launch_counts() == {"paged_attend": 0}


def test_unmapped_pages_are_ignored():
    """Poison every page no slot owns (the spares and the null page) with 1e9: the
    output is unchanged, bit for bit."""
    _, (q, k_pool, v_pool, table, t), _, _ = _setup(2)
    out = paged.paged_attend(q, k_pool, v_pool, table, t)
    owned = set(table.ravel().tolist())
    poison = [p for p in range(k_pool.shape[0]) if p not in owned]
    k2, v2 = k_pool.clone(), v_pool.clone()
    k2[poison] = 1e9
    v2[poison] = 1e9
    assert torch.equal(paged.paged_attend(q, k2, v2, table, t), out)


def test_t_zero_and_t_max_match_jax_kernel():
    """A slot at t = 0 attends over exactly one row; a slot at t = S - 1 over all."""
    jargs, targs, _, _ = _setup(3, b=2)
    jt = jnp.asarray([0, 15], jnp.int32)
    want = jax_paged.paged_attend(*jargs[:4], jt)
    got = paged.paged_attend(*targs[:4], _torch(jt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    # At t = 0 the output is v's row at position 0, exactly.
    q, k_pool, v_pool, table, _ = targs
    row0 = v_pool[table[0, 0].long(), 0]                        # [G, D]
    assert torch.equal(got[0], row0[:, None, :].expand_as(got[0]))


def test_window_skips_to_the_first_visible_page():
    """With a window of 3 at t = 14, only positions 12..14 count: poisoning every other
    position's rows changes nothing, and the output matches the JAX kernel's."""
    jargs, targs, _, _ = _setup(4, b=1)
    jt = jnp.asarray([14], jnp.int32)
    want = jax_paged.paged_attend(*jargs[:4], jt, window=3)
    q, k_pool, v_pool, table, _ = targs
    t = _torch(jt)
    got = paged.paged_attend(q, k_pool, v_pool, table, t, window=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    k2, v2 = k_pool.clone(), v_pool.clone()
    for pos in range(16):
        if not 12 <= pos <= 14:
            k2[table[0, pos // 4].long(), pos % 4] = 1e9
            v2[table[0, pos // 4].long(), pos % 4] = 1e9
    assert torch.equal(paged.paged_attend(q, k2, v2, table, t, window=3), got)


def test_seq_len_bounds_the_view():
    """``seq_len`` shorter than the table's ``P_max·ps`` hides the positions past it: a
    slot whose ``t`` has run past the context (t = 13, 15, 40 at seq_len 13) sees rows
    0..12, as the plain version over the 13-position view does, and poisoning the rows
    past the view changes nothing. A ``seq_len`` outside ``[1, P_max·ps]`` raises."""
    _, (q, k_pool, v_pool, table, _), _, _ = _setup(6)
    t = torch.tensor([13, 15, 40], dtype=torch.int32)
    got = paged.paged_attend(q, k_pool, v_pool, table, t, seq_len=13)
    want = paged.paged_attend_reference(q, k_pool, v_pool, table,
                                        torch.full_like(t, 12), seq_len=16)
    assert torch.equal(got, paged.paged_attend_reference(q, k_pool, v_pool, table, t,
                                                         seq_len=13))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **REF_TOL)
    k2, v2 = k_pool.clone(), v_pool.clone()
    for pos in (13, 14, 15):
        k2[table[:, pos // 4].long(), pos % 4] = 1e9
        v2[table[:, pos // 4].long(), pos % 4] = 1e9
    assert torch.equal(paged.paged_attend(q, k2, v2, table, t, seq_len=13), got)
    for bad in (0, 17):
        with pytest.raises(ValueError, match="seq_len"):
            paged.paged_attend(q, k_pool, v_pool, table, t, seq_len=bad)


def test_reference_equals_decode_attention_on_a_contiguous_table():
    """On a table mapping slot b to pages 1 + b·P_max ..., the gathered view is the slot's
    contiguous plane, and the reference is ``decode_attention`` on that plane, bit for
    bit (the engine's paged and contiguous layouts share this arithmetic)."""
    _, (q, k_pool, v_pool, table, t), _, _ = _setup(5, shuffle=False)
    planes = lambda pool: pool[1:13].reshape(3, 16, 2, 8)
    want = paged.decode_attention(q, planes(k_pool), planes(v_pool), t)
    got = paged.paged_attend_reference(q, k_pool, v_pool, table, t, seq_len=16)
    assert torch.equal(got, want)


def _split_then_merge(q, k_pool, v_pool, table, t, *, seq_len, chunk, window=0,
                      k_scale=None, v_scale=None):
    """The card's flash-decoding arithmetic in plain torch: each slot's ``seq_len``-position
    view cut into chunks of ``chunk`` positions, each chunk's partial softmax (m, l, acc)
    over its visible positions (l = 0 where it has none), then the combine kernel's merge:
    m* = max m_i, out = Σ acc_i·e^(m_i − m*) / Σ l_i·e^(m_i − m*) over the chunks with
    l_i > 0, and 0 where no chunk has one."""
    k = paged.gather_view(k_pool, table, seq_len).float()
    v = paged.gather_view(v_pool, table, seq_len).float()
    if k_scale is not None:
        k = k * paged.gather_view(k_scale, table, seq_len)[..., None]
        v = v * paged.gather_view(v_scale, table, seq_len)[..., None]
    pos = torch.arange(seq_len)[None]
    tb = t.long()[:, None]
    visible = pos <= tb
    if window:
        visible &= tb - pos < window
    scores = torch.einsum("bgrd,bsgd->bgrs", q * paged.attention_scale(q.shape[-1]), k)
    parts = []
    for c0 in range(0, seq_len, chunk):
        vis = (visible & (pos >= c0) & (pos < c0 + chunk))[:, None, None, :]
        sc = torch.where(vis, scores, paged.MASK_VALUE)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.where(vis, torch.exp(sc - m), 0.0)
        parts.append((m, p.sum(dim=-1, keepdim=True), torch.einsum("bgrs,bsgd->bgrd", p, v)))
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    live = l > 0
    m_star = torch.where(live, m, paged.MASK_VALUE).amax(dim=0)
    w = torch.where(live, torch.exp(m - m_star), 0.0)
    l_sum = (l * w).sum(dim=0)
    return (acc * w).sum(dim=0) / torch.where(l_sum == 0, 1.0, l_sum)


# (setup kwargs, t, seq_len, chunk, window): chunks that cut pages of 4 (3, 5, 6), a window
# that starts inside a chunk, t = 0, slots whose t differ so that some chunks are empty,
# seq_len below P_max·page_size (slots past it clip), and the kernel's own plans
# (split_plan on 132 SMs) at the serving shape and at R = 8, D = 128 over pages of 100
SPLIT_CASES = {
    "page_cut": (dict(rep=2), [5, 15, 10], 16, 3, 0),
    "window_inside_chunk": (dict(rep=2), [14, 9, 15], 16, 6, 5),
    "t_zero": (dict(rep=1), [0, 7, 0], 16, 5, 0),
    "empty_chunks": (dict(rep=4), [1, 15, 6], 16, 4, 0),
    "seq_len_short": (dict(rep=2), [13, 15, 40], 13, 4, 0),
    "int8": (dict(rep=2, qdtype=jnp.int8), [11, 2, 15], 16, 3, 0),
    "fp8_window": (dict(rep=2, qdtype=jnp.float8_e4m3fn), [11, 2, 15], 16, 5, 3),
    "serving_plan": (dict(b=8, g=4, rep=1, d=16, ps=64, s=832),
                     [0, 783, 784, 5, 63, 64, 400, 700], 784, None, 0),
    "r8_d128_plan": (dict(b=2, g=2, rep=8, d=128, ps=100, s=900), [783, 130], 784, None, 0),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_then_merge_matches_jax_kernel(case):
    """The B6 kernel's split-then-merge arithmetic (``_split_then_merge``) against the JAX
    Pallas kernel in interpret mode within atol 1e-5 + rtol 1e-5, the bound the card holds
    the kernel to; ``t`` clipped to ``seq_len - 1`` on the JAX side, whose view is the
    table's whole ``P_max·ps``."""
    setup, t_list, seq_len, chunk, window = SPLIT_CASES[case]
    jargs, targs, jsc, tsc = _setup(9, **setup)
    b, g, r, d = targs[0].shape
    if chunk is None:
        _, _, split_tiles = paged.split_plan(b, g, r, d, seq_len, 132)
        chunk = split_tiles * paged.TILE
    t = np.asarray(t_list, np.int32)
    want = jax_paged.paged_attend(*jargs[:4], jnp.asarray(np.minimum(t, seq_len - 1)),
                                  window=window, **jsc)
    got = _split_then_merge(*targs[:4], torch.from_numpy(t), seq_len=seq_len, chunk=chunk,
                            window=window, **tsc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("shape", [(8, 4, 1, 16, 784), (8, 2, 8, 128, 784), (8, 2, 4, 32, 784),
                                   (5, 2, 16, 128, 832), (200, 4, 1, 16, 784), (3, 2, 3, 8, 16),
                                   (1, 1, 40, 4, 100)])
@pytest.mark.parametrize("sm_count", [132, 16])
def test_split_plan_covers_the_view_once(shape, sm_count):
    """The kernel's grid: row blocks of at most 512 / D query rows (one float4 of output a
    thread of 128); chunks of whole tiles that cover the view's tiles with none wholly past
    it; one chunk when the row blocks alone fill the card, else enough for about
    SPLIT_BLOCKS_PER_SM blocks an SM."""
    b, g, r, d, seq_len = shape
    rows, n_split, split_tiles = paged.split_plan(b, g, r, d, seq_len, sm_count)
    tiles = -(-seq_len // paged.TILE)
    assert 1 <= rows <= r and rows * d <= paged.MAX_BLOCK_FLOATS
    assert n_split * split_tiles >= tiles > (n_split - 1) * split_tiles
    assert split_tiles == -(-tiles // n_split)
    blocks = b * g * -(-r // rows)
    if blocks >= sm_count:
        assert n_split == 1
    else:
        assert n_split == tiles or blocks * n_split >= sm_count


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_attention_scale_is_the_jax_f32_value(d):
    want = np.float32(1.0) / np.sqrt(np.float32(d))
    assert np.float32(paged.attention_scale(d)) == want


def _c_parameter_kinds(source: str, entry: str) -> list[str]:
    """The kinds (pointer, int, int64, float) of a C entry point's parameters, read from
    its definition in a ``csrc/*.cu`` source."""
    head = source[source.index(f"int {entry}("):]
    params = head[head.index("(") + 1:head.index(")")].split(",")
    kinds = []
    for p in params:
        p = " ".join(p.split())
        if "*" in p or "cudaStream_t" in p:
            kinds.append("pointer")
        elif p.startswith("int64_t"):
            kinds.append("int64")
        elif p.startswith("float"):
            kinds.append("float")
        else:
            assert p.startswith("int "), p
            kinds.append("int")
    return kinds


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C entry point's parameter list against the ctypes argtypes
    ``ops/_build.py`` binds it with (a mismatch would only show on the card)."""
    import ctypes

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import _build

    kind_of = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_int64: "int64",
               ctypes.c_float: "float", _build._S: "pointer"}
    for library, entries in _build.SIGNATURES.items():
        source = (_build.CSRC / f"{library}.cu").read_text()
        for entry, argtypes in entries.items():
            assert _c_parameter_kinds(source, entry) == [kind_of[a] for a in argtypes], entry
