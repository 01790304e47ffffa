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
