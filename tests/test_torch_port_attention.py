"""PyTorch port, attention ops: the dense core and the plain flash versions against the JAX
package.

The same numpy inputs go through both packages. The JAX flash kernels run in Pallas
interpret mode on the CPU, as ``tests/test_pallas_attention.py`` runs them; the port's
``flash_attention`` takes its plain versions for CPU tensors (the CUDA kernels are held
against those plain versions on the card, ``tests/test_torch_port_cuda.py``).

Tolerances, as the JAX package's own flash tests state them for interpret mode (f32
round-off, sums in another order): outputs and lse within rtol 1e-5 + atol 1e-5; gradients
within rtol 1e-4 + atol 2e-5. bfloat16 within 2e-2 (both round p to bf16 before the value
product and the output to bf16; an f32 value an ulp apart can round to the neighbouring
bf16).
"""

import pathlib
import platform

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.ops import attention as jax_attn
from csed_514_project_distributed_training_using_pytorch_tpu.ops import (
    pallas_attention as jax_pa,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    attention,
    flash_attention as fa,
)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
MASKS = [(False, None), (True, None), (False, 100), (True, 100)]
MASK_IDS = ["full", "causal", "window", "causal_window"]


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _both(arrays, dtype="f32"):
    """(jax arrays, torch tensors) holding the same values in the same dtype."""
    if dtype == "bf16":
        return ([jnp.asarray(a, jnp.bfloat16) for a in arrays],
                [torch.from_numpy(a).bfloat16() for a in arrays])
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, dtype=np.float32)


@pytest.mark.parametrize("causal,window", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_full_attention_matches_jax(causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays((2, 64, 2, 16), 3, 0), dtype)
    want = jax_attn.full_attention(jq, jk, jv, causal=causal, window=window)
    got = attention.full_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), **(FWD_TOL if dtype == "f32"
                                                      else BF16_TOL))


def test_windowed_attention_fn_binds_the_window():
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays((1, 32, 2, 16), 3, 1))
    np.testing.assert_allclose(
        _np(attention.windowed_attention_fn(5)(tq, tk, tv, causal=True)),
        _np(jax_attn.windowed_attention_fn(5)(jq, jk, jv, causal=True)), **FWD_TOL)
    with pytest.raises(ValueError, match="window must be >= 1"):
        attention.windowed_attention_fn(0)


def _loss_grads_jax(q, k, v, **kw):
    loss = lambda q, k, v: jnp.sum(jnp.sin(jax_pa.flash_attention(q, k, v, **kw)))
    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _loss_grads_port(q, k, v, **kw):
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(q, k, v, **kw)
    return torch.autograd.grad(torch.sin(out.float()).sum(), (q, k, v))


def _host_cpu() -> str:
    """The host CPU's model and whether it has the bf16 instructions that a CPU backend may
    take for products (``avx512_bf16``, ``amx_bf16``), from the kernel's CPU table."""
    try:
        text = pathlib.Path("/proc/cpuinfo").read_text()
    except OSError:
        return f"{platform.processor() or platform.machine()} (no CPU table)"
    model = next((line.split(":", 1)[1].strip() for line in text.splitlines()
                  if line.startswith("model name")), platform.machine())
    flags = set(next((line.split(":", 1)[1].split() for line in text.splitlines()
                      if line.startswith("flags")), []))
    return (f"{model}; avx512_bf16 {'avx512_bf16' in flags}, "
            f"amx_bf16 {'amx_bf16' in flags}")


def _which_side(got, want, arrays, *, causal, window):
    """For a failure message: each side's largest distance from float64 attention on the
    same inputs, the [b, s, h] rows where the two sides differ most, and the host CPU, so
    that a failure says which framework moved, where, and on what host."""
    q, k, v = (a.astype(np.float64) for a in arrays)
    s = q.shape[1]
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    visible = np.ones((s, s), bool)
    if causal:
        visible &= i >= j
    if window:
        visible &= np.abs(i - j) < window
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    scores = np.where(visible, scores, -np.inf)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    exact = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    rows = np.argsort(np.abs(got - want).max(-1), axis=None)[-3:]
    return (f"port vs float64 {np.abs(got - exact).max():.3e}, jax vs float64 "
            f"{np.abs(want - exact).max():.3e}; rows [b, s, h] differing most "
            f"{[tuple(int(x) for x in np.unravel_index(r, got.shape[:3])) for r in rows]}; "
            f"host CPU {_host_cpu()}")


@pytest.mark.parametrize("s,d", [(128, 16), (256, 64)])
@pytest.mark.parametrize("causal,window", MASKS, ids=MASK_IDS)
def test_plain_flash_matches_jax_flash(s, d, causal, window):
    arrays = _arrays((2, s, 2, d), 3, s + d)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays)
    got = _np(fa.flash_attention(tq, tk, tv, causal=causal, window=window))
    want = _np(jax_pa.flash_attention(jq, jk, jv, causal=causal, window=window))
    try:
        np.testing.assert_allclose(got, want, **FWD_TOL)
    except AssertionError as err:
        where = _which_side(got, want, arrays, causal=causal, window=window)
        raise AssertionError(f"{err}\n{where}") from None
    for name, got, want in zip("qkv", _loss_grads_port(tq, tk, tv, causal=causal,
                                                       window=window),
                               _loss_grads_jax(jq, jk, jv, causal=causal, window=window)):
        np.testing.assert_allclose(_np(got), _np(want), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("causal,window", [(False, None), (True, 100)],
                         ids=["full", "causal_window"])
def test_plain_flash_bf16_matches_jax_flash(causal, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays((2, 128, 2, 16), 3, 7), "bf16")
    out = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _np(out), _np(jax_pa.flash_attention(jq, jk, jv, causal=causal, window=window)),
        **BF16_TOL)
    for name, got, want in zip("qkv", _loss_grads_port(tq, tk, tv, causal=causal,
                                                       window=window),
                               _loss_grads_jax(jq, jk, jv, causal=causal, window=window)):
        np.testing.assert_allclose(_np(got), _np(want), err_msg=name, **BF16_TOL)


def _packed(x):
    """[B, S, H, D] -> the JAX kernels' packed [B·H, S, D]."""
    b, s, h, d = x.shape
    return jnp.transpose(x, (0, 2, 1, 3)).reshape(b * h, s, d)


def _unpacked(x, b, h):
    bh, s, d = x.shape
    return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal,window,dtype,shape", [
    (False, 0, "f32", (2, 256, 2, 16)), (True, 100, "f32", (2, 256, 2, 16)),
    (False, 0, "bf16", (1, 256, 2, 128)), (True, 100, "bf16", (1, 256, 2, 128)),
], ids=["full", "causal_window", "bf16_d128_full", "bf16_d128_causal_window"])
def test_plain_forward_lse_matches_jax(causal, window, dtype, shape):
    """The plain forward (what the card's forward kernels are held to) against the JAX
    forward: f32 at D = 16, and bf16 at D = 128, the width of the bf16 tensor-core kernel,
    where out is bf16 (BF16_TOL) and lse stays f32 (FWD_TOL)."""
    b, s, h, d = shape
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays(shape, 3, 11), dtype)
    j_out, j_lse = jax_pa.flash_forward_with_lse(_packed(jq), _packed(jk), _packed(jv),
                                                 causal=causal, window=window)
    out, lse = fa.flash_forward_plain(tq, tk, tv, causal=causal, window=window)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(_np(out), _unpacked(j_out, b, h).astype(np.float32),
                               **(FWD_TOL if dtype == "f32" else BF16_TOL))
    np.testing.assert_allclose(_np(lse), np.asarray(j_lse).reshape(b, h, s), **FWD_TOL)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 100)],
                         ids=["full", "causal_window"])
def test_plain_backward_matches_jax_backward_blocks(causal, window):
    """Given the JAX forward's out and lse and the same dO, the port's plain backward
    gives JAX ``flash_backward_blocks``'s dq, dk, dv (Δ from the same out and dO)."""
    b, s, h, d = 2, 256, 2, 16
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(_arrays((b, s, h, d), 4, 12))
    q3, k3, v3, g3 = (_packed(x) for x in (jq, jk, jv, jdo))
    j_out, j_lse = jax_pa.flash_forward_with_lse(q3, k3, v3, causal=causal, window=window)
    delta = jnp.sum(g3 * j_out, axis=-1).reshape(j_lse.shape)
    want = jax_pa.flash_backward_blocks(q3, k3, v3, g3, j_lse, delta, causal=causal,
                                        window=window)
    out = torch.from_numpy(_unpacked(j_out, b, h).copy())
    lse = torch.from_numpy(np.asarray(j_lse).reshape(b, h, s).copy())
    got = fa.flash_backward_plain(tq, tk, tv, out, lse, tdo, causal=causal, window=window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_np(g), _unpacked(w, b, h), err_msg=name, **GRAD_TOL)


def _tf32(x):
    """x rounded to TF32 (a 10-bit mantissa), to nearest with ties away from zero, by
    integer operations on the f32 bits (cvt.rna.tf32.f32 on finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the f32 backward kernels take it on the tensor cores: each operand split into
    hi = tf32(x) and lo = tf32(x − hi), then lo·hi + hi·lo + hi·hi in f32 (a product of two
    TF32 values is exact in f32; lo·lo is left out)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _backward_3xtf32(q, k, v, lse, delta, dout, *, causal, window):
    """The plain backward (``flash_attention._backward_plain``, f32) with every product in
    emulated 3xTF32 and p = exp2(s·scale·log2 e − lse·log2 e), as the card's
    ``flash_dq_tf32_kernel`` and ``flash_dkv_tf32_kernel`` compute it."""
    b, s, h, d = q.shape
    scale = 1.0 / np.sqrt(d)
    log2e = 1.4426950408889634
    qf, kf, vf, dof = (x.permute(0, 2, 1, 3) for x in (q, k, v, dout))
    sc = _mm_3xtf32(qf, kf.transpose(-1, -2))
    p = torch.exp2(sc * np.float32(scale * log2e) - lse[..., None] * np.float32(log2e))
    if causal or window:
        p = torch.where(attention.visibility_mask(s, s, causal=causal, window=window), p, 0.0)
    ds = p * (_mm_3xtf32(dof, vf.transpose(-1, -2)) - delta[..., None])
    grads = (_mm_3xtf32(ds, kf) * np.float32(scale),
             _mm_3xtf32(ds.transpose(-1, -2), qf) * np.float32(scale),
             _mm_3xtf32(p.transpose(-1, -2), dof))
    return [g.permute(0, 2, 1, 3) for g in grads]


@pytest.mark.parametrize("shape", [(2, 256, 2, 16), (1, 128, 1, 128)], ids=["d16", "d128"])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (False, 100), (True, 100)],
                         ids=MASK_IDS)
def test_3xtf32_backward_meets_the_card_tolerance(shape, causal, window):
    """The f32 backward's products in emulated 3xTF32 (the scheme of the card's f32 backward
    kernels) stay within the card's f32 grad tolerance (atol 1e-4, rtol 1e-4) of the FFMA
    plain version and of the JAX ``_dq_kernel``/``_dkv_kernel`` in interpret mode, from the
    same out, lse and dO."""
    b, s, h, d = shape
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(_arrays(shape, 4, d + window))
    q3, k3, v3, g3 = (_packed(x) for x in (jq, jk, jv, jdo))
    j_out, j_lse = jax_pa.flash_forward_with_lse(q3, k3, v3, causal=causal, window=window)
    delta = jnp.sum(g3 * j_out, axis=-1).reshape(j_lse.shape)
    want_jax = jax_pa.flash_backward_blocks(q3, k3, v3, g3, j_lse, delta, causal=causal,
                                            window=window)
    out = torch.from_numpy(_unpacked(j_out, b, h).copy())
    lse = torch.from_numpy(np.asarray(j_lse).reshape(b, h, s).copy())
    want = fa.flash_backward_plain(tq, tk, tv, out, lse, tdo, causal=causal, window=window)
    got = _backward_3xtf32(tq, tk, tv, lse, fa.flash_delta(out, tdo), tdo, causal=causal,
                           window=window)
    for name, g, w, wj in zip("qkv", got, want, want_jax):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(_np(g), _unpacked(wj, b, h), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def _forward_3xtf32(q, k, v, *, causal, window):
    """The plain forward (``flash_attention.flash_forward_plain``, f32) as the card's
    ``flash_fwd_tf32_kernel`` computes it: per key tile of ``KV_TILE``, S = Q·Kᵀ and P·V in
    emulated 3xTF32, the running max m kept in base 2 (the max of s·scale·log2 e over the
    visible keys), p = exp2(s·scale·log2 e − m) and corr = exp2(m_old − m_new); then
    out = acc / l and lse = m·ln 2 + log(l), with l == 0 guarded."""
    b, s, h, d = q.shape
    scale2 = np.float32(np.float32(1.0 / np.sqrt(d)) * np.float32(1.4426950408889634))
    qf, kf, vf = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    m = torch.full((b, h, s, 1), fa.MASK_VALUE, dtype=torch.float32)
    l = torch.zeros((b, h, s, 1), dtype=torch.float32)
    acc = torch.zeros((b, h, s, d), dtype=torch.float32)
    for k0 in range(0, s, fa.KV_TILE):
        kt, vt = kf[:, :, k0:k0 + fa.KV_TILE], vf[:, :, k0:k0 + fa.KV_TILE]
        sc = _mm_3xtf32(qf, kt.transpose(-1, -2))
        vis = attention.visibility_mask(s, kt.shape[2], causal=causal, window=window,
                                        k_offset=k0)
        mx = torch.where(vis, sc, fa.MASK_VALUE).amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m, mx * scale2)
        corr = torch.exp2(m - m_new)
        p = torch.where(vis, torch.exp2(sc * scale2 - m_new), 0.0)
        acc = acc * corr + _mm_3xtf32(p, vt)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).permute(0, 2, 1, 3)
    return out, (m * np.float32(np.log(2.0)) + torch.log(l_safe)).squeeze(-1)


@pytest.mark.parametrize("shape", [(2, 256, 2, 16), (1, 128, 1, 128)], ids=["d16", "d128"])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (False, 100), (True, 100)],
                         ids=MASK_IDS)
def test_3xtf32_forward_meets_the_card_tolerance(shape, causal, window):
    """The f32 forward in emulated 3xTF32 with base-2 softmax statistics (the scheme of the
    card's f32 forward kernel) stays within the card's f32 tolerances — out (atol 2e-5,
    rtol 1e-5), lse (atol 1e-4, rtol 1e-4) — of the FFMA plain version and of the JAX
    ``_fwd_kernel`` in interpret mode."""
    b, s, h, d = shape
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays(shape, 3, 3 * d + window))
    j_out, j_lse = jax_pa.flash_forward_with_lse(_packed(jq), _packed(jk), _packed(jv),
                                                 causal=causal, window=window)
    want_out, want_lse = fa.flash_forward_plain(tq, tk, tv, causal=causal, window=window)
    got_out, got_lse = _forward_3xtf32(tq, tk, tv, causal=causal, window=window)
    for want in (_np(want_out), _unpacked(j_out, b, h)):
        np.testing.assert_allclose(_np(got_out), want, atol=2e-5, rtol=1e-5)
    for want in (_np(want_lse), np.asarray(j_lse).reshape(b, h, s)):
        np.testing.assert_allclose(_np(got_lse), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s", [16, 128, 1920, 2048, 2049, 4096])
def test_dispatch_predicate_matches_jax(s):
    assert fa.dispatch_uses_flash(s) == jax_pa.dispatch_uses_flash(s)
    assert fa.FLASH_MIN_SEQ == jax_pa.FLASH_MIN_SEQ and fa.BLOCK == jax_pa.BLOCK


def test_dispatch_attention_takes_the_dense_core_below_the_crossover():
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays((1, 128, 2, 16), 3, 13))
    np.testing.assert_allclose(
        _np(fa.dispatch_attention(tq, tk, tv, causal=True)),
        _np(jax_pa.dispatch_attention(jq, jk, jv, causal=True)), **FWD_TOL)


@pytest.mark.parametrize("s,kw", [
    (100, {}),                      # length no lane-aligned block tiles
    (256, {"block": 100}),          # block not a multiple of 128
    (384, {"block": 256}),          # length not a multiple of the block
    (128, {"window": 0}),           # window below 1
    (128, {"window": -3}),
], ids=["length", "block", "length_vs_block", "window0", "window_negative"])
def test_bad_inputs_raise_as_in_jax(s, kw):
    (jq, jk, jv), (tq, tk, tv) = _both(_arrays((1, s, 1, 16), 3, 0))
    with pytest.raises(ValueError) as want:
        jax_pa.flash_attention(jq, jk, jv, **kw)
    with pytest.raises(ValueError) as got:
        fa.flash_attention(tq, tk, tv, **kw)
    assert str(got.value) == str(want.value)
