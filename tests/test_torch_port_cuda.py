"""PyTorch port on the card: each CUDA kernel against its plain version, and the train step
through the kernels against the plain step.

These tests need an NVIDIA GPU (Hopper: the kernels are built for sm_90a) and skip
elsewhere. They import neither JAX nor the JAX package, so they run on a machine that has
only PyTorch; there, skip this directory's JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerances as in ``chip_smoke.py``: the loss kernels within atol 1e-6 + rtol 1e-5 of the
plain versions, the one-leaf SGD kernel up to 1e-6 * max|p| and the multi-tensor SGD step
bitwise, 5 steps through the kernels within atol 1e-5 of the plain step. The flash kernels
with a hop offset at the flash kernels' own tolerances; the ring ops at gloo worlds on the
one card against the one-process flash attention within out (2e-5, 1e-5) and gradients
(1e-4, 1e-4).
"""

import math

import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import fused_kernels as fk
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import step

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows,cols", [(64, 10), (32, 10), (1, 10), (300, 130)])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_nll_kernels_match_plain(device, rows, cols, reduction):
    gen = torch.Generator(device=device).manual_seed(rows + cols)
    x = torch.randn(rows, cols, generator=gen, device=device) * 3
    y = torch.randint(0, cols, (rows,), generator=gen, device=device)
    before = fk.launch_counts()
    xk = x.clone().requires_grad_()
    loss = fk.nll_from_logits(xk, y, reduction)
    ct = torch.rand(rows, device=device) if reduction == "none" else torch.tensor(
        0.5, device=device)
    (dx,) = torch.autograd.grad(loss, xk, ct)
    torch.cuda.synchronize()
    after = fk.launch_counts()
    assert after["nll_fwd"] == before["nll_fwd"] + 1
    assert after["nll_bwd"] == before["nll_bwd"] + 1
    torch.testing.assert_close(loss.detach(), fk._nll_reduce(fk.nll_fwd_plain(x, y), reduction),
                               atol=1e-6, rtol=1e-5)
    scale = 1.0 / rows if reduction == "mean" else 1.0
    torch.testing.assert_close(dx, fk.nll_bwd_plain(x, y, ct, scale), atol=1e-6, rtol=1e-5)


def test_kernels_refuse_what_they_do_not_take(device):
    x = torch.randn(4, 10, device=device)
    with pytest.raises(TypeError):
        fk.nll_fwd(x.double(), torch.zeros(4, dtype=torch.int64, device=device))
    with pytest.raises(TypeError):
        fk.nll_fwd(x, torch.zeros(4, dtype=torch.int32, device=device))
    with pytest.raises(ValueError, match="contiguous"):
        fk.nll_fwd(torch.randn(10, 4, device=device).t(),
                   torch.zeros(4, dtype=torch.int64, device=device))
    with pytest.raises(ValueError, match="expected"):
        fk.nll_fwd(x, torch.zeros(4, dtype=torch.int64))


def test_launch_leaves_the_current_device_alone(device):
    """A wrapper makes its tensors' device current only for the launch."""
    on = torch.device("cuda", torch.cuda.device_count() - 1)
    before = torch.cuda.current_device()
    x = torch.randn(8, 10, device=on)
    y = torch.arange(8, device=on) % 10
    torch.testing.assert_close(fk.nll_fwd(x, y), fk.nll_fwd_plain(x, y), atol=1e-6, rtol=1e-5)
    assert torch.cuda.current_device() == before


@pytest.mark.parametrize("n", [10, 250, 16000, 1 << 22])
def test_sgd_kernel_matches_plain(device, n):
    gen = torch.Generator(device=device).manual_seed(n)
    p, v, g = (torch.randn(n, generator=gen, device=device) for _ in range(3))
    pk, vk, pp, vp = p.clone(), v.clone(), p.clone(), v.clone()
    for _ in range(3):
        fk.sgd_momentum_leaf(pk, vk, g, learning_rate=0.01, momentum=0.5)
        fk.sgd_momentum_leaf_plain(pp, vp, g, learning_rate=0.01, momentum=0.5)
    tol = 1e-6 * pp.abs().max().item()
    torch.testing.assert_close(pk, pp, atol=tol, rtol=0)
    torch.testing.assert_close(vk, vp, atol=tol, rtol=0)


def _leaf_dicts(device, sizes, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [{f"leaf{i}": torch.randn(n, generator=gen, device=device)
             for i, n in enumerate(sizes)} for _ in range(3)]


CNN_LEAF_SIZES = (250, 10, 5000, 20, 16000, 50, 500, 10)


@pytest.mark.parametrize("case", ["cnn", "large", "channels_last", "longer_than_table"])
def test_sgd_step_multi_tensor_matches_plain(device, case):
    """sgd_momentum_step on the card (one launch of the multi-tensor kernel per table of
    SGD_TABLE_LEAVES leaves) is bitwise the plain version applied leaf by leaf, over 3
    steps: on the CNN's 8 leaves, on those with a 2^22 leaf, with a channels-last conv
    weight gradient (made contiguous first), and on more leaves than one table holds."""
    sizes = {"cnn": CNN_LEAF_SIZES, "large": CNN_LEAF_SIZES + (1 << 22,),
             "channels_last": CNN_LEAF_SIZES,
             "longer_than_table": tuple(range(1, 2 * fk.SGD_TABLE_LEAVES + 4))}[case]
    params, vel, grads = _leaf_dicts(device, sizes, len(sizes))
    if case == "channels_last":
        conv = torch.randn(16, 10, 5, 5, device=device)
        for d in (params, vel):
            d["conv"] = torch.randn_like(conv)
        grads["conv"] = conv.to(memory_format=torch.channels_last)
        assert not grads["conv"].is_contiguous()
    pk, vk, pp, vp = ({k: t.clone() for k, t in d.items()} for d in (params, vel, params, vel))
    before = fk.launch_counts()["sgd_momentum"]
    for _ in range(3):
        out = fk.sgd_momentum_step(pk, vk, grads, learning_rate=0.01, momentum=0.5)
        for k, g in grads.items():
            fk.sgd_momentum_leaf_plain(pp[k], vp[k], g, learning_rate=0.01, momentum=0.5)
    torch.cuda.synchronize()
    assert out == (pk, vk)
    tables = -(-len(grads) // fk.SGD_TABLE_LEAVES)
    assert tables == (3 if case == "longer_than_table" else 1)
    assert fk.launch_counts()["sgd_momentum"] - before == 3 * tables
    for k in grads:
        assert torch.equal(pk[k], pp[k]), k
        assert torch.equal(vk[k], vp[k]), k


def test_train_steps_through_kernels_match_plain(device):
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    gen = torch.Generator(device=device).manual_seed(0)
    xs = torch.randn(5, 64, 28, 28, 1, generator=gen, device=device)
    ys = torch.randint(0, 10, (5, 64), generator=gen, device=device)
    finals = []
    for use_pallas in (True, False):
        state = step.create_train_state(net, torch.Generator().manual_seed(1), device=device)
        fn = step.make_train_step(net, learning_rate=0.01, momentum=0.5, use_pallas=use_pallas)
        for i in range(5):
            state, _ = fn(state, xs[i], ys[i], 1)
        finals.append(state.params)
    for k in finals[0]:
        torch.testing.assert_close(finals[0][k], finals[1][k], atol=1e-5, rtol=0)


# =========================================================================================
# Flash attention (B4, B5): each kernel against its plain version
# =========================================================================================
#
# Tolerances: float32 kernels against the plain versions within atol 2e-5 + rtol 1e-5 (out)
# and atol 1e-4 + rtol 1e-4 (lse, dq, dk, dv): the same arithmetic, f32 sums in another
# order, over up to 2048 keys or queries. bfloat16 out and grads within atol 1e-3 + rtol
# 2^-7, one bf16 ulp at any magnitude and two below 0.125 (a skipped 64-key tile moves out
# by ~5e-3 where |out| ~ 0.03, and fails); atol 1e-4 for the f32 lse.
#
# p and ds round to bf16 at the same places in kernel and plain version, but the bf16
# backward sums q·kᵀ and dO·vᵀ on the tensor cores, in another order than the plain
# version's f32 GEMMs. Where the exact p or ds lies within that f32 error of a bf16
# rounding midpoint, one rounds up and the other down, and the flipped step, times a row of
# k, q or dO, can exceed one ulp of a small output element. So the bf16 comparison at
# these tolerances draws its operands on a grid (``_exact_grid``) on which both products
# are exact in f32 in any order: kernel and plain version then round p and ds alike. On
# randn operands, test_flash_bf16_backward_differs_from_plain_only_at_rounding_ties holds
# every element beyond the tolerance to one-step flips at such midpoints.

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (  # noqa: E402
    transformer,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (  # noqa: E402
    attention,
    flash_attention as fa,
)

FLASH_TOL = {torch.float32: dict(out=(2e-5, 1e-5), lse=(1e-4, 1e-4), grad=(1e-4, 1e-4)),
             torch.bfloat16: dict(out=(1e-3, 2.0 ** -7), lse=(1e-4, 1e-4),
                                  grad=(1e-3, 2.0 ** -7))}
# windows whose edge falls on a tile boundary (64) and inside tiles (100, 160), so that
# both interior tiles and tiles the band edge crosses are walked
MASKS = [(False, 0), (True, 0), (False, 64), (True, 100), (False, 160), (True, 160)]


def _exact_grid(x):
    """x on the grid of 1/16 in [-4, 4]: a product of two such values is a multiple of
    2^-8 and a sum of up to 128 of them is at most 2^11 in magnitude, so every q·kᵀ and
    dO·vᵀ (D <= 128) is exact in f32 whatever the order of its sums."""
    return (x * 16).round().clamp(-64, 64) / 16


def _qkvd(device, b, s, h, d, dtype, seed, exact=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    xs = [torch.randn(b, s, h, d, generator=gen, device=device) for _ in range(4)]
    return [(_exact_grid(x) if exact else x).to(dtype) for x in xs]


def _close(got, want, tol):
    atol, rtol = tol
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("s", [64, 128, 256, 2048])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernels_match_plain(device, s, d, causal, window, dtype):
    """Every kernel against its plain version: f32 operands take the 3xTF32 tensor-core
    forward and backward, bf16 the bf16 tensor-core kernels, on operands of the exact grid;
    S = 64 is a single tile."""
    q, k, v, do = _qkvd(device, 2, s, 2, d, dtype, s + d + window,
                        exact=dtype == torch.bfloat16)
    tol = FLASH_TOL[dtype]
    out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
    out_p, lse_p = fa.flash_forward_plain(q, k, v, causal=causal, window=window)
    _close(out, out_p, tol["out"])
    _close(lse, lse_p, tol["lse"])
    grads = fa.flash_backward(q, k, v, out_p, lse_p, do, causal=causal, window=window)
    grads_p = fa.flash_backward_plain(q, k, v, out_p, lse_p, do, causal=causal,
                                      window=window)
    torch.cuda.synchronize()
    for got, want in zip(grads, grads_p):
        assert got.dtype == dtype
        _close(got, want, tol["grad"])


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 160)])
def test_flash_bf16_forward_on_randn_operands(device, causal, window):
    """The tensor-core forward against its plain version on randn operands (off the exact
    grid) at [2, 2048, 2, 128]: out within (1e-3, 2^-7), lse within (1e-4, 1e-4). The two
    sum q·kᵀ in other orders, so a p near a bf16 rounding midpoint may round one step
    apart; but out is a convex mix of v rows, and one such step moves it by at most 2^-7 of
    that p's weight p/l times its v row, below the tolerance unless one key holds much of a
    row's weight."""
    q, k, v, _ = _qkvd(device, 2, 2048, 2, 128, torch.bfloat16, 2048 + 128 + window)
    before = fa.launch_counts()["flash_fwd"]
    out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
    assert fa.launch_counts()["flash_fwd"] == before + 1
    out_p, lse_p = fa.flash_forward_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    _close(out, out_p, FLASH_TOL[torch.bfloat16]["out"])
    _close(lse, lse_p, FLASH_TOL[torch.bfloat16]["lse"])


F32_U = 2.0 ** -24       # unit roundoff of f32


def _rounding_ties(name, r, ops, lse, delta, vis, scale):
    """Row r of dq (a query) or of dk, dv (a key) of one (b, h) slice, from the operands
    ``ops`` = (q, k, v, dO) as f64 ``[S, D]`` and the f32 lse and Δ as f64 ``[S]``: over
    the row's visible partners, the exact value that is rounded to bf16 (ds for dq and dk,
    p for dv), a bound on how far either implementation's f32 value of it lies from it, and
    the row that one bf16 step of that value adds to the output (scale·k, scale·q or dO)."""
    q, k, v, do = ops
    if name == "dq":
        idx = vis[r].nonzero()[:, 0]
        qi, ki, vi, doi, lse_i, delta_i = q[r], k[idx], v[idx], do[r], lse[r], delta[r]
        vec = scale * k[idx]
    else:
        idx = vis[:, r].nonzero()[:, 0]
        qi, ki, vi, doi, lse_i, delta_i = q[idx], k[r], v[r], do[idx], lse[idx], delta[idx]
        vec = scale * q[idx] if name == "dk" else do[idx]
    # a sum of d exact bf16 products in f32 lies within (λ·√d + d/8)·u·Σ|terms| of the exact
    # sum: λ·√d·u·Σ|terms| with λ = 8 is Higham and Mary's probabilistic bound for sums
    # rounded to nearest in any order (it fails with probability below 2·d·exp(-32)), and
    # 2·u·Σ|terms| for each of the tensor cores' d/16 truncating k-steps
    d = q.shape[1]
    bound = (8 * math.sqrt(d) + d / 8) * F32_U
    s, e_s = (qi * ki).sum(-1), bound * (qi * ki).abs().sum(-1)
    dp, e_dp = (doi * vi).sum(-1), bound * (doi * vi).abs().sum(-1)
    x = s * scale - lse_i                                   # two f32 roundings
    e_x = scale * e_s + 2 * F32_U * ((s * scale).abs() + x.abs())
    p = x.exp()
    e_p = p * (e_x.exp() * (1 + 4 * F32_U) - 1)             # expf within 2 ulp
    dd = dp - delta_i
    e_dd = e_dp + 2 * F32_U * dd.abs()
    ds = p * dd
    e_ds = e_p * (dd.abs() + e_dd) + p * e_dd + 2 * F32_U * ds.abs()
    return (p, e_p, vec) if name == "dv" else (ds, e_ds, vec)


def _explain_by_flips(got, want, value, err, vec, tol):
    """Greedily take one-step flips (either sign, each value at most once) of the values
    whose bf16 rounding ``value ± err`` leaves open, until ``got`` lies within ``tol`` of
    ``want`` plus the flips: the number taken, or None if no flip brings it closer."""
    atol, rtol = tol
    lo, hi = ((value + sign * err).to(torch.bfloat16).double() for sign in (-1, 1))
    open_ = (lo != hi).nonzero()[:, 0]
    steps = (hi - lo)[open_, None] * vec[open_]
    steps = torch.cat([steps, -steps])
    taken = torch.zeros(len(steps), dtype=torch.bool, device=got.device)
    moved = torch.zeros_like(want)
    while True:
        resid = got - want - moved
        if bool((resid.abs() <= atol + rtol * (want + moved).abs()).all()):
            return int(taken.sum())
        norms = (resid - steps).norm(dim=-1).masked_fill(taken | taken.roll(len(open_)),
                                                         float("inf"))
        if not len(norms) or norms.min() >= resid.norm():
            return None
        best = int(norms.argmin())
        moved, taken[best] = moved + steps[best], True


def _f64_backward(q, k, v, do, lse, delta, vis, scale):
    """dq, dk, dv ``[B, S, H, D]`` in f64 from bf16 operands and the f32 lse and Δ, with p
    and ds rounded to bf16 from their exact values."""
    qf, kf, vf, dof = (x.double().permute(0, 2, 1, 3) for x in (q, k, v, do))
    x = (qf @ kf.transpose(-1, -2)) * scale - lse.double()[..., None]
    p = torch.where(vis, x.exp(), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta.double()[..., None])
    p, ds = (t.to(torch.bfloat16).double() for t in (p, ds))
    grads = (scale * ds @ kf, scale * ds.transpose(-1, -2) @ qf, p.transpose(-1, -2) @ dof)
    return [g.permute(0, 2, 1, 3) for g in grads]


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_bf16_backward_differs_from_plain_only_at_rounding_ties(device, d, causal,
                                                                     window):
    """randn bf16 operands at S = 2048 (the seeds of test_flash_kernels_match_plain): each
    dq, dk or dv row of the tensor-core kernels with an element beyond the bf16 tolerance
    of the plain version comes within it once one-step flips of p or ds are taken at
    visible pairs whose exact value (f64, from the same operands, lse and Δ) lies within
    the f32 error bound of a bf16 rounding midpoint. A skipped, extra or wrongly masked tile
    moves a row by sums over many pairs, which such flips do not explain. Prints each such
    row's worst element beside the f64 value with p and ds rounded from their exact
    values, and how far each of kernel and plain version lies from that f64 backward over
    the whole tensor (run with -s or -rP); on average the kernel lies no farther from it
    than the plain version, within 1%."""
    s, tol = 2048, FLASH_TOL[torch.bfloat16]["grad"]
    q, k, v, do = _qkvd(device, 2, s, 2, d, torch.bfloat16, s + d + window)
    out, lse = fa.flash_forward_plain(q, k, v, causal=causal, window=window)
    delta = fa.flash_delta(out, do)
    grads = fa.flash_backward(q, k, v, out, lse, do, causal=causal, window=window)
    grads_p = fa.flash_backward_plain(q, k, v, out, lse, do, causal=causal, window=window)
    vis = attention.visibility_mask(s, s, causal=causal, window=window, device=device)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32).item()
    atol, rtol = tol
    exact_grads = _f64_backward(q, k, v, do, lse, delta, vis, scale)
    for name, got, want, ref in zip(("dq", "dk", "dv"), grads, grads_p, exact_grads):
        got, want = got.double(), want.double()
        far = [((x - ref).abs() > atol + rtol * ref.abs()).sum().item() for x in (got, want)]
        mean = [(x - ref).abs().mean().item() for x in (got, want)]
        print(f"{name} d={d} causal={causal} window={window} against the f64 backward: "
              f"beyond the tolerance kernel {far[0]}, plain {far[1]} elements; mean |err| "
              f"kernel {mean[0]:.4g}, plain {mean[1]:.4g}")
        assert mean[0] <= 1.01 * mean[1], f"{name}: the kernel is farther from f64 on average"
        excess = (got - want).abs() - atol - rtol * want.abs()
        for b, r, h in (excess > 0).any(-1).nonzero().tolist():
            ops = [x[b, :, h].double() for x in (q, k, v, do)]
            value, err, vec = _rounding_ties(name, r, ops, lse[b, h].double(),
                                             delta[b, h].double(), vis, scale)
            flips = _explain_by_flips(got[b, r, h], want[b, r, h], value, err, vec, tol)
            c = int(excess[b, r, h].argmax())
            exact = float((value.to(torch.bfloat16).double() * vec[:, c]).sum())
            g, w = got[b, r, h, c].item(), want[b, r, h, c].item()
            print(f"{name}[{b}, {r}, {h}, {c}] d={d} causal={causal} window={window}: "
                  f"kernel {g:.6g}, plain {w:.6g}, f64 {exact:.6g}; |kernel - f64| "
                  f"{abs(g - exact):.4g}, |plain - f64| {abs(w - exact):.4g}; "
                  f"explained by {flips} flips")
            assert flips is not None, (
                f"{name} row ({b}, {r}, {h}): kernel and plain version differ beyond "
                f"one-step flips of p or ds at rounding ties")


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 160)])
def test_flash_f32_forward_against_f64(device, d, causal, window):
    """The 3xTF32 forward on randn f32 operands at S = 2048 (D = 16 is the composed
    trainer's width) against an f64 forward from the same operands: out within
    (2e-5, 1e-5) and lse within (1e-4, 1e-4) of it, as the FFMA plain version is. Prints
    each one's max and mean |err| against f64 (run with -s or -rP)."""
    s = 2048
    q, k, v, _ = _qkvd(device, 2, s, 2, d, torch.float32, 5 * d + window)
    got = fa.flash_forward(q, k, v, causal=causal, window=window)
    plain = fa.flash_forward_plain(q, k, v, causal=causal, window=window)
    vis = attention.visibility_mask(s, s, causal=causal, window=window, device=device)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32).item()
    qf, kf, vf = (x.double().permute(0, 2, 1, 3) for x in (q, k, v))
    scores = torch.where(vis, (qf @ kf.transpose(-1, -2)) * scale, -math.inf)
    exact = ((torch.softmax(scores, dim=-1) @ vf).permute(0, 2, 1, 3),
             torch.logsumexp(scores, dim=-1))
    for i, name in enumerate(("out", "lse")):
        errs = [(x[i].double() - exact[i]).abs() for x in (got, plain)]
        print(f"{name} d={d} causal={causal} window={window} against the f64 forward: "
              f"max |err| kernel {errs[0].max().item():.4g}, plain {errs[1].max().item():.4g}; "
              f"mean |err| kernel {errs[0].mean().item():.4g}, plain "
              f"{errs[1].mean().item():.4g}")
        _close(got[i], exact[i], FLASH_TOL[torch.float32][name])
        _close(plain[i], exact[i], FLASH_TOL[torch.float32][name])


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 160)])
def test_flash_f32_backward_against_f64(device, d, causal, window):
    """The 3xTF32 backward on randn f32 operands at S = 2048 (D = 16 is the composed
    trainer's width) against an f64 backward from the same operands, lse and Δ: within the
    f32 grad tolerance (1e-4, 1e-4) of it, as the FFMA plain version is. Prints each one's
    max and mean |err| against f64 (run with -s or -rP)."""
    s = 2048
    q, k, v, do = _qkvd(device, 2, s, 2, d, torch.float32, 7 * d + window)
    out, lse = fa.flash_forward_plain(q, k, v, causal=causal, window=window)
    delta = fa.flash_delta(out, do)
    grads = fa.flash_backward(q, k, v, out, lse, do, causal=causal, window=window)
    grads_p = fa.flash_backward_plain(q, k, v, out, lse, do, causal=causal, window=window)
    vis = attention.visibility_mask(s, s, causal=causal, window=window, device=device)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32).item()
    qf, kf, vf, dof = (x.double().permute(0, 2, 1, 3) for x in (q, k, v, do))
    p = torch.where(vis, ((qf @ kf.transpose(-1, -2)) * scale - lse.double()[..., None]).exp(),
                    0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta.double()[..., None])
    exact = [g.permute(0, 2, 1, 3) for g in (scale * ds @ kf, scale * ds.transpose(-1, -2) @ qf,
                                             p.transpose(-1, -2) @ dof)]
    for name, got, plain, ref in zip(("dq", "dk", "dv"), grads, grads_p, exact):
        errs = [(x.double() - ref).abs() for x in (got, plain)]
        print(f"{name} d={d} causal={causal} window={window} against the f64 backward: "
              f"max |err| kernel {errs[0].max().item():.4g}, plain {errs[1].max().item():.4g}; "
              f"mean |err| kernel {errs[0].mean().item():.4g}, plain "
              f"{errs[1].mean().item():.4g}")
        _close(got, ref, FLASH_TOL[torch.float32]["grad"])
        _close(plain, ref, FLASH_TOL[torch.float32]["grad"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_counts_one_launch_per_kernel(device, dtype):
    """One launch of each kernel on either route (3xTF32 backward for f32, bf16 tensor-core
    kernels for bf16)."""
    q, k, v, do = (x.requires_grad_() for x in _qkvd(device, 2, 256, 2, 64, dtype, 0))
    before = fa.launch_counts()
    out = fa.flash_attention(q, k, v, causal=True)
    torch.autograd.grad(out, (q, k, v), do)
    after = fa.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {"flash_fwd": 1, "flash_dq": 1,
                                                         "flash_dkv": 1}
    with torch.no_grad():
        fa.dispatch_attention(q[:, :128], k[:, :128], v[:, :128])   # dense below 2048
    assert fa.launch_counts() == after


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernels_read_strided_qkv_views(device, dtype):
    """q, k, v sliced out of a fused [B, S, 3, H, D] projection give what contiguous
    copies give, bit for bit: the kernels read by strides (the bf16 backward's 16-byte
    copies included: these views are aligned)."""
    gen = torch.Generator(device=device).manual_seed(3)
    qkv = torch.randn(2, 256, 3, 4, 16, generator=gen, device=device).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(2, 256, 4, 16, generator=gen, device=device).to(dtype)
    assert not q.is_contiguous()
    out, lse = fa.flash_forward(q, k, v, window=160)
    copies = [t.contiguous() for t in (q, k, v)]
    out_c, lse_c = fa.flash_forward(*copies, window=160)
    torch.testing.assert_close(out, out_c, atol=0, rtol=0)
    torch.testing.assert_close(lse, lse_c, atol=0, rtol=0)
    grads = fa.flash_backward(q, k, v, out, lse, do.transpose(1, 2).contiguous().transpose(
        1, 2), window=160)
    grads_c = fa.flash_backward(*copies, out_c, lse_c, do, window=160)
    for got, want in zip(grads, grads_c):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("route", ["backward", "forward"])
def test_flash_backward_bf16_refuses_misaligned_operands(device, route):
    """An operand one element off 16-byte alignment (a view cut from a flat buffer at
    offset 1) raises in the wrappers of the tensor-core kernels — both backward ones, or
    the forward, in bf16 and in f32 (3xTF32) — launching nothing."""
    b, s, h, d = 1, 128, 2, 64
    q, k, v, do = _qkvd(device, b, s, h, d, torch.bfloat16, 5)
    out, lse = fa.flash_forward_plain(q, k, v)
    delta = fa.flash_delta(out, do)
    flat = torch.empty(b * s * h * d + 1, dtype=torch.bfloat16, device=device)
    q_off = flat[1:].view(b, s, h, d)
    q_off.copy_(q)
    before = fa.launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        if route == "backward":
            fa.flash_dq(q_off, k, v, do, lse, delta)
        else:
            fa.flash_forward(q_off, k, v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        if route == "backward":
            fa.flash_dkv(k, q_off, v, do, lse, delta)
        else:
            fa.flash_forward(k, v, q_off, causal=True)
    assert fa.launch_counts() == before
    q32 = flat.float()[1:].view(b, s, h, d)
    f32 = [x.float() for x in (k, v, do)]
    with pytest.raises(ValueError, match="16-byte aligned"):
        if route == "backward":
            fa.flash_dq(q32, *f32[:2], f32[2], lse, delta)
        else:
            fa.flash_forward(q32, *f32[:2])
    with pytest.raises(ValueError, match="16-byte aligned"):
        if route == "backward":
            fa.flash_dkv(f32[0], q32, f32[1], f32[2], lse, delta)
        else:
            fa.flash_forward(f32[0], f32[1], q32, causal=True)
    assert fa.launch_counts() == before


@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_bf16_ignores_rows_outside_the_band(device, d):
    """Window 100 at S = 512: poisoning (1e9) every key row outside the band of query tile
    5 leaves that tile's dq unchanged, bit for bit, and poisoning every query row (q, dO,
    lse, Δ) outside the band of key tile 5 leaves that tile's dk and dv unchanged. The
    band's live tiles 3 and 7 hold poisoned rows too, so a masked element must add an
    exact 0."""
    s, w, t0 = 512, 100, 5 * 64
    q, k, v, do = _qkvd(device, 2, s, 2, d, torch.bfloat16, d)
    out, lse = fa.flash_forward_plain(q, k, v, window=w)
    delta = fa.flash_delta(out, do)
    rows = slice(t0, t0 + 64)
    out_of_band = torch.ones(s, dtype=torch.bool, device=device)
    out_of_band[t0 - w + 1:t0 + 64 + w - 1] = False
    dq = fa.flash_dq(q, k, v, do, lse, delta, window=w)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, window=w)
    kp, vp = k.clone(), v.clone()
    kp[:, out_of_band], vp[:, out_of_band] = 1e9, 1e9
    assert torch.equal(fa.flash_dq(q, kp, vp, do, lse, delta, window=w)[:, rows], dq[:, rows])
    qp, dop, lsep, deltap = q.clone(), do.clone(), lse.clone(), delta.clone()
    qp[:, out_of_band], dop[:, out_of_band] = 1e9, 1e9
    lsep[..., out_of_band], deltap[..., out_of_band] = 1e9, 1e9
    dk2, dv2 = fa.flash_dkv(qp, k, v, dop, lsep, deltap, window=w)
    assert torch.equal(dk2[:, rows], dk[:, rows])
    assert torch.equal(dv2[:, rows], dv[:, rows])


def test_flash_kernels_refuse_what_they_do_not_take(device):
    q, k, v, _ = _qkvd(device, 1, 128, 2, 16, torch.float32, 0)
    with pytest.raises(ValueError, match="contiguous in its last dim"):
        fa.flash_forward(q.transpose(2, 3).contiguous().transpose(2, 3)[..., :16], k, v)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_forward(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_forward(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_forward(*(x[..., :8].contiguous() for x in (q, k, v)))
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_forward(q, k.cpu(), v)


def test_transformer_step_through_flash_matches_dense(device):
    """One train step of the classifier at seq 128 with the flash kernels as its core
    matches the dense core within atol 1e-5 (f32 sums in another order)."""
    finals = []
    for core in (fa.flash_attention, attention.full_attention):
        model = transformer.TransformerClassifier(seq_len=128, embed_dim=32, num_heads=2,
                                                  dropout_rate=0.0, attention_fn=core)
        state = step.create_train_state(model, torch.Generator().manual_seed(1), device=device)
        fn = step.make_train_step(model, learning_rate=0.05, momentum=0.5)
        gen = torch.Generator(device=device).manual_seed(0)
        xs = torch.randn(4, 28, 28, 1, generator=gen, device=device)
        ys = torch.arange(4, device=device)
        state, loss = fn(state, xs, ys, 1)
        finals.append((loss, state.params))
    torch.testing.assert_close(finals[0][0], finals[1][0], atol=1e-5, rtol=0)
    for name in finals[0][1]:
        torch.testing.assert_close(finals[0][1][name], finals[1][1][name], atol=1e-5, rtol=0)


# =========================================================================================
# Paged decode (B6): the kernel against its plain version, and the serving engine on it
# =========================================================================================
#
# Tolerance: atol 1e-5 + rtol 1e-5. Kernel and plain version read the same pool values as
# f32 (or dequantise code·scale in f32 in both) and differ only in the order of f32 sums
# over up to 832 positions.

from csed_514_project_distributed_training_using_pytorch_tpu_torch import serving  # noqa: E402
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm  # noqa: E402
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (  # noqa: E402
    paged_attention as paged,
)

PAGED_TOL = dict(atol=1e-5, rtol=1e-5)
POOL_DTYPES = [torch.float32, torch.bfloat16, torch.int8, torch.float8_e4m3fn]


def _quantize_rows(x, dtype):
    """Per-row symmetric codes and f32 scales (the JAX package's ``quant.quantize_rows``)."""
    qmax = 127.0 if dtype == torch.int8 else 448.0
    amax = x.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    codes = x / scale[..., None]
    if dtype == torch.int8:
        codes = codes.round().clamp(-qmax, qmax)
    return codes.to(dtype), scale


def _paged_case(device, b, g, r, d, ps, p_max, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    num_pages = 1 + b * p_max + 3                 # null + reservations + unowned spares
    k = torch.randn(num_pages, ps, g, d, generator=gen, device=device)
    v = torch.randn(num_pages, ps, g, d, generator=gen, device=device)
    scales = {}
    if dtype in (torch.int8, torch.float8_e4m3fn):
        (k, ks), (v, vs) = _quantize_rows(k, dtype), _quantize_rows(v, dtype)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(dtype), v.to(dtype)
    perm = torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = perm[:b * p_max].reshape(b, p_max).to(torch.int32).to(device)
    q = torch.randn(b, g, r, d, generator=gen, device=device)
    t = torch.randint(0, p_max * ps, (b,), generator=torch.Generator().manual_seed(seed),
                      dtype=torch.int32)
    t[0] = 0
    return q, k, v, table, t.to(device), scales


@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("dtype", POOL_DTYPES, ids=["f32", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("r", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("d", [4, 8, 16, 32, 64, 128])
def test_paged_kernel_matches_plain(device, d, r, dtype, window):
    """Pages of 64 over a 13-page table (the serving engine's P_max at seq 784); any
    number R of query rows per KV head (R·D up to 2048 here, cut into row blocks of
    512 / D). Rows of 16-byte multiples take the kernel's 16-byte copies, narrower ones
    (int8 and fp8 at D = 4 and 8, bf16 at D = 4) its element copies."""
    q, k, v, table, t, scales = _paged_case(device, 5, 2, r, d, 64, 13, dtype, d + r)
    before = paged.launch_counts()["paged_attend"]
    out = paged.paged_attend(q, k, v, table, t, window=window, **scales)
    torch.cuda.synchronize()
    assert paged.launch_counts()["paged_attend"] == before + 1
    want = paged.paged_attend_reference(q, k, v, table, t, seq_len=13 * 64, window=window,
                                        **scales)
    assert out.dtype == torch.float32 and out.shape == q.shape
    torch.testing.assert_close(out, want, **PAGED_TOL)


@pytest.mark.parametrize("ps", [1, 4, 16, 100])
def test_paged_kernel_page_sizes_and_edges(device, ps):
    """Page sizes other than the tile; t past the table (clipped), t = 0, t = -1 (no
    visible row: zeros); unowned pages poisoned with 1e9 change nothing."""
    p_max = -(-200 // ps)
    q, k, v, table, t, _ = _paged_case(device, 4, 2, 2, 32, ps, p_max, torch.float32, ps)
    t[1], t[2], t[3] = p_max * ps + 50, 0, -1
    out = paged.paged_attend(q, k, v, table, t)
    want = paged.paged_attend_reference(q, k, v, table, t, seq_len=p_max * ps)
    want[3] = 0.0
    torch.testing.assert_close(out, want, **PAGED_TOL)
    owned = set(table.flatten().tolist())
    poison = torch.tensor([p for p in range(k.shape[0]) if p not in owned], device=device)
    k2, v2 = k.clone(), v.clone()
    k2[poison], v2[poison] = 1e9, 1e9
    assert torch.equal(paged.paged_attend(q, k2, v2, table, t), out)


def test_paged_kernel_clips_at_seq_len(device):
    """The engine's view: seq_len 784 under a 13-page table of 64 (832 positions). Slots
    at t = 783, 784 (a finished slot parks there), 800 and 831 see rows 0..783 on the
    card as in the plain version; poisoning rows 784..831 changes nothing."""
    q, k, v, table, t, _ = _paged_case(device, 4, 4, 1, 16, 64, 13, torch.float32, 3)
    t = torch.tensor([783, 784, 800, 831], dtype=torch.int32, device=device)
    out = paged.paged_attend(q, k, v, table, t, seq_len=784)
    want = paged.paged_attend_reference(q, k, v, table, t, seq_len=784)
    torch.testing.assert_close(out, want, **PAGED_TOL)
    k2, v2 = k.clone(), v.clone()
    tail = table[:, 784 // 64].long()
    k2[tail, 784 % 64:], v2[tail, 784 % 64:] = 1e9, 1e9
    assert torch.equal(paged.paged_attend(q, k2, v2, table, t, seq_len=784), out)


@pytest.mark.parametrize("t_kind", ["long", "mixed"])
@pytest.mark.parametrize("dtype", POOL_DTYPES, ids=["f32", "bf16", "int8", "fp8"])
def test_paged_kernel_long_and_mixed_t(device, t_kind, dtype):
    """The serving shape [8, 4, 1, 16] over the engine's 784-position view, split into one
    chunk a tile: every slot at t = 783 (every chunk live), or slots' t spread over the
    view so that some slots' later chunks are empty; and a batch of 80 slots, whose row
    blocks fill the card, so that each block walks its slot's tiles alone and no chunk is
    merged."""
    for b in (8, 80):
        q, k, v, table, t, scales = _paged_case(device, b, 4, 1, 16, 64, 13, dtype, b)
        if t_kind == "long":
            t.fill_(783)
        else:
            t.copy_(torch.arange(b, device=device, dtype=torch.int32) * 97 % 800)
        n_split = paged.split_plan(b, 4, 1, 16, 784, paged._sm_count(device.index))[1]
        assert n_split == (13 if b == 8 else 1)
        out = paged.paged_attend(q, k, v, table, t, seq_len=784, **scales)
        want = paged.paged_attend_reference(q, k, v, table, t, seq_len=784, **scales)
        torch.testing.assert_close(out, want, **PAGED_TOL)


def test_paged_kernel_makes_no_host_sync(device):
    """A call runs under ``torch.cuda.set_sync_debug_mode("error")``: the split plan comes
    from the shapes and the SM count, never from ``t``, so nothing waits on the card (the
    engine may capture the decode step in a CUDA graph)."""
    q, k, v, table, t, scales = _paged_case(device, 8, 4, 1, 16, 64, 13, torch.int8, 11)
    paged.paged_attend(q, k, v, table, t, seq_len=784, **scales)   # built and loaded first
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = paged.paged_attend(q, k, v, table, t, seq_len=784, **scales)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    want = paged.paged_attend_reference(q, k, v, table, t, seq_len=784, **scales)
    torch.testing.assert_close(out, want, **PAGED_TOL)


def test_paged_kernel_refuses_what_it_does_not_take(device):
    q, k, v, table, t, _ = _paged_case(device, 2, 2, 2, 16, 4, 4, torch.float32, 0)
    with pytest.raises(ValueError, match="table must be int32"):
        paged.paged_attend(q, k, v, table.long(), t)
    with pytest.raises(ValueError, match="t must be int32"):
        paged.paged_attend(q, k, v, table, t.long())
    with pytest.raises(TypeError, match="pool dtypes"):
        paged.paged_attend(q, k.half(), v.half(), table, t)
    q8 = torch.randn(2, 2, 8, 16, device=device)    # R = 8: taken, as the TPU kernel does
    torch.testing.assert_close(paged.paged_attend(q8, k, v, table, t),
                               paged.paged_attend_reference(q8, k, v, table, t, seq_len=16),
                               **PAGED_TOL)
    with pytest.raises(ValueError, match="one CUDA device"):
        paged.paged_attend(q, k, v, table.cpu(), t)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        paged.paged_attend(q, k, v, table, t, k_scale=torch.ones(k.shape[:3], device=device))
    q6, k6, v6, _, _, _ = _paged_case(device, 2, 2, 2, 6, 4, 4, torch.float32, 0)
    with pytest.raises(ValueError, match="multiple of 4"):     # the kernel moves float4s
        paged.paged_attend(q6, k6, v6, table, t)


@pytest.mark.parametrize("cfg", [dict(), dict(num_kv_heads=2), dict(attention_window=5),
                                 dict(rope=True), dict(num_heads=8, num_kv_heads=1)],
                         ids=["mha", "gqa", "window", "rope", "mqa_r8"])
def test_engine_paged_streams_on_the_card(device, cfg):
    """The engine on the card: the paged layout (through the kernel) against the
    contiguous layout (plain torch), greedy, through fewer slots than requests; one
    kernel launch per layer and decode step. mqa_r8: 8 query heads over one KV head
    (R = 8)."""
    model = lm.TransformerLM(**(dict(vocab_size=9, seq_len=16, embed_dim=32, num_layers=2,
                                     num_heads=4) | cfg))
    params = model.init(torch.Generator().manual_seed(0))

    def requests():
        rng = torch.Generator().manual_seed(1)
        return [serving.Request(
            prompt=torch.randint(0, 8, (int(torch.randint(0, 8, (1,), generator=rng)),),
                                 generator=rng).numpy().astype("int32"),
            max_new_tokens=int(torch.randint(1, 16, (1,), generator=rng)), request_id=i)
            for i in range(6)]

    streams = {}
    for layout in ("contiguous", "paged"):
        engine = serving.ContinuousBatchingEngine(model, params, num_slots=3,
                                                  kv_layout=layout, page_size=4)
        before = paged.launch_counts()["paged_attend"]
        streams[layout] = {c.request.request_id: c.tokens.tolist()
                           for c in engine.run(requests())}
        launched = paged.launch_counts()["paged_attend"] - before
        assert launched == (2 * engine.steps if layout == "paged" else 0)
    assert streams["paged"] == streams["contiguous"]


# =========================================================================================
# Data parallelism on the card: NCCL at world 1, gloo at world 2 (two ranks on one card)
# =========================================================================================

import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (  # noqa: E402
    data_parallel as dp,
    mesh,
)

_PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
_RENDEZVOUS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
               "MASTER_PORT")


def test_world1_nccl_step_equals_plain_step_bitwise(device, monkeypatch):
    """One rank on NCCL: the bucket's copies, an all-reduce over one rank and a division
    by 1 change no bit of the gradients or the loss."""
    for key in _RENDEZVOUS:
        monkeypatch.delenv(key, raising=False)
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    gen = torch.Generator(device=device).manual_seed(3)
    xs = torch.randn(5, 64, 28, 28, 1, generator=gen, device=device)
    ys = torch.randint(0, 10, (5, 64), generator=gen, device=device)
    torch.backends.cudnn.deterministic = True    # the two runs pick the same algorithms
    try:
        with mesh.cluster("cuda") as info:
            assert info.backend == "nccl"
            runs = []
            for reduce in (True, False):
                state = step.create_train_state(net, torch.Generator().manual_seed(1),
                                                device=info.device)
                fn = step.make_train_step(
                    net, learning_rate=0.01, momentum=0.5,
                    grad_reduce=dp.GradReducer(state.params) if reduce else None)
                losses = []
                for i in range(5):
                    state, loss = fn(state, xs[i], ys[i], 1)
                    losses.append(loss)
                runs.append((state.params, torch.stack(losses)))
    finally:
        torch.backends.cudnn.deterministic = False
    assert torch.equal(runs[0][1], runs[1][1])
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k]), k


def test_world2_gloo_on_one_card_keeps_replicas_in_sync(device, tmp_path):
    """Two ranks share the one card, so the backend is gloo (the bucket through pinned
    host memory); the trainer's closing replica check holds at atol 0."""
    env = {k: v for k, v in os.environ.items() if k not in _RENDEZVOUS}
    env["PYTHONPATH"] = str(pathlib.Path(__file__).resolve().parent.parent)
    proc = subprocess.run(
        [sys.executable, "-m", f"{_PKG}.train.launch", "--num-processes", "2",
         "--timeout", "300", "--", "-m", f"{_PKG}.train.distributed", "--device", "cuda",
         "--epochs", "2", "--max-train-examples", "2048", "--max-test-examples", "1000"],
        capture_output=True, text=True, timeout=400, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Collective backend: gloo (device cuda, 2 rank(s))" in proc.stdout
    assert proc.stdout.count("Epoch 1: train_loss:") == 1


# -- the hop offset (the ring schedules' blocks) ----------------------------------------------

OFFSET_MASKS = [(False, 0), (True, 0), (False, 100), (True, 160), (False, 300)]


@pytest.mark.parametrize("off", [-256, -128, 128, 256])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("causal,window", OFFSET_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_offset_kernels_match_plain(device, off, d, causal, window, dtype):
    """Every kernel with a hop offset against its plain version, the backward from the
    full row's statistics (this block merged with the diagonal block), as the ring
    schedules call them; a query tile no key of the block reaches writes out 0,
    lse -1e30 and no gradient."""
    q, k0, v0, do = _qkvd(device, 2, 256, 2, d, dtype, 7 + d + window,
                          exact=dtype == torch.bfloat16)
    _, k1, v1, _ = _qkvd(device, 2, 256, 2, d, dtype, 8 + d + window,
                         exact=dtype == torch.bfloat16)
    tol = FLASH_TOL[dtype]
    mask = dict(causal=causal, window=window, q_offset=off)
    out, lse = fa.flash_forward_with_lse(q, k1, v1, **mask)
    out_p, lse_p = fa.flash_forward_plain(q, k1, v1, **mask)
    _close(out, out_p, tol["out"])
    _close(lse, lse_p, tol["lse"])
    dead = lse_p == attention.MASK_VALUE                      # [B, H, S] rows seeing no key
    assert (lse[dead] == attention.MASK_VALUE).all()
    assert (out.transpose(1, 2)[dead] == 0).all()
    out0, lse0 = fa.flash_forward_plain(q, k0, v0, causal=causal, window=window)
    lse_full = torch.logaddexp(lse0, lse_p)
    rows = lambda x: x.transpose(1, 2)[..., None]
    out_full = (out0.float() * rows(torch.exp(lse0 - lse_full))
                + out_p.float() * rows(torch.exp(lse_p - lse_full)))
    delta = fa.flash_delta(out_full, do)
    grads = fa.flash_backward_blocks(q, k1, v1, do, lse_full, delta, **mask)
    grads_p = fa._backward_plain(q, k1, v1, lse_full, delta, do, **mask)
    torch.cuda.synchronize()
    for got, want in zip(grads, grads_p):
        _close(got, want, tol["grad"])
    if dead.all():
        assert all((g == 0).all() for g in grads)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_ops_on_one_card_match_flash_attention(device, tmp_path, world):
    """The three ring ops at a gloo world on the one card (``chip_smoke.ring_ops_child`` at
    a small shape, started through the launcher) against the one-process
    ``flash_attention`` on the full sequence (both through the 3xTF32 kernels; out within
    the kernels' f32 tolerance, gradients within 1e-4), every rank's launches, and those
    at a nonzero hop offset, equal to its plan (``chip_smoke.check_ring_ops``)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k not in _RENDEZVOUS}
    env["PYTHONPATH"] = str(root)
    out = tmp_path / "ring.json"
    proc = subprocess.run(
        [sys.executable, "-m", f"{_PKG}.train.launch", "--num-processes", str(world),
         "--timeout", "300", "--", "-c",
         f"import chip_smoke; chip_smoke.ring_ops_child({str(out)!r}, (2, 2048, 2, 16))"],
        capture_output=True, text=True, timeout=400, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    sys.path.insert(0, str(root))
    import chip_smoke
    result = chip_smoke.check_ring_ops(str(out), world)
    assert len(result["rows"]) == len(chip_smoke.RING_CASES)
    assert any(c[5] > 0 for row in result["rows"] for c in row["counts"])
