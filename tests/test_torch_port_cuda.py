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


# the composed trainer's local flash shapes on the mesh slice's paths, f32: a stage of 2
# with 4 microbatches [16, 2048, 4, 16]; data=2,model=2 [32, 2048, 2, 16]
MESH_SHAPES = [(16, 2048, 4, 16), (32, 2048, 2, 16)]


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=["stage-microbatch", "data2-model2"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_kernels_match_plain_at_the_mesh_shapes(device, shape, causal):
    """B4 and B5 against their plain versions at the local shapes the meshes hand them,
    f32 (3xTF32), within FLASH_TOL's f32 bounds."""
    q, k, v, do = _qkvd(device, *shape, torch.float32, sum(shape) + causal)
    tol = FLASH_TOL[torch.float32]
    out, lse = fa.flash_forward(q, k, v, causal=causal)
    out_p, lse_p = fa.flash_forward_plain(q, k, v, causal=causal)
    _close(out, out_p, tol["out"])
    _close(lse, lse_p, tol["lse"])
    grads = fa.flash_backward(q, k, v, out_p, lse_p, do, causal=causal)
    grads_p = fa.flash_backward_plain(q, k, v, out_p, lse_p, do, causal=causal)
    torch.cuda.synchronize()
    for got, want in zip(grads, grads_p):
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


# B6's quantized branches inside the engine, quantized weights, and the Server.
# Streams: paged (B6) against contiguous (plain torch), greedy, equal or first diverging at
# a true tie: the plain path's top-2 log-prob gap there below TIE_GAP (chip_smoke.py's
# rule; a K/V element within an f32 ulp of a rounding boundary takes neighbouring codes
# on the two paths).

from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import quant  # noqa: E402

TIE_GAP = 1e-5
QUANT_LM = dict(vocab_size=9, seq_len=16, embed_dim=32, num_layers=2, num_heads=4)


def _plain_gap(model, params, kv, stream, fill, p, device):
    """The plain path's top-2 gap (BOS masked) at position ``p``, replayed alone."""
    cache = lm.init_cache(model, 1, kv_dtype=kv, device=device)
    prompt = torch.zeros((1, model.seq_len), dtype=torch.int32, device=device)
    prompt[0, :fill] = torch.as_tensor(stream[:fill], device=device)
    for start, length, size in serving.greedy_chunk_plan(
            tuple(min(c, model.seq_len) for c in lm.PREFILL_CHUNK_SIZES), 0, fill):
        lm.prefill_chunk(model, params, cache, prompt, 0, start, length, start == 0,
                         chunk=size)
    for pos in range(fill, p + 1):
        ids = stream[pos - 1] if pos else model.vocab_size - 1
        _, lp = lm.decode_step_slots(model, params, cache, torch.tensor([ids], device=device),
                                     torch.tensor([pos], dtype=torch.int32, device=device))
    lp = lp[0].clone()
    lp[model.vocab_size - 1] = float("-inf")
    top2 = lp.topk(2).values
    return (top2[0] - top2[1]).item()


def _assert_equal_up_to_ties(got, want, requests, model, params, kv, device):
    assert sorted(got) == sorted(want)
    for req in requests:
        a, b = got[req.request_id], want[req.request_id]
        if a != b:
            p = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            gap = _plain_gap(model, params, kv, b, len(req.prompt), p, device)
            assert gap < TIE_GAP, f"request {req.request_id} differs at {p}, gap {gap:.3e}"


def _quant_requests():
    rng = torch.Generator().manual_seed(2)
    return [serving.Request(
        prompt=torch.randint(0, 8, (int(torch.randint(0, 10, (1,), generator=rng)),),
                             generator=rng).numpy().astype("int32"),
        max_new_tokens=int(torch.randint(1, 7, (1,), generator=rng)), request_id=i)
        for i in range(6)]


@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("cfg", [dict(), dict(num_kv_heads=2), dict(attention_window=5),
                                 dict(rope=True), dict(num_heads=8, num_kv_heads=1)],
                         ids=["mha", "gqa", "window", "rope", "mqa_r8"])
def test_engine_quantized_paged_streams_on_the_card(device, cfg, kv, monkeypatch):
    """B6's int8/fp8 branches inside the engine: every call is handed the engine's own
    narrow pools and their scale pools (no dequantized copy), its output is within
    PAGED_TOL of the plain version on the same operands, B6 launches once per layer and
    decode step, and the streams equal the contiguous quantized engine's up to ties."""
    model = lm.TransformerLM(**(QUANT_LM | cfg))
    params = model.init(torch.Generator().manual_seed(0))
    real, seen = paged.paged_attend, []

    def spy(q, k_pool, v_pool, table, t, **kw):
        out = real(q, k_pool, v_pool, table, t, **kw)
        seen.append((k_pool.dtype, kw.get("k_scale") is not None, k_pool.data_ptr()))
        torch.testing.assert_close(
            out, paged.paged_attend_reference(q, k_pool, v_pool, table, t, **kw), **PAGED_TOL)
        return out

    streams, engines = {}, {}
    for layout in ("contiguous", "paged"):
        engine = serving.ContinuousBatchingEngine(model, params, num_slots=3,
                                                  kv_layout=layout, page_size=4, kv_dtype=kv)
        before = paged.launch_counts()["paged_attend"]
        with monkeypatch.context() as m:
            m.setattr(paged, "paged_attend", spy)
            streams[layout] = {c.request.request_id: c.tokens.tolist()
                               for c in engine.run(_quant_requests())}
        launched = paged.launch_counts()["paged_attend"] - before
        assert launched == (model.num_layers * engine.steps if layout == "paged" else 0)
        engines[layout] = engine
    pools = {layer["k"].data_ptr() for layer in engines["paged"]._cache.values()}
    want = quant.resolve_kv_dtype(kv, torch.float32)[0]
    assert {(dt, sc) for dt, sc, _ in seen} == {(want, True)}
    assert {ptr for _, _, ptr in seen} <= pools
    _assert_equal_up_to_ties(streams["paged"], streams["contiguous"], _quant_requests(), model,
                             engines["contiguous"].params, kv, device)


def test_engine_quantized_weights_on_the_card(device):
    """w8 with int8 KV on the card against the same engine on the CPU: streams equal up to
    ties (f32 sums in another order). w8a8 on the card serves every request through its
    int8 routes (its accumulators are held bitwise in the next test; a w8a8 stream is not
    compared across devices: an f32 difference at an activation's rounding boundary moves
    a code, and the logits, by more than the tie gap)."""
    model = lm.TransformerLM(**QUANT_LM)
    params = model.init(torch.Generator().manual_seed(3))
    streams = {}
    for dev in (device, torch.device("cpu")):
        engine = serving.ContinuousBatchingEngine(model, params, num_slots=3,
                                                  kv_layout="paged", page_size=4,
                                                  kv_dtype="int8", quant_policy="w8",
                                                  device=dev)
        streams[dev.type] = {c.request.request_id: c.tokens.tolist()
                             for c in engine.run(_quant_requests())}
    cpu_params = quant.quantize_params(params, quant.QuantPolicy(weights="w8"))
    _assert_equal_up_to_ties(streams["cuda"], streams["cpu"], _quant_requests(), model,
                             cpu_params, "int8", torch.device("cpu"))
    quant.reset_route_counts()
    engine = serving.ContinuousBatchingEngine(model, params, num_slots=3, kv_layout="paged",
                                              page_size=4, kv_dtype="int8",
                                              quant_policy="w8a8")
    done = engine.run(_quant_requests())
    assert sorted(c.request.request_id for c in done) == list(range(6))
    assert all(c.finish == "ok" and max(c.tokens.tolist() or [0]) < 8 for c in done)
    assert quant.int8_matmul_routes["f32_exact"] > 0


@pytest.mark.parametrize("shape,route", [((8, 256, 768), "f32_exact"),
                                         ((32, 256, 768), "int_mm"),
                                         ((17, 64, 24), "int_mm"),
                                         ((40, 1024, 17), "f32_exact")])
def test_int8_accumulator_routes_on_the_card(device, shape, route):
    m, k, n = shape
    gen = torch.Generator().manual_seed(m + k + n)
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen)
    wq = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=gen)
    quant.reset_route_counts()
    got = quant.int8_accumulate(xq.to(device), wq.to(device))
    assert quant.int8_matmul_routes[route] == 1
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), xq.int() @ wq.int())
    with pytest.raises(ValueError, match="exact f32 route"):
        quant.int8_accumulate(torch.zeros((8, 2048), dtype=torch.int8, device=device),
                              torch.zeros((2048, 17), dtype=torch.int8, device=device))


def test_server_serves_on_the_card(device):
    """Threaded submits through ``serving.Server`` on the card (int8 KV, paged, prefix
    cache): every future resolves ``ok`` with ``engine.run``'s stream."""
    import threading

    model = lm.TransformerLM(**QUANT_LM)
    params = model.init(torch.Generator().manual_seed(4))
    kw = dict(num_slots=3, kv_layout="paged", page_size=4, kv_dtype="int8",
              prefix_cache_entries=4)
    want = {c.request.request_id: c.tokens.tolist()
            for c in serving.ContinuousBatchingEngine(model, params, **kw).run(
                _quant_requests())}
    server = serving.Server(serving.ContinuousBatchingEngine(model, params, **kw)).start()
    futures = {}

    def submit(reqs):
        for req in reqs:
            futures[req.request_id] = server.submit(req.prompt,
                                                    max_new_tokens=req.max_new_tokens)

    reqs = _quant_requests()
    threads = [threading.Thread(target=submit, args=(reqs[i::2],)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    done = {rid: fut.result(timeout=120) for rid, fut in futures.items()}
    server.stop(timeout=120)
    assert all(c.finish == "ok" for c in done.values())
    assert {rid: c.tokens.tolist() for rid, c in done.items()} == want


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


# =========================================================================================
# The captured epoch (train.step.CapturedSegment) and the step's remainder on the card
# =========================================================================================
#
# The captured segment against the eager loop of the same step on the card, 20 steps in two
# segments of 10: losses and parameters within 1e-6 (the same kernels on the same inputs),
# dropout off and on (the masks come from the step's device key on both paths). The step's
# remainder, captured on the card, against the eager loop on the CPU: within 1e-5 (conv sums
# in another order), the guard's counters equal as integers.

from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (  # noqa: E402
    optim,
)

CAPTURE_STEPS, CAPTURE_SEGMENT = 20, 10


def _segment_runs(state_fn, segment_fns, xs, ys, plan):
    """Each segment function over the plan in segments of ``CAPTURE_SEGMENT`` from its own
    fresh state: [(losses, final state)]."""
    runs = []
    for segment in segment_fns:
        state, losses = state_fn(), []
        for s0 in range(0, plan.shape[0], CAPTURE_SEGMENT):
            state, out = segment(state, xs, ys, plan[s0:s0 + CAPTURE_SEGMENT], 1)
            losses.append(out[0] if isinstance(out, tuple) else out)
        runs.append((torch.cat(losses), state))
    return runs


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("dropout", [False, True], ids=["dropout_off", "dropout_on"])
def test_captured_segment_matches_the_eager_loop(device, use_pallas, dropout, monkeypatch):
    """Captured against eager under cuDNN's deterministic algorithms: its default
    convolution backward is not deterministic from run to run on the card, and two runs
    of the same step parted by 1.1e-05 in conv1's weights over 20 steps without them."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    net = cnn.Net() if dropout else cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    gen = torch.Generator(device=device).manual_seed(4)
    xs = torch.randn(CAPTURE_STEPS * 64, 28, 28, 1, generator=gen, device=device)
    ys = torch.randint(0, 10, (CAPTURE_STEPS * 64,), generator=gen, device=device)
    plan = torch.randperm(CAPTURE_STEPS * 64, device=device).view(CAPTURE_STEPS, 64)
    fn = step.make_train_step(net, learning_rate=0.01, momentum=0.5, use_pallas=use_pallas)
    captured = step.CapturedSegment(fn)
    new_state = lambda: step.create_train_state(net, torch.Generator().manual_seed(1),
                                                device=device)
    fk.reset_launch_counts()
    (c_losses, c_state), = _segment_runs(new_state, [captured], xs, ys, plan)
    counts = fk.launch_counts()
    (e_losses, e_state), = _segment_runs(new_state, [step.make_segment_fn(fn)], xs, ys,
                                         plan)
    assert len(captured.graphs) == 1 and captured.replays == 2
    assert counts == dict.fromkeys(counts, CAPTURE_STEPS if use_pallas else 0)
    assert int(c_state.step) == CAPTURE_STEPS
    torch.testing.assert_close(c_losses, e_losses, atol=1e-6, rtol=0)
    for k in e_state.params:
        torch.testing.assert_close(c_state.params[k], e_state.params[k], atol=1e-6, rtol=0)


def test_grad_poison_replays_inside_the_captured_segment(device, monkeypatch):
    """``RESILIENCE_FAULTS`` poison folded into the captured step (a ``torch.where`` on the
    device-resident step): the graph, replayed, poisons the same steps as the eager loop
    (NaN at step 3, a planted fc1 element at step 12), the guard refuses the NaN step and
    counts alike, and B1-B3 launch once a step either way."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setenv("RESILIENCE_FAULTS", "nan:step=3;bitflip:step=12,leaf=fc1,scale=50.0")
    for name in ("RANK", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    gen = torch.Generator(device=device).manual_seed(6)
    xs = torch.randn(CAPTURE_STEPS * 64, 28, 28, 1, generator=gen, device=device)
    ys = torch.randint(0, 10, (CAPTURE_STEPS * 64,), generator=gen, device=device)
    plan = torch.randperm(CAPTURE_STEPS * 64, device=device).view(CAPTURE_STEPS, 64)
    fn = step.make_train_step(net, learning_rate=0.01, momentum=0.5, use_pallas=True,
                              guard=step.GuardSpec())
    new_state = lambda: step.create_train_state(net, torch.Generator().manual_seed(1),
                                                device=device, guard=True)
    fk.reset_launch_counts()
    (c_losses, c_state), = _segment_runs(new_state, [step.CapturedSegment(fn)], xs, ys,
                                         plan)
    counts = fk.launch_counts()
    (e_losses, e_state), = _segment_runs(new_state, [step.make_segment_fn(fn)], xs, ys,
                                         plan)
    assert counts == dict.fromkeys(counts, CAPTURE_STEPS)
    assert torch.isfinite(c_losses).all()          # the gradients are poisoned, not the loss
    for f in ("anomalies", "nonfinite", "skipped", "first_anomaly_step"):
        assert int(getattr(c_state.guard, f)) == int(getattr(e_state.guard, f)), f
    assert (int(c_state.guard.nonfinite), int(c_state.guard.first_anomaly_step)) == (1, 3)
    torch.testing.assert_close(c_losses, e_losses, atol=1e-6, rtol=0)
    for k in e_state.params:
        assert torch.isfinite(c_state.params[k]).all(), k
        torch.testing.assert_close(c_state.params[k], e_state.params[k], atol=1e-6, rtol=0)


def test_captured_segment_with_the_reducer_on_nccl(device, monkeypatch):
    """World 1 on NCCL: the all-reduce inside the graph; the reducer's calls count the
    replays; pregather and the health accumulators as the eager loop's (deterministic
    cuDNN algorithms, as above)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    for key in _RENDEZVOUS:
        monkeypatch.delenv(key, raising=False)
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    gen = torch.Generator(device=device).manual_seed(5)
    xs = torch.randn(CAPTURE_STEPS * 64, 28, 28, 1, generator=gen, device=device)
    ys = torch.randint(0, 10, (CAPTURE_STEPS * 64,), generator=gen, device=device)
    plan = torch.randperm(CAPTURE_STEPS * 64, device=device).view(CAPTURE_STEPS, 64)
    with mesh.cluster("cuda") as info:
        assert info.backend == "nccl"
        new_state = lambda: step.create_train_state(net, torch.Generator().manual_seed(1),
                                                    device=device)
        reducer = dp.GradReducer(new_state().params)
        assert step.segment_program(device, reducer) == "cuda-graph"
        epoch = step.make_epoch_fn(net, learning_rate=0.02, momentum=0.5, pregather=True,
                                   health=True, clip_grad_norm=1.0, grad_reduce=reducer)
        state, (losses, health) = epoch(new_state(), xs, ys, plan[:CAPTURE_SEGMENT], 1)
        state, (losses2, health2) = epoch(state, xs, ys, plan[CAPTURE_SEGMENT:], 1)
        assert reducer.calls == CAPTURE_STEPS
        eager = step.make_segment_fn(step.make_train_step(
            net, learning_rate=0.02, momentum=0.5, clip_grad_norm=1.0, with_metrics=True,
            grad_reduce=reducer), pregather=True, health=True)
        e_state, (e_losses, e_health) = eager(new_state(), xs, ys, plan[:CAPTURE_SEGMENT], 1)
        e_state, (e_losses2, e_health2) = eager(e_state, xs, ys, plan[CAPTURE_SEGMENT:], 1)
    torch.testing.assert_close(torch.cat([losses, losses2]), torch.cat([e_losses, e_losses2]),
                               atol=1e-6, rtol=0)
    for got, want in zip(step.merge_health(health, health2),
                         step.merge_health(e_health, e_health2)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    for k in e_state.params:
        torch.testing.assert_close(state.params[k], e_state.params[k], atol=1e-6, rtol=0)


REMAINDER = {
    "a-kernels-accum-clip-ema": (dict(), dict(use_pallas=True, grad_accum=4,
                                              clip_grad_norm=0.5, ema_decay=0.9)),
    "b-adamw-cosine-smoothing-clip": (
        dict(optimizer=optim.adamw(1e-3, weight_decay=0.01)),
        dict(lr_schedule=optim.make_lr_schedule("cosine", warmup_steps=5,
                                                total_steps=CAPTURE_STEPS),
             label_smoothing=0.1, clip_grad_norm=1.0)),
    "c-guard-nan-window": (dict(), dict(use_pallas=True,
                                        guard=step.GuardSpec(skip=((12, 14),)))),
}


@pytest.mark.parametrize("setting", sorted(REMAINDER))
def test_captured_step_remainder_matches_the_cpu(device, setting):
    init, kw = REMAINDER[setting]
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    gen = torch.Generator().manual_seed(6)
    xs = torch.randn(CAPTURE_STEPS * 64, 28, 28, 1, generator=gen)
    ys = torch.randint(0, 10, (CAPTURE_STEPS * 64,), generator=gen)
    if "guard" in kw:
        xs[7 * 64 + 3] = float("nan")                  # one example of step 7's batch
    plan = torch.arange(CAPTURE_STEPS * 64).view(CAPTURE_STEPS, 64)
    runs = {}
    for dev in (device, torch.device("cpu")):
        epoch = step.make_epoch_fn(net, learning_rate=0.01, momentum=0.5, **init, **kw)
        (losses, state), = _segment_runs(
            lambda: step.create_train_state(
                net, torch.Generator().manual_seed(7), device=dev,
                ema=kw.get("ema_decay", 0) > 0, guard="guard" in kw, **init),
            [epoch], xs.to(dev), ys.to(dev), plan.to(dev))
        runs[dev.type] = (losses.cpu(), state)
    (l_card, s_card), (l_cpu, s_cpu) = runs["cuda"], runs["cpu"]
    torch.testing.assert_close(l_card, l_cpu, atol=1e-5, rtol=0, equal_nan=True)
    for tree in ("params", "ema"):
        for k, want in (getattr(s_cpu, tree) or {}).items():
            torch.testing.assert_close(getattr(s_card, tree)[k].cpu(), want, atol=1e-5,
                                       rtol=0)
    if s_cpu.guard is not None:
        assert [int(t) for t in s_card.guard[2:]] == [int(t) for t in s_cpu.guard[2:]]
        assert (int(s_cpu.guard.nonfinite), int(s_cpu.guard.skipped),
                int(s_cpu.guard.first_anomaly_step)) == (1, 3, 7)


def test_single_trainer_on_the_card_runs_the_graph_and_exits_65_when_poisoned(device,
                                                                            tmp_path):
    root = pathlib.Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k not in _RENDEZVOUS}
    env["PYTHONPATH"] = str(root)
    code = (
        "import sys, runpy, numpy as np\n"
        f"from {_PKG} import data\n"
        f"from {_PKG}.data import mnist\n"
        "x, y = mnist._synthesize_split(640, 400); x = mnist._normalize(x); x[5] = np.nan\n"
        "tx, ty = mnist._synthesize_split(1000, 401)\n"
        "splits = (mnist.Dataset(x, y.astype(np.int32), 'synthetic'),\n"
        "          mnist.Dataset(mnist._normalize(tx), ty.astype(np.int32), 'synthetic'))\n"
        "data.load_mnist = lambda data_dir: splits\n"
        "sys.argv = ['single', '--guard', '--anomaly-exit', '1', '--n-epochs', '2',\n"
        "            '--use-pallas-kernels', '--results-dir', 'r']\n"
        f"runpy.run_module('{_PKG}.train.single', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 65, proc.stderr[-3000:]
    assert "Segment program: cuda-graph on cuda" in proc.stdout
    assert "anomaly window" in proc.stdout
    assert (tmp_path / "r" / "checkpoints" / "poison.json").is_file()


from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (  # noqa: E402
    checkpoint,
)


@pytest.mark.parametrize("async_", [False, True], ids=["sync", "async"])
def test_a_tick_checkpoint_holds_the_tick_not_the_next_replay(device, tmp_path, async_):
    """A captured segment's state lives in static buffers that each replay overwrites. A
    save at the tick, through either saver, copies it to the host before it returns: after
    one more replay and a flush, the restore gives the tick's state bitwise."""
    net = cnn.Net()
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(30 * 64, 28, 28, 1, generator=gen).to(device)
    y = torch.randint(0, 10, (30 * 64,), generator=gen).to(device)
    plan = torch.randperm(30 * 64, generator=gen).view(30, 64).to(device)
    segment = step.CapturedSegment(step.make_train_step(
        net, learning_rate=0.01, momentum=0.5, use_pallas=True))
    state = step.create_train_state(net, torch.Generator().manual_seed(3), device=device)
    state, _ = segment(state, x, y, plan[:10], 1)          # the capture, then a replay
    state, losses = segment(state, x, y, plan[10:20], 1)
    losses.cpu()                                           # the tick's host sync
    tick = {k: v.clone() for k, v in state.params.items()}
    tick_velocity = {k: v.clone() for k, v in state.velocity.items()}
    path = str(tmp_path / "model.ckpt")
    saver = checkpoint.make_saver(async_)
    saver.save_train_state(path, state)
    after, _ = segment(state, x, y, plan[20:30], 1)        # overwrites the same buffers
    assert after.params["fc2.bias"] is state.params["fc2.bias"]
    assert not torch.equal(after.params["fc2.bias"], tick["fc2.bias"])
    saver.flush()
    restored = checkpoint.restore_train_state(
        path, step.create_train_state(net, torch.Generator().manual_seed(0), device=device))
    assert int(restored.step) == 20 and restored.step.device == device
    for k in tick:
        assert torch.equal(restored.params[k], tick[k]), k
        assert torch.equal(restored.velocity[k], tick_velocity[k]), k


def test_single_trainer_async_checkpoint_writes_the_sync_bytes_on_the_card(device, tmp_path,
                                                                          monkeypatch):
    """``--async-checkpoint`` leaves the sync run's bytes on the card. cuDNN's default
    convolution backward is not deterministic from run to run on the card (two sync runs
    differ in the last bits), so both runs take its deterministic algorithms."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import single
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import config

    x, y = mnist._synthesize_split(1280, 300)
    tx, ty = mnist._synthesize_split(1000, 301)
    splits = (mnist.Dataset(mnist._normalize(x), y.astype("int32"), "synthetic"),
              mnist.Dataset(mnist._normalize(tx), ty.astype("int32"), "synthetic"))
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    data = {}
    for async_ in (False, True):
        out = tmp_path / str(async_)
        single.main(config.SingleProcessConfig(
            n_epochs=2, use_pallas_kernels=True, async_checkpoint=async_,
            keep_checkpoints=2, results_dir=str(out), images_dir=str(out / "img")),
            datasets=splits)
        data[async_] = [(out / "model.ckpt").read_bytes(),
                        (out / "checkpoints" / checkpoint.versioned_name(40)).read_bytes()]
    assert data[True] == data[False]


# -- the host-fed step and the device prefetch (data slice) ------------------------------

import numpy as np  # noqa: E402

from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (  # noqa: E402
    BatchLoader,
    mnist,
)

HOST_FED_ATOL = 1e-6           # captured replay vs eager steps on the card (chip_smoke [20])


def _host_batches(n_steps: int, batch: int = 64, seed: int = 400):
    x, y = mnist._synthesize_split(n_steps * batch, seed)
    images = mnist._normalize(x)
    return [(images[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch].astype(np.int32))
            for i in range(n_steps)]


def _host_fed_run(device, program: str, batches):
    model = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    state = step.create_train_state(model, torch.Generator().manual_seed(1), device=device)
    fed = step.HostFedStep(step.make_train_step(model, learning_rate=0.01, momentum=0.5,
                                                use_pallas=True), device, program=program)
    fk.reset_launch_counts()
    losses = []
    for bx, by in batches:
        state, loss = fed(state, bx, by, 1)
        losses.append(loss)
    torch.cuda.synchronize(device)
    return fed, state, torch.stack(losses).cpu(), fk.launch_counts()


def test_host_fed_graph_takes_different_batches_through_one_capture(device, monkeypatch):
    """Five different host batches through the one-step graph: one capture, five replays,
    the static input buffers at the same addresses, five different losses, each within
    1e-6 of the eager step on the same batch (deterministic cuDNN algorithms)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    batches = _host_batches(5)
    fed, state, losses, _ = _host_fed_run(device, "cuda-graph", batches)
    assert len(fed.captured.graphs) == 1 and fed.captured.replays == 5
    (x_buf, y_buf, _), = fed.buffers.values()
    key, = fed.captured.graphs
    assert key[2:4] == (x_buf.data_ptr(), y_buf.data_ptr())
    assert len(set(losses.tolist())) == 5
    np.testing.assert_array_equal(y_buf.cpu().numpy(), batches[-1][1])
    _, e_state, e_losses, _ = _host_fed_run(device, "eager", batches)
    torch.testing.assert_close(losses, e_losses, atol=HOST_FED_ATOL, rtol=0.0)
    for k, p in e_state.params.items():
        torch.testing.assert_close(state.params[k], p, atol=HOST_FED_ATOL, rtol=0.0)


def test_host_fed_launch_counts_equal_eager_steps(device):
    """B1-B3 counted at every replay equal the eager steps' launches; a batch of another
    shape gets its own buffers and graph, one graph per shape."""
    batches = _host_batches(4)
    batches.append((batches[0][0][:32], batches[0][1][:32]))
    fed, _, _, captured = _host_fed_run(device, "cuda-graph", batches)
    _, _, _, eager = _host_fed_run(device, "eager", batches)
    assert captured == eager == dict.fromkeys(eager, len(batches))
    assert len(fed.captured.graphs) == len(fed.buffers) == 2


def test_cuda_prefetch_keeps_its_values_under_allocator_pressure(device):
    """``prefetch=2`` onto the card: each batch is read on the consumer's stream after a
    spin kernel while the worker stages the next batches and the consumer's references are
    dropped at once; what was read equals the host iterator's batches (the allocator reuses
    no block that the consumer's stream still reads)."""
    x, y = mnist._synthesize_split(2048, 401)
    ds = mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic")
    host = list(BatchLoader(ds, 64, shuffle=True, seed=7))
    loader = BatchLoader(ds, 64, shuffle=True, seed=7, prefetch=2, device=device)
    read = []
    for bx, by in loader:
        torch.cuda._sleep(200_000)                  # the consumer's stream is behind
        read.append((bx * 1.0, by + 0))             # read after the spin
        del bx, by
        torch.empty(64 * 28 * 28, device=device).fill_(float("nan"))   # churn the pool
    torch.cuda.synchronize(device)
    assert len(read) == len(host) == 32
    for (gx, gy), (hx, hy) in zip(read, host):
        np.testing.assert_array_equal(gx.cpu().numpy(), hx)
        np.testing.assert_array_equal(gy.cpu().numpy(), hy)


# -- the pixel LM's training and sampling on the card -------------------------------------

LM_SMALL = dict(vocab_size=17, seq_len=128, embed_dim=64, num_layers=2, num_heads=4)


def _lm_segments(device, remat_policy=None, dropout=0.0):
    """10 steps of the trainer's step (``train.lm.make_lm_step`` at ``LMConfig``'s defaults:
    AdamW, clip 1.0; ``LM_SMALL``'s widths), captured and eagerly, from one start on one
    plan; ``remat_policy`` None trains without remat."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        lm as lm_train,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        LMConfig,
    )

    cfg = LMConfig(dropout_rate=dropout, remat=remat_policy is not None,
                   remat_policy=remat_policy or "")
    model = lm_train.lm_model(cfg, vocab=LM_SMALL["vocab_size"] - 1,
                              seq_len=LM_SMALL["seq_len"]).to(device)
    opt = lm_train.lm_optimizer(cfg)
    fn = lm_train.make_lm_step(model, cfg, optimizer=opt, steps_per_epoch=10)
    gen = torch.Generator(device=device).manual_seed(5)
    tokens = torch.randint(0, 16, (160, 128), generator=gen, device=device,
                           dtype=torch.int32)
    zeros = torch.zeros(160, dtype=torch.int64, device=device)
    plan = torch.randperm(160, generator=gen, device=device).view(10, 16)
    runs = {}
    for name, seg in (("captured", step.CapturedSegment(fn)),
                      ("eager", step.make_segment_fn(fn))):
        state = step.create_train_state(model, torch.Generator().manual_seed(1),
                                        optimizer=opt, device=device)
        state, losses = seg(state, tokens, zeros, plan, 3)
        torch.cuda.synchronize(device)
        runs[name] = (losses, {k: v.clone() for k, v in state.params.items()})
    return runs


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["dropout_off", "dropout_on"])
def test_captured_lm_segment_matches_the_eager_loop(device, dropout):
    runs = _lm_segments(device, dropout=dropout)
    (c_losses, c_params), (e_losses, e_params) = runs["captured"], runs["eager"]
    assert c_losses[-1] < c_losses[0]
    torch.testing.assert_close(c_losses, e_losses, atol=1e-6, rtol=0)
    for k in e_params:
        torch.testing.assert_close(c_params[k], e_params[k], atol=1e-6, rtol=0)


@pytest.mark.parametrize("policy", ["recompute-all", "save-dots"])
def test_remat_under_capture_matches_no_remat(device, policy):
    """Non-reentrant checkpoint recomputes inside the captured backward, the dropout masks
    redrawn from the step's key: the same losses and parameters as without remat."""
    plain = _lm_segments(device, dropout=0.1)["captured"]
    remat = _lm_segments(device, remat_policy=policy, dropout=0.1)["captured"]
    torch.testing.assert_close(remat[0], plain[0], atol=1e-6, rtol=0)
    for k in plain[1]:
        torch.testing.assert_close(remat[1][k], plain[1][k], atol=1e-6, rtol=0)


def test_greedy_generate_on_the_card_matches_the_cpu(device):
    """Greedy ``generate`` (prompted, GQA) on the card against the CPU, token for token up
    to a true tie (the CPU's top-2 log-prob gap at the first difference below 1e-5)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm

    model = lm.TransformerLM(**{**LM_SMALL, "seq_len": 200}, num_kv_heads=2)
    params = model.init(torch.Generator().manual_seed(2))
    prompt = torch.randint(0, 16, (4, 200), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    cpu = lm.generate(model, params, batch=4, temperature=0.0, prompt=prompt, prompt_len=50)
    card = lm.generate(model, {k: v.to(device) for k, v in params.items()}, batch=4,
                       temperature=0.0, prompt=prompt.to(device), prompt_len=50).cpu()
    assert torch.equal(card[:, :50], prompt[:, :50])
    for row in range(4):
        diff = (card[row] != cpu[row]).nonzero()
        if len(diff):
            p = int(diff[0])
            lp = torch.func.functional_call(model, params, (model.shift_right(
                cpu[row:row + 1].long()),))[0, p].clone()
            lp[model.vocab_size - 1] = float("-inf")
            top2 = lp.topk(2).values
            assert (top2[0] - top2[1]).item() < 1e-5, (row, p)
    sampled = lm.generate(model, {k: v.to(device) for k, v in params.items()},
                          torch.Generator(device=device).manual_seed(0), batch=4,
                          top_k=5, top_p=0.9)
    assert sampled.device.type == "cuda" and int(sampled.max()) < model.vocab_size - 1


def test_lm_gradients_are_the_same_run_to_run(device):
    """One LM step's gradients twice from the same inputs, bitwise: the token embedding is
    a one-hot product, whose gradient is a matmul (a gather's backward accumulates with
    atomics on the card), so a resumed run can equal an unbroken one."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm

    model = lm.TransformerLM().to(device)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    targets = torch.randint(0, 16, (64, 784), generator=torch.Generator(
        device=device).manual_seed(1), device=device)
    grads = []
    for _ in range(2):
        leaves = {k: p.clone().requires_grad_() for k, p in params.items()}
        loss = lm.next_token_loss(model, leaves, targets, None, deterministic=True)
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    for name, a, b in zip(params, *grads):
        assert torch.equal(a, b), name


# Speculative decoding on the card: verify against sequential decode, spec streams against
# spec off up to true ties (the verify pass's GEMMs have M = B·(k+1), not B), B6 never
# launched under spec, and the sampled accept rule against the target distribution.

from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (  # noqa: E402
    engine as engine_mod,
)

SPEC_ATOL = 1e-5     # verify row j vs decode at t + j: |diff| <= atol + atol·|decode|


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_verify_matches_sequential_decode_on_the_card(device, layout, kv):
    """Three slots (one at t = 14, whose rows past seq_len 16 drop): row j of one verify
    pass against ``decode_step_slots`` at t + j fed the same tokens, within SPEC_ATOL; the
    rows every other position holds are unchanged, bitwise."""
    model = lm.TransformerLM(**QUANT_LM)
    params = {k_: v.to(device) for k_, v in model.init(
        torch.Generator().manual_seed(4)).items()}
    k = 3
    gen = torch.Generator().manual_seed(5)
    ids = torch.randint(0, 8, (3,), generator=gen)
    draft = torch.randint(0, 8, (3, k), generator=gen)
    t = torch.tensor([0, 6, 14], dtype=torch.int32)
    base = lm.init_cache(model, 3, kv_dtype=kv, device=device)
    for layer in base.values():                   # rows already cached, as a real slot has
        for key, x in layer.items():
            x.copy_((torch.rand(x.shape, generator=gen) * 0.05 if "scale" in key else
                     torch.randint(-100, 100, x.shape, generator=gen) if x.dtype == torch.int8
                     else torch.randn(x.shape, generator=gen)).to(x.dtype))
    before = {n: {key: x.clone() for key, x in layer.items()} for n, layer in base.items()}
    if layout == "paged":
        ps, p_max = 4, 4
        table = (1 + torch.randperm(3 * p_max, generator=gen)).reshape(3, p_max).int()
        pool = lm.init_page_pool(model, 1 + 3 * p_max, page_size=ps, kv_dtype=kv,
                                 device=device)
        for name, layer in pool.items():
            for key, x in layer.items():
                for i in range(3):
                    for j in range(p_max):
                        x[int(table[i, j])] = base[name][key][i, j * ps:(j + 1) * ps]
        pool_before = {n: {key: x.clone() for key, x in layer.items()}
                       for n, layer in pool.items()}
        _, vlp = lm.paged_verify_chunk(model, params, pool, table.to(device), ids.to(device),
                                       t.to(device), draft.to(device), k=k)
    else:
        _, vlp = lm.verify_chunk(model, params, base, ids.to(device), t.to(device),
                                 draft.to(device), k=k)
    inputs = torch.cat([ids[:, None], draft], dim=1)
    for i in range(3):
        ref = {n: {key: x[i:i + 1].clone() for key, x in layer.items()}
               for n, layer in before.items()}
        for j in range(k + 1):
            pos = int(t[i]) + j
            if pos >= model.seq_len:
                break
            _, dlp = lm.decode_step_slots(model, params, ref, inputs[i, j:j + 1].to(device),
                                          torch.tensor([pos], dtype=torch.int32, device=device))
            assert ((vlp[i, j] - dlp[0]).abs() <= SPEC_ATOL + SPEC_ATOL * dlp[0].abs()).all()
    if layout == "paged":
        written = {(int(table[i, p // 4]), p % 4) for i in range(3)
                   for p in range(int(t[i]), min(int(t[i]) + k + 1, 16))}
        for name, layer in pool.items():
            for key, x in layer.items():
                for page in range(x.shape[0]):
                    for off in range(4):
                        if (page, off) not in written:
                            assert torch.equal(x[page, off], pool_before[name][key][page, off])
    else:
        for name, layer in base.items():
            for key, x in layer.items():
                for i in range(3):
                    keep = [p for p in range(16)
                            if not int(t[i]) <= p <= min(int(t[i]) + k, 15)]
                    assert torch.equal(x[i, keep], before[name][key][i, keep])


@pytest.mark.parametrize("spec", ["ngram", "draft-lm"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_spec_engine_streams_on_the_card(device, layout, spec):
    """The spec engine on the card against the engine without spec: streams equal up to
    true ties; the spec engine never runs the decode step, so B6 is never launched."""
    model = lm.TransformerLM(**QUANT_LM)
    params = model.init(torch.Generator().manual_seed(0))
    kw = dict(spec=spec, spec_k=3)
    if spec == "draft-lm":
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.spec import (
            DraftLMDrafter,
        )

        kw["drafter"] = DraftLMDrafter(model, params, chunk_sizes=(8,))
    plain = serving.ContinuousBatchingEngine(model, params, num_slots=3, kv_layout=layout,
                                             page_size=4)
    want = {c.request.request_id: c.tokens.tolist() for c in plain.run(_quant_requests())}
    engine = serving.ContinuousBatchingEngine(model, params, num_slots=3, kv_layout=layout,
                                              page_size=4, **kw)
    before = paged.launch_counts()["paged_attend"]
    got = {c.request.request_id: c.tokens.tolist() for c in engine.run(_quant_requests())}
    assert paged.launch_counts()["paged_attend"] == before
    assert engine.decode_calls == 0 and engine.verify_calls == {3: engine.steps}
    _assert_equal_up_to_ties(got, want, _quant_requests(), model, plain.params, None, device)
    if spec == "draft-lm":
        assert engine.spec_stats()["accepted_tokens_per_step"] > 1.0


def test_sampled_accept_fold_on_the_card(device):
    """``accept_fold`` at temperature 1 with 40,000 seeded draws on the card: the first
    emitted token's distribution against the target's within three times the expected
    total variation at that draw count (``tests/test_torch_port_spec.py``'s bound)."""
    n, k, v = 40_000, 3, 9
    gen = torch.Generator().manual_seed(21)
    logp = torch.log_softmax(torch.randn(k + 1, v, generator=gen) * 1.5, dim=-1)
    logp[:, v - 1] = -1e30
    fixed = int(torch.argsort(logp[0], descending=True)[1])
    tokens, counts = engine_mod.accept_fold(
        logp.to(device).expand(n, k + 1, v).clone(),
        torch.full((n, k), fixed, device=device), torch.full((n,), k, device=device),
        torch.ones(n, device=device), torch.zeros(n, dtype=torch.long, device=device),
        torch.ones(n, device=device), torch.Generator(device=device).manual_seed(5))
    p = torch.softmax(logp[0], dim=-1).double()
    emp = torch.bincount(tokens[:, 0].cpu(), minlength=v).double() / n
    tv = 0.5 * float((emp - p).abs().sum())
    bound = 3.0 * 0.5 * float(torch.sqrt(2.0 * p * (1.0 - p) / (math.pi * n)).sum())
    assert tv <= bound, (tv, bound)
    assert ((counts >= 1) & (counts <= k + 1)).all()


# =========================================================================================
# The transformer on every trainer and every sequence schedule
# =========================================================================================
#
# Ulysses of flash as a gloo world of 2 on the one card (B4/B5 over the full sequence of
# each rank's head group) against the plain flash version on the CPU: out within the
# kernels' f32 tolerance (2e-5, 1e-5), gradients within (1e-4, 1e-4); each rank one launch
# of each kernel. bench_transformer's flash route at S = 2048 in bf16.

import io  # noqa: E402
import json  # noqa: E402
import contextlib  # noqa: E402

from csed_514_project_distributed_training_using_pytorch_tpu_torch import (  # noqa: E402
    bench_transformer,
)

ULYSSES_CHILD = """
import json, sys
import numpy as np, torch
from {pkg}.ops import flash_attention as fa
from {pkg}.parallel import mesh, ulysses
torch.backends.cuda.matmul.allow_tf32 = False
with mesh.cluster("cuda") as info:
    q, k, v, g = np.random.default_rng(0).normal(size=(4, 2, 512, 4, 16)).astype(np.float32)
    leaves = [torch.from_numpy(x).cuda().requires_grad_() for x in (q, k, v)]
    fa.reset_launch_counts()
    out = ulysses.ulysses_attention(*leaves, causal=True, use_flash=True)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).cuda())
    torch.cuda.synchronize()
    with open({out!r} + f".rank{{info.process_index}}.json", "w") as f:
        json.dump(fa.launch_counts(), f)
    if info.process_index == 0:
        np.savez({out!r}, out=out.detach().cpu().numpy(),
                 **{{"d" + n: d.cpu().numpy() for n, d in zip("qkv", grads)}})
"""


def test_ulysses_of_flash_on_one_card_matches_the_plain_version(device, tmp_path):
    """``ulysses_attention(use_flash=True)`` at a gloo world of 2 on the card, causal, at
    ``[2, 512, 4, 16]`` f32 (each rank's B4/B5 on ``[2, 512, 2, 16]``), against
    ``flash_attention`` on the CPU (the plain versions)."""
    import numpy as np
    root = pathlib.Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k not in _RENDEZVOUS}
    env["PYTHONPATH"] = str(root)
    out = tmp_path / "ulysses.npz"
    proc = subprocess.run(
        [sys.executable, "-m", f"{_PKG}.train.launch", "--num-processes", "2", "--timeout",
         "300", "--", "-c", ULYSSES_CHILD.format(pkg=_PKG, out=str(out))],
        capture_output=True, text=True, timeout=400, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    q, k, v, g = np.random.default_rng(0).normal(size=(4, 2, 512, 4, 16)).astype(np.float32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want = fa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(want, leaves, torch.from_numpy(g))
    got = np.load(out)
    torch.testing.assert_close(torch.from_numpy(got["out"]), want.detach(), atol=2e-5,
                               rtol=1e-5)
    for name, grad in zip("qkv", grads):
        torch.testing.assert_close(torch.from_numpy(got["d" + name]), grad, atol=1e-4,
                                   rtol=1e-4)
    for rank in range(2):
        counts = json.loads((tmp_path / f"ulysses.npz.rank{rank}.json").read_text())
        assert counts == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}


def test_bench_transformer_runs_the_flash_kernels_on_the_card(device):
    """``bench_transformer --flash`` at S = 2048 in bf16: the dispatcher takes the flash
    route (``mma-bf16``), B4/B5 launch layers x (warm-up + 3 runs) x steps times, the loss
    is finite and the MFU is reported against the H100's peak."""
    fa.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench_transformer.main(["--d-model", "256", "--seq", "2048", "--batch", "2",
                                       "--layers", "2", "--heads", "4", "--steps", "2",
                                       "--flash"]) == 0
    line = json.loads(buf.getvalue())
    assert "attn-dispatch(flash)" in line["metric"] and line["flash_layout"] == "mma-bf16"
    assert line["platform"] == "gpu" and line["segment_program"] == "eager"
    assert math.isfinite(line["final_train_loss"]) and line["mfu_vs_bf16_peak"] is not None
    assert fa.launch_counts() == {"flash_fwd": 16, "flash_dq": 16, "flash_dkv": 16}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_handoff_planes_install_bitwise_on_the_card(device, kv):
    """The tiers' KV handoff on the card: a prefill engine's cached planes for a prompt
    (``kv`` planes; int8 with its f32 scales) go through ``serving.tiers``' codec to the
    CPU and back onto the card by the decode replica's side-stream copy; they arrive
    bitwise, and a decode engine holding them serves the prompt as a full-prefix hit
    (no prefill) with the prefill engine's greedy stream."""
    import numpy as np

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        ContinuousBatchingEngine,
        Request,
        replica,
        tiers,
    )

    model = lm.TransformerLM(seq_len=128, embed_dim=32, num_layers=2, num_heads=2)
    params = model.init(torch.Generator().manual_seed(3))
    prompt = np.random.default_rng(3).integers(0, 16, size=70).astype(np.int32)

    def engine():
        return ContinuousBatchingEngine(model, params, num_slots=2, kv_dtype=kv,
                                        prefix_cache_entries=4, device=device)

    pre, dec = engine(), engine()
    want = pre.run([Request(prompt=prompt, max_new_tokens=12)])[0].tokens.tolist()
    hit, planes = pre.prefix_cache.lookup(prompt, min_len=1, layout=pre.plane_layout)
    assert hit == len(prompt)
    payload = tiers.encode_planes(planes, layout=pre.plane_layout)
    moved = replica._planes_to_device(
        tiers.decode_planes(payload, layout=dec.plane_layout), dec.device)
    for name, layer in planes.items():
        for key, plane in layer.items():
            assert moved[name][key].device == plane.device
            assert moved[name][key].dtype == plane.dtype
            assert torch.equal(moved[name][key].view(torch.uint8), plane.view(torch.uint8))
    dec.prefix_cache.insert(prompt, moved, layout=dec.plane_layout)
    got = dec.run([Request(prompt=prompt, max_new_tokens=12)])[0].tokens.tolist()
    assert dec.prefill_tokens == 0 and dec.prefix_cache.hits == 1
    assert got == want


def test_topology_detect_reads_the_card(device, monkeypatch):
    """The planner's topology on the card: the device's name, torch's own total as the
    ``"runtime"`` budget, the H100's published peak and links, one device and one granule
    (no process group); ``PLAN_HBM_BYTES`` still wins, as in the JAX package."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import mesh
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan import costs

    monkeypatch.delenv("PLAN_HBM_BYTES", raising=False)
    total = torch.cuda.mem_get_info(device)[1]
    assert mesh.device_memory_budget(device) == (total, "runtime")
    topo = costs.Topology.detect(device)
    assert topo.device_kind == torch.cuda.get_device_name(device)
    assert (topo.hbm_bytes, topo.hbm_source) == (float(total), "runtime")
    assert (topo.num_devices, topo.num_slices) == (1, 1)
    if "h100" in topo.device_kind.lower():
        assert (topo.peak_flops, topo.ici_bytes, topo.dcn_bytes) == (989e12, 4.5e11, 5e10)
    monkeypatch.setenv("PLAN_HBM_BYTES", str(1 << 30))
    assert mesh.device_memory_budget(device) == (1 << 30, "env")


def test_serve_planner_slot_bytes_equal_the_engines_on_the_card(device):
    """``plan.scenarios.for_serve``'s slot bytes (meta planes) equal the contiguous
    engine's ``byte_accounting`` on the card, for each KV dtype."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch import plan, serving
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm

    model = lm.TransformerLM(seq_len=128, embed_dim=32, num_layers=2, num_heads=2)
    params = model.init(torch.Generator().manual_seed(3))
    for kv in (None, "int8", "fp8"):
        engine = serving.ContinuousBatchingEngine(model, params, num_slots=4,
                                                  kv_dtype=kv or "model", device=device)
        sc = plan.scenarios.for_serve(model, num_slots=4, prompt_len=64, kv_dtype=kv,
                                      device=device)
        assert sc.stats.kv_bytes_per_slot == engine.byte_accounting()["kv_bytes_per_slot"]
        assert sc.topo.hbm_source == "runtime"


@pytest.mark.parametrize("case", ["cnn", "lm", "lm-remat"])
def test_step_flops_equal_flop_counter_mode_on_the_card(device, case):
    """``utils.telemetry.train_step_flops`` on the card equals ``FlopCounterMode``'s total:
    the backward runs on the autograd engine's device thread there, and the remat
    recomputation inside it must be counted as on the CPU. The CNN runs its plain loss and
    update (the fused kernels' flops come by formula, which ``FlopCounterMode`` cannot
    see)."""
    from torch.utils.flop_counter import FlopCounterMode

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        lm as lm_train,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        telemetry,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        LMConfig,
    )

    gen = torch.Generator(device=device).manual_seed(7)
    if case == "cnn":
        model = cnn.Net().to(device)
        state = step.create_train_state(model, torch.Generator().manual_seed(0),
                                        device=device)
        fn = step.make_train_step(model, learning_rate=0.01, momentum=0.5)
        batch = (torch.randn(64, 28, 28, 1, generator=gen, device=device),
                 torch.randint(0, 10, (64,), generator=gen, device=device), 0)
    else:
        cfg = LMConfig(embed_dim=64, num_layers=2, num_heads=4, batch_size=8,
                       remat=case == "lm-remat")
        model = lm_train.lm_model(cfg, vocab=cfg.num_levels + 1, seq_len=784).to(device)
        opt = lm_train.lm_optimizer(cfg)
        state = step.create_train_state(model, torch.Generator().manual_seed(0),
                                        optimizer=opt, device=device)
        fn = lm_train.make_lm_step(model, cfg, optimizer=opt, steps_per_epoch=10)
        batch = (torch.randint(0, 16, (8, 784), generator=gen, device=device),
                 torch.zeros(8, dtype=torch.int64, device=device), 1)
    with FlopCounterMode(display=False) as counter:
        fn(telemetry._clone(state), *batch)
    want = counter.get_total_flops()
    assert want > 0 and telemetry.train_step_flops(fn, state, *batch) == float(want)
