"""PyTorch port, ops slice: functional layers, initializers, SGD and the plain versions of
the fused kernels, against the JAX package on the same numpy inputs.

Tolerances: the layers agree within atol 1e-5 (float32 convolutions and matmuls sum in
another order); the fused loss and its gradient within atol 1e-6 (plus rtol 1e-6 for the
summed reduction, whose magnitude grows with the batch); SGD within atol 1e-6. The JAX
package's Pallas kernels run in interpret mode here, as its own tests run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu import ops as jax_ops
from csed_514_project_distributed_training_using_pytorch_tpu.ops import optim as jax_optim
from csed_514_project_distributed_training_using_pytorch_tpu.ops import pallas_kernels as pk
from csed_514_project_distributed_training_using_pytorch_tpu_torch import ops
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    fused_kernels as fk,
    optim,
)

CNN_LEAVES = {"conv1_kernel": (5, 5, 1, 10), "conv1_bias": (10,),
              "conv2_kernel": (5, 5, 10, 20), "conv2_bias": (20,),
              "fc1_kernel": (320, 50), "fc1_bias": (50,),
              "fc2_kernel": (50, 10), "fc2_bias": (10,)}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("stride,padding", [(1, "VALID"), (2, "VALID"), (1, "SAME")])
def test_conv2d_matches(stride, padding):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 9, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    ours = ops.conv2d(_t(x), _t(w), _t(b), stride=stride, padding=padding).numpy()
    theirs = np.asarray(jax_ops.conv2d(x, w, b, stride=stride, padding=padding))
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=1e-5)


@pytest.mark.parametrize("window,stride", [(2, None), (3, 2)])
def test_max_pool2d_matches(window, stride):
    x = np.random.default_rng(1).normal(size=(2, 8, 8, 5)).astype(np.float32)
    ours = ops.max_pool2d(_t(x), window, stride).numpy()
    theirs = np.asarray(jax_ops.max_pool2d(x, window, stride))
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=1e-5)


def test_dense_relu_log_softmax_match():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 20)).astype(np.float32)
    w = rng.normal(size=(20, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    np.testing.assert_allclose(ops.dense(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(jax_ops.dense(x, w, b)), atol=1e-5)
    np.testing.assert_allclose(ops.dense(_t(x), _t(w)).numpy(),
                               np.asarray(jax_ops.dense(x, w)), atol=1e-5)
    np.testing.assert_array_equal(ops.relu(_t(x)).numpy(), np.asarray(jax_ops.relu(x)))
    np.testing.assert_allclose(ops.log_softmax(_t(x)).numpy(),
                               np.asarray(jax_ops.log_softmax(x)), atol=1e-5)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_nll_and_cross_entropy_match(reduction):
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(16, 10)) * 2).astype(np.float32)
    labels = rng.integers(0, 10, size=16).astype(np.int32)
    lp = np.asarray(jax_ops.log_softmax(logits))
    np.testing.assert_allclose(
        ops.nll_loss(_t(lp), _t(labels.astype(np.int64)), reduction=reduction).numpy(),
        np.asarray(jax_ops.nll_loss(lp, labels, reduction=reduction)), atol=1e-5)
    np.testing.assert_allclose(
        ops.cross_entropy_loss(_t(logits), _t(labels.astype(np.int64)),
                               reduction=reduction).numpy(),
        np.asarray(jax_ops.cross_entropy_loss(logits, labels, reduction=reduction)),
        atol=1e-5)


def test_nll_rejects_unknown_reduction():
    with pytest.raises(ValueError):
        ops.nll_loss(torch.zeros(2, 3), torch.zeros(2, dtype=torch.int64), reduction="max")
    with pytest.raises(ValueError):
        fk.nll_from_logits(torch.zeros(2, 3), torch.zeros(2, dtype=torch.int64), "max")


def test_dropout_identity_when_deterministic_or_rate_zero():
    x = torch.randn(4, 6, 6, 3)
    g = torch.Generator().manual_seed(0)
    for fn in (ops.dropout, ops.dropout2d):
        assert fn(g, x, 0.5, deterministic=True) is x
        assert fn(g, x, 0.0, deterministic=False) is x


def test_dropout_statistics():
    """Keep rate ~0.5 and survivors scaled by 2 (inverted dropout); the masks are a function
    of the generator's seed. 64,000 draws: the keep fraction's std is 0.002."""
    x = torch.ones(64, 1000)
    out = ops.dropout(torch.Generator().manual_seed(5), x, 0.5, deterministic=False)
    vals = set(out.unique().tolist())
    assert vals == {0.0, 2.0}
    assert abs((out > 0).float().mean().item() - 0.5) < 0.01
    again = ops.dropout(torch.Generator().manual_seed(5), x, 0.5, deterministic=False)
    other = ops.dropout(torch.Generator().manual_seed(6), x, 0.5, deterministic=False)
    assert torch.equal(out, again) and not torch.equal(out, other)


def test_dropout2d_drops_whole_channels():
    """NHWC channelwise dropout: each (example, channel) map is all zero or all scaled by 2;
    3,200 maps, keep fraction within 0.05 of 0.5 (std 0.009)."""
    x = torch.rand(64, 8, 8, 50) + 0.5
    out = ops.dropout2d(torch.Generator().manual_seed(7), x, 0.5, deterministic=False)
    kept = (out != 0).all(dim=(1, 2))
    dropped = (out == 0).all(dim=(1, 2))
    assert torch.all(kept | dropped)
    assert abs(kept.float().mean().item() - 0.5) < 0.05
    torch.testing.assert_close(out[kept[:, None, None, :].expand_as(out)],
                               2 * x[kept[:, None, None, :].expand_as(x)])


def test_initializers_bounds_and_determinism():
    g = lambda: torch.Generator().manual_seed(3)
    w = ops.torch_kaiming_uniform(g(), (20, 10, 5, 5))
    bound = 1 / np.sqrt(250)
    assert w.shape == (20, 10, 5, 5) and w.dtype == torch.float32
    assert w.abs().max().item() <= bound and w.abs().max().item() > 0.9 * bound
    assert torch.equal(w, ops.torch_kaiming_uniform(g(), (20, 10, 5, 5)))
    d = ops.torch_kaiming_uniform(g(), (50, 320))
    assert d.abs().max().item() <= 1 / np.sqrt(320)
    b = ops.torch_fan_in_uniform(250)(g(), (20,))
    assert b.shape == (20,) and b.abs().max().item() <= bound
    with pytest.raises(ValueError):
        ops.torch_kaiming_uniform(g(), (3, 3, 3))


def test_sgd_update_matches_three_steps():
    rng = np.random.default_rng(4)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in CNN_LEAVES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in CNN_LEAVES.items()}
             for _ in range(3)]
    ours = optim.sgd(0.01, 0.5)
    params = {k: _t(v) for k, v in p0.items()}
    vel = ours.init(params)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jv = jax_optim.sgd_init(jp)
    for g in grads:
        params, vel = ours.update(params, vel, {k: _t(v) for k, v in g.items()})
        jp, jv = jax_optim.sgd_update(jp, jv, g, learning_rate=0.01, momentum=0.5)
    for k in CNN_LEAVES:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), atol=1e-6)
        np.testing.assert_allclose(vel[k].numpy(), np.asarray(jv[k]), atol=1e-6)
    assert ours.hyperparams == {"learning_rate": 0.01, "momentum": 0.5}
    with pytest.raises(ValueError, match="choose 'sgd' or 'adamw'"):
        optim.make_optimizer("lamb", learning_rate=0.01, momentum=0.5)
    assert optim.make_optimizer("sgd", learning_rate=0.02, momentum=0.5).name == "sgd"
    adamw = optim.make_optimizer("adamw", learning_rate=0.01, momentum=0.5,
                                 weight_decay=0.1)
    assert (adamw.name, adamw.hyperparams["weight_decay"]) == ("adamw", 0.1)


@pytest.mark.parametrize("rows", [1, 32, 64, 300])
@pytest.mark.parametrize("cols", [10, 130])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_fused_nll_plain_matches_pallas(rows, cols, reduction):
    """Value and gradient of ``nll_from_logits`` (the plain version, on CPU tensors) against
    the JAX package's Pallas kernel and its custom VJP, in interpret mode."""
    rng = np.random.default_rng(rows * 1000 + cols)
    x = (rng.normal(size=(rows, cols)) * 2).astype(np.float32)
    y = rng.integers(0, cols, size=rows)
    ct = (rng.uniform(size=rows).astype(np.float32) if reduction == "none"
          else np.float32(0.75))

    xt = _t(x).requires_grad_()
    loss = fk.nll_from_logits(xt, _t(y.astype(np.int64)), reduction)
    (grad,) = torch.autograd.grad(loss, xt, torch.tensor(ct))

    jval, vjp = jax.vjp(lambda a: pk.nll_from_logits(a, jnp.asarray(y, jnp.int32),
                                                     reduction), jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jval), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-6)


def test_fused_nll_kernel_halves_match_pallas_kernels():
    """The per-row forward and the backward with a per-row cotangent, directly."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(37, 12)) * 3).astype(np.float32)
    y = rng.integers(0, 12, size=37)
    ct = rng.uniform(size=37).astype(np.float32)
    per_row = fk.nll_fwd(_t(x), _t(y.astype(np.int64)))
    np.testing.assert_allclose(per_row.numpy(),
                               np.asarray(pk.nll_from_logits(x, y.astype(np.int32), "none")),
                               atol=1e-6)
    dx, _ = pk._nll_bwd("none", (jnp.asarray(x), jnp.asarray(y, jnp.int32)), jnp.asarray(ct))
    np.testing.assert_allclose(fk.nll_bwd(_t(x), _t(y.astype(np.int64)), _t(ct)).numpy(),
                               np.asarray(dx), atol=1e-6)


def test_fused_nll_out_of_range_label_picks_nothing():
    x = torch.randn(3, 5)
    y = torch.tensor([5, -1, 2])
    per_row = fk.nll_fwd(x, y)
    assert per_row[0].item() == 0.0 and per_row[1].item() == 0.0
    d = fk.nll_bwd(x, y, torch.ones(3))
    torch.testing.assert_close(d[0], torch.softmax(x[0], 0))


def test_fused_sgd_plain_matches_pallas_three_steps():
    rng = np.random.default_rng(5)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in CNN_LEAVES.items()}
    v0 = {k: rng.normal(size=s).astype(np.float32) for k, s in CNN_LEAVES.items()}
    params = {k: _t(v.copy()) for k, v in p0.items()}
    vel = {k: _t(v.copy()) for k, v in v0.items()}
    jp, jv = dict(p0), dict(v0)
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in CNN_LEAVES.items()}
        out_p, out_v = fk.sgd_momentum_step(params, vel, {k: _t(a) for k, a in g.items()},
                                            learning_rate=0.01, momentum=0.5)
        assert out_p is params and out_v is vel          # updated in place
        jp, jv = pk.sgd_momentum_step(jp, jv, g, learning_rate=0.01, momentum=0.5)
        for k in CNN_LEAVES:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), atol=1e-6)
            np.testing.assert_allclose(vel[k].numpy(), np.asarray(jv[k]), atol=1e-6)


def test_wrappers_take_plain_version_only_on_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device is refused, never run
    through the plain version; CPU tensors launch nothing."""
    fk.reset_launch_counts()
    meta = torch.empty(4, 10, device="meta")
    labels = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="expected"):
        fk.nll_fwd(meta, labels)
    with pytest.raises(ValueError, match="expected"):
        fk.nll_bwd(meta, labels, torch.empty((), device="meta"))
    with pytest.raises(ValueError, match="expected"):
        fk.sgd_momentum_leaf(meta, meta.clone(), meta.clone(), learning_rate=0.1, momentum=0.5)
    with pytest.raises(ValueError, match="shapes differ"):
        fk.sgd_momentum_leaf(torch.zeros(3), torch.zeros(3), torch.zeros(4),
                             learning_rate=0.1, momentum=0.5)
    with pytest.raises(ValueError, match=r"logits \[B, C\]"):
        fk.nll_fwd(torch.zeros(4), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="ct must be"):
        fk.nll_bwd(torch.zeros(4, 3), torch.zeros(4, dtype=torch.int64), torch.zeros(2))
    fk.nll_fwd(torch.zeros(4, 3), torch.zeros(4, dtype=torch.int64))
    assert fk.launch_counts() == {"nll_fwd": 0, "nll_bwd": 0, "sgd_momentum": 0}
