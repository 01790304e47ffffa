"""PyTorch port, the optimizer remainder: AdamW, the LR schedules, global-norm clipping and
label-smoothed NLL, against the JAX package's ``ops/optim.py`` and ``ops/nn.py``.

The same inputs, made from a numpy seed, go through both. Tolerances: optimizer and
schedule values within 1e-6 (float32 arithmetic in the same order); the global norm and
the clipped gradients within rtol 1e-6 (the leaves' squared sums are added in another
order); the label-smoothed NLL within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.ops import nn as jax_nn
from csed_514_project_distributed_training_using_pytorch_tpu.ops import optim as jax_optim
from csed_514_project_distributed_training_using_pytorch_tpu_torch import ops
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import optim

LEAVES = {"conv1.weight": (10, 1, 5, 5), "conv1.bias": (10,), "fc2.weight": (10, 50),
          "fc2.bias": (10,)}
TOL = 1e-6


def _leaves(rng, scale: float = 1.0) -> dict[str, np.ndarray]:
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in LEAVES.items()}


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adamw_ten_steps_match_jax(weight_decay):
    rng = np.random.default_rng(11)
    p0 = _leaves(rng)
    grads = [_leaves(rng, 0.1) for _ in range(10)]
    ours = optim.make_optimizer("adamw", learning_rate=3e-3, momentum=0.5,
                                weight_decay=weight_decay)
    theirs = jax_optim.make_optimizer("adamw", learning_rate=3e-3, momentum=0.5,
                                      weight_decay=weight_decay)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = ours.init(params)
    assert optim.is_adam_state(state) and state["count"].dtype == torch.int64
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = theirs.init(jp)
    for g in grads:
        params, state = ours.update(params, state, {k: torch.from_numpy(v) for k, v in g.items()})
        jp, js = theirs.update(jp, js, {k: jnp.asarray(v) for k, v in g.items()})
    assert int(state["count"]) == int(js["count"]) == 10
    for k in LEAVES:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), atol=TOL, rtol=0)
        np.testing.assert_allclose(state["m"][k].numpy(), np.asarray(js["m"][k]), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(state["v"][k].numpy(), np.asarray(js["v"][k]), atol=TOL,
                                   rtol=0)


def test_adamw_and_sgd_take_a_device_lr_scale():
    """``lr_scale`` as a 0-d tensor (a schedule's value on the device) gives the update a
    float scale gives, for both optimizers."""
    rng = np.random.default_rng(12)
    p0, g = _leaves(rng), _leaves(rng, 0.1)
    for opt in (optim.sgd(0.05, 0.5), optim.adamw(1e-3, weight_decay=0.01)):
        params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        grads = {k: torch.from_numpy(v) for k, v in g.items()}
        a, _ = opt.update(params, opt.init(params), grads, lr_scale=0.25)
        b, _ = opt.update(params, opt.init(params), grads,
                          lr_scale=torch.tensor(0.25, dtype=torch.float32))
        for k in LEAVES:
            torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)


@pytest.mark.parametrize("name,warmup,total", [
    ("constant", 0, 50), ("constant", 10, 50), ("cosine", 0, 50), ("cosine", 10, 50),
    ("cosine", 5, 30)])
def test_schedule_multipliers_over_50_steps_match_jax(name, warmup, total):
    ours = optim.make_lr_schedule(name, warmup_steps=warmup, total_steps=total)
    theirs = jax_optim.make_lr_schedule(name, warmup_steps=warmup, total_steps=total)
    if theirs is None:
        assert ours is None                 # warmup-free constant: no multiply at all
        return
    steps = np.arange(50, dtype=np.int64)
    got = [float(ours(torch.tensor(s))) for s in steps]
    want = [float(theirs(jnp.asarray(s, jnp.int32))) for s in steps]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert all(0.0 <= v <= 1.0 for v in got)


def test_schedule_errors_match_jax():
    for kw in (dict(name="cosine", warmup_steps=10, total_steps=10),
               dict(name="linear"), dict(name="constant", warmup_steps=-1)):
        with pytest.raises(ValueError) as ours:
            optim.make_lr_schedule(**kw)
        with pytest.raises(ValueError) as theirs:
            jax_optim.make_lr_schedule(**kw)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("max_norm", [0.5, 5.0, 1e3])
def test_clip_by_global_norm_and_global_l2_norm_match_jax(max_norm):
    rng = np.random.default_rng(13)
    g = _leaves(rng)
    got, gnorm = optim.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()},
                                           max_norm)
    want, jnorm = jax_optim.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                                max_norm)
    np.testing.assert_allclose(float(gnorm), float(jnorm), rtol=TOL)
    np.testing.assert_allclose(float(optim.global_l2_norm(
        {k: torch.from_numpy(v) for k, v in g.items()})), float(jnorm), rtol=TOL)
    for k in LEAVES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL, atol=1e-7)
    # torch's own clip_grad_norm_ (the semantics both follow)
    ref = [torch.from_numpy(v.copy()).requires_grad_() for v in g.values()]
    for t, v in zip(ref, g.values()):
        t.grad = torch.from_numpy(v.copy())
    torch.nn.utils.clip_grad_norm_(ref, max_norm)
    for t, k in zip(ref, g):
        np.testing.assert_allclose(got[k].numpy(), t.grad.numpy(), rtol=TOL, atol=1e-7)


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_label_smoothed_nll_matches_jax_and_torch(smoothing, reduction):
    rng = np.random.default_rng(14)
    logits = (rng.normal(size=(32, 10)) * 2).astype(np.float32)
    labels = rng.integers(0, 10, size=32)
    log_probs = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    got = ops.nll_loss(log_probs, torch.from_numpy(labels), reduction=reduction,
                       label_smoothing=smoothing)
    want = jax_nn.nll_loss(jnp.asarray(log_probs.numpy()), jnp.asarray(labels, jnp.int32),
                           reduction=reduction, label_smoothing=smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=1e-6)
    ce = torch.nn.functional.cross_entropy(torch.from_numpy(logits),
                                           torch.from_numpy(labels), reduction=reduction,
                                           label_smoothing=smoothing)
    np.testing.assert_allclose(got.numpy(), ce.numpy(), atol=1e-5, rtol=1e-5)


def test_make_optimizer_errors_and_state_layout_match_jax():
    for kw in (dict(name="sgd", weight_decay=0.1), dict(name="lamb")):
        with pytest.raises(ValueError) as ours:
            optim.make_optimizer(kw["name"], learning_rate=0.01, momentum=0.5,
                                 weight_decay=kw.get("weight_decay", 0.0))
        with pytest.raises(ValueError) as theirs:
            jax_optim.make_optimizer(kw["name"], learning_rate=0.01, momentum=0.5,
                                     weight_decay=kw.get("weight_decay", 0.0))
        assert str(ours.value) == str(theirs.value)
    ours = optim.make_optimizer("adamw", learning_rate=0.01, momentum=0.5)
    theirs = jax_optim.make_optimizer("adamw", learning_rate=0.01, momentum=0.5)
    assert ours.hyperparams == theirs.hyperparams
    params = {k: torch.zeros(s) for k, s in LEAVES.items()}
    sgd_state, adam_state = optim.sgd_init(params), optim.adamw_init(params)
    assert not optim.is_adam_state(sgd_state) and optim.is_adam_state(adam_state)
    shapes = lambda tree: {k: tuple(t.shape) for k, t in tree.items()}
    assert optim.map_param_trees(sgd_state, shapes) == LEAVES
    mapped = optim.map_param_trees(adam_state, shapes, lambda c: int(c))
    assert mapped == {"m": LEAVES, "v": LEAVES, "count": 0}
