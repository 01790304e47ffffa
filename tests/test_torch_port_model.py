"""PyTorch port, model slice: ``Net`` against the JAX package's ``Net`` on carried-over
parameters.

Forward log-probs and parameter gradients agree within atol 1e-5 (float32 convolutions
and matmuls sum in another order in the two frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from csed_514_project_distributed_training_using_pytorch_tpu import ops as jax_ops
from csed_514_project_distributed_training_using_pytorch_tpu.models.cnn import Net as JaxNet
from csed_514_project_distributed_training_using_pytorch_tpu_torch import models
from csed_514_project_distributed_training_using_pytorch_tpu_torch import ops
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn


@pytest.fixture(scope="module")
def setup():
    jnet = JaxNet()
    jparams = jnet.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 28, 28, 1)))["params"]
    rng = np.random.default_rng(7)
    x = rng.normal(size=(16, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=16)
    return jnet, jparams, cnn.params_from_jax(jparams), x, y


def test_param_count_and_layout(setup):
    _, jparams, params, _, _ = setup
    net = cnn.Net()
    assert cnn.param_count(net) == cnn.param_count(params) == 21_840
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    assert all(v.is_contiguous() and v.dtype == torch.float32 for v in params.values())
    assert sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(jparams)) == 21_840


def test_forward_matches_jax(setup):
    jnet, jparams, params, x, _ = setup
    ours = functional_call(cnn.Net(), params, (torch.from_numpy(x),)).detach().numpy()
    theirs = np.asarray(jnet.apply({"params": jparams}, jnp.asarray(x)))
    assert ours.shape == (16, 10)
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
    net = cnn.Net()
    net.load_state_dict(params)
    np.testing.assert_allclose(net(torch.from_numpy(x)).detach().numpy(), theirs, atol=1e-5)


def test_loss_and_grads_match_jax(setup):
    jnet, jparams, params, x, y = setup

    def jloss(p):
        return jax_ops.nll_loss(jnet.apply({"params": p}, jnp.asarray(x)),
                                jnp.asarray(y, jnp.int32))

    jval, jgrads = jax.value_and_grad(jloss)(jparams)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = ops.nll_loss(functional_call(cnn.Net(), leaves, (torch.from_numpy(x),)),
                        torch.from_numpy(y))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(loss.item(), float(jval), atol=1e-5)
    # params_from_jax is a pure relayout, so it carries gradients across as well.
    want = cnn.params_from_jax({k: np.asarray(v) for k, v in jgrads.items()})
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(), atol=1e-5,
                                   err_msg=f"grad mismatch at {k}")


def test_init_draws_from_the_generator():
    net = cnn.Net()
    a = net.init(torch.Generator().manual_seed(3))
    b = net.init(torch.Generator().manual_seed(3))
    c = net.init(torch.Generator().manual_seed(4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc1.weight"], c["fc1.weight"])
    assert a["conv2.weight"].abs().max().item() <= 1 / np.sqrt(250)
    assert a["fc1.bias"].abs().max().item() <= 1 / np.sqrt(320)


def test_dropout_in_training_mode_only():
    net = cnn.Net()
    assert (net.conv_dropout_rate, net.fc_dropout_rate) == (0.5, 0.5)
    x = torch.randn(8, 28, 28, 1)
    eval_out = net(x)
    torch.testing.assert_close(net(x, deterministic=True), eval_out)
    g = lambda s: torch.Generator().manual_seed(s)
    t1 = net(x, deterministic=False, generator=g(1))
    assert not torch.allclose(t1, eval_out)
    torch.testing.assert_close(net(x, deterministic=False, generator=g(1)), t1)
    off = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    off.load_state_dict(net.state_dict())
    torch.testing.assert_close(off(x, deterministic=False, generator=g(1)), eval_out)


def test_build_model():
    assert isinstance(models.build_model("cnn"), cnn.Net)
    with pytest.raises(ValueError, match="only 'cnn'"):
        models.build_model("transformer")
