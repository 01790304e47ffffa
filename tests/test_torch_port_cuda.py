"""PyTorch port on the card: each CUDA kernel against its plain version, and the train step
through the kernels against the plain step.

These tests need an NVIDIA GPU (Hopper: the kernels are built for sm_90a) and skip
elsewhere. They import neither JAX nor the JAX package, so they run on a machine that has
only PyTorch; there, skip this directory's JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerances as in ``chip_smoke.py``: the loss kernels within atol 1e-6 + rtol 1e-5 of the
plain versions, the SGD kernel bitwise up to 1e-6 * max|p|, 5 steps through the kernels
within atol 1e-5 of the plain step.
"""

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
