"""PyTorch port, expert parallelism (``parallel/expert_parallel.py``, the MoE blocks of
``models/transformer.py``, the composed trainer's ``expert`` axis), against the JAX
package.

(a) ``_route`` (top-1 Switch, top-2 GShard, with and without dropped tokens) gives the JAX
    package's one-hot ``[N, E, C]`` dispatch and combine layout and its auxiliary;
(b) ``moe_apply`` on one rank against the JAX ``moe_apply`` (forward, the auxiliary, and
    the gradients of ``sum(out·g) + aux``) and against the dense oracle;
(c) in a gloo world of 2 on the CPU (the port's launcher, one thread a rank):
    ``moe_apply`` over an expert axis of 2 (the tokens split over the ranks, the slots to
    their experts and back by all-to-all) against the JAX ``moe_apply``, top-1 and top-2;
    the composed trainer at ``--mesh data=1,expert=2`` with ``--moe-top-k`` 1 and 2
    against one rank running the same MoE model, and top-2 against the JAX composed
    trainer on a 2-device mesh (the auxiliary in the objective, ``aux_loss_weight`` 0.01
    in both).

Tolerances (f32 in another summation order): layer outputs and the auxiliary within rtol
1e-5 + atol 1e-6, gradients within rtol 1e-4 + atol 1e-6; the routing's layouts exactly;
trainer losses within atol 1e-5, parameters within rtol 1e-4 + atol 1e-5.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.parallel import (
    expert_parallel as jax_ep,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train import (
    composed as jax_composed,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    config as jax_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import transformer
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    expert_parallel as ep,
)

import torch_port_fleet as fleet

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_ATOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
N, D, H, E = 32, 8, 16, 4
# name -> (top-k, capacity factor); 0.5 drops tokens
CASES = {"top1": (1, 1.25), "top1-drops": (1, 0.5), "top2": (2, 1.25),
         "top2-drops": (2, 0.5)}


def _case(i: int):
    params = ep.init_moe_params(torch.Generator().manual_seed(70 + i), d_model=D,
                                d_hidden=H, num_experts=E)
    rng = np.random.default_rng(70 + i)
    tokens, g = rng.normal(size=(2, N, D)).astype(np.float32)
    return {k: v.numpy() for k, v in params.items()}, tokens, g


def _jax_moe(params, tokens, g, k, factor):
    def loss(p, x):
        out, aux = jax_ep.moe_apply(p, x, capacity_factor=factor, num_selected=k)
        return jnp.sum(out * g) + aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                        has_aux=True))(
        {n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(tokens))
    return out, aux, grads


@pytest.mark.parametrize("i", range(len(CASES)), ids=list(CASES))
def test_route_layout_matches_jax(i):
    k, factor = list(CASES.values())[i]
    params, tokens, _ = _case(i)
    capacity = ep.capacity_for(N, E, k, factor)
    slots, kept, gates, aux = ep._route(torch.from_numpy(params["router_kernel"]),
                                        torch.from_numpy(tokens), capacity=capacity,
                                        num_selected=k)
    dispatch, combine = ep.dispatch_tensors(slots, kept, gates, E, capacity)
    j_dispatch, j_combine, j_aux = jax_ep._route(
        {n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(tokens),
        capacity=capacity, num_selected=k)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(j_dispatch))
    np.testing.assert_allclose(combine.numpy(), np.asarray(j_combine), **FWD_TOL)
    np.testing.assert_allclose(aux.item(), float(j_aux), **FWD_TOL)
    if factor < 1:
        assert dispatch.sum() < k * N          # the case drops tokens


@pytest.mark.parametrize("i", range(len(CASES)), ids=list(CASES))
def test_moe_apply_matches_jax_and_the_oracle(i):
    k, factor = list(CASES.values())[i]
    params, tokens, g = _case(i)
    leaves = {n: torch.from_numpy(v).requires_grad_() for n, v in params.items()}
    x = torch.from_numpy(tokens).requires_grad_()
    out, aux = ep.moe_apply(leaves, x, capacity_factor=factor, num_selected=k)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum() + aux,
                                [x] + list(leaves.values()))
    j_out, j_aux, (j_dp, j_dx) = _jax_moe(params, tokens, g, k, factor)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **FWD_TOL)
    np.testing.assert_allclose(aux.item(), float(j_aux), **FWD_TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(j_dx), **GRAD_TOL)
    for (name, _), got in zip(leaves.items(), grads[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(j_dp[name]), err_msg=name,
                                   **GRAD_TOL)
    with torch.no_grad():
        o_out, o_aux = ep.moe_apply_dense_oracle(
            {n: torch.from_numpy(v) for n, v in params.items()}, torch.from_numpy(tokens),
            capacity_factor=factor, num_selected=k)
    np.testing.assert_allclose(out.detach().numpy(), o_out.numpy(), **FWD_TOL)
    assert o_aux.item() == aux.item()


# -- the fleet ------------------------------------------------------------------------------

N_TRAIN, N_TEST = 32, 16
COMPOSED_KW = dict(epochs=1, batch_size=8, batch_size_test=16, learning_rate=0.05,
                   momentum=0.5, seed=3, seq_len=16, mesh="data=1,expert=2")

CHILD = """
from {pkg}.parallel import expert_parallel as ep, mesh, tensor_parallel as tp
from {pkg}.train import composed
from {pkg}.utils import config
base = {base!r}
saved = {{}}
with mesh.cluster("cpu"):            # one group for every case
    grid = mesh.ProcessGrid("data=1,expert=2")
    cases = np.load(base + "/moe.npz")
    for i, (name, (k, factor)) in enumerate({cases!r}.items()):
        full = {{n: torch.from_numpy(cases[f"{{name}}/p/{{n}}"])
                 for n in ("router_kernel", "up_kernel", "up_bias", "down_kernel",
                           "down_bias")}}
        specs = ep.moe_partition_specs(full)
        leaves = {{n: v.requires_grad_() for n, v in tp.shard_params(full, specs,
                                                                      grid).items()}}
        x = torch.from_numpy(cases[name + "/x"]).requires_grad_()
        out, aux = ep.moe_apply(leaves, x, capacity_factor=factor, num_selected=k,
                                expert=grid.axis("expert"))
        grads = torch.autograd.grad(
            (out * torch.from_numpy(cases[name + "/g"])).sum() + aux,
            [x] + list(leaves.values()))
        saved[name + "/out"] = out.detach().numpy()
        saved[name + "/aux"] = aux.detach().numpy()
        saved[name + "/dx"] = grads[0].numpy()
        for (n, _), gn in zip(leaves.items(), grads[1:]):
            saved[f"{{name}}/d/{{n}}"] = tp.unshard_leaf(gn, specs[n], grid, n).numpy()
    init = np.load(base + "/init.npz")
    for top_k in (1, 2):
        state, hist = composed.main(config.ComposedConfig(
            device="cpu", results_dir=base + f"/top{{top_k}}", moe_top_k=top_k,
            **{composed_kw!r}), datasets=splits({n_train}, {n_test}),
            init_params={{k: torch.from_numpy(init[k]) for k in init.files}})
        saved[f"top{{top_k}}/train"] = np.array(hist.train_losses)
        saved[f"top{{top_k}}/test"] = np.array(hist.test_losses)
        for k, p in state.params.items():
            saved[f"top{{top_k}}/p/{{k}}"] = p.numpy()
if RANK == 0:
    np.savez(base + "/ep.npz", **saved)
"""


@pytest.fixture(scope="module", autouse=True)
def fleets(tmp_path_factory):
    """The file's fleet, started before its first test so that the JAX references run
    while it trains."""
    base = tmp_path_factory.mktemp("ep")
    arrays = {}
    for i, name in enumerate(CASES):
        params, tokens, g = _case(i)
        arrays[name + "/x"], arrays[name + "/g"] = tokens, g
        for n, v in params.items():
            arrays[f"{name}/p/{n}"] = v
    np.savez(base / "moe.npz", **arrays)
    code = CHILD.format(pkg=fleet.PKG, base=str(base), cases=CASES,
                        composed_kw=COMPOSED_KW, n_train=N_TRAIN, n_test=N_TEST)
    fleet.port_init(base / "init.npz", seq_len=16, num_experts=2)
    f = fleet.Fleets(base, {"ep": (code, 2)})
    yield f
    f.close()


@pytest.mark.parametrize("i", range(len(CASES)), ids=list(CASES))
def test_moe_apply_at_expert_2_matches_jax(fleets, i):
    name, (k, factor) = list(CASES.items())[i]
    params, tokens, g = _case(i)
    j_out, j_aux, (j_dp, j_dx) = _jax_moe(params, tokens, g, k, factor)
    got = np.load(fleets.get("ep") / "ep.npz")
    np.testing.assert_allclose(got[name + "/out"], np.asarray(j_out), **FWD_TOL)
    np.testing.assert_allclose(got[name + "/aux"], float(j_aux), **FWD_TOL)
    np.testing.assert_allclose(got[name + "/dx"], np.asarray(j_dx), **GRAD_TOL)
    for n in params:
        np.testing.assert_allclose(got[f"{name}/d/{n}"], np.asarray(j_dp[n]), err_msg=n,
                                   **GRAD_TOL)


def _splits():
    out = []
    for n, seed in ((N_TRAIN, 200), (N_TEST, 201)):
        x, y = jax_mnist._synthesize_split(n, seed)
        out.append(jax_mnist.Dataset(jax_mnist._normalize(x), y.astype(np.int32),
                                     "synthetic"))
    return tuple(out)


def _one_rank_moe(top_k: int, init: dict):
    """The same MoE classifier trained on one rank (no expert axis: both experts local),
    through the composed trainer's own segment function, over its epoch plan: the train
    loss, the test loss and the parameters after the epoch."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        composed,
        step,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import config
    kw = dict(COMPOSED_KW, mesh="data=1")
    cfg = config.ComposedConfig(device="cpu", moe_top_k=top_k, **kw)
    model = transformer.TransformerClassifier(seq_len=16, dropout_rate=0.0, num_experts=2,
                                              expert_top_k=top_k)
    steps = N_TRAIN // cfg.batch_size
    optimizer, segment = composed.build_segment_fn(cfg, model, total_steps=steps)
    params = {k: torch.from_numpy(v) for k, v in init.items()}
    state = step.TrainState(params, optimizer.init(params), torch.zeros((), dtype=torch.int64))
    (train_x, train_y), (test_x, test_y) = (
        (torch.from_numpy(d.images), torch.from_numpy(d.labels.astype(np.int64)))
        for d in (mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic")
                  for x, y in (mnist._synthesize_split(N_TRAIN, 200),
                               mnist._synthesize_split(N_TEST, 201))))
    plan = torch.from_numpy(composed.epoch_plan(cfg.seed, 0, N_TRAIN, steps,
                                                cfg.batch_size))
    state, losses = segment(state, train_x, train_y, plan, cfg.seed + 1)
    sum_nll, _ = step.make_eval_fn(model, batch_size=cfg.batch_size_test)(
        state.params, test_x, test_y)
    return losses.mean().item(), sum_nll.item() / N_TEST, state.params


def test_composed_at_expert_2_matches_jax(fleets, tmp_path):
    """Top-2 (GShard) against the JAX composed trainer on its 2-device expert mesh."""
    init = np.load(fleets.base / "init.npz")
    with mock.patch.object(jax_composed, "create_train_state",
                           fleet.jax_starting_from({k: init[k] for k in init.files})):
        j_state, j_hist = jax_composed.main(
            jax_config.ComposedConfig(results_dir=str(tmp_path), moe_top_k=2,
                                      **COMPOSED_KW), datasets=_splits())
    got = np.load(fleets.get("ep") / "ep.npz")
    np.testing.assert_allclose(got["top2/train"], j_hist.train_losses, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["top2/test"], j_hist.test_losses, atol=LOSS_ATOL)
    for k, want in transformer.params_from_jax(j_state.params).items():
        np.testing.assert_allclose(got[f"top2/p/{k}"], want.numpy(), err_msg=k,
                                   **PARAM_TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_composed_at_expert_2_matches_one_rank(fleets, top_k):
    """Top-1 (Switch) and top-2 against one rank running the same MoE model."""
    init = np.load(fleets.base / "init.npz")
    train, test, params = _one_rank_moe(top_k, {k: init[k] for k in init.files})
    got = np.load(fleets.get("ep") / "ep.npz")
    np.testing.assert_allclose(got[f"top{top_k}/train"], [train], atol=LOSS_ATOL)
    np.testing.assert_allclose(got[f"top{top_k}/test"], [test], atol=LOSS_ATOL)
    for k, p in params.items():
        np.testing.assert_allclose(got[f"top{top_k}/p/{k}"], p.numpy(), err_msg=k,
                                   **PARAM_TOL)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
