"""PyTorch port, tensor parallelism (``parallel/tensor_parallel.py``, the model axis of
``models/transformer.py``, the composed and LM trainers at ``model=2``), against the JAX
package.

(a) ``param_partition_specs`` splits each transformer leaf on the dim the JAX rules split
    it, MHA and GQA and MoE alike, and ``shard_leaf``'s pieces tile each leaf exactly
    (the fused qkv/kv columns by heads);
(b) a ``TransformerBlock`` over a model axis of 2 (a gloo world of 2 on the CPU: the
    port's launcher, one thread a rank): local heads, Megatron's f and g, forward and the
    gradients of ``sum(out·g)`` against the JAX block on the same numpy-seeded inputs and
    parameters, MHA, and GQA with RoPE and a causal mask;
(c) the composed trainer at ``--mesh data=1,model=2`` against the JAX composed trainer on
    a 2-device mesh, and the LM trainer at ``--mesh data=1,model=2`` against its own
    ``data=1`` run.

Tolerances (f32 partial products summed over the model group in another order): block
outputs within rtol 1e-5 + atol 1e-5, gradients within rtol 1e-4 + atol 2e-5; trainer
losses within atol 1e-5 and parameters within rtol 1e-4 + atol 1e-5 (the LM's AdamW:
rtol 1e-4 + atol 1e-5 on parameters as well).
"""

import itertools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.models import (
    transformer as jax_tf,
)
from csed_514_project_distributed_training_using_pytorch_tpu.parallel import (
    tensor_parallel as jax_tp,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train import (
    composed as jax_composed,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    config as jax_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import transformer
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    mesh,
    tensor_parallel as tp,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import lm as lm_train
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import config

import torch_port_fleet as fleet

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
LOSS_ATOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_spec_tuple(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


@pytest.mark.parametrize("kw", [{}, {"num_kv_heads": 2}, {"num_experts": 4}],
                         ids=["mha", "gqa", "moe"])
def test_partition_specs_match_jax(kw):
    model = jax_tf.TransformerClassifier(dropout_rate=0.0, **kw)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 28, 28, 1))))["params"]
    flat_specs = jax_tp.param_partition_specs(params)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    names = {".".join(getattr(p, "key", str(p)) for p in path): torch.zeros(leaf.shape)
             for path, leaf in leaves}
    port = tp.param_partition_specs(names)
    assert len(leaves) == len(port)
    for path, leaf in leaves:
        name = ".".join(getattr(p, "key", str(p)) for p in path)
        spec = flat_specs
        for p in path:
            spec = spec[getattr(p, "key", str(p))]
        assert port[name] == _jax_spec_tuple(spec, leaf.ndim), name


@pytest.mark.parametrize("n", [2, 4])
def test_shards_tile_every_leaf(n):
    """Over every rank of a model axis of ``n``, the held ranges cover each split leaf
    exactly once (a replicated one once a rank), and ``shard_leaf`` is those ranges side by side (qkv/kv: each part's head
    slice, so a rank's q, k and v columns are its own heads')."""
    params = transformer.TransformerClassifier(num_kv_heads=n).init(
        torch.Generator().manual_seed(0))
    specs = tp.filter_to_grid(tp.param_partition_specs(params), ("data", "model"))
    for name, full in params.items():
        seen = torch.zeros(full.shape, dtype=torch.int32)
        for r in range(n):
            grid = mesh.ProcessGrid(f"data=1,model={n}", rank=r, world=n)
            ranges = tp.held_ranges(name, full.shape, specs[name], grid)
            for box in itertools.product(*ranges):
                seen[box] += 1
            split = [d for d, rs in enumerate(ranges) if len(rs) > 1]
            want = full[tuple(rs[0] for rs in ranges)] if not split else torch.cat(
                [full[box] for box in itertools.product(*ranges)], dim=split[0])
            assert torch.equal(tp.shard_leaf(full, specs[name], grid, name), want), name
        copies = 1 if "model" in specs[name] else n      # a replicated leaf: every rank
        assert bool((seen == copies).all()), name


# -- the fleet ------------------------------------------------------------------------------

N_TRAIN, N_TEST = 32, 16
BLOCK_CASES = {"mha": dict(num_heads=4), "gqa-rope-causal": dict(num_heads=4,
                                                                  num_kv_heads=2,
                                                                  rope=True, causal=True)}
COMPOSED_KW = dict(epochs=1, batch_size=8, batch_size_test=16, learning_rate=0.05,
                   momentum=0.5, seed=3, seq_len=16, mesh="data=1,model=2")
LM_KW = dict(epochs=1, batch_size=8, max_train_examples=32, max_test_examples=10,
             eval_batch=10, embed_dim=16, num_layers=1, num_heads=2, generate=0)


def _block_case(i: int, kw: dict):
    """The case's block parameters (drawn by the port from a seed, the JAX tree beside
    them) and its inputs (x, the output cotangent)."""
    block = transformer.TransformerBlock(32, dropout_rate=0.0, **kw)
    params = block.init(torch.Generator().manual_seed(40 + i))
    rng = np.random.default_rng(40 + i)
    x, g = rng.normal(size=(2, 2, 8, 32)).astype(np.float32)
    return params, transformer.params_to_jax(params), x, g


CHILD = """
from {pkg}.models import transformer
from {pkg}.parallel import mesh, tensor_parallel as tp
from {pkg}.train import composed, lm
from {pkg}.utils import config
from torch.func import functional_call
base = {base!r}
saved = {{}}
with mesh.cluster("cpu"):            # one group for every case
    grid = mesh.ProcessGrid("data=1,model=2")
    cases = np.load(base + "/blocks.npz")
    for name, kw in {blocks!r}.items():
        full = {{k[len(name) + 3:]: torch.from_numpy(cases[k]) for k in cases.files
                 if k.startswith(name + "/p/")}}
        block = transformer.TransformerBlock(32, dropout_rate=0.0,
                                             shard=mesh.ShardContext.of(grid), **kw)
        specs = tp.filter_to_grid(tp.param_partition_specs(full), grid.names)
        leaves = {{k: v.requires_grad_() for k, v in tp.shard_params(full, specs,
                                                                      grid).items()}}
        x = torch.from_numpy(cases[name + "/x"]).requires_grad_()
        out = functional_call(block, leaves, (x, True, None))
        grads = torch.autograd.grad(out, [x] + list(leaves.values()),
                                    torch.from_numpy(cases[name + "/g"]))
        saved[name + "/out"] = out.detach().numpy()
        saved[name + "/dx"] = grads[0].numpy()
        for (k, _), gk in zip(leaves.items(), grads[1:]):
            saved[name + "/d/" + k] = tp.unshard_leaf(gk, specs[k], grid, k).numpy()
    init = np.load(base + "/init.npz")
    state, hist = composed.main(config.ComposedConfig(
        device="cpu", results_dir=base + "/composed", **{composed_kw!r}),
        datasets=splits({n_train}, {n_test}),
        init_params={{k: torch.from_numpy(init[k]) for k in init.files}})
    saved["composed/train"] = np.array(hist.train_losses)
    saved["composed/test"] = np.array(hist.test_losses)
    for k, p in state.params.items():
        saved["composed/p/" + k] = p.numpy()
    state, hist = lm.main(config.LMConfig(
        device="cpu", mesh="data=1,model=2", images_dir=base + "/img",
        results_dir=base + "/lm", **{lm_kw!r}), datasets=splits(32, 10))
    saved["lm/train"] = np.array(hist.train_losses)
    saved["lm/test"] = np.array(hist.test_losses)
    for k, p in state.params.items():
        saved["lm/p/" + k] = p.numpy()
if RANK == 0:
    np.savez(base + "/tp.npz", **saved)
"""


@pytest.fixture(scope="module", autouse=True)
def fleets(tmp_path_factory):
    """The file's fleet, started before its first test so that the JAX references run
    while it trains."""
    base = tmp_path_factory.mktemp("tp")
    cases = {}
    for i, (name, kw) in enumerate(BLOCK_CASES.items()):
        params, _, x, g = _block_case(i, kw)
        cases[name + "/x"], cases[name + "/g"] = x, g
        for k, p in params.items():
            cases[f"{name}/p/{k}"] = p.numpy()
    np.savez(base / "blocks.npz", **cases)
    code = CHILD.format(pkg=fleet.PKG, base=str(base), blocks=BLOCK_CASES,
                        composed_kw=COMPOSED_KW, lm_kw=LM_KW, n_train=N_TRAIN,
                        n_test=N_TEST)
    fleet.port_init(base / "init.npz", seq_len=16)
    f = fleet.Fleets(base, {"tp": (code, 2)})
    yield f
    f.close()


@pytest.mark.parametrize("i", range(len(BLOCK_CASES)), ids=list(BLOCK_CASES))
def test_block_at_model_2_matches_jax(fleets, i):
    name, kw = list(BLOCK_CASES.items())[i]
    _, params, x, g = _block_case(i, kw)
    jblock = jax_tf.TransformerBlock(dropout_rate=0.0, **kw)

    def loss(p, x):
        out = jblock.apply({"params": p}, x, True)
        return jnp.sum(out * g), out

    (_, out), (d_params, dx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                          has_aux=True))(params, x)
    got = np.load(fleets.get("tp") / "tp.npz")
    np.testing.assert_allclose(got[name + "/out"], np.asarray(out), **FWD_TOL)
    np.testing.assert_allclose(got[name + "/dx"], np.asarray(dx), **GRAD_TOL)
    for k, want in transformer.params_from_jax(d_params).items():
        np.testing.assert_allclose(got[f"{name}/d/{k}"], want.numpy(), err_msg=k,
                                   **GRAD_TOL)


def _splits(pkg, n_train, n_test):
    out = []
    for n, seed in ((n_train, 200), (n_test, 201)):
        x, y = pkg._synthesize_split(n, seed)
        out.append(pkg.Dataset(pkg._normalize(x), y.astype(np.int32), "synthetic"))
    return tuple(out)


def test_composed_at_model_2_matches_jax(fleets, tmp_path):
    init = np.load(fleets.base / "init.npz")
    with mock.patch.object(jax_composed, "create_train_state",
                           fleet.jax_starting_from({k: init[k] for k in init.files})):
        j_state, j_hist = jax_composed.main(
            jax_config.ComposedConfig(results_dir=str(tmp_path), **COMPOSED_KW),
            datasets=_splits(jax_mnist, N_TRAIN, N_TEST))
    got = np.load(fleets.get("tp") / "tp.npz")
    np.testing.assert_allclose(got["composed/train"], j_hist.train_losses, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["composed/test"], j_hist.test_losses, atol=LOSS_ATOL)
    for k, want in transformer.params_from_jax(j_state.params).items():
        np.testing.assert_allclose(got["composed/p/" + k], want.numpy(), err_msg=k,
                                   **PARAM_TOL)


def test_lm_at_model_2_matches_data_1(fleets, tmp_path):
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
    state, hist = lm_train.main(config.LMConfig(
        device="cpu", images_dir=str(tmp_path / "img"), results_dir=str(tmp_path),
        **LM_KW), datasets=_splits(mnist, 32, 10))
    got = np.load(fleets.get("tp") / "tp.npz")
    np.testing.assert_allclose(got["lm/train"], hist.train_losses, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["lm/test"], hist.test_losses, atol=LOSS_ATOL)
    for k, p in state.params.items():
        np.testing.assert_allclose(got["lm/p/" + k], p.numpy(), err_msg=k, **PARAM_TOL)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
