"""PyTorch port, FSDP/ZeRO (``parallel/fsdp.py``, ``train.distributed --fsdp``, the composed
trainer's ``--fsdp``), against the JAX package.

(a) ``_zero_dim`` chooses, leaf by leaf, the dim the JAX rule chooses (the transformer's,
    the MoE's and the CNN's leaves in the JAX layout, axis sizes 2, 4 and 8, the default
    and a small ``min_leaf_size``, with and without taken dims); ``fsdp_partition_specs``
    and the hybrid FSDP × TP specs equal the JAX package's ``PartitionSpec``s;
(b) in a gloo world of 2 on the CPU (the port's launcher, one thread a rank):
    ``train.distributed --fsdp`` against plain DP on the same world, the composed trainer
    at ``--mesh data=2 --fsdp`` with gradient accumulation and dropout (each rank's rows
    of the global masks) against ``data=1``, and the gathers a step makes with and
    without ``--remat`` (the recomputation gathers each block's leaves again).

Tolerances: FSDP against DP on one world, parameters within atol 1e-6 (the same sums,
the reduce-scatter's in another grouping); the composed trainer against data=1, losses
within atol 1e-5 and parameters within rtol 1e-4 + atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.models import (
    cnn as jax_cnn,
    transformer as jax_tf,
)
from csed_514_project_distributed_training_using_pytorch_tpu.parallel import (
    fsdp as jax_fsdp,
    make_mesh,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train.step import (
    TrainState as JaxTrainState,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import fsdp
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import composed
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import config

import torch_port_fleet as fleet

LOSS_ATOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
FSDP_VS_DP_ATOL = 1e-6


def _jax_shapes(model, x):
    """A JAX model's parameter shapes (no compile): ``{dotted name: ShapeDtypeStruct}``
    and the tree."""
    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))["params"]
    flat = {".".join(getattr(p, "key", str(p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    return flat, tree


def _spec(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


MODELS = {
    "transformer": (jax_tf.TransformerClassifier(dropout_rate=0.0),
                    jnp.zeros((1, 28, 28, 1))),
    "moe": (jax_tf.TransformerClassifier(dropout_rate=0.0, num_experts=4),
            jnp.zeros((1, 28, 28, 1))),
    "cnn": (jax_cnn.Net(), jnp.zeros((1, 28, 28, 1))),
}


@pytest.mark.parametrize("model", list(MODELS))
def test_zero_dim_matches_jax_leaf_by_leaf(model):
    flat, _ = _jax_shapes(*MODELS[model])
    for name, leaf in flat.items():
        arr = np.zeros(leaf.shape, np.float32)
        for n in (2, 4, 8):
            for min_size in (fsdp.MIN_LEAF_SIZE, 16):
                for taken in ((), (0,), (arr.ndim - 1,)):
                    assert fsdp._zero_dim(leaf.shape, n, min_size, taken) == \
                        jax_fsdp._zero_dim(arr, n, min_size, taken), (name, n, min_size,
                                                                       taken)


@pytest.mark.parametrize("model", list(MODELS))
def test_fsdp_specs_match_jax(model):
    flat, tree = _jax_shapes(*MODELS[model])
    want = jax_fsdp.fsdp_partition_specs(tree, 2)
    got = fsdp.fsdp_partition_specs({k: torch.zeros(v.shape) for k, v in flat.items()}, 2)
    for name, leaf in flat.items():
        spec = want
        for part in name.split("."):
            spec = spec[part]
        assert got[name] == _spec(spec, leaf.ndim), name


@pytest.mark.parametrize("axes", [("data",), ("data", "model"),
                                  ("data", "seq", "model"), ("data", "expert")])
def test_hybrid_specs_match_jax(axes):
    sizes = {"data": 2, "seq": 2, "model": 2, "expert": 2}
    kw = {"num_experts": 2} if "expert" in axes else {}
    flat, tree = _jax_shapes(jax_tf.TransformerClassifier(dropout_rate=0.0, **kw),
                             jnp.zeros((1, 28, 28, 1)))
    shape = tuple(sizes[a] for a in axes)
    jmesh = make_mesh(int(np.prod(shape)), axis_names=axes, axis_shape=shape)
    state = JaxTrainState(params=tree, velocity=tree,
                          step=jax.ShapeDtypeStruct((), jnp.int32))
    want = jax_fsdp.hybrid_state_shardings(jmesh, state).params
    got = fsdp.hybrid_partition_specs({k: torch.zeros(v.shape) for k, v in flat.items()},
                                      axes, 2)
    for name, leaf in flat.items():
        sh = want
        for part in name.split("."):
            sh = sh[part]
        assert got[name] == _spec(sh.spec, leaf.ndim), name


# -- the fleet ------------------------------------------------------------------------------

N_TRAIN, N_TEST = 32, 16
DIST_KW = dict(epochs=1, max_train_examples=256, max_test_examples=100,
               batch_size_test=100, device="cpu")
COMPOSED_KW = dict(epochs=1, batch_size=8, batch_size_test=16, learning_rate=0.05,
                   momentum=0.5, seed=3, seq_len=16, dropout_rate=0.1, grad_accum=2)
# name -> the data=2 run's flags
COMPOSED_RUNS = {"fsdp": dict(mesh="data=2", fsdp=True),
                 "fsdp-remat": dict(mesh="data=2", fsdp=True, remat=True)}
# the leaves the hybrid rule splits at data=2 (no model axis): embed_kernel and each
# block's qkv, out, mlp_up and mlp_down kernels
SPLIT_TOP, SPLIT_PER_BLOCK, BLOCKS = 1, 4, 2

CHILD = """
from {pkg}.parallel import collectives, mesh
from {pkg}.train import composed, distributed
from {pkg}.utils import config
base = {base!r}
saved = {{}}
with mesh.cluster("cpu"):            # one group for every run
    train, test = splits(256, 100)
    for name, kw in (("dp", {{}}), ("fsdp", {{"fsdp": True}})):
        state, _ = distributed.main(config.DistributedConfig(
            results_dir=base + "/" + name, images_dir=base + "/img", **{dist_kw!r}, **kw),
            datasets=(train, test))
        for k, p in state.params.items():
            saved[f"dist-{{name}}/{{k}}"] = p.numpy()
    for name, kw in {runs!r}.items():
        collectives.reset_call_counts()
        state, hist = composed.main(config.ComposedConfig(
            device="cpu", results_dir=base + "/" + name, **{composed_kw!r}, **kw),
            datasets=splits({n_train}, {n_test}))
        counts = collectives.call_counts()
        saved[name + "/gathers"] = np.array([counts.get("gather_dim", 0),
                                             counts.get("gather_dim.backward", 0)])
        saved[name + "/train"] = np.array(hist.train_losses)
        saved[name + "/test"] = np.array(hist.test_losses)
        for k, p in state.params.items():
            saved[name + "/p/" + k] = p.numpy()
if RANK == 0:
    np.savez(base + "/fsdp.npz", **saved)
"""


@pytest.fixture(scope="module", autouse=True)
def fleets(tmp_path_factory):
    """The file's fleet, started before its first test so that the JAX rule checks run
    while it trains."""
    base = tmp_path_factory.mktemp("fsdp")
    code = CHILD.format(pkg=fleet.PKG, base=str(base), dist_kw=DIST_KW,
                        composed_kw=COMPOSED_KW, runs=COMPOSED_RUNS, n_train=N_TRAIN,
                        n_test=N_TEST)
    f = fleet.Fleets(base, {"fsdp": (code, 2)})
    yield f
    f.close()


def test_distributed_fsdp_matches_plain_dp(fleets):
    got = np.load(fleets.get("fsdp") / "fsdp.npz")
    names = [k[len("dist-dp/"):] for k in got.files if k.startswith("dist-dp/")]
    assert len(names) == 8
    for k in names:
        np.testing.assert_allclose(got["dist-fsdp/" + k], got["dist-dp/" + k],
                                   rtol=0, atol=FSDP_VS_DP_ATOL, err_msg=k)


def _splits():
    out = []
    for n, seed in ((N_TRAIN, 200), (N_TEST, 201)):
        x, y = mnist._synthesize_split(n, seed)
        out.append(mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic"))
    return tuple(out)


@pytest.fixture(scope="module")
def data_1(tmp_path_factory):
    state, hist = composed.main(
        config.ComposedConfig(device="cpu", mesh="data=1",
                              results_dir=str(tmp_path_factory.mktemp("d1")),
                              **COMPOSED_KW),
        datasets=_splits())
    return state, hist


@pytest.mark.parametrize("name", list(COMPOSED_RUNS))
def test_composed_fsdp_at_data_2_matches_data_1(fleets, data_1, name):
    state, hist = data_1
    got = np.load(fleets.get("fsdp") / "fsdp.npz")
    np.testing.assert_allclose(got[name + "/train"], hist.train_losses, atol=LOSS_ATOL)
    np.testing.assert_allclose(got[name + "/test"], hist.test_losses, atol=LOSS_ATOL)
    for k, p in state.params.items():
        np.testing.assert_allclose(got[f"{name}/p/{k}"], p.numpy(), err_msg=k,
                                   **PARAM_TOL)


def test_remat_gathers_each_block_again(fleets):
    """Each forward gathers every split leaf once, the backward reduce-scatters each; the
    rematerialized blocks gather theirs a second time in the backward's recomputation."""
    got = np.load(fleets.get("fsdp") / "fsdp.npz")
    steps = N_TRAIN // COMPOSED_KW["batch_size"]
    forwards = steps * COMPOSED_KW["grad_accum"]
    evals = N_TEST // COMPOSED_KW["batch_size_test"]
    per_forward = SPLIT_TOP + SPLIT_PER_BLOCK * BLOCKS
    assert got["fsdp/gathers"].tolist() == [(forwards + evals) * per_forward,
                                            forwards * per_forward]
    assert got["fsdp-remat/gathers"].tolist() == [
        (forwards + evals) * per_forward + forwards * SPLIT_PER_BLOCK * BLOCKS,
        forwards * per_forward]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
