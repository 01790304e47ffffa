"""PyTorch port, the composed meshes (``parallel/mesh.py::ProcessGrid``, the composed and
LM trainers on meshes of several axes, the sharded checkpoint), against the JAX package and
the port's own ``data=1`` runs.

(a) ``ProcessGrid`` gives each rank the coordinates of the JAX package's device mesh
    (``make_mesh`` reshapes the device list row-major over the spec's axes);
(b) in a gloo world of 8 on the CPU (the port's launcher, one thread a rank): the JAX
    default mesh ``data=2,seq=2,model=2`` for one epoch, with ``--fsdp`` (hybrid ZeRO ×
    TP) and ``--sharded-checkpoint``, against ``data=1``; then ``--mesh data=4,model=2``
    resuming from that sharded directory for a second epoch, against two ``data=1``
    epochs;
(c) in a gloo world of 4: the composed trainer at ``--mesh data=2,expert=2`` (the MoE's
    queues and auxiliary over the global batch) against the JAX composed trainer on a
    4-device mesh, the LM trainer at ``--mesh data=2,seq=2`` against its ``data=1`` run,
    and ``--mesh model=2,data=2 --dcn-data 2`` (the hybrid rank order, which moves the
    ranks of this mesh) against the same mesh without it, within 1e-6;
(e) ``hybrid_rank_order`` against the JAX package's ``make_hybrid_mesh`` (device ids on
    the 8 virtual CPU devices), shapes and errors;
(d) the sharded checkpoint interchange: the port's directory (written at the default
    mesh) restores in the JAX package, and the JAX package's (written at
    ``data=2,model=2``) in the port, each bitwise equal to the writer's full-state
    checkpoint, and onto the standard layout of one device.

Tolerances (f32 in another summation order): losses within atol 1e-5, parameters within
rtol 1e-4 + atol 1e-5; the checkpoints exactly.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.parallel import make_mesh
from csed_514_project_distributed_training_using_pytorch_tpu.train import (
    composed as jax_composed,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    checkpoint as jax_checkpoint,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    config as jax_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import transformer
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import mesh
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
    composed,
    step,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import lm as lm_train
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    checkpoint,
    config,
)

import torch_port_fleet as fleet

LOSS_ATOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("spec", ["data=2,seq=2,model=2", "stage=2,data=2,expert=2",
                                  "data=1,model=4", "data=8"])
def test_grid_coordinates_are_the_jax_mesh_layout(spec):
    names, sizes = mesh.parse_mesh_spec(spec)
    devices = make_mesh(int(np.prod(sizes)), axis_names=names, axis_shape=sizes).devices
    world = devices.size
    for rank in range(world):
        grid = mesh.ProcessGrid(spec, rank=rank, world=world)
        position = tuple(grid.coords[n] for n in names)
        assert devices[position].id == rank, (spec, rank)
        for n in names:          # the ranks along an axis vary that coordinate alone
            ax = grid.axis(n)
            assert ax.ranks[ax.index] == rank and len(ax.ranks) == ax.size


# -- the fleets ------------------------------------------------------------------------------

N_TRAIN, N_TEST = 32, 16
COMPOSED_KW = dict(batch_size=8, batch_size_test=16, learning_rate=0.05, momentum=0.5,
                   seed=3, seq_len=16)
EXPERT_KW = dict(COMPOSED_KW, epochs=1, mesh="data=2,expert=2")
LM_KW = dict(epochs=1, batch_size=8, max_train_examples=32, max_test_examples=10,
             eval_batch=10, embed_dim=16, num_layers=1, num_heads=2, generate=0)

CHILD_8 = """
from {pkg}.parallel import mesh
from {pkg}.train import composed
from {pkg}.utils import config
base = {base!r}
saved = {{}}
init = np.load(base + "/init.npz")
with mesh.cluster("cpu"):            # one group for every run
    for name, kw in (("default", dict(epochs=1, fsdp=True, sharded_checkpoint=True)),
                     ("resumed", dict(epochs=2, mesh="data=4,model=2",
                                      resume_from=base + "/default/model_composed.ckpt"
                                      ".sharded"))):
        state, hist = composed.main(config.ComposedConfig(
            device="cpu", results_dir=base + "/" + name, **{kw!r}, **kw),
            datasets=splits({n_train}, {n_test}),
            init_params={{k: torch.from_numpy(init[k]) for k in init.files}})
        saved[name + "/train"] = np.array(hist.train_losses)
        saved[name + "/test"] = np.array(hist.test_losses)
        for k, p in state.params.items():
            saved[name + "/p/" + k] = p.numpy()
if RANK == 0:
    np.savez(base + "/m8.npz", **saved)
"""

CHILD_4 = """
from {pkg}.parallel import mesh
from {pkg}.train import composed, lm
from {pkg}.utils import config
base = {base!r}
saved = {{}}
init = np.load(base + "/init_moe.npz")
init0 = np.load(base + "/init.npz")
with mesh.cluster("cpu"):            # one group for every run
    state, hist = composed.main(config.ComposedConfig(
        device="cpu", results_dir=base + "/expert", **{expert_kw!r}),
        datasets=splits({n_train}, {n_test}),
        init_params={{k: torch.from_numpy(init[k]) for k in init.files}})
    saved["expert/train"] = np.array(hist.train_losses)
    saved["expert/test"] = np.array(hist.test_losses)
    for k, p in state.params.items():
        saved["expert/p/" + k] = p.numpy()
    state, hist = lm.main(config.LMConfig(
        device="cpu", mesh="data=2,seq=2", images_dir=base + "/img",
        results_dir=base + "/lm", **{lm_kw!r}), datasets=splits(32, 10))
    saved["lm/train"] = np.array(hist.train_losses)
    saved["lm/test"] = np.array(hist.test_losses)
    for k, p in state.params.items():
        saved["lm/p/" + k] = p.numpy()
    for name, dcn in (("dcn", 2), ("nodcn", 0)):
        state, hist = composed.main(config.ComposedConfig(
            device="cpu", results_dir="", mesh="model=2,data=2", dcn_data=dcn, epochs=1,
            **{dcn_kw!r}), datasets=splits({n_train}, {n_test}),
            init_params={{k: torch.from_numpy(init0[k]) for k in init0.files}})
        saved[name + "/train"] = np.array(hist.train_losses)
        for k, p in state.params.items():
            saved[name + "/p/" + k] = p.numpy()
if RANK == 0:
    np.savez(base + "/m4.npz", **saved)
"""


@pytest.fixture(scope="module", autouse=True)
def fleets(tmp_path_factory):
    """The file's two fleets (worlds of 8 and 4), started before its first test."""
    base = tmp_path_factory.mktemp("meshes")
    fleet.port_init(base / "init.npz", seq_len=16)
    fleet.port_init(base / "init_moe.npz", seq_len=16, num_experts=2)
    f = fleet.Fleets(base, {
        "m8": (CHILD_8.format(pkg=fleet.PKG, base=str(base), kw=COMPOSED_KW,
                              n_train=N_TRAIN, n_test=N_TEST), 8),
        "m4": (CHILD_4.format(pkg=fleet.PKG, base=str(base), expert_kw=EXPERT_KW,
                              lm_kw=LM_KW, dcn_kw=COMPOSED_KW, n_train=N_TRAIN,
                              n_test=N_TEST), 4)})
    yield f
    f.close()


def _splits(pkg, n_train=N_TRAIN, n_test=N_TEST):
    out = []
    for n, seed in ((n_train, 200), (n_test, 201)):
        x, y = pkg._synthesize_split(n, seed)
        out.append(pkg.Dataset(pkg._normalize(x), y.astype(np.int32), "synthetic"))
    return tuple(out)


def _init(fleets, name="init.npz"):
    init = np.load(fleets.base / name)
    return {k: init[k] for k in init.files}


def _check(got, prefix, train, test, params):
    np.testing.assert_allclose(got[prefix + "/train"], train, atol=LOSS_ATOL)
    np.testing.assert_allclose(got[prefix + "/test"], test, atol=LOSS_ATOL)
    for k, p in params.items():
        np.testing.assert_allclose(got[f"{prefix}/p/{k}"], p, err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("epochs", [1, 2], ids=["default-mesh", "resumed-data4-model2"])
def test_default_mesh_and_resume_match_data_1(fleets, tmp_path, epochs):
    init = _init(fleets)
    state, hist = composed.main(
        config.ComposedConfig(device="cpu", mesh="data=1", epochs=epochs,
                              results_dir=str(tmp_path), **COMPOSED_KW),
        datasets=_splits(mnist), init_params={k: torch.from_numpy(v)
                                              for k, v in init.items()})
    got = np.load(fleets.get("m8") / "m8.npz")
    name = "default" if epochs == 1 else "resumed"
    train = hist.train_losses if epochs == 1 else hist.train_losses[1:]
    test = hist.test_losses if epochs == 1 else hist.test_losses[1:]
    _check(got, name, train, test, {k: p.numpy() for k, p in state.params.items()})


def test_data_2_expert_2_matches_jax(fleets, tmp_path):
    init = _init(fleets, "init_moe.npz")
    with mock.patch.object(jax_composed, "create_train_state",
                           fleet.jax_starting_from(init)):
        j_state, j_hist = jax_composed.main(
            jax_config.ComposedConfig(results_dir=str(tmp_path), **EXPERT_KW),
            datasets=_splits(jax_mnist))
    got = np.load(fleets.get("m4") / "m4.npz")
    _check(got, "expert", j_hist.train_losses, j_hist.test_losses,
           {k: p.numpy() for k, p in transformer.params_from_jax(j_state.params).items()})


def test_lm_at_data_2_seq_2_matches_data_1(fleets, tmp_path):
    state, hist = lm_train.main(config.LMConfig(
        device="cpu", images_dir=str(tmp_path / "img"), results_dir=str(tmp_path),
        **LM_KW), datasets=_splits(mnist, 32, 10))
    got = np.load(fleets.get("m4") / "m4.npz")
    _check(got, "lm", hist.train_losses, hist.test_losses,
           {k: p.numpy() for k, p in state.params.items()})


def _port_ref(init):
    model = composed.build_classifier(config.ComposedConfig(mesh="data=1", **COMPOSED_KW))
    state = step.create_train_state(model, torch.Generator().manual_seed(0))
    return state._replace(params={k: torch.from_numpy(v) for k, v in init.items()})


def _assert_same_state(a, b):
    """Two standard-layout states (flat port dicts) bitwise equal, leaf by leaf."""
    assert int(a.step) == int(b.step)
    assert set(a.params) == set(b.params)
    for k in a.params:
        np.testing.assert_array_equal(a.params[k].numpy(), b.params[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(a.velocity[k].numpy(), b.velocity[k].numpy(),
                                      err_msg=k)


def test_port_sharded_checkpoint_restores_in_jax(fleets):
    """The default mesh's sharded directory (split over model and, under --fsdp, data)
    restores in the JAX package bitwise equal to the run's full-state checkpoint, and in
    the port onto one device's standard layout."""
    base = fleets.get("m8") / "default"
    init = _init(fleets)
    j_ref = fleet.jax_starting_from(init)(None, None)
    j_sharded = jax_checkpoint.restore_train_state_sharded(
        str(base / "model_composed.ckpt.sharded"), j_ref)
    j_full = jax_checkpoint.restore_train_state(str(base / "model_composed.ckpt"), j_ref)
    as_port = lambda s: step.TrainState(
        transformer.params_from_jax(s.params), transformer.params_from_jax(s.velocity),
        torch.tensor(int(s.step)))
    _assert_same_state(as_port(j_sharded), as_port(j_full))
    ref = _port_ref(init)
    _assert_same_state(
        checkpoint.restore_train_state_sharded(str(base / "model_composed.ckpt.sharded"),
                                               ref),
        checkpoint.restore_train_state(str(base / "model_composed.ckpt"), ref))


def test_jax_sharded_checkpoint_restores_in_the_port(fleets, tmp_path):
    """The JAX package's directory, written at ``data=2,model=2`` under ``--fsdp``,
    restores in the port bitwise equal to the JAX run's full-state checkpoint."""
    init = _init(fleets)
    kw = dict(COMPOSED_KW, epochs=1, mesh="data=2,model=2", fsdp=True,
              sharded_checkpoint=True)
    with mock.patch.object(jax_composed, "create_train_state",
                           fleet.jax_starting_from(init)):
        jax_composed.main(jax_config.ComposedConfig(results_dir=str(tmp_path), **kw),
                          datasets=_splits(jax_mnist))
    ref = _port_ref(init)
    _assert_same_state(
        checkpoint.restore_train_state_sharded(
            str(tmp_path / "model_composed.ckpt.sharded"), ref),
        checkpoint.restore_train_state(str(tmp_path / "model_composed.ckpt"), ref))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# -- (e) the hybrid ICI x DCN rank order ----------------------------------------------------


def test_dcn_data_trains_as_the_same_mesh_without_it(fleets):
    got = np.load(fleets.get("m4") / "m4.npz")
    np.testing.assert_allclose(got["dcn/train"], got["nodcn/train"], atol=1e-6)
    names = [k[len("dcn/p/"):] for k in got.files if k.startswith("dcn/p/")]
    assert names
    for k in names:
        np.testing.assert_allclose(got["dcn/p/" + k], got["nodcn/p/" + k], atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("names,shape,slices", [
    (("data", "model"), (4, 2), 2), (("data", "seq", "model"), (2, 2, 2), 2),
    (("model", "data"), (2, 4), 2), (("data",), (8,), 4), (("data", "model"), (8, 1), 8),
    (("seq", "data"), (2, 4), 4)], ids=lambda x: str(x))
def test_hybrid_rank_order_is_make_hybrid_mesh(names, shape, slices, devices8):
    import jax

    from csed_514_project_distributed_training_using_pytorch_tpu.parallel import (
        make_hybrid_mesh,
    )
    devices = make_hybrid_mesh(names, shape, num_slices=slices,
                               devices=jax.devices()[:int(np.prod(shape))]).devices
    want = np.vectorize(lambda d: d.id)(devices)
    got = mesh.hybrid_rank_order(names, shape, num_slices=slices)
    np.testing.assert_array_equal(got, want)
    for rank in range(got.size):          # the grid puts each rank where the order does
        grid = mesh.ProcessGrid(",".join(f"{n}={s}" for n, s in zip(names, shape)),
                                rank=rank, world=got.size, order=got)
        assert got[tuple(grid.coords[n] for n in names)] == rank


@pytest.mark.parametrize("names,shape,slices", [
    (("model",), (8,), 2), (("data", "model"), (2, 4), 4), (("data", "model"), (4, 2), 3)],
    ids=["no-data-axis", "slices-over-data", "slices-over-devices"])
def test_hybrid_rank_order_refuses_as_make_hybrid_mesh(names, shape, slices, devices8):
    import jax

    from csed_514_project_distributed_training_using_pytorch_tpu.parallel import (
        make_hybrid_mesh,
    )
    with pytest.raises(ValueError) as theirs:
        make_hybrid_mesh(names, shape, num_slices=slices, devices=jax.devices())
    with pytest.raises(ValueError) as ours:
        mesh.hybrid_rank_order(names, shape, num_slices=slices)
    assert str(ours.value) == str(theirs.value)


def test_dcn_data_needs_a_data_axis():
    with pytest.raises(ValueError, match="--dcn-data needs a data axis"):
        composed.main(config.ComposedConfig(device="cpu", mesh="seq=2", dcn_data=2),
                      datasets=_splits(mnist))
