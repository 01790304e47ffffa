"""PyTorch port, pipeline parallelism (``parallel/pipeline.py``, the composed trainer's
``stage`` axis), against the JAX package.

(a) the bridge: ``stack_stage_params``, ``stack_transformer_blocks`` and
    ``unstack_transformer_blocks`` against the JAX package's, bitwise, and the round trip;
(b) the refusals a stage axis makes, in the JAX package's words;
(c) in a gloo world of 2 on the CPU (the port's launcher, one thread a rank): the
    composed trainer at ``--mesh data=1,stage=2 --pipeline-microbatches 4`` under
    ``gpipe`` against the JAX composed trainer (its ``PipelinedClassifier``) on a
    2-device mesh and under ``1f1b`` against the port's ``data=1`` run (the eval engine
    pipelines the replicated eval batch); the stage run's ``model_composed.ckpt``
    restores bitwise into a ``data=1`` state, and in the JAX package.

Tolerances (f32 in another summation order): losses within atol 1e-5, parameters within
rtol 1e-4 + atol 1e-5; the bridge and the checkpoints exactly.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.parallel import (
    pipeline as jax_pipeline,
)
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
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import pipeline
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
    composed,
    step,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    checkpoint,
    config,
)

import torch_port_fleet as fleet

LOSS_ATOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _params(layers: int = 4):
    return transformer.TransformerClassifier(num_layers=layers).init(
        torch.Generator().manual_seed(5))


def test_bridge_matches_jax_bitwise():
    params = _params()
    stacked, rest = pipeline.stack_transformer_blocks(params, 4)
    j_tree = jax.tree_util.tree_map(jnp.asarray, transformer.params_to_jax(params))
    j_stacked, j_rest = jax_pipeline.stack_transformer_blocks(j_tree, 4)
    want = transformer.params_from_jax(j_stacked)
    assert set(stacked) == set(want)
    for k in stacked:
        assert torch.equal(stacked[k], want[k]), k
    assert set(rest) == set(transformer.params_from_jax(j_rest))
    back = pipeline.unstack_transformer_blocks(stacked, rest)
    assert set(back) == set(params)
    for k in params:
        assert torch.equal(back[k], params[k]), k
    flat = pipeline.to_stacked_layout(params, 4)
    back = pipeline.from_stacked_layout(flat)
    assert all(torch.equal(back[k], params[k]) for k in params)
    per_stage = [{"w": torch.full((2, 3), float(i))} for i in range(3)]
    got = pipeline.stack_stage_params(per_stage)["w"]
    want = jax_pipeline.stack_stage_params([{"w": jnp.full((2, 3), float(i))}
                                            for i in range(3)])["w"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for layers, match in ((3, "beyond num_layers=3"), (5, "lacks block subtrees")):
        with pytest.raises(ValueError, match=match):
            pipeline.stack_transformer_blocks(params, layers)


def _tiny(pkg, n_train=16, n_test=8):
    out = []
    for n, seed in ((n_train, 200), (n_test, 201)):
        x, y = pkg._synthesize_split(n, seed)
        out.append(pkg.Dataset(pkg._normalize(x), y.astype(np.int32), "synthetic"))
    return tuple(out)


@pytest.mark.parametrize("kw", [
    dict(mesh="data=1,seq=2,stage=2"),
    dict(mesh="data=1,stage=2", dropout_rate=0.1),
    dict(mesh="data=1,stage=2", remat=True),
    dict(mesh="data=2,stage=2", fsdp=True),
    dict(mesh="data=1,stage=2,model=2", flash_attention=True, seq_len=128),
    dict(mesh="data=1,stage=2", sharded_checkpoint=True),
    dict(mesh="data=1,stage=2", batch_size=6, pipeline_microbatches=4),
    dict(mesh="data=2,stage=2", batch_size=8, pipeline_microbatches=8),
    dict(mesh="data=1,stage=2", batch_size_test=10, pipeline_microbatches=4),
], ids=["seq", "dropout", "remat", "fsdp", "flash-model", "sharded-ckpt", "microbatches",
        "microbatch-data", "test-batch"])
def test_stage_refusals_use_the_jax_words(tmp_path, kw):
    with pytest.raises(ValueError) as got:
        composed.main(config.ComposedConfig(device="cpu", **kw), datasets=_tiny(mnist))
    with pytest.raises(ValueError) as want:
        jax_composed.main(jax_config.ComposedConfig(results_dir=str(tmp_path), **kw),
                          datasets=_tiny(jax_mnist))
    assert str(got.value) == str(want.value)


# -- the fleet ------------------------------------------------------------------------------

N_TRAIN, N_TEST = 32, 16
COMPOSED_KW = dict(epochs=1, batch_size=8, batch_size_test=16, learning_rate=0.05,
                   momentum=0.5, seed=3, seq_len=16, pipeline_microbatches=4)

CHILD = """
from {pkg}.parallel import mesh, pipeline
from {pkg}.train import composed
from {pkg}.utils import config
base = {base!r}
saved = {{}}
init = np.load(base + "/init.npz")
with mesh.cluster("cpu"):            # one group for every run
    for schedule in ("gpipe", "1f1b"):
        state, hist = composed.main(config.ComposedConfig(
            device="cpu", mesh="data=1,stage=2", pipeline_schedule=schedule,
            results_dir=base + "/" + schedule, **{composed_kw!r}),
            datasets=splits({n_train}, {n_test}),
            init_params={{k: torch.from_numpy(init[k]) for k in init.files}})
        saved[schedule + "/train"] = np.array(hist.train_losses)
        saved[schedule + "/test"] = np.array(hist.test_losses)
        saved[schedule + "/bubble"] = np.array(pipeline.last_timing()["bubble"])
        for k, p in state.params.items():
            saved[schedule + "/p/" + k] = p.numpy()
if RANK == 0:
    np.savez(base + "/pp.npz", **saved)
"""


@pytest.fixture(scope="module", autouse=True)
def fleets(tmp_path_factory):
    """The file's fleet, started before its first test so that the JAX references run
    while it trains."""
    base = tmp_path_factory.mktemp("pp")
    code = CHILD.format(pkg=fleet.PKG, base=str(base), composed_kw=COMPOSED_KW,
                        n_train=N_TRAIN, n_test=N_TEST)
    fleet.port_init(base / "init.npz", seq_len=16)
    f = fleet.Fleets(base, {"pp": (code, 2)})
    yield f
    f.close()


def test_gpipe_at_stage_2_matches_jax(fleets, tmp_path):
    init = np.load(fleets.base / "init.npz")
    with mock.patch.object(jax_composed, "create_train_state",
                           fleet.jax_starting_from({k: init[k] for k in init.files})):
        j_state, j_hist = jax_composed.main(
            jax_config.ComposedConfig(results_dir=str(tmp_path), mesh="data=1,stage=2",
                                      **COMPOSED_KW),
            datasets=_tiny(jax_mnist, N_TRAIN, N_TEST))
    got = np.load(fleets.get("pp") / "pp.npz")
    assert float(got["gpipe/bubble"]) == 1 / 5         # (S-1)/(M+S-1), S 2, M 4
    np.testing.assert_allclose(got["gpipe/train"], j_hist.train_losses, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["gpipe/test"], j_hist.test_losses, atol=LOSS_ATOL)
    for k, want in transformer.params_from_jax(j_state.params).items():
        np.testing.assert_allclose(got["gpipe/p/" + k], want.numpy(), err_msg=k,
                                   **PARAM_TOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_stage_2_matches_data_1(fleets, tmp_path, schedule):
    init = np.load(fleets.base / "init.npz")
    state, hist = composed.main(
        config.ComposedConfig(device="cpu", mesh="data=1", results_dir=str(tmp_path),
                              **COMPOSED_KW),
        datasets=_tiny(mnist, N_TRAIN, N_TEST),
        init_params={k: torch.from_numpy(init[k]) for k in init.files})
    got = np.load(fleets.get("pp") / "pp.npz")
    np.testing.assert_allclose(got[schedule + "/train"], hist.train_losses, atol=LOSS_ATOL)
    np.testing.assert_allclose(got[schedule + "/test"], hist.test_losses, atol=LOSS_ATOL)
    for k, p in state.params.items():
        np.testing.assert_allclose(got[f"{schedule}/p/{k}"], p.numpy(), err_msg=k,
                                   **PARAM_TOL)


def test_stage_checkpoint_restores_bitwise_into_data_1(fleets):
    """The stage run's checkpoint is the standard per-name layout: it restores into a
    ``data=1`` state, in either package, bitwise equal to the run's final state."""
    base = fleets.get("pp")
    got = np.load(base / "pp.npz")
    model = composed.build_classifier(config.ComposedConfig(mesh="data=1",
                                                            **COMPOSED_KW))
    ref = step.create_train_state(model, torch.Generator().manual_seed(0))
    restored = checkpoint.restore_train_state(str(base / "gpipe" / "model_composed.ckpt"),
                                              ref)
    assert int(restored.step) == N_TRAIN // COMPOSED_KW["batch_size"]
    for k, p in restored.params.items():
        np.testing.assert_array_equal(p.numpy(), got["gpipe/p/" + k], err_msg=k)
    init = np.load(base / "init.npz")
    j_ref = fleet.jax_starting_from({k: init[k] for k in init.files})(None, None)
    j_restored = jax_checkpoint.restore_train_state(
        str(base / "gpipe" / "model_composed.ckpt"), j_ref)
    for k, p in transformer.params_from_jax(j_restored.params).items():
        np.testing.assert_array_equal(p.numpy(), got["gpipe/p/" + k], err_msg=k)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
