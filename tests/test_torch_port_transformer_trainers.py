"""PyTorch port, the transformer on every trainer: ``models.build_model``'s knobs,
``train.single`` and ``train.distributed`` with ``--model transformer``, the composed
trainer's checkpoint, resume and preemption, and ``bench_transformer``, against the JAX
package.

(a) ``build_model`` maps ``bf16``/``attention_window``/``kv_heads``/``rope`` as the JAX
    package's does and refuses with its words;
(b) both ``train.single.main``s with ``--model transformer`` on the same injected 160/100
    split at batch 32 with log_interval 5 (one segment of 5 steps), dropout off, the
    port starting from the JAX trainer's initial parameters: every recorded loss and the
    final parameters within atol 1e-4 in f32 (float32 sums in another order over 5
    updates), within atol 2e-2 (losses) and 5e-3 (parameters) in bf16 (activations rounded
    to 8 bits, in another order); the port's ``model.ckpt`` restored by the JAX package,
    and the JAX package's by the port, bitwise;
(c) ``train.distributed --model transformer`` as a world of 2 gloo processes on the CPU
    against the world of 1 on the same global batch, dropout off: losses within rtol 1e-5,
    parameters within rtol 1e-4 + atol 1e-6 (the reduce adds the halves in another order);
(d) the composed trainer's ``model_composed.ckpt`` restored by the other package, both
    ways, bitwise; a run resumed from it equal to the unbroken run, bitwise; SIGTERM inside
    an epoch giving exit 75 with that epoch's checkpoint durable;
(e) ``bench_transformer``: the port's JSON line holds every key of the repository's root
    script's line at tiny shapes, and names the route it ran.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bench_transformer as root_bench_transformer
from csed_514_project_distributed_training_using_pytorch_tpu import models as jax_models
from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.train import (
    composed as jax_composed,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train import single as jax_single
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    checkpoint as jax_checkpoint,
    config as jax_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch import (
    bench_transformer,
    models,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import transformer
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
    composed,
    single,
    step,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    checkpoint,
    config,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"


def _datasets(n_train: int, n_test: int):
    out = []
    for n, seed in ((n_train, 100), (n_test, 101)):
        x, y = mnist._synthesize_split(n, seed)
        out.append((mnist._normalize(x), y.astype(np.int32)))
    return (tuple(mnist.Dataset(x, y, "synthetic") for x, y in out),
            tuple(jax_mnist.Dataset(x, y, "synthetic") for x, y in out))


def _flat(jax_params) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in transformer.params_from_jax(jax_params).items()}


# -- (a) build_model ----------------------------------------------------------------------


def test_build_model_maps_the_knobs_as_jax():
    assert models.build_model("cnn", bf16=True).dtype == torch.bfloat16
    m = models.build_model("transformer", bf16=True, attention_window=5, kv_heads=2,
                           rope=True, remat=True, remat_policy="save-dots", causal=True)
    j = jax_models.build_model("transformer", bf16=True, attention_window=5, kv_heads=2,
                               rope=True, remat=True, remat_policy="save-dots", causal=True)
    assert (m.dtype, m.num_kv_heads, m.rope, m.remat, m.remat_policy, m.causal) == (
        torch.bfloat16, j.num_kv_heads, j.rope, j.remat, j.remat_policy, j.causal)
    assert m.block_0.attn.attention_fn.keywords == {"window": 5}
    for kw in (dict(name="cnn", remat=True), dict(name="cnn", causal=True),
               dict(name="transformer", kv_heads=3), dict(name="mlp"),
               dict(name="transformer", remat_policy="save-dots"),
               dict(name="transformer", attention_window=-1)):
        with pytest.raises(ValueError) as want:
            jax_models.build_model(**kw)
        with pytest.raises(ValueError) as got:
            models.build_model(**kw)
        assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]


# -- (b) train.single --model transformer ---------------------------------------------------

SINGLE_KW = dict(n_epochs=1, batch_size_train=32, batch_size_test=100, learning_rate=0.05,
                 momentum=0.5, log_interval=5, model="transformer")
SINGLE_VARIANTS = {
    "f32": (dict(), dict(atol=1e-4), dict(atol=1e-4)),
    "fused-gqa-rope-remat": (dict(use_pallas_kernels=True, kv_heads=2, rope=True,
                                  remat=True), dict(atol=1e-4), dict(atol=1e-4)),
    "bf16-causal-window": (dict(bf16=True, causal=True, attention_window=5),
                           dict(atol=2e-2), dict(atol=5e-3)),
}


class _SingleHarness:
    """Both ``train.single.main``s on the same injected split, dropout off, the port
    starting from the JAX trainer's initial parameters."""

    def __init__(self, tmp_path, monkeypatch):
        self.tmp = tmp_path
        self.port_ds, self.ref_ds = _datasets(160, 100)
        self.captured = {}
        jax_create, jax_build = jax_single.create_train_state, jax_single.build_model

        def capture(model, rng, **kw):
            state = jax_create(model, rng, **kw)
            self.captured.setdefault("params", jax.tree_util.tree_map(np.array,
                                                                       state.params))
            return state

        def start_from_jax(model, generator, *, optimizer, device, **_):
            params = {k: torch.from_numpy(v).to(device)
                      for k, v in _flat(self.captured["params"]).items()}
            return step.TrainState(params, optimizer.init(params), 0)

        monkeypatch.setattr(jax_single, "create_train_state", capture)
        monkeypatch.setattr(jax_single, "build_model", lambda *a, **k: jax_build(
            *a, **k).clone(dropout_rate=0.0))
        monkeypatch.setattr(single, "create_train_state", start_from_jax)
        monkeypatch.setattr(single, "build_model",
                            functools.partial(models.build_model, dropout_rate=0.0))

    def run(self, name: str, **flags):
        dirs = dict(results_dir=str(self.tmp / name / "results"),
                    images_dir=str(self.tmp / name / "images"))
        jstate, jhist = jax_single.main(
            jax_config.SingleProcessConfig(**SINGLE_KW, **dirs, **flags),
            datasets=self.ref_ds)
        dirs = dict(results_dir=str(self.tmp / name / "port"),
                    images_dir=str(self.tmp / name / "images"))
        state, hist = single.main(
            config.SingleProcessConfig(device="cpu", **SINGLE_KW, **dirs, **flags),
            datasets=self.port_ds)
        return (jstate, jhist), (state, hist)


@pytest.mark.parametrize("variant", list(SINGLE_VARIANTS))
def test_single_transformer_matches_jax_trainer(tmp_path, monkeypatch, variant):
    flags, loss_tol, param_tol = SINGLE_VARIANTS[variant]
    (jstate, jhist), (state, hist) = _SingleHarness(tmp_path, monkeypatch).run(
        variant, **flags)
    assert int(state.step) == int(jstate.step) == 5
    assert hist.train_counter == jhist.train_counter
    np.testing.assert_allclose(hist.train_losses, jhist.train_losses, **loss_tol)
    np.testing.assert_allclose(hist.test_losses, jhist.test_losses, **loss_tol)
    want = _flat(jstate.params)
    assert set(state.params) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].numpy(), v, err_msg=k, **param_tol)
    # the port's closing checkpoint, read by the JAX package: the final state bitwise
    restored = jax_checkpoint.restore_train_state(
        str(tmp_path / variant / "port" / "model.ckpt"), jstate)
    assert int(restored.step) == 5
    for k, v in _flat(restored.params).items():
        np.testing.assert_array_equal(v, state.params[k].numpy(), err_msg=k)
    # and the JAX package's, read by the port
    ported = checkpoint.restore_train_state(
        str(tmp_path / variant / "results" / "model.ckpt"), state)
    for k, v in want.items():
        np.testing.assert_array_equal(ported.params[k].numpy(), v, err_msg=k)


# -- (c) train.distributed --model transformer at world 2 -------------------------------------

DIST_KW = dict(epochs=1, global_batch_size=16, batch_size_test=100, learning_rate=0.05,
               momentum=0.5, log_interval=2, model="transformer", kv_heads=2, causal=True,
               max_train_examples=64, max_test_examples=100, seed=4)

DIST_CHILD = """
import functools, os
import numpy as np, torch
from {pkg} import models
from {pkg}.train import distributed
from {pkg}.utils import config
torch.set_num_threads(1)
distributed.build_model = functools.partial(models.build_model, dropout_rate=0.0)
state, hist = distributed.main(config.DistributedConfig(
    device="cpu", results_dir={out!r}, images_dir={out!r}, **{kw!r}))
if os.environ["RANK"] == "0":
    np.savez({out!r} + "/w2.npz", train=np.array(hist.train_losses),
             **{{k: p.numpy() for k, p in state.params.items()}})
"""


def test_distributed_transformer_world_2_matches_world_1(tmp_path, monkeypatch):
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        distributed,
    )
    monkeypatch.setattr(distributed, "build_model",
                        functools.partial(models.build_model, dropout_rate=0.0))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    out_dir = tmp_path / "w2"
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.train.launch", "--num-processes", "2", "--timeout",
         "240", "--", "-c", DIST_CHILD.format(pkg=PKG, out=str(out_dir), kw=DIST_KW)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(tmp_path))
    state, hist = distributed.main(config.DistributedConfig(
        device="cpu", results_dir=str(tmp_path / "w1"), images_dir=str(tmp_path / "w1"),
        **DIST_KW))
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"{out[-2000:]}\n{err[-4000:]}"
    assert "Segment program: eager on cpu" in out
    got = np.load(out_dir / "w2.npz")
    np.testing.assert_allclose(got["train"], hist.train_losses, rtol=1e-5)
    for k, p in state.params.items():
        np.testing.assert_allclose(got[k], p.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


# -- (d) the composed trainer's checkpoint, resume and preemption -----------------------------

COMPOSED_KW = dict(mesh="data=1", epochs=2, batch_size=16, batch_size_test=50,
                   learning_rate=0.05, momentum=0.5, seed=5)


def test_composed_checkpoint_interchanges_with_jax_bitwise(tmp_path):
    port_ds, ref_ds = _datasets(48, 50)
    jstate, _ = jax_composed.main(jax_config.ComposedConfig(
        results_dir=str(tmp_path / "jax"), **COMPOSED_KW), datasets=ref_ds)
    state, _ = composed.main(config.ComposedConfig(
        device="cpu", results_dir=str(tmp_path / "port"), **COMPOSED_KW), datasets=port_ds)
    assert int(state.step) == int(jstate.step) == 6
    # the JAX package's file, read by the port, and written back: the same bytes
    jax_file = tmp_path / "jax" / "model_composed.ckpt"
    ported = checkpoint.restore_train_state(str(jax_file), state)
    for k, v in _flat(jstate.params).items():
        np.testing.assert_array_equal(ported.params[k].numpy(), v, err_msg=k)
    checkpoint.save_train_state(str(tmp_path / "again.ckpt"), ported)
    assert (tmp_path / "again.ckpt").read_bytes() == jax_file.read_bytes()
    # the port's, read by the JAX package
    restored = jax_checkpoint.restore_train_state(
        str(tmp_path / "port" / "model_composed.ckpt"), jstate)
    assert int(restored.step) == 6
    for k, v in _flat(restored.params).items():
        np.testing.assert_array_equal(v, state.params[k].numpy(), err_msg=k)


def test_composed_resume_equals_the_unbroken_run(tmp_path):
    port_ds, _ = _datasets(48, 50)
    straight, _ = composed.main(config.ComposedConfig(
        device="cpu", results_dir=str(tmp_path / "straight"), **COMPOSED_KW),
        datasets=port_ds)
    composed.main(config.ComposedConfig(
        device="cpu", results_dir=str(tmp_path / "first"), keep_checkpoints=2,
        **dict(COMPOSED_KW, epochs=1)), datasets=port_ds)
    first = tmp_path / "first" / "checkpoints" / checkpoint.versioned_name(3)
    resumed, hist = composed.main(config.ComposedConfig(
        device="cpu", results_dir=str(tmp_path / "resumed"), resume_from=str(first),
        **COMPOSED_KW), datasets=port_ds)
    assert int(resumed.step) == 6 and len(hist.train_losses) == 1
    for k, p in straight.params.items():
        assert torch.equal(resumed.params[k], p), k
    assert (tmp_path / "resumed" / "model_composed.ckpt").read_bytes() == (
        tmp_path / "straight" / "model_composed.ckpt").read_bytes()


PREEMPT_CHILD = """
import os, signal, sys
import numpy as np
from {pkg}.data import mnist
from {pkg}.train import composed, single
from {pkg}.utils import config
x, y = mnist._synthesize_split(48, 100)
train = mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic")
x, y = mnist._synthesize_split(50, 101)
test = mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic")
plan = composed.epoch_plan
def plan_then_term(seed, epoch, *a):
    if epoch == 1:
        os.kill(os.getpid(), signal.SIGTERM)   # inside epoch 1: stop at its boundary
    return plan(seed, epoch, *a)
composed.epoch_plan = plan_then_term
main = lambda cfg: composed.main(cfg, datasets=(train, test))
single.run_cli(config.ComposedConfig, main)
"""


def test_composed_sigterm_exits_75_with_the_epoch_checkpoint(tmp_path):
    args = ["--device", "cpu", "--epochs", "3", "--batch-size", "16", "--batch-size-test",
            "50", "--mesh", "data=1", "--handle-preemption", "--results-dir",
            str(tmp_path / "results"), "--heartbeat-dir", str(tmp_path / "hb")]
    proc = subprocess.run([sys.executable, "-c", PREEMPT_CHILD.format(pkg=PKG), *args],
                          capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 75, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "preempted at step 6" in proc.stdout
    assert "Epoch 1:" in proc.stdout and "Epoch 2:" not in proc.stdout
    beat = json.loads((tmp_path / "hb" / "heartbeat_p0.json").read_text())
    assert beat["status"] == "preempted" and beat["step"] == 6
    ref = composed.build_classifier(config.ComposedConfig(mesh="data=1"))
    restored = checkpoint.restore_train_state(
        str(tmp_path / "results" / "model_composed.ckpt"),
        step.create_train_state(ref, torch.Generator()))
    assert int(restored.step) == 6


# -- (e) bench_transformer ------------------------------------------------------------------

TINY_BENCH = ["--d-model", "16", "--seq", "16", "--batch", "4", "--layers", "1", "--heads",
              "2", "--steps", "2"]


def test_bench_transformer_prints_the_root_scripts_keys(capsys):
    assert root_bench_transformer.main(TINY_BENCH) == 0
    root = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert bench_transformer.main([*TINY_BENCH, "--device", "cpu", "--flash"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    ours = json.loads(lines[0])
    assert set(root) <= set(ours) and set(ours) - set(root) == {"segment_program"}
    assert ours["train_flops_per_step_by_component"] == root[
        "train_flops_per_step_by_component"]
    assert ours["model_train_flops_per_step"] == root["model_train_flops_per_step"]
    assert "attn-dispatch(dense)" in ours["metric"] and ours["flash_layout"] is None
    assert (ours["platform"], ours["mfu_vs_bf16_peak"], ours["segment_program"]) == (
        "cpu", None, "eager")
    assert np.isfinite(ours["final_train_loss"]) and ours["steps_per_run"] == 2
    # at S = 2048 the dispatcher takes the flash route: f32 operands run 3xTF32
    assert bench_transformer.main(["--d-model", "16", "--seq", "2048", "--batch", "1",
                                   "--layers", "1", "--heads", "2", "--steps", "1",
                                   "--no-bf16", "--flash", "--device", "cpu"]) == 0
    flash = json.loads(capsys.readouterr().out)
    assert "attn-dispatch(flash)" in flash["metric"] and flash["flash_layout"] == "tf32x3"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
