"""PyTorch port, the numerical guard: the in-step verdict and identity update, the host
runtime (``train/guard.py``), the rollback-and-skip vocabulary (``resilience/poison.py``)
and the trainers' exit 65, against the JAX package.

The same inputs, made from a numpy seed, and the same initial parameters (the JAX
package's, carried over by ``cnn.params_from_jax``) go through both packages with dropout
off. Tolerances: a 20-step guarded trajectory with a NaN batch and a skip window within
1e-5 in every finite loss and parameter, the NaN steps NaN in both, the guard's counters
equal as integers; skip windows, poison windows, markers and exit codes exactly equal;
the parameter fingerprint within rtol 1e-6 (per-leaf f32 sums in another layout order).
"""

import os
import pathlib
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.models.cnn import Net as JaxNet
from csed_514_project_distributed_training_using_pytorch_tpu.ops import optim as jax_optim
from csed_514_project_distributed_training_using_pytorch_tpu.resilience import (
    poison as jax_poison,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train import (
    distributed as jax_distributed,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train import guard as jax_guard
from csed_514_project_distributed_training_using_pytorch_tpu.train import single as jax_single
from csed_514_project_distributed_training_using_pytorch_tpu.train import step as jax_step
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    config as jax_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    telemetry as jax_telemetry,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import optim
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import poison
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
    guard,
    single,
    step,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    config,
    telemetry,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
LR, MOMENTUM, ATOL = 0.05, 0.5, 1e-5
STEPS, BATCH = 20, 16
POISON_STEP, WINDOW = 7, (12, 14)
COUNTERS = ("count", "anomalies", "nonfinite", "spikes", "skipped", "first_anomaly_step",
            "last_anomaly_step")


def _jax_params(seed: int = 0):
    return JaxNet().init({"params": jax.random.PRNGKey(seed)},
                         jnp.zeros((1, 28, 28, 1)))["params"]


def _to_port(tree) -> dict[str, torch.Tensor]:
    return cnn.params_from_jax({k: np.asarray(v) for k, v in tree.items()})


# -- the in-step guard ------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
def test_guarded_trajectory_with_a_nan_batch_and_a_skip_window_matches_jax(use_pallas):
    rng = np.random.default_rng(21)
    xs = rng.normal(size=(STEPS, BATCH, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=(STEPS, BATCH))
    xs[POISON_STEP, 3] = np.nan                        # one poisoned example
    xs[16] *= 40.0                                     # a spike, once the test is armed
    spec = dict(zscore=3.0, skip=(WINDOW,))
    jparams = _jax_params()
    jstate = jax_step.TrainState(jparams, jax_optim.sgd_init(jparams),
                                 jnp.zeros((), jnp.int32), guard=jax_step.init_guard())
    jfn = jax.jit(jax_step.make_train_step(
        JaxNet(conv_dropout_rate=0.0, fc_dropout_rate=0.0), learning_rate=LR,
        momentum=MOMENTUM, use_pallas=use_pallas, guard=jax_step.GuardSpec(**spec)))
    params = _to_port(jparams)
    state = step.TrainState(params, optim.sgd_init(params), torch.zeros((), dtype=torch.int64),
                            guard=step.init_guard())
    fn = step.make_train_step(cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0),
                              learning_rate=LR, momentum=MOMENTUM, use_pallas=use_pallas,
                              guard=step.GuardSpec(**spec))
    ours, theirs = [], []
    for i in range(STEPS):
        jstate, jloss = jfn(jstate, jnp.asarray(xs[i]), jnp.asarray(ys[i], jnp.int32),
                            jax.random.PRNGKey(1))
        state, loss = fn(state, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]), 1)
        ours.append(loss.item())
        theirs.append(float(jloss))
    np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=0)      # NaN where both are
    assert np.isnan(ours[POISON_STEP]) and np.isfinite(np.delete(ours, POISON_STEP)).all()
    got = {f: int(getattr(state.guard, f)) for f in COUNTERS}
    want = {f: int(getattr(jstate.guard, f)) for f in COUNTERS}
    assert got == want
    assert (got["nonfinite"], got["spikes"], got["first_anomaly_step"],
            got["last_anomaly_step"]) == (1, 1, POISON_STEP, 16)
    assert got["skipped"] == 2 + 2 and got["count"] == STEPS - 4
    np.testing.assert_allclose(float(state.guard.ema_mean), float(jstate.guard.ema_mean),
                               rtol=1e-5)
    for k, want_p in _to_port(jstate.params).items():
        np.testing.assert_allclose(state.params[k].numpy(), want_p.numpy(), atol=ATOL,
                                   rtol=0, err_msg=k)
        assert torch.isfinite(state.params[k]).all()


def test_a_guard_that_never_fires_is_the_unguarded_step_bitwise():
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.normal(size=(16, 28, 28, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=16))
    for use_pallas in (False, True):
        runs = []
        for spec in (None, step.GuardSpec()):
            s = step.create_train_state(net, torch.Generator().manual_seed(0),
                                        guard=spec is not None)
            fn = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM,
                                      use_pallas=use_pallas, guard=spec)
            for _ in range(3):
                s, _ = fn(s, x, y, 1)
            runs.append(s)
        for k in runs[0].params:
            assert torch.equal(runs[0].params[k], runs[1].params[k]), k


# -- the vocabulary ---------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["", "4:7", "4:7,9:10", "9:10, 4:7", "0:1,", "3:100"])
def test_parse_and_format_skip_steps_match_jax(spec):
    assert poison.parse_skip_steps(spec) == jax_poison.parse_skip_steps(spec)
    windows = poison.parse_skip_steps(spec)
    assert poison.format_skip_steps(windows) == jax_poison.format_skip_steps(windows)


@pytest.mark.parametrize("bad", ["5", "7:5", "-1:3", "a:b", "4:4"])
def test_malformed_skip_windows_raise_like_jax(bad):
    with pytest.raises(ValueError) as ours:
        poison.parse_skip_steps(bad)
    with pytest.raises(ValueError) as theirs:
        jax_poison.parse_skip_steps(bad)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("existing,new", [
    ((), (4, 5)), (((4, 5),), (9, 10)), (((4, 6),), (5, 7)), (((4, 6), (10, 12)), (6, 8)),
    (((2, 3), (8, 9)), (3, 8))])
def test_merge_windows_and_poisoned_match_jax(existing, new):
    assert poison.merge_windows(existing, new) == jax_poison.merge_windows(existing, new)
    ours, theirs = poison.Poisoned(40, new), jax_poison.Poisoned(40, new)
    assert (ours.step, ours.window, str(ours)) == (theirs.step, theirs.window, str(theirs))
    assert poison.EXIT_POISONED == jax_poison.EXIT_POISONED == 65
    assert poison.MARKER_NAME == jax_poison.MARKER_NAME


def test_markers_cross_between_the_packages(tmp_path):
    poison.write_marker(str(tmp_path), window=(3, 9), step=12, anomalies=2)
    marker = jax_poison.read_marker(str(tmp_path))
    assert (marker["window"], marker["step"], marker["anomalies"]) == ((3, 9), 12, 2)
    assert not (tmp_path / poison.MARKER_NAME).exists()         # consumed
    jax_poison.write_marker(str(tmp_path), window=(5, 6), step=7, anomalies=1)
    assert poison.read_marker(str(tmp_path), consume=False)["window"] == (5, 6)
    assert poison.read_marker(str(tmp_path))["step"] == 7
    assert poison.read_marker(str(tmp_path)) is None


def test_param_fingerprint_matches_jax():
    jparams = _jax_params(4)
    ours = telemetry.param_fingerprint(_to_port(jparams))
    theirs = jax_telemetry.param_fingerprint(jparams)
    assert ours == pytest.approx(theirs, rel=1e-6)


def _guard_config(**kw):
    return types.SimpleNamespace(**{"guard": True, "guard_zscore": 8.0, "skip_steps": "",
                                    "anomaly_exit": 1, **kw})


def test_guard_runtime_stamps_and_windows_match_jax(tmp_path):
    """The same counters, epoch after epoch, through both runtimes: equal stamps, and
    Poisoned with the same window (a resumed attempt's history included)."""
    epochs = [  # (anomalies, first, last, skipped, step after the epoch, steps)
        (0, -1, -1, 0, 10, 10), (2, 13, 17, 2, 20, 10), (3, 13, 24, 3, 30, 10)]
    for base in ((0, -1), (1, 4)):                 # a fresh run, a resumed one
        ours_rt = guard.GuardRuntime(_guard_config(anomaly_exit=2),
                                     store_dir=str(tmp_path / "ours"))
        theirs_rt = jax_guard.GuardRuntime(_guard_config(anomaly_exit=2),
                                           store_dir=str(tmp_path / "jax"))
        start = step.init_guard()._replace(anomalies=torch.tensor(base[0], dtype=torch.int32),
                                           first_anomaly_step=torch.tensor(
                                               base[1], dtype=torch.int32))
        jstart = jax_step.init_guard()._replace(anomalies=jnp.asarray(base[0], jnp.int32),
                                                first_anomaly_step=jnp.asarray(base[1],
                                                                               jnp.int32))
        params = _to_port(_jax_params())
        ours_rt.baseline(types.SimpleNamespace(guard=start))
        theirs_rt.baseline(types.SimpleNamespace(guard=jstart))
        raised = []
        for e, (anoms, first, last, skipped, at, steps) in enumerate(epochs):
            anoms += base[0]
            g = start._replace(anomalies=torch.tensor(anoms, dtype=torch.int32),
                               first_anomaly_step=torch.tensor(first if anoms else base[1],
                                                               dtype=torch.int32),
                               last_anomaly_step=torch.tensor(last, dtype=torch.int32),
                               skipped=torch.tensor(skipped, dtype=torch.int32))
            jg = jax_step.GuardState(*(jnp.asarray(t.numpy()) for t in g))
            ours_state = types.SimpleNamespace(guard=g, params=params, step=torch.tensor(at))
            jax_state = types.SimpleNamespace(guard=jg, params=_jax_params(),
                                              step=jnp.asarray(at))
            stamp = ours_rt.epoch_end(ours_state, e, steps)
            jstamp = theirs_rt.epoch_end(jax_state, e, steps)
            assert {k: v for k, v in stamp.items() if k != "fingerprint"} == \
                {k: v for k, v in jstamp.items() if k != "fingerprint"}
            assert stamp["fingerprint"] == pytest.approx(jstamp["fingerprint"], rel=1e-6)
            outcome = []
            for rt, st in ((ours_rt, ours_state), (theirs_rt, jax_state)):
                try:
                    rt.check_poisoned(st)
                    outcome.append(None)
                except (poison.Poisoned, jax_poison.Poisoned) as exc:
                    outcome.append((exc.step, exc.window))
            assert outcome[0] == outcome[1]
            raised.append(outcome[0])
        assert raised[0] is None and raised[1] is not None
    assert poison.read_marker(str(tmp_path / "ours")) == {
        **jax_poison.read_marker(str(tmp_path / "jax")),
        "unix_time": pytest.approx(0, abs=1e12)}


def test_guard_off_runtime_does_nothing():
    rt = guard.GuardRuntime(types.SimpleNamespace(guard=False))
    assert rt.spec is None and rt.epoch_end(None, 0, 10) is None
    rt.baseline(None)
    rt.check_poisoned(None)
    spec = guard.GuardRuntime(_guard_config(skip_steps="3:5,8:9")).spec
    assert spec == step.GuardSpec(zscore=8.0, skip=((3, 5), (8, 9)))


# -- the trainers' exit 65 --------------------------------------------------------------


N_TRAIN, N_TEST, POISON_ROW = 640, 1000, 5


def _poisoned_splits():
    x, y = mnist._synthesize_split(N_TRAIN, 400)
    x = mnist._normalize(x)
    x[POISON_ROW] = np.nan
    tx, ty = mnist._synthesize_split(N_TEST, 401)
    return (x, y.astype(np.int32)), (mnist._normalize(tx), ty.astype(np.int32))


POISON_CHILD = """
import sys, runpy
import numpy as np
import torch
torch.set_num_threads(1)
from {pkg} import data
from {pkg}.data import mnist
x, y = mnist._synthesize_split({n_train}, 400)
x = mnist._normalize(x)
x[{row}] = np.nan
tx, ty = mnist._synthesize_split({n_test}, 401)
splits = (mnist.Dataset(x, y.astype(np.int32), "synthetic"),
          mnist.Dataset(mnist._normalize(tx), ty.astype(np.int32), "synthetic"))
data.load_mnist = lambda data_dir: splits
sys.argv = ["{module}", *{argv!r}]
runpy.run_module("{pkg}.train.{module}", run_name="__main__")
"""


def _child(module: str, argv: list[str]) -> list[str]:
    return ["-c", textwrap.dedent(POISON_CHILD.format(
        pkg=PKG, n_train=N_TRAIN, n_test=N_TEST, row=POISON_ROW, module=module,
        argv=argv))]


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    return env


def test_single_trainer_exits_65_with_the_jax_trainers_window(tmp_path, monkeypatch):
    (x, y), (tx, ty) = _poisoned_splits()
    monkeypatch.setattr(jax_single, "build_model", lambda *a, **k: JaxNet())
    jcfg = jax_config.SingleProcessConfig(
        n_epochs=2, guard=True, anomaly_exit=1, results_dir=str(tmp_path / "jax"),
        images_dir=str(tmp_path / "jax" / "images"))
    with pytest.raises(jax_poison.Poisoned) as theirs:
        jax_single.main(jcfg, datasets=(jax_mnist.Dataset(x, y, "synthetic"),
                                        jax_mnist.Dataset(tx, ty, "synthetic")))
    # in process: the same window as the JAX trainer's, and the marker
    with pytest.raises(poison.Poisoned) as ours:
        single.main(config.SingleProcessConfig(
            n_epochs=2, guard=True, anomaly_exit=1, device="cpu",
            results_dir=str(tmp_path / "port"), images_dir=str(tmp_path / "port" / "images")),
            datasets=(mnist.Dataset(x, y, "synthetic"), mnist.Dataset(tx, ty, "synthetic")))
    assert (ours.value.step, ours.value.window) == (theirs.value.step, theirs.value.window)
    assert ours.value.step == N_TRAIN // 64 and ours.value.window[1] - ours.value.window[0] == 1
    # the command line: exit 65, the marker naming the window
    proc = subprocess.run([sys.executable, *_child("single", [
        "--guard", "--anomaly-exit", "1", "--n-epochs", "2", "--device", "cpu",
        "--use-pallas-kernels", "--results-dir", "cli"])], capture_output=True, text=True,
        timeout=300, env=_env(), cwd=str(tmp_path))
    assert proc.returncode == poison.EXIT_POISONED, proc.stderr[-3000:]
    marker = poison.read_marker(str(tmp_path / "cli" / "checkpoints"))
    assert marker["window"] == theirs.value.window
    assert f"anomaly window {theirs.value.window[0]}:{theirs.value.window[1]}" in proc.stdout


def test_distributed_trainer_at_world_2_exits_65_with_the_jax_trainers_window(
        tmp_path, monkeypatch):
    (x, y), (tx, ty) = _poisoned_splits()
    monkeypatch.setattr(jax_distributed, "build_model", lambda *a, **k: JaxNet())
    jcfg = jax_config.DistributedConfig(
        epochs=2, guard=True, anomaly_exit=1, results_dir=str(tmp_path / "jax"),
        images_dir=str(tmp_path / "jax" / "images"))
    with pytest.raises(jax_poison.Poisoned) as theirs:
        jax_distributed.main(jcfg, num_devices=2, datasets=(
            jax_mnist.Dataset(x, y, "synthetic"), jax_mnist.Dataset(tx, ty, "synthetic")))
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.train.launch", "--num-processes", "2", "--timeout",
         "240", "--", *_child("distributed", [
             "--guard", "--anomaly-exit", "1", "--epochs", "2", "--device", "cpu",
             "--results-dir", "port"])],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=str(tmp_path))
    assert proc.returncode == poison.EXIT_POISONED, proc.stderr[-3000:]
    assert "Collective backend: gloo (device cpu, 2 rank(s))" in proc.stdout
    marker = poison.read_marker(str(tmp_path / "port" / "checkpoints"))
    assert (marker["step"], marker["window"]) == (theirs.value.step, theirs.value.window)
    assert proc.stdout.count("poisoned at step") == 1                    # rank 0 prints


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
