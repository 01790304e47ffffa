"""PyTorch port, training slice: the train step, the evaluation, the trainer and its
reporting, against the JAX package.

Tolerances: 5 train steps with dropout off agree within atol 1e-5 in parameters and loss,
with the fused kernels off and on; the whole single-process trainer, run by both packages
on the same injected dataset from the same parameters with dropout off, agrees within atol
1e-4 in every recorded loss and in the final parameters (float32 sums in another order,
compounded over a short epoch of updates), and so does each package's resume from the
other's checkpoint against the other package's own resume, and each package's
``--use-host-pipeline`` against the other's. The port's host-fed epoch equals its
device-resident epoch bitwise on the CPU.
"""

import io
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.models.cnn import Net as JaxNet
from csed_514_project_distributed_training_using_pytorch_tpu.train import single as jax_single
from csed_514_project_distributed_training_using_pytorch_tpu.train import step as jax_step
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    checkpoint as jax_checkpoint,
    config as jax_config,
    metrics as jax_metrics,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import fused_kernels
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import single, step
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import config, metrics

LR, MOMENTUM = 0.05, 0.5


def _datasets(n_train: int, n_test: int):
    """The same synthetic splits as each package's Dataset."""
    out = []
    for n, seed in ((n_train, 100), (n_test, 101)):
        x, y = mnist._synthesize_split(n, seed)
        out.append((mnist._normalize(x), y.astype(np.int32)))
    port = tuple(mnist.Dataset(x, y, "synthetic") for x, y in out)
    ref = tuple(jax_mnist.Dataset(x, y, "synthetic") for x, y in out)
    return port, ref


def _jax_params(seed: int = 0):
    return JaxNet().init({"params": jax.random.PRNGKey(seed)},
                         jnp.zeros((1, 28, 28, 1)))["params"]


def _assert_params_close(ours: dict, jax_params, atol: float) -> None:
    want = cnn.params_from_jax({k: np.asarray(v) for k, v in jax_params.items()})
    assert set(ours) == set(want)
    for k in want:
        np.testing.assert_allclose(ours[k].detach().numpy(), want[k].numpy(), atol=atol,
                                   err_msg=f"param mismatch at {k}")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_five_train_steps_match_jax(use_pallas):
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(5, 16, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=(5, 16))
    jparams = _jax_params()

    jnet = JaxNet(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    jstate = jax_step.TrainState(jparams, jax.tree_util.tree_map(jnp.zeros_like, jparams),
                                 jnp.zeros((), jnp.int32))
    jfn = jax.jit(jax_step.make_train_step(jnet, learning_rate=LR, momentum=MOMENTUM,
                                           use_pallas=use_pallas))
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    params = cnn.params_from_jax({k: np.asarray(v) for k, v in jparams.items()})
    state = step.TrainState(params, {k: torch.zeros_like(v) for k, v in params.items()}, 0)
    fn = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM, use_pallas=use_pallas)
    for i in range(5):
        jstate, jloss = jfn(jstate, jnp.asarray(xs[i]), jnp.asarray(ys[i], jnp.int32),
                            jax.random.PRNGKey(1))
        state, loss = fn(state, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]), 1)
        np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    assert state.step == int(jstate.step) == 5
    _assert_params_close(state.params, jstate.params, atol=1e-5)


def test_fused_step_updates_in_place_and_plain_step_does_not():
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    x, y = torch.randn(8, 28, 28, 1), torch.randint(0, 10, (8,))
    for use_pallas in (False, True):
        state = step.create_train_state(net, torch.Generator().manual_seed(0))
        before = {k: v.clone() for k, v in state.params.items()}
        fn = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM,
                                  use_pallas=use_pallas)
        new, _ = fn(state, x, y, 0)
        assert (new.params["fc2.bias"] is state.params["fc2.bias"]) == use_pallas
        assert not torch.equal(new.params["fc2.bias"], before["fc2.bias"])


def test_dropout_masks_are_keyed_on_seed_and_step():
    net = cnn.Net()
    x, y = torch.randn(8, 28, 28, 1), torch.randint(0, 10, (8,))
    fn = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM)

    def one_step(seed, at_step):
        state = step.create_train_state(net, torch.Generator().manual_seed(0))
        state = state._replace(step=at_step)
        return fn(state, x, y, seed)[1].item()

    assert one_step(1, 3) == one_step(1, 3)
    assert one_step(1, 3) != one_step(1, 4)
    assert one_step(1, 3) != one_step(2, 3)
    assert step.step_seed(1, 3) == step.step_seed(1, 3) != step.step_seed(3, 1)


def test_segment_fn_equals_stepping():
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    images, labels = torch.randn(40, 28, 28, 1), torch.randint(0, 10, (40,))
    plan = torch.from_numpy(np.random.default_rng(2).permutation(40)[:32].reshape(4, 8))
    fn = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM)
    s1 = step.create_train_state(net, torch.Generator().manual_seed(0))
    s1, losses = step.make_segment_fn(fn)(s1, images, labels, plan, 5)
    s2 = step.create_train_state(net, torch.Generator().manual_seed(0))
    manual = []
    for row in plan:
        s2, loss = fn(s2, images[row], labels[row], 5)
        manual.append(loss)
    assert losses.shape == (4,) and s1.step == s2.step == 4
    torch.testing.assert_close(losses, torch.stack(manual), rtol=0, atol=0)
    for k in s1.params:
        torch.testing.assert_close(s1.params[k], s2.params[k], rtol=0, atol=0)


def test_eval_fn_matches_jax():
    jparams = _jax_params(3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=300)
    j_nll, j_correct = jax_step.make_eval_fn(JaxNet(), batch_size=100)(
        jparams, jnp.asarray(x), jnp.asarray(y, jnp.int32))
    params = cnn.params_from_jax({k: np.asarray(v) for k, v in jparams.items()})
    nll, correct = step.make_eval_fn(cnn.Net(), batch_size=100)(
        params, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(nll.item(), float(j_nll), atol=1e-3, rtol=1e-6)
    assert correct.item() == int(j_correct)
    with pytest.raises(ValueError, match="not divisible"):
        step.make_eval_fn(cnn.Net(), batch_size=7)(params, torch.from_numpy(x),
                                                   torch.from_numpy(y))


SLICE_KW = dict(n_epochs=1, batch_size_train=64, batch_size_test=1000, learning_rate=LR,
                momentum=MOMENTUM, log_interval=2, use_pallas_kernels=True)


class _Slice:
    """The harness of both ``train.single.main``s on the same injected 300/1000 split,
    dropout off, the port starting from the JAX trainer's initial parameters."""

    def __init__(self, tmp_path, monkeypatch):
        self.tmp = tmp_path
        (self.port_ds, self.ref_ds) = _datasets(300, 1000)
        self.captured = {}
        jax_create = jax_single.create_train_state

        def capture(model, rng, **kw):
            state = jax_create(model, rng, **kw)
            self.captured.setdefault("params", {k: np.asarray(v)
                                                for k, v in state.params.items()})
            return state

        def start_from_jax(model, generator, *, optimizer, device, **_):
            params = {k: v.to(device)
                      for k, v in cnn.params_from_jax(self.captured["params"]).items()}
            return step.TrainState(params, optimizer.init(params), 0)

        monkeypatch.setattr(jax_single, "create_train_state", capture)
        monkeypatch.setattr(jax_single, "build_model", lambda *a, **k: JaxNet(
            conv_dropout_rate=0.0, fc_dropout_rate=0.0))
        monkeypatch.setattr(single, "create_train_state", start_from_jax)
        monkeypatch.setattr(single, "build_model", lambda name, **_: cnn.Net(
            conv_dropout_rate=0.0, fc_dropout_rate=0.0))

    def jax(self, name: str, resume_from: str | None = None, **flags):
        cfg = jax_config.SingleProcessConfig(results_dir=str(self.tmp / name / "results"),
                                             images_dir=str(self.tmp / name / "images"),
                                             **SLICE_KW, **flags)
        return jax_single.main(cfg, resume_from=resume_from, datasets=self.ref_ds)

    def port(self, name: str, resume_from: str | None = None, **flags):
        cfg = config.SingleProcessConfig(results_dir=str(self.tmp / name / "results"),
                                         images_dir=str(self.tmp / name / "images"),
                                         device="cpu", **SLICE_KW, **flags)
        return single.main(cfg, resume_from=resume_from, datasets=self.port_ds)


def test_whole_slice_matches_jax_trainer(tmp_path, monkeypatch, capsys):
    """Both ``train.single.main``s, on the same injected 300/1000 split at batch 64 with
    log_interval 2 (two segments of two steps, then a ragged tail of 44), dropout off, from
    the same initial parameters, through the fused kernels."""
    _whole_slice_against_jax(tmp_path, monkeypatch, capsys)


def test_host_pipeline_matches_jax_host_pipeline(tmp_path, monkeypatch, capsys):
    """``--use-host-pipeline`` in both packages on the harness above: host batches through
    each package's native prefetcher, one step a batch, at the same tolerance."""
    out = _whole_slice_against_jax(tmp_path, monkeypatch, capsys, use_host_pipeline=True)
    assert "Host-fed program: eager on cpu" in out and "host batches: native" in out


def _whole_slice_against_jax(tmp_path, monkeypatch, capsys, **flags) -> str:
    harness = _Slice(tmp_path, monkeypatch)
    jstate, jhist = harness.jax("jax", **flags)
    jax_out = capsys.readouterr().out
    state, hist = harness.port("port", **flags)
    port_out = capsys.readouterr().out

    assert state.step == int(jstate.step) == 5
    assert hist.train_counter == jhist.train_counter == [128, 256]
    assert hist.test_counter == jhist.test_counter == [0, 300]
    np.testing.assert_allclose(hist.train_losses, jhist.train_losses, atol=1e-4)
    np.testing.assert_allclose(hist.test_losses, jhist.test_losses, atol=1e-4)
    _assert_params_close(state.params, jstate.params, atol=1e-4)
    assert len(hist.epoch_seconds) == 1
    # The progress lines are the same lines (losses agree to the printed digits or nearly).
    lines = lambda out: [l.split("\tLoss")[0] for l in out.splitlines()
                         if l.startswith("Train Epoch")]
    assert lines(port_out) == lines(jax_out) == ["Train Epoch: 1 [128/300 (43%)]",
                                                 "Train Epoch: 1 [256/300 (85%)]"]
    port_dir = tmp_path / "port" / "results"
    rows = [json.loads(l) for l in open(port_dir / "metrics.jsonl")]
    assert [(r["kind"], r["examples_seen"]) for r in rows] == [
        ("train", 128), ("train", 256), ("test", 0), ("test", 300)]
    # the closing checkpoint holds the final state, in the JAX package's layout
    restored = jax_checkpoint.restore_train_state(str(port_dir / "model.ckpt"), jstate)
    assert int(restored.step) == 5
    for k, v in cnn.params_to_jax(state.params).items():
        np.testing.assert_array_equal(np.asarray(restored.params[k]), v, err_msg=k)
    for png in ("train_images.png", "train_test_curve.png"):
        assert (tmp_path / "port" / "images" / png).stat().st_size > 0
    return port_out


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "fused"])
def test_host_pipeline_epoch_equals_device_resident_epoch_bitwise(tmp_path, use_pallas):
    """The port's host-fed epochs (dropout on, 2 epochs of 11 steps with a ragged tail,
    log_interval 3) against its device-resident epochs on the CPU: every recorded loss, the
    final state, ``metrics.jsonl`` and ``model.ckpt`` bit for bit; the loader's data wait
    recorded once an epoch."""
    (train, test), _ = _datasets(700, 1000)
    runs = {}
    for host in (False, True):
        d = tmp_path / ("host" if host else "device")
        runs[host] = single.main(config.SingleProcessConfig(
            device="cpu", n_epochs=2, log_interval=3, use_pallas_kernels=use_pallas,
            use_host_pipeline=host, results_dir=str(d), images_dir=str(d / "images")),
            datasets=(train, test))
    (d_state, d_hist), (h_state, h_hist) = runs[False], runs[True]
    assert int(h_state.step) == int(d_state.step) == 22
    assert h_hist.train_counter == d_hist.train_counter
    assert h_hist.train_losses == d_hist.train_losses
    assert h_hist.test_losses == d_hist.test_losses
    for tree in ("params", "velocity"):
        for k, v in getattr(d_state, tree).items():
            assert torch.equal(getattr(h_state, tree)[k], v), (tree, k)
    for name in ("metrics.jsonl", "model.ckpt"):
        assert (tmp_path / "host" / name).read_bytes() == \
            (tmp_path / "device" / name).read_bytes(), name
    assert len(h_hist.data_wait_seconds) == 2 and d_hist.data_wait_seconds == []


def test_host_pipeline_cli_trains_one_epoch(tmp_path):
    """``python -m <port>.train.single --device cpu --use-host-pipeline
    --use-pallas-kernels`` end to end on a cut split."""
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "csed_514_project_distributed_training_using_pytorch_tpu_torch"
         ".train.single", "--device", "cpu", "--use-host-pipeline", "--use-pallas-kernels",
         "--n-epochs", "1", "--max-train-examples", "640", "--max-test-examples", "1000",
         "--data-dir", str(tmp_path / "none")],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Host-fed program: eager on cpu" in proc.stdout
    assert proc.stdout.count("Train Epoch: 1 [") == 1          # the tick at 640/640
    assert proc.stdout.count("Test set: Avg. loss") == 2
    assert (tmp_path / "results" / "model.ckpt").stat().st_size > 0


@pytest.mark.parametrize("trainer", ["single", "distributed"])
def test_health_stats_on_the_host_fed_paths_raises_the_jax_message(trainer):
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        distributed,
    )
    if trainer == "single":
        main, cfg = single.main, config.SingleProcessConfig(
            device="cpu", health_stats=True, use_host_pipeline=True)
        flag = "--use-host-pipeline"
    else:
        main, cfg = distributed.main, config.DistributedConfig(
            device="cpu", health_stats=True, host_local_feed=True)
        flag = "--host-local-feed"
    with pytest.raises(ValueError, match=f"not available on the per-batch {flag} path"):
        main(cfg)


def test_progress_bar_draws_the_jax_bar_on_a_terminal_only():
    class Tty(io.StringIO):
        def isatty(self):
            return True

    out = {}
    for name, cls in (("port", metrics.ProgressBar), ("jax", jax_metrics.ProgressBar)):
        tty, pipe = Tty(), io.StringIO()
        for stream in (tty, pipe):
            with cls(3, desc="Epoch 1 ", stream=stream, min_interval_s=0.0) as bar:
                for _ in range(3):
                    bar.update(1)
        assert pipe.getvalue() == ""
        # the rate differs from run to run: compare the bar with it cut out
        out[name] = re.sub(r"\d+\.\dit/s", "R", tty.getvalue())
    assert out["port"] == out["jax"]
    assert out["port"].endswith("Epoch 1 [########################] 3/3 R\n")


def test_single_resume_interoperates_with_jax_trainer(tmp_path, monkeypatch, capsys):
    """``--resume-from`` across the packages, on the harness above (dropout off, atol
    1e-4): the port resumes from the ``model.ckpt`` the JAX trainer wrote and the JAX
    trainer from the port's, and each trajectory matches the other package's own resume
    from the same file, one more epoch ("train n_epochs more") at equal step counts."""
    harness = _Slice(tmp_path, monkeypatch)
    harness.jax("jax")
    harness.port("port")
    for writer in ("jax", "port"):
        ckpt = str(tmp_path / writer / "results" / "model.ckpt")
        jstate, jhist = harness.jax(f"jax_from_{writer}", resume_from=ckpt)
        state, hist = harness.port(f"port_from_{writer}", resume_from=ckpt)
        assert int(state.step) == int(jstate.step) == 10, writer
        assert hist.train_counter == jhist.train_counter == [128, 256]
        np.testing.assert_allclose(hist.train_losses, jhist.train_losses, atol=1e-4,
                                   err_msg=writer)
        np.testing.assert_allclose(hist.test_losses, jhist.test_losses, atol=1e-4,
                                   err_msg=writer)
        _assert_params_close(state.params, jstate.params, atol=1e-4)
    out = capsys.readouterr().out
    assert out.count("Resumed from") == 4 and "at step 5" in out


def test_async_trainer_writes_the_sync_trainers_checkpoints(tmp_path):
    """``--async-checkpoint`` leaves the bytes the synchronous saver leaves: the closing
    ``model.ckpt`` and every versioned file, with the same seed and data."""
    (train, test), _ = _datasets(256, 1000)
    out = {}
    for mode in (False, True):
        d = tmp_path / ("async" if mode else "sync")
        state, _ = single.main(config.SingleProcessConfig(
            device="cpu", n_epochs=2, log_interval=2, use_pallas_kernels=True,
            async_checkpoint=mode, keep_checkpoints=3, results_dir=str(d),
            images_dir=str(d / "images")), datasets=(train, test))
        store = d / "checkpoints"
        out[mode] = {name: (store / name).read_bytes() for name in os.listdir(store)
                     if name.endswith(".msgpack")}
        out[mode]["model.ckpt"] = (d / "model.ckpt").read_bytes()
    assert sorted(out[True]) == ["ckpt_00000004.msgpack", "ckpt_00000008.msgpack",
                                 "model.ckpt"]
    assert out[True] == out[False]
    assert out[True]["model.ckpt"] == out[True]["ckpt_00000008.msgpack"]


def test_main_without_device_cpu_raises_here():
    """The trainer's default device is the card; on a machine without one it raises before
    touching any data instead of quietly training on the CPU."""
    assert config.SingleProcessConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        single.main(config.SingleProcessConfig(data_dir="/nonexistent"))
    with pytest.raises(ValueError, match="unsupported device"):
        single.resolve_device("meta")


def test_main_rejects_unported_optimizer(tmp_path):
    """AdamW is ported: the trainer trains with it (the loss falls over an epoch); an
    optimizer neither package has still raises."""
    (train, test), _ = _datasets(256, 1000)
    state, hist = single.main(config.SingleProcessConfig(
        device="cpu", optimizer="adamw", learning_rate=1e-3, weight_decay=0.01,
        n_epochs=1, log_interval=2, results_dir=str(tmp_path),
        images_dir=str(tmp_path / "images")), datasets=(train, test))
    assert set(state.velocity) == {"m", "v", "count"} and int(state.velocity["count"]) == 4
    assert hist.test_losses[-1] < hist.test_losses[0]
    with pytest.raises(ValueError, match="choose 'sgd' or 'adamw'"):
        single.main(config.SingleProcessConfig(device="cpu", optimizer="lamb"))


def test_parse_config_flags():
    cfg = config.parse_config(config.SingleProcessConfig,
                              ["--use-pallas-kernels", "--device", "cpu", "--n-epochs", "2",
                               "--learning-rate", "0.02"])
    assert (cfg.use_pallas_kernels, cfg.device, cfg.n_epochs, cfg.learning_rate) == (
        True, "cpu", 2, 0.02)
    defaults = config.parse_config(config.SingleProcessConfig, [])
    assert defaults == config.SingleProcessConfig()
    ref = jax_config.SingleProcessConfig()
    for f in ("n_epochs", "batch_size_train", "batch_size_test", "learning_rate", "momentum",
              "optimizer", "log_interval", "seed", "data_dir", "results_dir",
              "use_pallas_kernels"):
        assert getattr(defaults, f) == getattr(ref, f), f
    for f in ("max_train_examples", "max_test_examples", "resume_from", "keep_checkpoints",
              "async_checkpoint", "images_dir", "profile", "profile_dir", "heartbeat_dir",
              "handle_preemption", "download_data", "use_host_pipeline"):
        assert getattr(defaults, f) == getattr(ref, f), f
    cfg = config.parse_config(config.SingleProcessConfig,
                              ["--use-host-pipeline", "--download-data"])
    assert cfg.use_host_pipeline and cfg.download_data
    for f in ("model", "bf16", "remat", "remat_policy", "causal", "attention_window",
              "kv_heads", "rope"):
        assert getattr(defaults, f) == getattr(ref, f), f
    cfg = config.parse_config(config.SingleProcessConfig,
                              ["--model", "transformer", "--bf16", "--rope", "--remat"])
    assert (cfg.model, cfg.bf16, cfg.rope, cfg.remat) == ("transformer", True, True, True)
    with pytest.raises(SystemExit):                   # no abbreviations
        config.parse_config(config.SingleProcessConfig, ["--n-epoch", "2"])
    cfg = config.parse_config(config.SingleProcessConfig,
                              ["--telemetry", "t.jsonl", "--health-stats"])
    assert (cfg.telemetry, cfg.health_stats) == ("t.jsonl", True)


def test_metrics_lines_and_jsonl_match_jax(tmp_path):
    assert metrics.train_progress_line(2, 640, 60000, 0.123456789) == \
        jax_metrics.train_progress_line(2, 640, 60000, 0.123456789)
    assert metrics.test_summary_line(0.4699, 9356, 10000, 12.3456) == \
        jax_metrics.test_summary_line(0.4699, 9356, 10000, 12.3456)
    ours, theirs = metrics.MetricsHistory(), jax_metrics.MetricsHistory()
    for h in (ours, theirs):
        h.record_train(640, 2.25)
        h.record_train(1280, float("nan"))
        h.record_test(0, 2.31)
    metrics.save_metrics_jsonl(ours, str(tmp_path / "a" / "m.jsonl"))
    jax_metrics.save_metrics_jsonl(theirs, str(tmp_path / "b" / "m.jsonl"))
    assert (tmp_path / "a" / "m.jsonl").read_bytes() == (tmp_path / "b" / "m.jsonl").read_bytes()
    watch = metrics.Stopwatch()
    assert 0.0 <= watch.elapsed() < 60.0
    assert not os.path.exists(tmp_path / "a" / "m.jsonl.tmp")


def test_launch_counters_untouched_by_cpu_training():
    fused_kernels.reset_launch_counts()
    net = cnn.Net()
    state = step.create_train_state(net, torch.Generator().manual_seed(0))
    fn = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM, use_pallas=True)
    fn(state, torch.randn(4, 28, 28, 1), torch.randint(0, 10, (4,)), 0)
    assert fused_kernels.launch_counts() == {"nll_fwd": 0, "nll_bwd": 0, "sgd_momentum": 0}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
