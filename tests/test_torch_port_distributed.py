"""PyTorch port, data-parallel slice: the process group, the collectives, the gradient
reducer, the data-parallel trainer, its launcher and its smoke, against the JAX package.

Multi-rank runs are worlds of 2 gloo processes on the CPU, started by the port's launcher
with a hard ``--timeout`` (a hang fails the test, exit 124) and one CPU thread each.

Tolerances: the index plans bitwise; world 2 against world 1 on the concatenated batch
over 3 steps, dropout off, the loss within rtol 1e-5 and the parameters within rtol 1e-4 +
atol 1e-6 (the JAX package's DDP-equivalence oracle: the reduce adds the two halves'
gradients in another order); the port's trainer at world 2 against the JAX trainer on 2
devices, from the same parameters on the same split with dropout off, every recorded loss
within atol 1e-5 (and so with ``--host-local-feed`` in both); sharded against replicated evaluation within rtol 1e-4; a run resumed
from its ``model_dist.ckpt`` against the unbroken run, bitwise (world 1 and world 2).
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.models.cnn import Net as JaxNet
from csed_514_project_distributed_training_using_pytorch_tpu.parallel.sampler import (
    ShardedSampler as JaxSampler,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train import (
    distributed as jax_distributed,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    checkpoint as jax_checkpoint,
    config as jax_config,
    metrics as jax_metrics,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
    data_parallel as dp,
    mesh,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.sampler import (
    ShardedSampler,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
    distributed,
    launch,
    step,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    config,
    determinism,
    metrics,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
FLEET_TIMEOUT = 120            # seconds; the launcher kills the fleet and exits 124
LR, MOMENTUM = 0.05, 0.5
N_TRAIN, N_TEST = 512, 200     # 8 global steps of 64 an epoch; 2 eval batches of 100

# Put at the head of every child's code: the tiny synthetic splits (the same bytes as
# _datasets() below) and one CPU thread per rank.
CHILD_PRELUDE = f"""
import json, sys
import numpy as np
import torch
from {PKG}.data import mnist
from {PKG}.models import cnn
from {PKG}.train import distributed, step
from {PKG}.utils import config
torch.set_num_threads(1)

def datasets():
    out = []
    for n, seed in (({N_TRAIN}, 200), ({N_TEST}, 201)):
        x, y = mnist._synthesize_split(n, seed)
        out.append(mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic"))
    return tuple(out)

def dropout_off():
    distributed.build_model = lambda name, **_: cnn.Net(conv_dropout_rate=0.0,
                                                   fc_dropout_rate=0.0)
"""


def run_fleet(tmp_path, *command, n: int = 2) -> subprocess.CompletedProcess:
    """``python <command>`` as a world of ``n`` through the port's launcher, in
    ``tmp_path``; returns the launcher's exit code and both output streams."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    return subprocess.run(
        [sys.executable, "-m", f"{PKG}.train.launch", "--num-processes", str(n),
         "--timeout", str(FLEET_TIMEOUT), "--", *command],
        capture_output=True, text=True, timeout=FLEET_TIMEOUT + 60, env=env,
        cwd=str(tmp_path))


def child(code: str) -> list[str]:
    return ["-c", CHILD_PRELUDE + textwrap.dedent(code)]


def _datasets():
    """The children's splits, as each package's Dataset."""
    out = []
    for n, seed in ((N_TRAIN, 200), (N_TEST, 201)):
        x, y = mnist._synthesize_split(n, seed)
        out.append((mnist._normalize(x), y.astype(np.int32)))
    port = tuple(mnist.Dataset(x, y, "synthetic") for x, y in out)
    ref = tuple(jax_mnist.Dataset(x, y, "synthetic") for x, y in out)
    return port, ref


def _summaries(out: str) -> list[tuple[int, float, float, float]]:
    """(epoch, train_loss, val_loss, accuracy) of every epoch summary line."""
    pat = r"Epoch (\d+): train_loss: ([\d.]+), val_loss: ([\d.]+), accuracy: ([\d.]+)"
    return [(int(e), float(t), float(v), float(a)) for e, t, v, a in re.findall(pat, out)]


# -- the plan, the backend rule, the group ---------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 4])
def test_epoch_index_plan_matches_jax_bitwise(world):
    per = 64 // world
    ours = [ShardedSampler(1000, num_replicas=world, rank=r, seed=42) for r in range(world)]
    theirs = [JaxSampler(1000, num_replicas=world, rank=r, seed=42) for r in range(world)]
    for epoch in (0, 1, 5):
        got = distributed.epoch_index_plan(ours, epoch, per)
        want = jax_distributed.epoch_index_plan(theirs, epoch, per)
        assert got.shape == (1000 // world // per, 64)
        np.testing.assert_array_equal(got, want)


def test_backend_rule():
    assert mesh.choose_backend("cuda", 1, 1) == "nccl"
    assert mesh.choose_backend("cuda", 4, 4) == "nccl"
    assert mesh.choose_backend("cuda", 2, 1) == "gloo"      # two ranks share one card
    assert mesh.choose_backend("cpu", 1, 0) == "gloo"
    assert mesh.choose_backend("cpu", 2, 8) == "gloo"


def test_world_of_one_on_a_local_store_is_created_and_destroyed(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert not dist.is_initialized()
    with mesh.cluster("cpu") as info:
        assert (info.process_index, info.process_count, info.backend) == (0, 1, "gloo")
        assert info.is_coordinator and info.device == torch.device("cpu")
        with mesh.cluster("cpu") as inner:            # an existing group is reused
            assert inner == info
        assert dist.is_initialized()
        x = torch.arange(3.0)
        assert torch.equal(collectives.all_reduce_sum(x), x)
        assert torch.equal(collectives.ring_pass(x), x)
        assert torch.equal(collectives.all_gather(x), x[None])
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="unsupported device"):
        mesh.initialize_cluster("meta")


def test_missing_peer_fails_within_the_timeout(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(launch._free_port()))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="cluster rendezvous failed"):
        mesh.initialize_cluster("cpu", timeout_s=1)
    assert not dist.is_initialized()
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        mesh.initialize_cluster("cpu")


# -- the step and the reducer ----------------------------------------------------------


def _step_data(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(64, 28, 28, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=64))
    return x, y


def test_world_of_one_reducer_step_equals_plain_step_bitwise():
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    x, y = _step_data()
    plain = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM)
    s_plain = step.create_train_state(net, torch.Generator().manual_seed(0))
    with mesh.cluster("cpu"):
        s_dp = step.create_train_state(net, torch.Generator().manual_seed(0))
        reducer = dp.GradReducer(s_dp.params)
        assert reducer.numel == cnn.param_count(s_dp.params) == 21840
        reduced = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM,
                                       grad_reduce=reducer, rank=0)
        for _ in range(3):
            s_plain, l_plain = plain(s_plain, x, y, 1)
            s_dp, l_dp = reduced(s_dp, x, y, 1)
            assert torch.equal(l_plain, l_dp)
        assert reducer.calls == 3                     # one all-reduce a step
    for k in s_plain.params:
        assert torch.equal(s_plain.params[k], s_dp.params[k]), k


def test_rank_zero_draws_the_single_process_masks():
    assert step.step_seed(1, 3, 0) == step.step_seed(1, 3)
    assert len({step.step_seed(1, 3, r) for r in range(4)}) == 4
    net = cnn.Net()
    x, y = _step_data(1)
    s = step.create_train_state(net, torch.Generator().manual_seed(0))
    fn = lambda rank: step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM,
                                           rank=rank)(s, x, y, 1)[1].item()
    assert fn(0) == step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM)(
        s, x, y, 1)[1].item()
    assert fn(0) != fn(1)


ORACLE_CHILD = """
import torch.distributed as dist
from {pkg}.parallel import data_parallel as dp, mesh
with mesh.cluster("cpu") as info:
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.normal(size=(64, 28, 28, 1)).astype(np.float32))
    y = torch.from_numpy(g.integers(0, 10, size=64))
    rows = slice(32 * info.process_index, 32 * (info.process_index + 1))
    state = step.create_train_state(net, torch.Generator().manual_seed(7))
    fn = step.make_train_step(net, learning_rate={lr}, momentum={mom},
                              grad_reduce=dp.GradReducer(state.params),
                              rank=info.process_index)
    losses = []
    for _ in range(3):
        state, loss = fn(state, x[rows], y[rows], 1)
        losses.append(loss.item())
    if info.is_coordinator:
        np.savez("oracle.npz", losses=np.array(losses),
                 **{{k: v.numpy() for k, v in state.params.items()}})
"""


def test_two_ranks_equal_one_rank_on_the_concatenated_batch(tmp_path):
    """The DDP-equivalence oracle: world 2 (gloo, two processes, 32 rows each) against
    world 1 on the concatenated 64 rows, 3 steps, dropout off."""
    proc = run_fleet(tmp_path, *child(ORACLE_CHILD.format(pkg=PKG, lr=LR, mom=MOMENTUM)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(tmp_path / "oracle.npz")
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    x, y = _step_data()
    with mesh.cluster("cpu"):
        state = step.create_train_state(net, torch.Generator().manual_seed(7))
        fn = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM,
                                  grad_reduce=dp.GradReducer(state.params))
        losses = []
        for _ in range(3):
            state, loss = fn(state, x, y, 1)
            losses.append(loss.item())
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for k, v in state.params.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


# -- the trainer -----------------------------------------------------------------------


PARITY_CHILD = """
dropout_off()
params = dict(np.load("jax_params.npz"))
def start(model, generator, *, optimizer, device, **_):
    p = {k: v.to(device) for k, v in cnn.params_from_jax(params).items()}
    return step.TrainState(p, optimizer.init(p), 0)
distributed.create_train_state = start
cfg = config.DistributedConfig(**json.loads(sys.argv[1]))
distributed.main(cfg, datasets=datasets())
"""


def _world_2_against_jax(tmp_path, monkeypatch, capsys, **flags) -> str:
    """Both ``distributed.main``s on the same 512/200 split, global batch 64 over 2
    replicas, 2 epochs, log_interval 2, dropout off, from the same parameters, with
    ``flags`` set in both packages' configs; returns the port's rank-0 output."""
    kw = dict(epochs=2, global_batch_size=64, batch_size_test=100, learning_rate=LR,
              momentum=MOMENTUM, log_interval=2, **flags)
    _, (ref_train, ref_test) = _datasets()
    captured = {}
    jax_create = jax_distributed.create_train_state

    def capture(model, rng, **k):
        state = jax_create(model, rng, **k)
        captured.update({n: np.asarray(v) for n, v in state.params.items()})
        return state

    monkeypatch.setattr(jax_distributed, "create_train_state", capture)
    monkeypatch.setattr(jax_distributed, "build_model", lambda *a, **k: JaxNet(
        conv_dropout_rate=0.0, fc_dropout_rate=0.0))
    jcfg = jax_config.DistributedConfig(results_dir=str(tmp_path / "jax" / "results"),
                                        images_dir=str(tmp_path / "jax" / "images"), **kw)
    _, jhist = jax_distributed.main(jcfg, num_devices=2, datasets=(ref_train, ref_test))
    jax_out = capsys.readouterr().out
    np.savez(tmp_path / "jax_params.npz", **captured)

    proc = run_fleet(tmp_path, *child(PARITY_CHILD),
                     json.dumps(dict(kw, device="cpu", results_dir="port")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Distributed training: 2 devices on 2 process(es)" in proc.stdout
    assert "Collective backend: gloo" in proc.stdout
    ours, theirs = _summaries(proc.stdout), _summaries(jax_out)
    assert [e for e, *_ in ours] == [e for e, *_ in theirs] == [0, 1]   # rank 0 alone
    rows = [json.loads(l) for l in open(tmp_path / "port" / "metrics.jsonl")]
    train = [(r["examples_seen"], r["loss"]) for r in rows if r["kind"] == "train"]
    test = [(r["examples_seen"], r["loss"]) for r in rows if r["kind"] == "test"]
    assert [e for e, _ in train] == jhist.train_counter
    assert [e for e, _ in test] == jhist.test_counter == [512, 1024]
    np.testing.assert_allclose([l for _, l in train], jhist.train_losses, atol=1e-5)
    np.testing.assert_allclose([l for _, l in test], jhist.test_losses, atol=1e-5)
    # the printed per-epoch means (4 decimals) agree to the printed digits
    np.testing.assert_allclose([o[1:3] for o in ours], [t[1:3] for t in theirs], atol=2e-4)
    assert proc.stdout.count("Train Epoch: 0 [128/512 (25%)]") == 1
    return proc.stdout


def test_trainer_at_world_2_matches_jax_trainer_on_2_devices(tmp_path, monkeypatch, capsys):
    """The device-resident split on each rank, against the JAX trainer's scanned epoch."""
    out = _world_2_against_jax(tmp_path, monkeypatch, capsys)
    assert "Segment program: eager on cpu" in out


def test_host_local_feed_at_world_2_matches_jax_host_local_feed(tmp_path, monkeypatch,
                                                               capsys):
    """``--host-local-feed`` in both packages: each rank of the gloo world feeds its own
    column block of every global batch from host memory, one step a batch; the JAX trainer
    assembles its 2-device batch from the host-local rows. The recorded losses agree
    within atol 1e-5, the printed means to their digits."""
    out = _world_2_against_jax(tmp_path, monkeypatch, capsys, host_local_feed=True)
    assert "Host-local feed: this process feeds global-batch columns [0:32]" in out
    assert "Host-fed program: eager on cpu" in out
    assert "Segment program" not in out


def test_trainer_trains_the_step_options_like_jax_at_world_1(tmp_path, monkeypatch, capsys):
    """AdamW (once rejected here) with decay, a cosine schedule with warmup, clipping,
    label smoothing, the EMA, gradient accumulation, the guard and the pregathered
    segment: the port at world 1 (gloo, in process) against the JAX trainer on 1 device,
    same split, same parameters, dropout off; every recorded loss within atol 1e-5."""
    kw = dict(epochs=2, global_batch_size=64, batch_size_test=100, momentum=MOMENTUM,
              log_interval=2, optimizer="adamw", learning_rate=2e-3, weight_decay=0.01,
              lr_schedule="cosine", warmup_steps=3, clip_grad_norm=1.0,
              label_smoothing=0.1, ema_decay=0.9, grad_accum=2, guard=True, pregather=True)
    (port_train, port_test), (ref_train, ref_test) = _datasets()
    captured = {}
    jax_create = jax_distributed.create_train_state

    def capture(model, rng, **k):
        state = jax_create(model, rng, **k)
        captured.update({n: np.asarray(v) for n, v in state.params.items()})
        return state

    monkeypatch.setattr(jax_distributed, "create_train_state", capture)
    monkeypatch.setattr(jax_distributed, "build_model", lambda *a, **k: JaxNet(
        conv_dropout_rate=0.0, fc_dropout_rate=0.0))
    jcfg = jax_config.DistributedConfig(results_dir=str(tmp_path / "jax" / "results"),
                                        images_dir=str(tmp_path / "jax" / "images"), **kw)
    _, jhist = jax_distributed.main(jcfg, num_devices=1, datasets=(ref_train, ref_test))

    port_create = distributed.create_train_state

    def start(model, generator, **k):
        state = port_create(model, generator, **k)
        params = cnn.params_from_jax(captured)
        return state._replace(params=params, velocity=k["optimizer"].init(params),
                              ema={n: p.clone() for n, p in params.items()})

    monkeypatch.setattr(distributed, "create_train_state", start)
    monkeypatch.setattr(distributed, "build_model", lambda name, **_: cnn.Net(
        conv_dropout_rate=0.0, fc_dropout_rate=0.0))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    capsys.readouterr()
    state, hist = distributed.main(config.DistributedConfig(
        device="cpu", results_dir=str(tmp_path / "port"),
        images_dir=str(tmp_path / "port" / "images"), **kw),
        datasets=(port_train, port_test))
    out = capsys.readouterr().out
    assert "Segment program: eager on cpu" in out
    assert int(state.step) == 16 and int(state.guard.anomalies) == 0
    assert int(state.guard.count) == 16
    assert hist.train_counter == jhist.train_counter
    np.testing.assert_allclose(hist.train_losses, jhist.train_losses, atol=1e-5)
    np.testing.assert_allclose(hist.test_losses, jhist.test_losses, atol=1e-5)


def _world_1(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)


def _equal_states(a, b) -> None:
    assert int(a.step) == int(b.step)
    for tree in ("params", "velocity"):
        for k, v in getattr(a, tree).items():
            assert torch.equal(v, getattr(b, tree)[k]), (tree, k)


def test_world_1_resume_equals_the_unbroken_run_bitwise(tmp_path, monkeypatch):
    """2 epochs straight against 1 epoch, then ``--epochs 2 --resume-from
    model_dist.ckpt``, dropout on (the masks are a function of seed, step and rank), at
    world 1 on a local gloo store: the same parameters, velocity and step, bitwise; the
    resumed run trains epoch 1 alone and records the same losses for it."""
    _world_1(monkeypatch)
    (train, test), _ = _datasets()
    kw = dict(global_batch_size=64, batch_size_test=100, learning_rate=LR,
              momentum=MOMENTUM, log_interval=2, device="cpu")
    cfg = lambda name, **more: config.DistributedConfig(
        results_dir=str(tmp_path / name), images_dir=str(tmp_path / name / "img"),
        **kw, **more)
    straight, s_hist = distributed.main(cfg("straight", epochs=2), datasets=(train, test))
    distributed.main(cfg("first", epochs=1), datasets=(train, test))
    ckpt = str(tmp_path / "first" / "model_dist.ckpt")
    resumed, r_hist = distributed.main(cfg("resumed", epochs=2, resume_from=ckpt),
                                       datasets=(train, test))
    _equal_states(resumed, straight)
    assert int(resumed.step) == 2 * (N_TRAIN // 64)
    assert r_hist.train_counter == s_hist.train_counter[len(r_hist.train_counter):]
    assert r_hist.train_losses == s_hist.train_losses[len(r_hist.train_losses):]
    assert r_hist.test_losses == s_hist.test_losses[1:]
    assert (tmp_path / "resumed" / "model_dist.ckpt").read_bytes() == \
        (tmp_path / "straight" / "model_dist.ckpt").read_bytes()
    assert (tmp_path / "straight" / "img" / "train_test_curve_dist.png").is_file()


@pytest.mark.parametrize("ema", [False, True])
def test_model_dist_export_loads_through_jax_load_params(tmp_path, monkeypatch, ema):
    """Rank 0's ``model_dist.msgpack`` is the JAX package's params export: its
    ``load_params`` reads it equal to ``params_to_jax`` of the final params, or of the EMA
    under ``--ema-decay``."""
    _world_1(monkeypatch)
    (train, test), _ = _datasets()
    state, _ = distributed.main(config.DistributedConfig(
        epochs=1, batch_size_test=100, device="cpu", ema_decay=0.9 if ema else 0.0,
        results_dir=str(tmp_path), images_dir=str(tmp_path / "img")),
        datasets=(train, test))
    reference = JaxNet().init({"params": jax.random.PRNGKey(0)},
                              jnp.zeros((1, 28, 28, 1)))["params"]
    got = jax_checkpoint.load_params(str(tmp_path / "model_dist.msgpack"), reference)
    want = cnn.params_to_jax(state.ema if ema else state.params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    if ema:
        assert not all(torch.equal(state.ema[k], p) for k, p in state.params.items())


RESUME_CHILD = """
from {pkg}.parallel import mesh
out = {{}}
with mesh.cluster("cpu") as info:
    kw = dict(global_batch_size=64, batch_size_test=100, learning_rate=0.05, device="cpu")
    for name, epochs, resume in (("straight", 2, ""), ("first", 1, ""),
                                 ("resumed", 2, "first/model_dist.ckpt")):
        cfg = config.DistributedConfig(epochs=epochs, resume_from=resume, results_dir=name,
                                       images_dir=name + "/img", **kw)
        state, _ = distributed.main(cfg, datasets=datasets())
        out[name] = {{k: v.numpy() for k, v in state.params.items()}}
        out[name]["step"] = np.asarray(int(state.step))
np.savez(f"rank{{info.process_index}}.npz",
         **{{f"{{n}}/{{k}}": v for n, d in out.items() for k, v in d.items()}})
"""


def test_world_2_resume_keeps_the_replicas_equal(tmp_path):
    """At world 2 under the launcher (gloo), rank 0 restores ``model_dist.ckpt`` and
    broadcasts it: the resumed run's replicas agree bitwise, and equal the unbroken run's
    (main()'s closing replica check passes too)."""
    proc = run_fleet(tmp_path, *child(RESUME_CHILD.format(pkg=PKG)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("Resumed from first/model_dist.ckpt at step 8 (starting "
                             "epoch 1)") == 1
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for key in ranks[0].files:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
        if key.startswith("resumed/"):
            np.testing.assert_array_equal(ranks[0][key],
                                          ranks[0]["straight/" + key.split("/", 1)[1]],
                                          err_msg=key)
    assert int(ranks[1]["resumed/step"]) == 16


SHARD_EVAL_CHILD = """
from {pkg}.parallel import mesh
dropout_off()
out = {{}}
with mesh.cluster("cpu") as info:          # both runs share one group
    for shard in (False, True):
        cfg = config.DistributedConfig(epochs=1, batch_size_test=50, learning_rate=0.05,
                                       shard_eval=shard, device="cpu",
                                       results_dir=f"r{{int(shard)}}")
        _, hist = distributed.main(cfg, datasets=datasets())
        out[str(shard)] = hist.test_losses
if info.is_coordinator:
    json.dump(out, open("eval.json", "w"))
"""


def test_shard_eval_gives_the_replicated_metrics(tmp_path):
    proc = run_fleet(tmp_path, *child(SHARD_EVAL_CHILD.format(pkg=PKG)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.load(open(tmp_path / "eval.json"))
    np.testing.assert_allclose(got["True"], got["False"], rtol=1e-4)
    summaries = _summaries(proc.stdout)
    assert len(summaries) == 2 and summaries[0][2:] == pytest.approx(summaries[1][2:],
                                                                      rel=1e-3)


def test_indivisible_global_batch_raises(tmp_path):
    proc = run_fleet(tmp_path, *child(
        "distributed.main(config.DistributedConfig(global_batch_size=63, device='cpu'),"
        " datasets=datasets())"))
    assert proc.returncode == 1
    assert "global batch 63 not divisible by world size 2" in proc.stderr


def test_device_cuda_without_card_raises():
    """The trainer's default device is the card; without one it raises before the
    rendezvous instead of quietly training on the CPU."""
    assert config.DistributedConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.main(config.DistributedConfig(data_dir="/nonexistent"))
    assert not dist.is_initialized()


UNPORTED = [["--plan", "auto"], ["--epoch", "2"]]
MODEL_FIELDS = ("model", "bf16", "remat", "remat_policy", "causal", "attention_window",
                "kv_heads", "rope")


def test_config_keeps_jax_defaults_and_rejects_unported_flags():
    defaults = config.parse_config(config.DistributedConfig, [])
    assert defaults == config.DistributedConfig()
    ref = jax_config.DistributedConfig()
    for f in ("epochs", "global_batch_size", "batch_size_test", "learning_rate", "momentum",
              "optimizer", "log_interval", "seed", "sampler_seed", "data_dir", "results_dir",
              "shard_eval", "max_train_examples", "max_test_examples", "resume_from",
              "keep_checkpoints", "async_checkpoint", "images_dir", "profile", "profile_dir",
              "heartbeat_dir", "handle_preemption", "download_data", "host_local_feed",
              "fsdp", *MODEL_FIELDS):
        assert getattr(defaults, f) == getattr(ref, f), f
    cfg = config.parse_config(config.DistributedConfig,
                              ["--shard-eval", "--device", "cpu", "--epochs", "2"])
    assert (cfg.shard_eval, cfg.device, cfg.epochs) == (True, "cpu", 2)
    cfg = config.parse_config(config.DistributedConfig,
                              ["--model", "transformer", "--bf16", "--kv-heads", "2"])
    assert (cfg.model, cfg.bf16, cfg.kv_heads) == ("transformer", True, 2)
    for argv in UNPORTED:
        with pytest.raises(SystemExit):
            config.parse_config(config.DistributedConfig, argv)
    cfg = config.parse_config(config.DistributedConfig,
                              ["--telemetry", "t.jsonl", "--health-stats"])
    assert (cfg.telemetry, cfg.health_stats) == ("t.jsonl", True)
    with pytest.raises(ValueError, match="choose 'sgd' or 'adamw'"):
        distributed.main(config.DistributedConfig(device="cpu", optimizer="lamb"))


# -- the replica check, the smoke, the launcher, the logging gate ----------------------


SYNC_CHILD = """
from {pkg}.parallel import mesh
from {pkg}.utils import determinism
with mesh.cluster("cpu") as info:
    params = cnn.Net().init(torch.Generator().manual_seed(0))
    determinism.assert_replicas_synced(params)           # equal replicas pass
    if info.process_index == 1:
        params["fc2.bias"][0] += 0.01
    try:
        determinism.assert_replicas_synced(params)
    except RuntimeError as e:
        assert "desync" in str(e), e
        print(f"rank {{info.process_index}} raised", flush=True)
    else:
        raise SystemExit(f"rank {{info.process_index}}: the desync went unseen")
"""


def test_assert_replicas_synced_raises_on_a_perturbed_rank(tmp_path):
    proc = run_fleet(tmp_path, *child(SYNC_CHILD.format(pkg=PKG)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "rank 0 raised" in proc.stdout and "rank 1 raised" in proc.stdout
    params = cnn.Net().init(torch.Generator().manual_seed(0))
    determinism.assert_replicas_synced(params)            # no group: a no-op
    assert determinism.param_fingerprint(params) == pytest.approx(
        sum(float(p.abs().sum()) for p in params.values()), rel=1e-6)


def test_smoke_ring_at_world_2(tmp_path):
    proc = run_fleet(tmp_path, "-m", f"{PKG}.train.smoke", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "smoke: 2 process(es), backend gloo" in proc.stdout
    assert proc.stdout.count("Device 1 has data 0.0") == 1        # rank 0 prints alone
    assert "Device 0 has data 1.0" in proc.stdout
    assert "OK — rendezvous + ring p2p verified" in proc.stdout


@pytest.mark.parametrize("case", ["child_exit_3", "timeout", "all_ok"])
def test_launcher_exit_codes(case):
    code = {"child_exit_3": "import os, sys; sys.exit(3 if os.environ['RANK'] == '1' "
                            "else 0)",
            "timeout": "import time; time.sleep(60)",
            "all_ok": "import os; assert os.environ['WORLD_SIZE'] == '2'"}[case]
    rc = launch.launch(["-c", code], num_processes=2, timeout=3)
    assert rc == {"child_exit_3": 3, "timeout": 124, "all_ok": 0}[case]


def test_metrics_log_is_rank0_gated_and_lines_match_jax(monkeypatch, capsys):
    assert metrics.dist_epoch_summary_line(2, 0.5, 0.4, 0.9, 12.3) == \
        jax_metrics.dist_epoch_summary_line(2, 0.5, 0.4, 0.9, 12.3)
    monkeypatch.setenv("RANK", "1")
    metrics.log("from rank 1")
    monkeypatch.setenv("RANK", "0")
    metrics.log("from rank 0")
    assert capsys.readouterr().out == "from rank 0\n"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
