"""PyTorch port, the training step's remainder and the segment program, against the JAX
package's ``train/step.py``.

The same inputs, made from a numpy seed, and the same initial parameters (the JAX
package's, carried over by ``cnn.params_from_jax``) go through both packages' steps with
dropout off. Tolerances: 20-step trajectories within 1e-5 in every loss, parameter, EMA and
AdamW moment (float32 sums in another order, compounded over 20 updates); the segment
program's losses, parameters and health accumulators within 1e-5 of the JAX scan. On the
CPU the segment program is the eager loop; the captured CUDA graph is held against it on
the card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` [20]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.models.cnn import Net as JaxNet
from csed_514_project_distributed_training_using_pytorch_tpu.ops import optim as jax_optim
from csed_514_project_distributed_training_using_pytorch_tpu.train import step as jax_step
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    config as jax_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import nn as port_nn
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import optim
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
    composed,
    distributed,
    single,
    step,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import config

LR, MOMENTUM, ATOL = 0.05, 0.5, 1e-5
STEPS, BATCH = 20, 16


def _jax_params(seed: int = 0):
    return JaxNet().init({"params": jax.random.PRNGKey(seed)},
                         jnp.zeros((1, 28, 28, 1)))["params"]


def _to_port(tree) -> dict[str, torch.Tensor]:
    return cnn.params_from_jax({k: np.asarray(v) for k, v in tree.items()})


def _assert_tree_close(ours: dict, theirs, what: str) -> None:
    want = _to_port(theirs)
    for k in want:
        np.testing.assert_allclose(ours[k].detach().numpy(), want[k].numpy(), atol=ATOL,
                                   rtol=0, err_msg=f"{what} mismatch at {k}")


def _data(seed: int):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(STEPS, BATCH, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=(STEPS, BATCH))
    return xs, ys


SETTINGS = {
    # (a) the fused kernels (their plain versions here; Pallas interpret mode in JAX),
    # gradient accumulation over 4 microbatches, clipping and the EMA
    "a-fused-accum-clip-ema": dict(use_pallas=True, grad_accum=4, clip_grad_norm=0.5,
                                   ema_decay=0.9),
    # (b) AdamW with decay, a cosine schedule with warmup, label smoothing and clipping
    "b-adamw-cosine-smoothing-clip": dict(optimizer="adamw", schedule=("cosine", 5),
                                          label_smoothing=0.1, clip_grad_norm=1.0),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_twenty_step_trajectory_matches_jax(setting):
    kw = dict(SETTINGS[setting])
    xs, ys = _data(1)
    jparams = _jax_params()
    adam = kw.pop("optimizer", None) == "adamw"
    schedule = kw.pop("schedule", None)
    j_opt = jax_optim.adamw(2e-3, weight_decay=0.01) if adam else None
    p_opt = optim.adamw(2e-3, weight_decay=0.01) if adam else None
    j_sched = p_sched = None
    if schedule:
        j_sched = jax_optim.make_lr_schedule(schedule[0], warmup_steps=schedule[1],
                                             total_steps=STEPS)
        p_sched = optim.make_lr_schedule(schedule[0], warmup_steps=schedule[1],
                                         total_steps=STEPS)
    ema = kw.get("ema_decay", 0.0) > 0
    jstate = jax_step.TrainState(
        jparams, (j_opt.init(jparams) if adam else jax_optim.sgd_init(jparams)),
        jnp.zeros((), jnp.int32), ema=jax.tree_util.tree_map(jnp.array, jparams) if ema
        else None)
    jfn = jax.jit(jax_step.make_train_step(
        JaxNet(conv_dropout_rate=0.0, fc_dropout_rate=0.0), learning_rate=LR,
        momentum=MOMENTUM, optimizer=j_opt, lr_schedule=j_sched, **kw))
    params = _to_port(jparams)
    state = step.TrainState(params, (p_opt.init(params) if adam else optim.sgd_init(params)),
                            torch.zeros((), dtype=torch.int64),
                            ema={k: p.clone() for k, p in params.items()} if ema else None)
    fn = step.make_train_step(cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0),
                              learning_rate=LR, momentum=MOMENTUM, optimizer=p_opt,
                              lr_schedule=p_sched, **kw)
    for i in range(STEPS):
        jstate, jloss = jfn(jstate, jnp.asarray(xs[i]), jnp.asarray(ys[i], jnp.int32),
                            jax.random.PRNGKey(1))
        state, loss = fn(state, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]), 1)
        np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL, rtol=0,
                                   err_msg=f"loss at step {i}")
    assert int(state.step) == int(jstate.step) == STEPS
    _assert_tree_close(state.params, jstate.params, "params")
    if ema:
        _assert_tree_close(state.ema, jstate.ema, "ema")
    if adam:
        assert int(state.velocity["count"]) == int(jstate.velocity["count"]) == STEPS
        _assert_tree_close(state.velocity["m"], jstate.velocity["m"], "adam m")
        _assert_tree_close(state.velocity["v"], jstate.velocity["v"], "adam v")


@pytest.mark.parametrize("pregather", [False, True])
@pytest.mark.parametrize("health", [False, True])
def test_epoch_fn_matches_the_jax_scan(pregather, health):
    x, y = mnist._synthesize_split(96, 31)
    images, labels = mnist._normalize(x), y.astype(np.int64)
    plan = np.random.default_rng(3).permutation(96)[:80].reshape(5, 16)
    jparams = _jax_params(2)
    jstate = jax_step.TrainState(jparams, jax_optim.sgd_init(jparams),
                                 jnp.zeros((), jnp.int32))
    jepoch = jax.jit(jax_step.make_epoch_fn(
        JaxNet(conv_dropout_rate=0.0, fc_dropout_rate=0.0), learning_rate=LR,
        momentum=MOMENTUM, pregather=pregather, clip_grad_norm=2.0, health=health))
    jstate, jout = jepoch(jstate, jnp.asarray(images), jnp.asarray(labels, jnp.int32),
                          jnp.asarray(plan, jnp.int32), jax.random.PRNGKey(1))
    params = _to_port(jparams)
    state = step.TrainState(params, optim.sgd_init(params),
                            torch.zeros((), dtype=torch.int64))
    epoch = step.make_epoch_fn(cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0),
                               learning_rate=LR, momentum=MOMENTUM, pregather=pregather,
                               clip_grad_norm=2.0, health=health)
    state, out = epoch(state, torch.from_numpy(images), torch.from_numpy(labels),
                       torch.from_numpy(plan), 1)
    losses, jlosses = (out[0], jout[0]) if health else (out, jout)
    assert losses.shape == (5,) and int(state.step) == int(jstate.step) == 5
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), atol=ATOL, rtol=0)
    _assert_tree_close(state.params, jstate.params, "params")
    if health:
        for field in step.HealthStats._fields:
            np.testing.assert_allclose(float(getattr(out[1], field)),
                                       float(getattr(jout[1], field)), atol=ATOL,
                                       rtol=1e-6, err_msg=field)


def test_health_accumulators_merge_like_jax():
    rng = np.random.default_rng(5)
    pairs = rng.uniform(0.1, 3.0, size=(6, 2)).astype(np.float32)
    ours, theirs = step.init_health(), jax_step.init_health()
    halves = []
    for part in (pairs[:3], pairs[3:]):
        h, jh = step.init_health(), jax_step.init_health()
        for loss, norm in part:
            h = step.update_health(h, torch.tensor(loss), torch.tensor(norm))
            jh = jax_step.update_health(jh, jnp.asarray(loss), jnp.asarray(norm))
        halves.append((h, jh))
    ours = step.merge_health(halves[0][0], halves[1][0])
    theirs = jax_step.merge_health(halves[0][1], halves[1][1])
    for field in step.HealthStats._fields:
        np.testing.assert_allclose(float(getattr(ours, field)),
                                   float(getattr(theirs, field)), rtol=1e-6)


def test_use_pallas_raises_where_jax_raises():
    net, jnet = cnn.Net(), JaxNet()
    cases = [dict(optimizer=("adamw",)), dict(lr_schedule=True), dict(label_smoothing=0.1),
             dict(loss_fn=True)]
    for case in cases:
        ours = {k: v for k, v in case.items()}
        theirs = dict(ours)
        if "optimizer" in case:
            ours["optimizer"], theirs["optimizer"] = optim.adamw(0.01), jax_optim.adamw(0.01)
        if "lr_schedule" in case:
            ours["lr_schedule"] = optim.make_lr_schedule("constant", warmup_steps=2)
            theirs["lr_schedule"] = jax_optim.make_lr_schedule("constant", warmup_steps=2)
        if "loss_fn" in case:
            ours["loss_fn"] = theirs["loss_fn"] = lambda *a: 0.0
        with pytest.raises(ValueError) as got:
            step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM, use_pallas=True,
                                 **ours)
        with pytest.raises(ValueError) as want:
            jax_step.make_train_step(jnet, learning_rate=LR, momentum=MOMENTUM,
                                     use_pallas=True, **theirs)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="grad_accum must be >= 1"):
        step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM, grad_accum=0)


def test_ema_and_guard_need_their_state():
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    x, y = torch.randn(8, 28, 28, 1), torch.randint(0, 10, (8,))
    bare = step.create_train_state(net, torch.Generator().manual_seed(0))
    assert bare.ema is None and bare.guard is None and bare.step.dtype == torch.int64
    with pytest.raises(ValueError, match="ema=True"):
        step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM,
                             ema_decay=0.9)(bare, x, y, 1)
    with pytest.raises(ValueError, match="guard=True"):
        step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM,
                             guard=step.GuardSpec())(bare, x, y, 1)
    full = step.create_train_state(net, torch.Generator().manual_seed(0), ema=True,
                                   guard=True)
    assert all(torch.equal(full.ema[k], full.params[k]) for k in full.params)
    assert full.ema["fc2.bias"] is not full.params["fc2.bias"]
    assert [int(t) for t in full.guard] == [0, 0, 0, 0, 0, 0, 0, -1, -1]


def test_dropout_key_on_the_device_equals_its_host_mirror():
    steps = torch.arange(0, 2000, 97, dtype=torch.int64)
    for seed, rank in ((1, 0), (1, 3), (12345, 1)):
        keys = step.dropout_key(seed, steps, rank)
        assert keys.tolist() == [step.step_seed(seed, int(s), rank) for s in steps]
        assert bool(((keys >= 0) & (keys < 2 ** 32)).all())
    assert len({step.step_seed(1, s) for s in range(1000)}) == 1000


def test_dropout_stream_keeps_at_the_rate_and_draws_distinct_masks():
    cpu = torch.device("cpu")
    stream = port_nn.DropoutStream(torch.tensor(step.step_seed(1, 0)))
    m1 = stream.keep_mask((256, 512), 0.5, cpu)
    m2 = stream.keep_mask((256, 512), 0.5, cpu)
    assert m1.dtype == torch.bool and m1.shape == (256, 512)
    assert float(m1.float().mean()) == pytest.approx(0.5, abs=0.005)
    assert float((m1 == m2).float().mean()) == pytest.approx(0.5, abs=0.005)  # independent
    other = port_nn.DropoutStream(torch.tensor(step.step_seed(1, 1))).keep_mask(
        (256, 512), 0.5, cpu)
    assert float((m1 == other).float().mean()) == pytest.approx(0.5, abs=0.005)
    again = port_nn.DropoutStream(lambda: torch.tensor(step.step_seed(1, 0)))
    assert torch.equal(again.keep_mask((256, 512), 0.5, cpu), m1)   # a function of the key
    kept = port_nn.dropout(port_nn.DropoutStream(torch.tensor(7)), torch.ones(4000), 0.25,
                           deterministic=False)
    assert float((kept > 0).float().mean()) == pytest.approx(0.75, abs=0.03)
    torch.testing.assert_close(kept[kept > 0], torch.full_like(kept[kept > 0], 1 / 0.75))


def test_dropout_masks_of_other_keys_are_uncorrelated():
    """Masks of 300 steps' keys, and of keys one or two bits apart, correlate no more than
    independent draws do (4096 elements: std 1/64, so |corr| above 0.1 is > 6 sigma)."""
    cpu = torch.device("cpu")
    keys = step.dropout_key(1, torch.arange(300), 0)
    masks = torch.stack([port_nn.DropoutStream(k).keep_mask((4096,), 0.5, cpu)
                         for k in keys]).float() - 0.5
    corr = masks @ masks.T / (4096 * 0.25)
    assert float(corr[~torch.eye(300, dtype=torch.bool)].abs().max()) < 0.1
    for flip in (1, 2, 1 << 31):
        near = torch.stack([port_nn.DropoutStream(k ^ flip).keep_mask((4096,), 0.5, cpu)
                            for k in keys[:50]]).float() - 0.5
        assert float((near * masks[:50]).mean().abs() / 0.25) < 0.02


def test_grad_accum_draws_a_distinct_mask_per_microbatch():
    """With dropout on, accumulating two microbatches of the same rows is not the same
    as stepping on the doubled batch twice: each microbatch has its own masks."""
    net = cnn.Net()
    x, y = torch.randn(8, 28, 28, 1), torch.randint(0, 10, (8,))
    state = step.create_train_state(net, torch.Generator().manual_seed(0))
    fn = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM, grad_accum=2)
    _, loss_a = fn(state, torch.cat([x[:4], x[:4]]), torch.cat([y[:4], y[:4]]), 1)
    single_fn = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM)
    _, loss_b = single_fn(state, x[:4], y[:4], 1)
    assert loss_a.item() != pytest.approx(loss_b.item(), abs=1e-7)
    _, loss_c = fn(state, torch.cat([x[:4], x[:4]]), torch.cat([y[:4], y[:4]]), 1)
    assert loss_a.item() == loss_c.item()              # same (seed, step): same masks


class _Reducer:
    def __init__(self, host_staged):
        self.host_staged = host_staged


def test_segment_program_is_a_rule_of_the_device_and_the_reducer():
    assert step.segment_program(torch.device("cpu")) == "eager"
    assert step.segment_program(torch.device("cpu"), _Reducer(False)) == "eager"
    assert step.segment_program(torch.device("cuda", 0)) == "cuda-graph"
    assert step.segment_program(torch.device("cuda", 0), _Reducer(False)) == "cuda-graph"
    assert step.segment_program(torch.device("cuda", 0), _Reducer(True)) == "eager"
    net = cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0)
    fn = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM)
    state = step.create_train_state(net, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="runs on a CUDA device"):
        step.CapturedSegment(fn)(state, torch.randn(16, 28, 28, 1),
                                 torch.randint(0, 10, (16,)),
                                 torch.arange(16).view(2, 8), 1)


def test_epoch_from_step_on_the_cpu_is_the_eager_loop_and_rejects_an_unroll():
    net = cnn.Net()
    images, labels = torch.randn(40, 28, 28, 1), torch.randint(0, 10, (40,))
    plan = torch.from_numpy(np.random.default_rng(2).permutation(40)[:32].reshape(4, 8))
    fn = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM)
    runs = []
    for build in (step.make_epoch_from_step(fn), step.make_segment_fn(fn)):
        s = step.create_train_state(net, torch.Generator().manual_seed(0))
        runs.append(build(s, images, labels, plan, 5))
    torch.testing.assert_close(runs[0][1], runs[1][1], atol=0, rtol=0)
    for k in runs[0][0].params:
        torch.testing.assert_close(runs[0][0].params[k], runs[1][0].params[k], atol=0,
                                   rtol=0)
    with pytest.raises(ValueError, match="no loop body to unroll.*ROADMAP A4"):
        step.make_epoch_from_step(fn, unroll=8)


TRAINERS = {
    "single": (single.main, config.SingleProcessConfig, dict()),
    "distributed": (distributed.main, config.DistributedConfig, dict()),
    "composed": (composed.main, config.ComposedConfig, dict(mesh="data=1")),
}


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
@pytest.mark.parametrize("flag,match", [
    # the id it had while telemetry was unported
    pytest.param(dict(health_stats=True), "--health-stats .* pass --telemetry PATH too",
                 id="flag0---telemetry.*ROADMAP A11"),
    (dict(scan_unroll=8), "no loop body to unroll.*ROADMAP A4")])
def test_still_rejected_step_flags_name_their_roadmap_item(trainer, flag, match):
    main, cls, extra = TRAINERS[trainer]
    with pytest.raises(ValueError, match=match):
        main(cls(device="cpu", data_dir="/nonexistent", **extra, **flag))


STEP_FLAGS = ["--optimizer", "adamw", "--weight-decay", "0.01", "--lr-schedule", "cosine",
              "--warmup-steps", "3", "--clip-grad-norm", "1.0", "--label-smoothing", "0.1",
              "--ema-decay", "0.9", "--grad-accum", "2", "--guard", "--guard-zscore", "6",
              "--anomaly-exit", "1", "--skip-steps", "4:6", "--scan-unroll", "1",
              "--pregather"]


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_every_step_flag_parses_with_the_jax_defaults(trainer):
    _, cls, _ = TRAINERS[trainer]
    ref = getattr(jax_config, cls.__name__)()
    defaults = config.parse_config(cls, [])
    for f in ("optimizer", "weight_decay", "lr_schedule", "warmup_steps", "clip_grad_norm",
              "label_smoothing", "ema_decay", "grad_accum", "guard", "guard_zscore",
              "anomaly_exit", "skip_steps", "health_stats", "scan_unroll", "pregather"):
        if hasattr(ref, f):
            assert getattr(defaults, f) == getattr(ref, f), f
    cfg = config.parse_config(cls, STEP_FLAGS)
    assert (cfg.optimizer, cfg.weight_decay, cfg.lr_schedule, cfg.warmup_steps,
            cfg.clip_grad_norm, cfg.label_smoothing, cfg.ema_decay, cfg.grad_accum,
            cfg.guard, cfg.guard_zscore, cfg.anomaly_exit, cfg.skip_steps, cfg.scan_unroll,
            cfg.pregather) == ("adamw", 0.01, "cosine", 3, 1.0, 0.1, 0.9, 2, True, 6.0, 1,
                               "4:6", 1, True)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
