"""PyTorch port, fault injection (``resilience/faults.py``), the grad poison folded into the
step (``train/step.py``) and the torn write in the checkpoint writer, against the JAX
package.

The grammar: every spec (the JAX tests' rejections included) parses to equal faults or to
equal errors in both packages. The poison: the same inputs, made from a numpy seed, and the
same initial parameters (the JAX package's, carried over by ``cnn.params_from_jax``) go
through both steps with dropout off and a poison armed; every loss and parameter within
1e-5 (NaN where both are NaN), the guard's counters equal as integers. An unarmed step, or
one with only tick faults armed, is bitwise the step without the module. The torn write:
the same bytes cut in both packages, and the store's scans (both packages') skip the file.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.models.cnn import Net as JaxNet
from csed_514_project_distributed_training_using_pytorch_tpu.ops import optim as jax_optim
from csed_514_project_distributed_training_using_pytorch_tpu.resilience import (
    faults as jax_faults,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train import step as jax_step
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    checkpoint as jax_checkpoint,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch import resilience
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import optim
from csed_514_project_distributed_training_using_pytorch_tpu_torch.resilience import (
    faults,
    heartbeat,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import step
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
LR, MOMENTUM, ATOL = 0.05, 0.5, 1e-5
STEPS, BATCH = 10, 16
COUNTERS = ("count", "anomalies", "nonfinite", "spikes", "skipped", "first_anomaly_step",
            "last_anomaly_step")


@pytest.fixture(autouse=True)
def _fresh_fault_caches():
    """``get_faults`` caches by spec string in both packages: start and end every test
    with cold caches and no process-index override."""
    for mod in (faults, jax_faults):
        mod._parse.cache_clear()
    faults.set_process_index(None)
    yield
    for mod in (faults, jax_faults):
        mod._parse.cache_clear()
    faults.set_process_index(None)


def _parsed(mod, spec):
    try:
        return [dataclasses.astuple(f) for f in mod._parse(spec)]
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", [
    "kill:proc=1,step=8,flag=/tmp/f;torn:match=ckpt_00000008",
    "kill:step=3,exit=7;preempt:epoch=2;freeze:proc=1,step=2;stall:secs=0.5,step=4",
    "torn:match=ckpt,flag=/tmp/t", "spike:step=3", "nan:step=0,proc=2",
    "bitflip:step=3,leaf=kernel,scale=1e12", " ; kill:step=1 ;",
    # the JAX tests' rejections (tests/test_anomaly.py, tests/test_resilience.py)
    "nan:proc=0", "spike:step=3,flag=/tmp/x", "bitflip:step=3", "spike:step=3,epoch=1",
    "torn:step=3,match=x", "torn:epoch=1,match=x", "torn:proc=0", "explode:step=1",
    "kill:widget=1", "kill:step=x", "stall:secs=fast"])
def test_fault_grammar_matches_jax(spec):
    assert _parsed(faults, spec) == _parsed(jax_faults, spec)


def test_kinds_and_defaults_match_jax():
    for name in ("KINDS", "POISON_KINDS", "DEFAULT_KILL_EXIT", "DEFAULT_STALL_SECS",
                 "DEFAULT_SPIKE_SCALE", "DEFAULT_BITFLIP_VALUE", "ENV_VAR"):
        assert getattr(faults, name) == getattr(jax_faults, name), name


def test_process_index_rule(monkeypatch):
    """``proc`` matches the index set by the replica, else ``RANK``, else
    ``JAX_PROCESS_ID`` (what the JAX router's launcher sets), else 0."""
    monkeypatch.setenv(faults.ENV_VAR, "nan:step=3,proc=1;spike:step=4")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    kinds = lambda: [f.kind for f in faults.grad_poisons()]
    assert kinds() == ["spike"]
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    assert kinds() == ["nan", "spike"]
    monkeypatch.setenv("RANK", "0")
    assert kinds() == ["spike"]
    faults.set_process_index(1)
    assert kinds() == ["nan", "spike"]
    monkeypatch.delenv(faults.ENV_VAR)
    assert faults.grad_poisons() == () and not faults.active()


def test_mangle_write_cuts_the_same_bytes_once_per_flag(monkeypatch, tmp_path):
    data = bytes(range(256)) * 7 + b"tail"
    monkeypatch.setenv(faults.ENV_VAR,
                       f"torn:match=ckpt_00000008,flag={tmp_path / 'torn'}")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    monkeypatch.delenv("RANK", raising=False)
    assert faults.mangle_write("a/ckpt_00000004.msgpack", data) == data
    cut = faults.mangle_write("a/ckpt_00000008.msgpack", data)
    assert cut == data[:len(data) // 2]
    # the port's marker (suffix .p0) vouches for this process in both packages
    assert faults.mangle_write("a/ckpt_00000008.msgpack", data) == data
    assert jax_faults.mangle_write("a/ckpt_00000008.msgpack", data) == data
    os.remove(tmp_path / "torn.p0")
    assert jax_faults.mangle_write("a/ckpt_00000008.msgpack", data) == cut


def test_torn_store_write_is_skipped_by_both_packages_scans(monkeypatch, tmp_path):
    net = cnn.Net()
    state = step.create_train_state(net, torch.Generator().manual_seed(0))
    store = str(tmp_path / "store")
    checkpoint.save_versioned(store, state._replace(step=torch.tensor(4)), keep=3)
    monkeypatch.setenv(faults.ENV_VAR, "torn:match=ckpt_00000008")
    path8 = checkpoint.save_versioned(store, state._replace(step=torch.tensor(8)), keep=3)
    size = os.path.getsize(path8)
    entry = checkpoint.manifest_entry_for(path8)
    assert size == entry["bytes"] // 2
    ckpt4 = os.path.join(store, checkpoint.versioned_name(4))
    assert checkpoint.newest_valid_checkpoint(store) == ckpt4
    assert checkpoint.newest_healthy_checkpoint(store) == ckpt4
    assert jax_checkpoint.newest_valid_checkpoint(store) == ckpt4
    assert jax_checkpoint.newest_healthy_checkpoint(store) == ckpt4


def test_tick_faults_in_the_run_hooks(monkeypatch, tmp_path):
    """``kill`` fires at the first epoch tick whose step reaches the threshold (exit 41,
    at most once with ``flag``, in a child process); ``freeze`` silences the beat."""
    child = ("import sys, torch; sys.path.insert(0, %r)\n"
             "from %s import resilience\n"
             "class S: step = torch.tensor(int(sys.argv[1]))\n"
             "resilience.RunHooks().epoch_tick(S(), 2)\n" % (ROOT, PKG))
    env = dict(os.environ, RESILIENCE_FAULTS=f"kill:step=8,flag={tmp_path / 'k'}")
    run = lambda s: subprocess.run([sys.executable, "-c", child, str(s)], env=env,
                                   capture_output=True, text=True, timeout=120)
    assert run(4).returncode == 0
    killed = run(8)
    assert killed.returncode == 41 and "[faults] kill" in killed.stderr
    assert run(9).returncode == 0                       # the flag: once per process index
    monkeypatch.setenv(faults.ENV_VAR, "freeze:step=2")

    class S:
        step = torch.tensor(1)

    hb_dir = str(tmp_path / "hb")
    hooks = resilience.RunHooks(heartbeat_dir=hb_dir)
    hooks.epoch_tick(S(), 1)
    assert heartbeat.read_heartbeats(hb_dir)[0]["step"] == 1
    S.step = torch.tensor(2)
    hooks.epoch_tick(S(), 2)
    assert heartbeat.read_heartbeats(hb_dir)[0]["step"] == 1    # frozen


def test_jax_leaf_paths():
    assert step.jax_leaf_path("conv1.weight") == "['conv1_kernel']"
    assert step.jax_leaf_path("fc2.bias") == "['fc2_bias']"
    assert step.jax_leaf_path("block_0.attn.qkv_kernel") == \
        "['block_0']['attn']['qkv_kernel']"


def _jax_params(seed: int = 0):
    return JaxNet().init({"params": jax.random.PRNGKey(seed)},
                         jnp.zeros((1, 28, 28, 1)))["params"]


def _to_port(tree) -> dict[str, torch.Tensor]:
    return cnn.params_from_jax({k: np.asarray(v) for k, v in tree.items()})


# (spec, guarded, use_pallas): each poison once with the guard (which must refuse it) and
# once without (the poisoned update applied), the fused kernels on two of them
POISON_CASES = [
    ("nan:step=3", True, False),
    ("nan:step=3", True, True),
    ("spike:step=6", True, False),
    ("spike:step=6,scale=3.0", False, False),
    ("bitflip:step=5,leaf=kernel", True, False),
    ("bitflip:step=5,leaf=fc1,scale=2.0", False, True),
    ("bitflip:step=2,leaf=conv,scale=-0.5", False, False),
]


@pytest.mark.parametrize("spec,guarded,use_pallas", POISON_CASES,
                         ids=[f"{s}-{'guard' if g else 'plain'}-{'pallas' if p else 'xla'}"
                              for s, g, p in POISON_CASES])
def test_poisoned_step_matches_jax(spec, guarded, use_pallas, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, spec)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    rng = np.random.default_rng(31)
    xs = rng.normal(size=(STEPS, BATCH, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=(STEPS, BATCH))
    jparams = _jax_params()
    jguard = jax_step.GuardSpec(zscore=3.0) if guarded else None
    jstate = jax_step.TrainState(jparams, jax_optim.sgd_init(jparams),
                                 jnp.zeros((), jnp.int32),
                                 guard=jax_step.init_guard() if guarded else None)
    jfn = jax.jit(jax_step.make_train_step(
        JaxNet(conv_dropout_rate=0.0, fc_dropout_rate=0.0), learning_rate=LR,
        momentum=MOMENTUM, use_pallas=use_pallas, guard=jguard))
    params = _to_port(jparams)
    state = step.TrainState(params, optim.sgd_init(params), torch.zeros((), dtype=torch.int64),
                            guard=step.init_guard() if guarded else None)
    fn = step.make_train_step(cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0),
                              learning_rate=LR, momentum=MOMENTUM, use_pallas=use_pallas,
                              guard=step.GuardSpec(zscore=3.0) if guarded else None)
    ours, theirs = [], []
    for i in range(STEPS):
        jstate, jloss = jfn(jstate, jnp.asarray(xs[i]), jnp.asarray(ys[i], jnp.int32),
                            jax.random.PRNGKey(1))
        state, loss = fn(state, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]), 1)
        ours.append(loss.item())
        theirs.append(float(jloss))
    np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=0)
    want = _to_port(jstate.params)
    for k, p in state.params.items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), atol=ATOL, rtol=0,
                                   err_msg=k)
    if guarded:
        got = {f: int(getattr(state.guard, f)) for f in COUNTERS}
        assert got == {f: int(getattr(jstate.guard, f)) for f in COUNTERS}
        assert got["anomalies"] == 1 and got["skipped"] == 1
    else:
        # the poisoned update was applied: the run parts from an unpoisoned one
        monkeypatch.delenv(faults.ENV_VAR)
        plain_fn = step.make_train_step(cnn.Net(conv_dropout_rate=0.0, fc_dropout_rate=0.0),
                                        learning_rate=LR, momentum=MOMENTUM,
                                        use_pallas=use_pallas)
        plain = step.TrainState(_to_port(jparams), optim.sgd_init(_to_port(jparams)),
                                torch.zeros((), dtype=torch.int64))
        for i in range(STEPS):
            plain, _ = plain_fn(plain, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]), 1)
        assert any(not torch.equal(plain.params[k], state.params[k]) for k in want)


def test_unarmed_and_tick_only_steps_are_the_plain_step_bitwise(monkeypatch):
    """With ``RESILIENCE_FAULTS`` unset, or arming only tick faults, the step folds in no
    poison (``_grad_poison_fn`` is None) and trains bitwise as before; a poison armed for
    another process index is not folded in either."""
    net = cnn.Net()
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.normal(size=(16, 28, 28, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=16))
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    runs = []
    for armed in (None, "kill:step=999;freeze:step=999;torn:match=nothing",
                  "nan:step=1,proc=3"):
        if armed is None:
            monkeypatch.delenv(faults.ENV_VAR, raising=False)
        else:
            monkeypatch.setenv(faults.ENV_VAR, armed)
        assert step._grad_poison_fn() is None
        for use_pallas in (False, True):
            s = step.create_train_state(net, torch.Generator().manual_seed(0))
            fn = step.make_train_step(net, learning_rate=LR, momentum=MOMENTUM,
                                      use_pallas=use_pallas)
            for _ in range(3):
                s, _ = fn(s, x, y, 1)
            runs.append((use_pallas, s))
    for use_pallas, s in runs[2:]:
        ref = runs[int(use_pallas)][1]
        for k in ref.params:
            assert torch.equal(ref.params[k], s.params[k]), k
