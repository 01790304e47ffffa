"""PyTorch port, sequence-parallel slice: the einsum ring and zig-zag, Ulysses, the composed
trainer's seq schedules and the LM's seq axis, against the JAX package.

(a) ``parallel.ring_attention.ring_attention`` / ``zigzag_ring_attention`` (the einsum
    schedules, autograd through the hops) and ``parallel.ulysses.ulysses_attention`` (dense,
    and of flash through the kernels' plain versions) in one world of 2 gloo processes on
    the CPU, started by the port's launcher with a hard ``--timeout`` and one thread each,
    against the JAX ``ring_attention`` / ``zigzag_ring_attention`` / ``ulysses_attention``
    on a 2-device CPU mesh (the JAX flash kernel in interpret mode), forward and the
    gradients of ``sum(out·g)``;
(b) Ulysses' three shape refusals and the composed trainer's with the JAX words;
(c) the composed trainer at ``--mesh data=1,seq=2``: Ulysses (dense) and the einsum ring
    against the JAX composed trainer on the same mesh; the windowed einsum zig-zag,
    Ulysses of flash and the causal einsum ring with ``--remat`` against the port's own
    ``data=1`` run; dropout off;
(d) the LM trainer at ``--mesh data=1,seq=2``, the einsum ring and the zig-zag with a
    window, against its own ``data=1`` run.

Inputs are numpy arrays drawn from a seed and handed to both packages. Tolerances (f32
sums in another order): outputs within rtol 1e-5 + atol 1e-5, gradients within rtol 1e-4 +
atol 2e-5; trainer losses within atol 1e-5 and parameters within rtol 1e-4 + atol 1e-5.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.models import (
    transformer as jax_tf,
)
from csed_514_project_distributed_training_using_pytorch_tpu.parallel import make_mesh
from csed_514_project_distributed_training_using_pytorch_tpu.parallel.ring_attention import (
    ring_attention as jax_ring_attention,
    zigzag_ring_attention as jax_zigzag_ring_attention,
)
from csed_514_project_distributed_training_using_pytorch_tpu.parallel.ulysses import (
    ulysses_attention as jax_ulysses_attention,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train import (
    composed as jax_composed,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train import step as jax_step
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    config as jax_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import transformer
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import ulysses
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import composed
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import lm as lm_train
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import config

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
FLEET_TIMEOUT = 240            # seconds; the launcher kills the fleet and exits 124
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
LOSS_ATOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    return env


def _start_fleet(cwd: pathlib.Path, code: str) -> subprocess.Popen:
    """``python -c code`` as a world of 2 through the port's launcher, started and not
    waited for (the JAX reference runs meanwhile)."""
    return subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.train.launch", "--num-processes", "2",
         "--timeout", str(FLEET_TIMEOUT), "--", "-c", code],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(), cwd=str(cwd))


def _finish(proc: subprocess.Popen) -> str:
    out, err = proc.communicate(timeout=FLEET_TIMEOUT + 60)
    assert proc.returncode == 0, f"fleet exited {proc.returncode}\n{out[-2000:]}\n{err[-4000:]}"
    return out


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """Every fleet of the file, started at once; ``get(name)`` waits for one and loads what
    its rank 0 saved."""
    base = tmp_path_factory.mktemp("seq")
    procs = {
        "ops": _start_fleet(base, OPS_CHILD.format(pkg=PKG, cases=OPS_CASES,
                                                   path=str(base / "ops.npz"))),
        "composed": _start_fleet(base, COMPOSED_CHILD.format(
            pkg=PKG, runs=COMPOSED_RUNS, n_train=N_TRAIN, n_test=N_TEST,
            init=str(_composed_init(base)), base=str(base), base_kw=COMPOSED_BASE)),
        "lm": _start_fleet(base, LM_CHILD.format(pkg=PKG, runs=LM_RUNS, kw=LM_KW,
                                                 base=str(base))),
    }
    done = {}

    def get(name):
        if name not in done:
            done[name] = _finish(procs[name])
        return base

    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# -- (a) the einsum schedules and Ulysses ---------------------------------------------------

# name, schedule, [B, S, H, D], causal, window
OPS_CASES = [
    ("ring-full", "ring", (1, 64, 2, 8), False, 0),
    ("ring-causal", "ring", (1, 64, 2, 8), True, 0),
    ("ring-w5", "ring", (1, 64, 2, 8), False, 5),
    ("ring-causal-w40", "ring", (1, 64, 2, 8), True, 40),
    ("zigzag", "zigzag", (1, 64, 2, 8), True, 0),
    ("zigzag-w12", "zigzag", (1, 64, 2, 8), True, 12),
    ("ulysses-dense", "ulysses", (2, 256, 4, 16), False, 0),
    ("ulysses-dense-causal-w50", "ulysses", (2, 256, 4, 16), True, 50),
    ("ulysses-flash", "ulysses-flash", (2, 256, 4, 16), False, 0),
    ("ulysses-flash-causal", "ulysses-flash", (2, 256, 4, 16), True, 0),
]


def _op_inputs(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(4, *shape)).astype(np.float32)


OPS_CHILD = """
import numpy as np, torch
from {pkg}.parallel import mesh, ring_attention as ra, ulysses
torch.set_num_threads(1)
saved = {{}}
with mesh.cluster("cpu") as info:
    for i, (name, schedule, shape, causal, window) in enumerate({cases!r}):
        q, k, v, g = np.random.default_rng(i).normal(size=(4, *shape)).astype(np.float32)
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        if schedule == "zigzag":
            out = ra.zigzag_ring_attention(*leaves, window=window)
        elif schedule == "ring":
            out = ra.ring_attention(*leaves, causal=causal, window=window)
        else:
            out = ulysses.ulysses_attention(*leaves, causal=causal, window=window,
                                            use_flash=schedule == "ulysses-flash")
        grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
        saved[name + "/out"] = out.detach().numpy()
        for x, grad in zip("qkv", grads):
            saved[name + "/d" + x] = grad.numpy()
    if info.process_index == 0:
        np.savez({path!r}, **saved)
"""


def _jax_op(schedule, causal, window, q, k, v, g):
    """The JAX schedule on a 2-device CPU mesh: out and the gradients of ``sum(out·g)``."""
    jmesh = make_mesh(2, axis_names=("seq",))
    if schedule == "zigzag":
        fn = lambda q, k, v: jax_zigzag_ring_attention(jmesh, q, k, v, window=window)
    elif schedule == "ring":
        fn = lambda q, k, v: jax_ring_attention(jmesh, q, k, v, causal=causal,
                                                window=window)
    else:
        fn = lambda q, k, v: jax_ulysses_attention(jmesh, q, k, v, causal=causal,
                                                   window=window,
                                                   use_flash=schedule == "ulysses-flash")

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return out, grads


@pytest.mark.parametrize("i", range(len(OPS_CASES)), ids=[c[0] for c in OPS_CASES])
def test_seq_op_matches_jax(fleets, i):
    name, schedule, shape, causal, window = OPS_CASES[i]
    q, k, v, g = _op_inputs(shape, i)
    out, grads = _jax_op(schedule, causal, window, q, k, v, g)
    got = np.load(fleets("ops") / "ops.npz")
    np.testing.assert_allclose(got[name + "/out"], np.asarray(out), **FWD_TOL)
    for x, grad in zip("qkv", grads):
        np.testing.assert_allclose(got[name + "/d" + x], np.asarray(grad),
                                   err_msg=f"{name} d{x}", **GRAD_TOL)


# -- (b) the refusals -------------------------------------------------------------------------

ULYSSES_REFUSALS = [((30, 4, 4, False), "seq-divisibility"),
                    ((16, 4, 8, False), "heads"),
                    ((200, 4, 2, True), "flash-block")]


@pytest.mark.parametrize("shape", [c for c, _ in ULYSSES_REFUSALS],
                         ids=[i for _, i in ULYSSES_REFUSALS])
def test_ulysses_refusals_use_the_jax_words(shape):
    s, h, n, use_flash = shape
    x = jnp.zeros((1, s, h, 8), jnp.float32)
    with pytest.raises(ValueError) as want:
        jax_ulysses_attention(make_mesh(n, axis_names=("seq",)), x, x, x,
                              use_flash=use_flash)
    with pytest.raises(ValueError) as got:
        ulysses.check_shapes(s, h, n, use_flash)
    assert str(got.value) == str(want.value)


def _tiny_datasets():
    out = []
    for n, seed in ((64, 200), (10, 201)):
        x, y = mnist._synthesize_split(n, seed)
        out.append((mnist._normalize(x), y.astype(np.int32)))
    return (tuple(mnist.Dataset(x, y, "synthetic") for x, y in out),
            tuple(jax_mnist.Dataset(x, y, "synthetic") for x, y in out))


@pytest.mark.parametrize("kw", [
    dict(mesh="data=1,seq=8", seq_impl="ulysses", seq_len=16),
    dict(mesh="data=1,seq=2", seq_impl="ulysses", flash_attention=True, seq_len=200),
    dict(mesh="data=1,seq=2", zigzag_attention=True, causal=True, seq_len=18),
], ids=["ulysses-heads", "ulysses-flash-block", "zigzag-einsum-divisibility"])
def test_composed_seq_refusals_match_jax(tmp_path, kw):
    port_ds, ref_ds = _tiny_datasets()
    with pytest.raises(ValueError) as got:
        composed.main(config.ComposedConfig(device="cpu", **kw), datasets=port_ds)
    with pytest.raises(ValueError) as want:
        jax_composed.main(jax_config.ComposedConfig(results_dir=str(tmp_path), **kw),
                          datasets=ref_ds)
    assert str(got.value) == str(want.value)


# -- (c) the composed trainer -----------------------------------------------------------------

N_TRAIN, N_TEST = 32, 16
COMPOSED_BASE = dict(epochs=1, batch_size=8, batch_size_test=16, learning_rate=0.05,
                     momentum=0.5, seed=3)
# name -> the flags of the seq=2 run (the reference is JAX's on the same mesh, or the
# port's data=1 run with the flags in "ref")
COMPOSED_RUNS = {
    "ulysses": dict(mesh="data=1,seq=2", seq_impl="ulysses", seq_len=16),
    "ring": dict(mesh="data=1,seq=2", seq_len=16),
    "zigzag-w6": dict(mesh="data=1,seq=2", zigzag_attention=True, causal=True,
                      attention_window=6, seq_len=16),
    "ulysses-flash": dict(mesh="data=1,seq=2", seq_impl="ulysses", flash_attention=True,
                          seq_len=256),
    "ring-remat": dict(mesh="data=1,seq=2", causal=True, remat=True, seq_len=16),
}
AGAINST_JAX = ("ulysses", "ring")


def _composed_init(base: pathlib.Path) -> pathlib.Path:
    """The JAX composed trainer's initial parameters at both seq lengths, for both
    packages."""
    path = base / "init.npz"
    saved = {}
    for s in (16, 256):
        j_init = jax_step.create_train_state(jax_tf.TransformerClassifier(
            seq_len=s, dropout_rate=0.0), jax.random.PRNGKey(3)).params
        for k, p in transformer.params_from_jax(j_init).items():
            saved[f"{s}/{k}"] = p.numpy()
    np.savez(path, **saved)
    return path


COMPOSED_CHILD = """
import os
import numpy as np, torch
from {pkg}.data import mnist
from {pkg}.parallel import mesh
from {pkg}.train import composed
from {pkg}.utils import config
torch.set_num_threads(1)
splits = []
for n, seed in (({n_train}, 200), ({n_test}, 201)):
    x, y = mnist._synthesize_split(n, seed)
    splits.append(mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic"))
loaded = np.load({init!r})
base = {base_kw!r}
with mesh.cluster("cpu"):            # one group for every run
    for name, kw in {runs!r}.items():
        s = kw["seq_len"]
        init = {{k.split("/", 1)[1]: torch.from_numpy(loaded[k]) for k in loaded.files
                 if k.startswith(f"{{s}}/")}}
        state, hist = composed.main(config.ComposedConfig(
            device="cpu", results_dir=os.path.join({base!r}, name), **base, **kw),
            datasets=tuple(splits), init_params=init)
        if os.environ["RANK"] == "0":
            np.savez(os.path.join({base!r}, name + ".npz"),
                     train=np.array(hist.train_losses), test=np.array(hist.test_losses),
                     **{{k: p.numpy() for k, p in state.params.items()}})
"""


def _splits(pkg):
    out = []
    for n, seed in ((N_TRAIN, 200), (N_TEST, 201)):
        x, y = pkg._synthesize_split(n, seed)
        out.append(pkg.Dataset(pkg._normalize(x), y.astype(np.int32), "synthetic"))
    return tuple(out)


def _check_run(got, train, test, params) -> None:
    np.testing.assert_allclose(got["train"], train, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["test"], test, atol=LOSS_ATOL)
    for name, want in params.items():
        np.testing.assert_allclose(got[name], np.asarray(want), err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("name", AGAINST_JAX)
def test_composed_seq_schedule_matches_jax(fleets, tmp_path, name):
    kw = dict(COMPOSED_BASE, **COMPOSED_RUNS[name])
    j_state, j_hist = jax_composed.main(
        jax_config.ComposedConfig(results_dir=str(tmp_path / "jax"), **kw),
        datasets=_splits(jax_mnist))
    got = np.load(fleets("composed") / f"{name}.npz")
    _check_run(got, j_hist.train_losses, j_hist.test_losses,
               {k: v.numpy() for k, v in transformer.params_from_jax(j_state.params).items()})


@pytest.mark.parametrize("name", [n for n in COMPOSED_RUNS if n not in AGAINST_JAX])
def test_composed_seq_schedule_matches_data_1(fleets, tmp_path, name):
    kw = dict(COMPOSED_BASE, **COMPOSED_RUNS[name])
    ref_kw = dict(kw, mesh="data=1", seq_impl="ring", remat=False, zigzag_attention=False)
    loaded = np.load(fleets("composed") / "init.npz")
    s = kw["seq_len"]
    init = {k.split("/", 1)[1]: torch.from_numpy(loaded[k]) for k in loaded.files
            if k.startswith(f"{s}/")}
    state, hist = composed.main(
        config.ComposedConfig(device="cpu", results_dir=str(tmp_path), **ref_kw),
        datasets=_splits(mnist), init_params=init)
    got = np.load(fleets("composed") / f"{name}.npz")
    _check_run(got, hist.train_losses, hist.test_losses,
               {k: p.numpy() for k, p in state.params.items()})
    # the seq world's checkpoint is the run's final state, in the transformer layout
    assert (fleets("composed") / name / "model_composed.ckpt").stat().st_size > 0


# -- (d) the LM's seq axis --------------------------------------------------------------------

LM_KW = dict(epochs=1, batch_size=8, max_train_examples=32, max_test_examples=10,
             eval_batch=10, embed_dim=16, num_layers=1, num_heads=2, generate=0,
             optimizer="sgd", weight_decay=0.0, learning_rate=0.05, clip_grad_norm=0.0)
LM_RUNS = {"ring": dict(mesh="data=1,seq=2"),
           "zigzag-w100": dict(mesh="data=1,seq=2", zigzag_attention=True,
                               attention_window=100)}

LM_CHILD = """
import os
import numpy as np, torch
from {pkg}.parallel import mesh
from {pkg}.train import lm
from {pkg}.utils import config
torch.set_num_threads(1)
with mesh.cluster("cpu"):            # one group for every run
    for name, kw in {runs!r}.items():
        state, hist = lm.main(config.LMConfig(
            device="cpu", images_dir=os.path.join({base!r}, "img-" + name),
            results_dir=os.path.join({base!r}, "lm-" + name), **{kw!r}, **kw))
        if os.environ["RANK"] == "0":
            np.savez(os.path.join({base!r}, "lm-" + name + ".npz"),
                     train=np.array(hist.train_losses), test=np.array(hist.test_losses),
                     **{{k: p.numpy() for k, p in state.params.items()}})
"""


@pytest.mark.parametrize("name", list(LM_RUNS))
def test_lm_seq_axis_matches_data_1(fleets, tmp_path, name):
    window = LM_RUNS[name].get("attention_window", 0)
    state, hist = lm_train.main(config.LMConfig(
        device="cpu", images_dir=str(tmp_path / "img"), results_dir=str(tmp_path),
        attention_window=window,
        **LM_KW))
    got = np.load(fleets("lm") / f"lm-{name}.npz")
    _check_run(got, hist.train_losses, hist.test_losses,
               {k: p.numpy() for k, p in state.params.items()})


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
