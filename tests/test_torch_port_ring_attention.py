"""PyTorch port, sequence-parallel slice: the hop offset in the flash plain versions, the
ring-of-flash schedules over ``torch.distributed`` and the composed trainer on a seq axis,
against the JAX package.

(a) ``flash_forward_with_lse`` / ``flash_backward_blocks`` with a ``q_offset`` (their plain
    versions on the CPU) against the JAX package's in Pallas interpret mode, the backward
    from the full row's statistics (the hop merged with the diagonal block);
(b) the ring ops (plain, windowed, zig-zag) in worlds of 2 and 4 gloo processes on the CPU,
    started by the port's launcher with a hard ``--timeout`` and one CPU thread each,
    against the JAX ``ring_flash_attention`` / ``zigzag_ring_flash_attention`` on a 2- and
    4-device CPU mesh, forward and gradients; and each rank's kernel calls against the
    plan, and the plan against the dense mask;
(c) the composed trainer at ``--mesh data=1,seq=2 --flash-attention`` (a world of 2)
    against the JAX composed trainer on the same mesh, seq 256, dropout off;
(d) the flag and divisibility errors, with the JAX package's messages where it has them.

Inputs are numpy arrays drawn from a seed and handed to both packages. Tolerances, as the
JAX package's own flash tests state them for interpret mode (f32 round-off, sums in
another order): outputs and lse within rtol 1e-5 + atol 1e-5, gradients within rtol 1e-4
+ atol 2e-5; the trainer's losses within atol 1e-5 and its parameters within rtol 1e-4 +
atol 1e-5 after 4 steps.
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
from csed_514_project_distributed_training_using_pytorch_tpu.ops import (
    pallas_attention as jax_pa,
)
from csed_514_project_distributed_training_using_pytorch_tpu.parallel import make_mesh
from csed_514_project_distributed_training_using_pytorch_tpu.parallel.ring_attention import (
    make_ring_attention_fn as jax_make_ring_attention_fn,
    ring_flash_attention as jax_ring_flash_attention,
    zigzag_ring_flash_attention as jax_zigzag_ring_flash_attention,
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
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    attention,
    flash_attention as fa,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    mesh,
    ring_attention as ra,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import composed
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


def _start_fleet(cwd: pathlib.Path, n: int, code: str) -> subprocess.Popen:
    """``python -c code`` as a world of ``n`` through the port's launcher, started and not
    waited for (the JAX reference runs meanwhile)."""
    return subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.train.launch", "--num-processes", str(n),
         "--timeout", str(FLEET_TIMEOUT), "--", "-c", code],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(), cwd=str(cwd))


def _finish(proc: subprocess.Popen) -> None:
    out, err = proc.communicate(timeout=FLEET_TIMEOUT + 60)
    assert proc.returncode == 0, f"fleet exited {proc.returncode}\n{out[-2000:]}\n{err[-4000:]}"


def _packed(x: np.ndarray) -> jnp.ndarray:
    """``[B, S, H, D]`` -> the JAX kernels' packed ``[B·H, S, D]``."""
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _unpacked(x, b: int, h: int) -> np.ndarray:
    bh, s, d = x.shape
    return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)


def _stats4(x: np.ndarray) -> jnp.ndarray:
    """``[B, H, S]`` statistics -> the JAX kernels' ``[B·H, S/128, 1, 128]``."""
    b, h, s = x.shape
    return jnp.asarray(x.reshape(b * h, s // 128, 1, 128))


# -- (a) the hop offset in the flash building blocks ----------------------------------------

OFFSET_CASES = ([(off, causal, window) for off in (-256, -128, 128, 256)
                 for causal, window in ((False, 100), (True, 300))]
                + [(-128, False, 300), (256, False, 300)])


def _hop(q, k0, v0, k1, v1, g, *, causal, window, off):
    """The port's hop block at ``off`` against the diagonal block: its forward, the full
    row's statistics (the two merged) and the hop's backward from them."""
    t = [torch.from_numpy(x) for x in (q, k0, v0, k1, v1, g)]
    out, lse = fa.flash_forward_with_lse(t[0], t[3], t[4], causal=causal, window=window,
                                         q_offset=off)
    out0, lse0 = fa.flash_forward_with_lse(t[0], t[1], t[2], causal=causal, window=window)
    lse_full = torch.logaddexp(lse0, lse)
    rows = lambda x: x.transpose(1, 2)[..., None]
    out_full = (out0 * rows(torch.exp(lse0 - lse_full))
                + out * rows(torch.exp(lse - lse_full)))
    delta = fa.flash_delta(out_full, t[5])
    grads = fa.flash_backward_blocks(t[0], t[3], t[4], t[5], lse_full, delta,
                                     causal=causal, window=window, q_offset=off)
    return out, lse, lse_full, delta, grads


@pytest.mark.parametrize("off,causal,window", OFFSET_CASES)
def test_offset_blocks_match_jax_interpret(off, causal, window):
    b, s, h, d = 1, 512, 2, 8
    rng = np.random.default_rng(1000 + off + window + causal)
    q, k0, v0, k1, v1, g = rng.normal(size=(6, b, s, h, d)).astype(np.float32)
    out, lse, lse_full, delta, grads = _hop(q, k0, v0, k1, v1, g, causal=causal,
                                            window=window, off=off)
    j_out, j_lse = jax_pa.flash_forward_with_lse(
        _packed(q), _packed(k1), _packed(v1), causal=causal, window=window, q_offset=off)
    np.testing.assert_allclose(out.numpy(), _unpacked(j_out, b, h), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse).reshape(b, h, s), **FWD_TOL)
    want = jax_pa.flash_backward_blocks(
        _packed(q), _packed(k1), _packed(v1), _packed(g), _stats4(lse_full.numpy()),
        _stats4(delta.numpy()), causal=causal, window=window, q_offset=off)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        np.testing.assert_allclose(got.numpy(), _unpacked(w, b, h), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("off,causal,window", [(1024, False, 100), (-512, True, 0)])
def test_offset_block_with_every_row_dead(off, causal, window):
    """No query of the hop sees a key: out 0 and lse MASK_VALUE in both packages, and the
    backward from the full row's statistics contributes nothing (p = 0, never
    exp(MASK_VALUE − lse) of a stale score)."""
    b, s, h, d = 1, 512, 2, 8
    rng = np.random.default_rng(7)
    q, k0, v0, k1, v1, g = rng.normal(size=(6, b, s, h, d)).astype(np.float32)
    out, lse, lse_full, delta, grads = _hop(q, k0, v0, k1, v1, g, causal=causal,
                                            window=window, off=off)
    j_out, j_lse = jax_pa.flash_forward_with_lse(
        _packed(q), _packed(k1), _packed(v1), causal=causal, window=window, q_offset=off)
    assert (out == 0).all() and (lse == attention.MASK_VALUE).all()
    np.testing.assert_array_equal(np.asarray(j_out), 0.0)
    np.testing.assert_array_equal(np.asarray(j_lse), np.float32(attention.MASK_VALUE))
    want = jax_pa.flash_backward_blocks(
        _packed(q), _packed(k1), _packed(v1), _packed(g), _stats4(lse_full.numpy()),
        _stats4(delta.numpy()), causal=causal, window=window, q_offset=off)
    for got, w in zip(grads, want):
        assert (got == 0).all()
        np.testing.assert_array_equal(np.asarray(w), 0.0)


def test_offset_is_checked_as_jax_checks_it():
    x = torch.zeros(1, 256, 2, 8)
    lse = torch.zeros(1, 2, 256)
    for call in (lambda: fa.flash_forward_with_lse(x, x, x, q_offset=64),
                 lambda: fa.flash_backward_blocks(x, x, x, x, lse, lse, q_offset=-64)):
        with pytest.raises(ValueError, match="q_offset must be a multiple of block=128"):
            call()
    with pytest.raises(ValueError, match="equal q/k block sets"):
        fa.flash_backward_blocks(x, x[:, :128], x[:, :128], x, lse, lse)
    assert attention.visibility_mask(2, 4, causal=True, window=None, q_offset=2).tolist() == [
        [True, True, True, False], [True, True, True, True]]


# -- (b) the ring ops over torch.distributed against the JAX schedules ----------------------

# (name, schedule, seq, causal, window) by world; seq = the JAX tests' own shapes
RING_CASES = {
    2: [("ring-full", "ring", 256, False, 0), ("ring-causal", "ring", 256, True, 0),
        ("ring-w100", "ring", 256, False, 100), ("ring-causal-w300", "ring", 256, True, 300),
        ("zigzag", "zigzag", 512, True, 0), ("zigzag-w100", "zigzag", 512, True, 100)],
    4: [("ring-causal", "ring", 512, True, 0), ("ring-causal-w100", "ring", 512, True, 100),
        ("ring-w300", "ring", 512, False, 300), ("zigzag-w400", "zigzag", 1024, True, 400)],
}
RING_SHAPE = (1, 2, 8)         # batch, heads, head dim


def _ring_inputs(seq: int, seed: int) -> np.ndarray:
    b, h, d = RING_SHAPE
    return np.random.default_rng(seed).normal(size=(4, b, seq, h, d)).astype(np.float32)


RING_CHILD = """
import numpy as np, torch
import torch.distributed as dist
from {pkg}.ops import flash_attention as fa
from {pkg}.parallel import collectives, mesh, ring_attention as ra
torch.set_num_threads(1)
calls = {{"forward": 0, "backward": 0}}
def counted(name, fn):
    def call(*a, **k):
        calls[name] += 1
        return fn(*a, **k)
    return call
fa.flash_forward_with_lse = counted("forward", fa.flash_forward_with_lse)
fa.flash_backward_blocks = counted("backward", fa.flash_backward_blocks)
saved = {{}}
with mesh.cluster("cpu") as info:
    for name, schedule, seq, causal, window in {cases!r}:
        q, k, v, g = np.random.default_rng(seq + window + causal).normal(
            size=(4, {b}, seq, {h}, {d})).astype(np.float32)
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        calls.update(forward=0, backward=0)
        if schedule == "zigzag":
            out = ra.zigzag_ring_flash_attention(*leaves, window=window)
        else:
            out = ra.ring_flash_attention(*leaves, causal=causal, window=window)
        grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
        planned = ra.planned_blocks(schedule, info.process_count, info.process_index,
                                    seq_len=seq, causal=causal, window=window)
        mine = torch.tensor([calls["forward"], calls["backward"], planned])
        saved[name + "/calls"] = collectives.all_gather(mine).numpy()
        saved[name + "/out"] = out.detach().numpy()
        for x, grad in zip("qkv", grads):
            saved[name + "/d" + x] = grad.numpy()
    if info.process_index == 0:
        np.savez({path!r}, **saved)
"""


@pytest.fixture(scope="module")
def ring_results(tmp_path_factory):
    """Both worlds' fleets, started at once; ``get(world)`` waits for one and loads what
    its rank 0 saved."""
    base = tmp_path_factory.mktemp("ring")
    b, h, d = RING_SHAPE
    procs = {world: _start_fleet(base, world, RING_CHILD.format(
        pkg=PKG, cases=cases, path=str(base / f"w{world}.npz"), b=b, h=h, d=d))
        for world, cases in RING_CASES.items()}
    loaded = {}

    def get(world):
        if world not in loaded:
            _finish(procs[world])
            loaded[world] = dict(np.load(base / f"w{world}.npz"))
        return loaded[world]

    yield get
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _jax_ring(world, schedule, causal, window, q, k, v, g):
    """The JAX schedule on a ``world``-device CPU mesh: out and the gradients of
    ``sum(out·g)``, in one compiled program."""
    jmesh = make_mesh(world, axis_names=("seq",))
    if schedule == "zigzag":
        fn = lambda q, k, v: jax_zigzag_ring_flash_attention(jmesh, q, k, v,
                                                                  window=window)
    else:
        fn = lambda q, k, v: jax_ring_flash_attention(jmesh, q, k, v, causal=causal,
                                                           window=window)

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return out, grads


@pytest.mark.parametrize("world,case", [(w, c) for w, cases in RING_CASES.items()
                                        for c in cases],
                         ids=[f"w{w}-{c[0]}" for w, cases in RING_CASES.items()
                              for c in cases])
def test_ring_op_matches_jax(ring_results, world, case):
    name, schedule, seq, causal, window = case
    q, k, v, g = _ring_inputs(seq, seq + window + causal)
    want_out, want_grads = _jax_ring(world, schedule, causal, window, q, k, v, g)
    got = ring_results(world)
    np.testing.assert_allclose(got[f"{name}/out"], np.asarray(want_out), **FWD_TOL)
    for x, want in zip("qkv", want_grads):
        np.testing.assert_allclose(got[f"{name}/d{x}"], np.asarray(want), err_msg=x,
                                   **GRAD_TOL)


@pytest.mark.parametrize("world", sorted(RING_CASES))
def test_ring_calls_follow_the_plan(ring_results, world):
    """Every rank makes one forward and one backward block call per planned block of its
    hops (``planned_blocks``), in every case."""
    got = ring_results(world)
    for name, *_ in RING_CASES[world]:
        calls = got[f"{name}/calls"]                     # [rank, (fwd, bwd, planned)]
        assert calls.shape == (world, 3)
        assert (calls[:, 0] == calls[:, 2]).all() and (calls[:, 1] == calls[:, 2]).all(), name
        assert (calls[:, 2] > 0).all(), name


def _live_blocks_by_mask(schedule, n, rank, s, causal, window):
    """The blocks one rank must visit, from the dense mask: for the ring, the shards whose
    block holds a visible pair for the rank's queries; for the zig-zag, the (query chunk,
    key chunk) pairs with one, over the rank's two query chunks."""
    vis = attention.visibility_mask(s, s, causal=causal, window=window or None)
    if schedule == "ring":
        c = s // n
        rows = vis[rank * c:(rank + 1) * c]
        return sum(bool(rows[:, o * c:(o + 1) * c].any()) for o in range(n))
    c = s // (2 * n)
    return sum(bool(vis[qc * c:(qc + 1) * c, kc * c:(kc + 1) * c].any())
               for qc in (rank, 2 * n - 1 - rank) for kc in range(2 * n))


@pytest.mark.parametrize("schedule,causal", [("ring", False), ("ring", True),
                                             ("zigzag", True)])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_plan_visits_every_live_block_once(schedule, causal, n):
    """The truncated, bidirectional and wrapped hop plans call the kernels exactly on the
    blocks the dense mask says are live, at every rank."""
    s = 2 * n * 128
    for window in (0, 1, 100, 128, 129, 300, 700, 4096):
        for rank in range(n):
            want = _live_blocks_by_mask(schedule, n, rank, s, causal, window)
            got = ra.planned_blocks(schedule, n, rank, seq_len=s, causal=causal,
                                    window=window)
            assert got == want, (n, rank, window)


@pytest.mark.parametrize("schedule,causal", [("ring", False), ("ring", True),
                                             ("zigzag", True)])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_plan_offsets_are_the_live_off_diagonal_blocks(schedule, causal, n):
    """Under a window, the blocks the plans call at a nonzero ``q_offset`` are exactly the
    live blocks off the diagonal (another shard's, or another chunk's, keys); without one,
    none: the ring and the zig-zag then mask past and future blocks by their case alone."""
    s = 2 * n * 128
    for window in (0, 1, 100, 128, 129, 300, 700, 4096):
        vis = attention.visibility_mask(s, s, causal=causal, window=window or None)
        for rank in range(n):
            if schedule == "ring":
                c = s // n
                pairs = [(rank, o) for o in range(n)]
            else:
                c = s // (2 * n)
                pairs = [(qc, kc) for qc in (rank, 2 * n - 1 - rank) for kc in range(2 * n)]
            want = sum(bool(vis[qc * c:(qc + 1) * c, kc * c:(kc + 1) * c].any())
                       for qc, kc in pairs if qc != kc) if window else 0
            got = ra.planned_blocks(schedule, n, rank, seq_len=s, causal=causal,
                                    window=window, offset_only=True)
            assert got == want, (n, rank, window)


# -- (c) the composed trainer on a seq axis ---------------------------------------------------

TRAINER_CHILD = """
import os
import numpy as np, torch
from {pkg}.data import mnist
from {pkg}.train import composed
from {pkg}.utils import config
torch.set_num_threads(1)
splits = []
for n, seed in (({n_train}, 200), ({n_test}, 201)):
    x, y = mnist._synthesize_split(n, seed)
    splits.append(mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic"))
init = {{k: torch.from_numpy(v) for k, v in np.load({init!r}).items()}}
state, hist = composed.main(config.ComposedConfig(device="cpu", **{kw!r}),
                            datasets=tuple(splits), init_params=init)
if os.environ["RANK"] == "0":
    np.savez({out!r}, train=np.array(hist.train_losses), test=np.array(hist.test_losses),
             **{{k: p.numpy() for k, p in state.params.items()}})
"""


def test_composed_seq_axis_matches_jax(tmp_path):
    n_train, n_test = 32, 16
    kw = dict(mesh="data=1,seq=2", flash_attention=True, seq_len=256, epochs=1,
              batch_size=8, batch_size_test=16, learning_rate=0.05, momentum=0.5, seed=3)
    j_model = jax_tf.TransformerClassifier(seq_len=256, dropout_rate=0.0)
    j_init = jax_step.create_train_state(j_model, jax.random.PRNGKey(3)).params
    np.savez(tmp_path / "init.npz", **{k: p.numpy() for k, p in
                                        transformer.params_from_jax(j_init).items()})
    proc = _start_fleet(tmp_path, 2, TRAINER_CHILD.format(
        pkg=PKG, n_train=n_train, n_test=n_test, init=str(tmp_path / "init.npz"),
        kw=dict(kw, results_dir=str(tmp_path / "port")), out=str(tmp_path / "port.npz")))
    ref = []
    for n, seed in ((n_train, 200), (n_test, 201)):
        x, y = jax_mnist._synthesize_split(n, seed)
        ref.append(jax_mnist.Dataset(jax_mnist._normalize(x), y.astype(np.int32),
                                     "synthetic"))
    j_state, j_hist = jax_composed.main(
        jax_config.ComposedConfig(results_dir=str(tmp_path / "jax"), **kw),
        datasets=tuple(ref))
    _finish(proc)
    got = np.load(tmp_path / "port.npz")
    np.testing.assert_allclose(got["train"], j_hist.train_losses, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["test"], j_hist.test_losses, atol=LOSS_ATOL)
    for name, want in transformer.params_from_jax(j_state.params).items():
        np.testing.assert_allclose(got[name], want.numpy(), err_msg=name, **PARAM_TOL)


# -- (d) errors -------------------------------------------------------------------------------


def _tiny_datasets():
    out = []
    for n, seed in ((64, 200), (10, 201)):
        x, y = mnist._synthesize_split(n, seed)
        out.append((mnist._normalize(x), y.astype(np.int32)))
    return (tuple(mnist.Dataset(x, y, "synthetic") for x, y in out),
            tuple(jax_mnist.Dataset(x, y, "synthetic") for x, y in out))


@pytest.mark.parametrize("kw", [
    dict(mesh="data=1,seq=2", flash_attention=True, seq_len=384),
    dict(mesh="data=1,seq=2", flash_attention=True, zigzag_attention=True, causal=True,
         seq_len=256),
    dict(mesh="data=1,seq=2", flash_attention=True, zigzag_attention=True, seq_len=512),
    dict(mesh="data=1", flash_attention=True, zigzag_attention=True, causal=True,
         seq_len=256),
    dict(mesh="data=1,seq=2", seq_impl="rings"),
    dict(mesh="data=1,seq=2", seq_impl="ulysses", zigzag_attention=True, causal=True),
], ids=["ring-divisibility", "zigzag-divisibility", "zigzag-causal-only",
        "zigzag-needs-seq", "seq-impl", "ulysses-zigzag"])
def test_flag_errors_match_jax(tmp_path, kw):
    port_ds, ref_ds = _tiny_datasets()
    with pytest.raises(ValueError) as got:
        composed.main(config.ComposedConfig(device="cpu", **kw), datasets=port_ds)
    with pytest.raises(ValueError) as want:
        jax_composed.main(jax_config.ComposedConfig(results_dir=str(tmp_path), **kw),
                          datasets=ref_ds)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,match", [
    # each mesh trains now; what is refused is a launcher world other than its product,
    # with the JAX package's make_mesh words
    ({"mesh": "data=2,seq=2", "flash_attention": True, "seq_len": 256},
     "requested 4 devices, have 1"),
    ({"mesh": "data=1,seq=2,model=2", "seq_len": 256}, "requested 4 devices, have 1"),
    ({"mesh": "data=2,seq=2", "seq_impl": "ulysses"}, "requested 4 devices, have 1"),
    ({"mesh": "data=2,seq=2", "zigzag_attention": True, "causal": True, "seq_len": 512},
     "requested 4 devices, have 1"),
    ({"mesh": "data=1,seq=2", "flash_attention": True, "seq_len": 256},
     "requested 2 devices, have 1"),
])
def test_unported_seq_configs_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        composed.main(config.ComposedConfig(device="cpu", **kw),
                      datasets=_tiny_datasets()[0])


def test_ring_function_errors_match_jax():
    rng = np.random.default_rng(0)
    x100, x128 = (rng.normal(size=(1, s, 2, 8)).astype(np.float32) for s in (100, 128))
    jmesh = make_mesh(1, axis_names=("seq",))
    with mesh.cluster("cpu"):
        for port_call, jax_call in (
                (lambda: ra.ring_flash_attention(*[torch.from_numpy(x100)] * 3),
                 lambda: jax_ring_flash_attention(jmesh, *[jnp.asarray(x100)] * 3)),
                (lambda: ra.zigzag_ring_flash_attention(*[torch.from_numpy(x128)] * 3),
                 lambda: jax_zigzag_ring_flash_attention(jmesh,
                                                              *[jnp.asarray(x128)] * 3)),
                (lambda: ra.ring_flash_attention(*[torch.from_numpy(x128)] * 3, window=-1),
                 lambda: jax_ring_flash_attention(jmesh, *[jnp.asarray(x128)] * 3,
                                                       window=-1)),
                (lambda: ra.make_ring_attention_fn(use_flash=True, use_zigzag=True)(
                    *[torch.from_numpy(x128)] * 3, causal=False),
                 lambda: jax_make_ring_attention_fn(jmesh, use_flash=True,
                                                         use_zigzag=True)(
                    *[jnp.asarray(x128)] * 3, causal=False))):
            with pytest.raises(ValueError) as got:
                port_call()
            with pytest.raises(ValueError) as want:
                jax_call()
            assert str(got.value) == str(want.value)
        # the einsum zig-zag refuses bidirectional attention as the JAX one does
        with pytest.raises(ValueError) as got:
            ra.make_ring_attention_fn(use_zigzag=True)(*[torch.from_numpy(x128)] * 3)
        with pytest.raises(ValueError) as want:
            jax_make_ring_attention_fn(jmesh, use_zigzag=True)(*[jnp.asarray(x128)] * 3)
        assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="process group"):
        ra.ring_flash_attention(*[torch.from_numpy(x128)] * 3)


def test_seq_axis_size():
    """The seq axis is the grid's: its size, and each rank's index along it, row-major
    over the spec as the JAX package's make_mesh lays out its devices."""
    assert mesh.ProcessGrid("data=1").size("seq") == 1
    assert mesh.ProcessGrid("data=1,seq=4", rank=3, world=4).axis("seq").index == 3
    grid = mesh.ProcessGrid("data=2,seq=2,model=2", rank=5, world=8)
    assert grid.coords == {"data": 1, "seq": 0, "model": 1}
    assert grid.axis("seq").ranks == (5, 7) and grid.axis("data").ranks == (1, 5)
    assert grid.axis("model").ranks == (4, 5) and grid.size("stage") == 1
    for spec in ("data=2", "data=2,seq=2", "data=1,seq=2,model=2", "stage=2"):
        with pytest.raises(ValueError, match="devices, have 1"):
            mesh.ProcessGrid(spec)
    with pytest.raises(ValueError, match="must equal the launcher's world"):
        mesh.ProcessGrid("data=2", rank=0, world=4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
