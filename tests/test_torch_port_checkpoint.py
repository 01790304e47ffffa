"""PyTorch port, checkpoints: the first-party msgpack codec against msgpack-python, and the
checkpoint files against the JAX package's, byte for byte and restored both ways.

Tolerances: none. The codec writes msgpack-python's bytes (the ``packb`` flax calls) at
every length boundary; the port's ``save_train_state``, ``save_params`` and
``save_versioned`` write the JAX package's bytes for the same state; each package restores
the other's files bitwise (a layout change moves axes, never values).
"""

import hashlib
import itertools
import os
import subprocess
import sys
import threading

import flax.serialization as flax_ser
import jax
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from csed_514_project_distributed_training_using_pytorch_tpu.models.cnn import Net as JaxNet
from csed_514_project_distributed_training_using_pytorch_tpu.ops import optim as jax_optim
from csed_514_project_distributed_training_using_pytorch_tpu.train import step as jax_step
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    checkpoint as jax_checkpoint,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import optim
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import step
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    _msgpack,
    checkpoint,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flax_packb(value) -> bytes:
    """What flax writes: msgpack-python's packb as ``msgpack_serialize`` calls it."""
    return msgpack.packb(value, default=flax_ser._msgpack_ext_pack, strict_types=True)


# -- the codec --------------------------------------------------------------------------

INTS = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1, 2 ** 64 - 1,
        -1, -32, -33, -128, -129, -2 ** 15 - 1, -2 ** 63]
LENGTHS = [0, 31, 32, 255, 256, 65536]
CODEC_CASES = (
    [("int", v) for v in INTS]
    + [("str", "s" * n) for n in LENGTHS] + [("bin", b"b" * n) for n in LENGTHS]
    + [("map", {f"k{i}": i for i in range(n)}) for n in (15, 16, 65536)]
    + [("ext", _msgpack.ExtType(5, bytes(range(256)) * (n // 256) + bytes(n % 256)))
       for n in (1, 2, 4, 8, 16, 17, 255, 256, 65536)]
    + [("nil", None), ("bool", True), ("bool", False), ("float64", 0.1),
       ("float64", -2.5e300), ("float64", float("inf"))])


def _case_id(case):
    kind, value = case
    size = len(value.data) if kind == "ext" else (
        value if kind in ("int", "bool") else len(value) if hasattr(value, "__len__")
        else value)
    return f"{kind}-{size}"


@pytest.mark.parametrize("case", CODEC_CASES, ids=[_case_id(c) for c in CODEC_CASES])
def test_codec_matches_msgpack_at_every_length_boundary(case):
    kind, value = case
    want = (msgpack.packb(msgpack.ExtType(value.code, value.data)) if kind == "ext"
            else flax_packb(value))
    assert _msgpack.packb(value) == want
    got = _msgpack.unpackb(want, ext_hook=_msgpack.ExtType) if kind == "ext" else \
        _msgpack.unpackb(want)
    assert got == value and type(got) is type(value)


@pytest.mark.parametrize("value", [
    np.arange(6, dtype=np.float32).reshape(2, 3), np.zeros((), np.int32),
    np.arange(5, dtype=np.int64), np.array([True, False]), np.zeros((0, 3), np.float32),
    np.arange(24, dtype=np.uint8).reshape(2, 3, 4), np.float32(3.5), np.int64(-4),
    np.bool_(True), np.float64(2.0)], ids=lambda v: f"{type(v).__name__}-{v.dtype}")
def test_codec_writes_and_reads_flax_arrays_and_scalars(value):
    tree = {"leaf": value}
    data = flax_ser.msgpack_serialize(tree)
    assert _msgpack.packb(tree) == data
    ours, theirs = _msgpack.from_bytes(data)["leaf"], flax_ser.msgpack_restore(data)["leaf"]
    assert type(ours) is type(theirs) and ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


def test_codec_reads_flaxs_chunked_arrays_and_refuses_to_write_one_unchunked(monkeypatch):
    """flax splits a leaf over MAX_CHUNK_SIZE bytes into ``__msgpack_chunked_array__``
    chunks: read back as one array, at a limit lowered to 64 bytes; the encoder raises on
    such a leaf instead of writing bytes flax would not."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(50, dtype=np.float32).reshape(5, 10),
            "small": np.arange(3, dtype=np.float32)}
    data = flax_ser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    back = _msgpack.from_bytes(data)
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    with pytest.raises(ValueError, match="__msgpack_chunked_array__"):
        _msgpack.packb(tree)
    assert _msgpack.packb({"small": tree["small"]}) == flax_ser.msgpack_serialize(
        {"small": tree["small"]})


def test_codec_rejects_truncated_and_trailing_bytes_and_foreign_types():
    data = flax_ser.msgpack_serialize({"a": np.arange(4, dtype=np.float32), "s": "x" * 40,
                                       "n": 70000})
    for cut in range(len(data)):
        with pytest.raises(ValueError):
            _msgpack.unpackb(data[:cut])
    with pytest.raises(ValueError, match="trailing"):
        _msgpack.unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="ext type 5"):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(5, b"abc")))
    with pytest.raises(ValueError, match="0xc1"):
        _msgpack.unpackb(b"\xc1")
    with pytest.raises(TypeError, match="complex"):
        _msgpack.packb(1j)
    with pytest.raises(OverflowError):
        _msgpack.packb(2 ** 64)


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=300))
_arrays = st.builds(
    lambda dtype, shape, seed: np.random.default_rng(seed).integers(
        0, 100, size=shape).astype(dtype),
    st.sampled_from(["float32", "int32", "int64", "uint8", "bool"]),
    st.lists(st.integers(0, 4), max_size=3).map(tuple), st.integers(0, 2 ** 16))
_trees = st.recursive(_scalars | _arrays,
                      lambda children: st.dictionaries(st.text(max_size=12), children,
                                                       max_size=6),
                      max_leaves=20)


@settings(max_examples=150, deadline=None)
@given(_trees)
def test_codec_round_trips_random_trees_as_msgpack_does(tree):
    data = flax_packb(tree)
    assert _msgpack.packb(tree) == data
    back = _msgpack.unpackb(data)
    assert _msgpack.packb(back) == data          # equal trees, arrays and dtypes included


# -- states in both packages ------------------------------------------------------------

CONFIGS = list(itertools.product(("sgd", "adamw"), (False, True), (False, True)))
CONFIG_IDS = [f"{o}-ema{int(e)}-guard{int(g)}" for o, e, g in CONFIGS]
JAX_GUARD_DTYPES = {"ema_mean": np.float32, "ema_sq": np.float32}


def _jax_state(opt: str, ema: bool, guard: bool, seed: int = 0):
    """A JAX ``TrainState`` initialised by the JAX package, its optimizer state, EMA, step
    and guard counters filled from ``np.random.default_rng(seed)``."""
    optimizer = jax_optim.make_optimizer(opt, learning_rate=0.01, momentum=0.5)
    init = jax_step.create_train_state(JaxNet(), jax.random.PRNGKey(seed),
                                       optimizer=optimizer, ema=ema, guard=guard)
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v) for k, v in init.params.items()}
    noise = lambda: {k: rng.normal(size=v.shape).astype(np.float32)
                     for k, v in params.items()}
    velocity = noise() if opt == "sgd" else {
        "m": noise(), "v": {k: np.abs(v) for k, v in noise().items()},
        "count": np.asarray(rng.integers(1, 1000), np.int32)}
    guard_state = None
    if guard:
        guard_state = jax_step.GuardState(*(
            np.asarray(rng.normal() if f in JAX_GUARD_DTYPES else rng.integers(-1, 50),
                       JAX_GUARD_DTYPES.get(f, np.int32))
            for f in jax_step.GuardState._fields))
    return jax_step.TrainState(params, velocity,
                               np.asarray(rng.integers(1, 10 ** 6), np.int32),
                               noise() if ema else None, guard_state)


def _jax_dict(state) -> dict:
    """A JAX state's serialization form (host numpy), as its checkpoint holds it."""
    out = {"params": state.params, "velocity": state.velocity, "step": state.step}
    if state.ema is not None:
        out["ema"] = state.ema
    if state.guard is not None:
        out["guard"] = state.guard._asdict()
    return jax.device_get(out)


def _port_reference(opt: str, ema: bool, guard: bool, seed: int = 1):
    optimizer = optim.make_optimizer(opt, learning_rate=0.01, momentum=0.5)
    return step.create_train_state(cnn.Net(), torch.Generator().manual_seed(seed),
                                   optimizer=optimizer, ema=ema, guard=guard)


def _port_state(opt: str, ema: bool, guard: bool, seed: int = 0):
    """The JAX state of ``_jax_state`` carried across into the port."""
    return checkpoint.state_from_jax_dict(_jax_dict(_jax_state(opt, ema, guard, seed)),
                                          _port_reference(opt, ema, guard))


def _assert_trees_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("opt,ema,guard", CONFIGS, ids=CONFIG_IDS)
def test_save_train_state_writes_the_jax_packages_bytes(tmp_path, opt, ema, guard):
    jstate = _jax_state(opt, ema, guard)
    pstate = checkpoint.state_from_jax_dict(_jax_dict(jstate),
                                            _port_reference(opt, ema, guard))
    assert pstate.step.dtype == torch.int64
    jax_checkpoint.save_train_state(str(tmp_path / "jax.ckpt"), jstate)
    checkpoint.save_train_state(str(tmp_path / "port.ckpt"), pstate)
    data = (tmp_path / "jax.ckpt").read_bytes()
    assert (tmp_path / "port.ckpt").read_bytes() == data
    top = list(msgpack.unpackb(data, raw=False))
    assert top == ["params", "velocity", "step"] + ["ema"] * ema + ["guard"] * guard


@pytest.mark.parametrize("opt,ema,guard", CONFIGS, ids=CONFIG_IDS)
def test_save_params_and_save_versioned_write_the_jax_packages_bytes(tmp_path, opt, ema,
                                                                     guard):
    jstate = _jax_state(opt, ema, guard, seed=3)
    pstate = checkpoint.state_from_jax_dict(_jax_dict(jstate),
                                            _port_reference(opt, ema, guard))
    jax_checkpoint.save_params(str(tmp_path / "jax.msgpack"), jstate.params)
    checkpoint.save_params(str(tmp_path / "port.msgpack"), pstate.params)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    stamp = dict(health={"clean": True, "anomalies": 0, "skipped": 0,
                         "step": int(jstate.step), "fingerprint": 1.5},
                 cursor={"version": 1, "kind": "epoch", "seed": 1, "epoch": 2, "batch": 0,
                         "step": int(jstate.step)})
    j = jax_checkpoint.save_versioned(str(tmp_path / "jax_store"), jstate, keep=2, **stamp)
    p = checkpoint.save_versioned(str(tmp_path / "port_store"), pstate, keep=2, **stamp)
    assert os.path.basename(p) == os.path.basename(j) == checkpoint.versioned_name(
        int(jstate.step))
    assert open(p, "rb").read() == open(j, "rb").read()
    drop_time = lambda man: [{k: v for k, v in e.items() if k != "unix_time"}
                             for e in man["entries"]]
    assert drop_time(jax_checkpoint.load_manifest(str(tmp_path / "port_store"))) == \
        drop_time(jax_checkpoint.load_manifest(str(tmp_path / "jax_store")))


@pytest.mark.parametrize("opt,ema,guard", CONFIGS, ids=CONFIG_IDS)
def test_port_restores_a_jax_file_bitwise(tmp_path, opt, ema, guard):
    jstate = _jax_state(opt, ema, guard, seed=5)
    path = str(tmp_path / "jax.ckpt")
    jax_checkpoint.save_train_state(path, jstate)
    got = checkpoint.restore_train_state(path, _port_reference(opt, ema, guard))
    assert int(got.step) == int(jstate.step) and got.step.dtype == torch.int64
    want = cnn.params_from_jax(jstate.params)
    for k, v in want.items():
        assert torch.equal(got.params[k], v), k
    _assert_trees_equal(checkpoint.state_to_jax_dict(got), _jax_dict(jstate))


@pytest.mark.parametrize("opt,ema,guard", CONFIGS, ids=CONFIG_IDS)
def test_jax_restores_a_port_file_bitwise(tmp_path, opt, ema, guard):
    pstate = _port_reference(opt, ema, guard, seed=6)
    gen = torch.Generator().manual_seed(6)
    perturb = lambda d: {k: v + torch.randn(v.shape, generator=gen) for k, v in d.items()}
    velocity = (perturb(pstate.velocity) if opt == "sgd" else
                {"m": perturb(pstate.velocity["m"]), "v": perturb(pstate.velocity["v"]),
                 "count": torch.tensor(41)})
    pstate = pstate._replace(params=perturb(pstate.params), velocity=velocity,
                             step=torch.tensor(4321),
                             ema=perturb(pstate.ema) if ema else None)
    path = str(tmp_path / "port.ckpt")
    checkpoint.save_train_state(path, pstate)
    jref = jax_step.create_train_state(
        JaxNet(), jax.random.PRNGKey(9), ema=ema, guard=guard,
        optimizer=jax_optim.make_optimizer(opt, learning_rate=0.01, momentum=0.5))
    got = jax.device_get(jax_checkpoint.restore_train_state(path, jref))
    assert int(got.step) == 4321
    _assert_trees_equal(got.params, cnn.params_to_jax(pstate.params))
    _assert_trees_equal(_jax_dict(got), checkpoint.state_to_jax_dict(pstate))


RECONCILE = [("ema", True, False), ("ema", False, True), ("guard", True, False),
             ("guard", False, True)]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("field,in_file,in_state", RECONCILE,
                         ids=[f"{f}-file{int(a)}-state{int(b)}" for f, a, b in RECONCILE])
def test_ema_and_guard_reconcile_as_in_the_jax_package(tmp_path, writer, field, in_file,
                                                       in_state):
    """A file with or without the optional field restores into a state with or without
    it, through both packages alike: a missing EMA seeds from the params, a missing guard
    keeps the state's fresh counters, an unwanted one is dropped."""
    flags = lambda on: dict(ema=on and field == "ema", guard=on and field == "guard")
    jstate = _jax_state("sgd", **flags(in_file), seed=7)
    path = str(tmp_path / "file.ckpt")
    if writer == "jax":
        jax_checkpoint.save_train_state(path, jstate)
    else:
        checkpoint.save_train_state(path, _port_state("sgd", **flags(in_file), seed=7))
    jref = jax_step.create_train_state(JaxNet(), jax.random.PRNGKey(2), **flags(in_state))
    want = _jax_dict(jax_checkpoint.restore_train_state(path, jref))
    got = checkpoint.restore_train_state(path, _port_reference("sgd", **flags(in_state)))
    assert (getattr(got, field) is None) == (not in_state)
    _assert_trees_equal(checkpoint.state_to_jax_dict(got), want)
    if field == "ema" and in_state:
        for k, v in got.params.items():
            assert torch.equal(got.ema[k], v), k


# -- params exports ---------------------------------------------------------------------


def test_params_exports_load_in_both_packages(tmp_path):
    jstate = _jax_state("sgd", True, False, seed=8)
    pstate = checkpoint.state_from_jax_dict(_jax_dict(jstate), _port_reference("sgd", True,
                                                                               False))
    ref = _port_reference("sgd", False, False).params
    checkpoint.save_params(str(tmp_path / "port.msgpack"), pstate.ema)
    jax_checkpoint.save_params(str(tmp_path / "jax.msgpack"), jstate.ema)
    checkpoint.save_train_state(str(tmp_path / "state.ckpt"), pstate)
    for name, want in (("port.msgpack", pstate.ema), ("jax.msgpack", pstate.ema),
                       ("state.ckpt", pstate.params)):
        got = checkpoint.load_params_or_state(str(tmp_path / name), ref)
        assert all(torch.equal(got[k], want[k]) for k in want), name
        theirs = jax_checkpoint.load_params_or_state(str(tmp_path / name), jstate.params)
        _assert_trees_equal(jax.device_get(theirs), cnn.params_to_jax(want))
    got = checkpoint.load_params(str(tmp_path / "jax.msgpack"), ref)
    assert all(torch.equal(got[k], pstate.ema[k]) for k in ref)
    with pytest.raises(ValueError, match="not a train-state checkpoint"):
        checkpoint.restore_train_state(str(tmp_path / "port.msgpack"),
                                       _port_reference("sgd", False, False))


def test_restore_raises_on_a_state_of_another_structure(tmp_path):
    path = str(tmp_path / "sgd.ckpt")
    checkpoint.save_train_state(path, _port_state("sgd", False, False))
    with pytest.raises(ValueError, match="AdamW"):
        checkpoint.restore_train_state(path, _port_reference("adamw", False, False))
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
        TransformerClassifier,
    )
    model = TransformerClassifier()
    tstate = step.create_train_state(model, torch.Generator().manual_seed(0))
    checkpoint.save_train_state(str(tmp_path / "t.ckpt"), tstate)     # the nested tree
    with pytest.raises(ValueError, match="keys"):
        checkpoint.restore_train_state(str(tmp_path / "t.ckpt"), _port_reference(
            "sgd", False, False))
    with pytest.raises(ValueError, match="beyond the model's"):
        checkpoint.restore_train_state(path, tstate)


# -- the store --------------------------------------------------------------------------


def _store(tmp_path, steps, *, keep=3, clean=lambda s: True):
    base = _port_state("sgd", False, True, seed=11)
    for s in steps:
        checkpoint.save_versioned(str(tmp_path), base._replace(step=torch.tensor(s)),
                                  keep=keep,
                                  health={"clean": clean(s), "anomalies": 0, "skipped": 0,
                                          "step": s, "fingerprint": 0.0})
    return str(tmp_path)


def test_truncated_checkpoint_raises_checkpoint_corrupt_naming_the_path(tmp_path):
    path = tmp_path / "model.ckpt"
    checkpoint.save_train_state(str(path), _port_state("sgd", False, False))
    path.write_bytes(path.read_bytes()[:-100])
    ref = _port_reference("sgd", False, False)
    with pytest.raises(checkpoint.CheckpointCorrupt, match=str(path)):
        checkpoint.restore_train_state(str(path), ref)
    with pytest.raises(checkpoint.CheckpointCorrupt, match="model.ckpt"):
        checkpoint.load_params_or_state(str(path), ref.params)
    with pytest.raises(jax_checkpoint.CheckpointCorrupt):       # and the JAX package's
        jax_checkpoint.restore_train_state(str(path), _jax_state("sgd", False, False))


def test_newest_valid_skips_a_torn_file(tmp_path):
    store = _store(tmp_path, (10, 20, 30))
    newest = os.path.join(store, checkpoint.versioned_name(30))
    with open(newest, "r+b") as f:
        f.truncate(1000)
    want = os.path.join(store, checkpoint.versioned_name(20))
    assert checkpoint.newest_valid_checkpoint(store) == want
    assert jax_checkpoint.newest_valid_checkpoint(store) == want
    os.remove(os.path.join(store, checkpoint.MANIFEST_NAME))        # decode-validated
    assert checkpoint.newest_valid_checkpoint(store) == want
    assert checkpoint.newest_valid_checkpoint(str(tmp_path / "absent")) is None


def test_newest_healthy_prefers_the_newest_clean_stamp(tmp_path):
    store = _store(tmp_path, (10, 20, 30), clean=lambda s: s != 30)
    name = lambda s: os.path.join(store, checkpoint.versioned_name(s))
    assert checkpoint.newest_healthy_checkpoint(store) == name(20)
    assert jax_checkpoint.newest_healthy_checkpoint(store) == name(20)
    assert checkpoint.newest_healthy_checkpoint(store, before_step=20) == name(10)
    assert checkpoint.newest_valid_checkpoint(store) == name(30)


def test_keep_n_gc_and_the_manifest_the_jax_package_reads(tmp_path):
    store = _store(tmp_path, (10, 20, 30, 40), keep=2)
    files = sorted(f for f in os.listdir(store) if f.endswith(".msgpack"))
    assert files == [checkpoint.versioned_name(30), checkpoint.versioned_name(40)]
    man = jax_checkpoint.load_manifest(store)
    assert [e["step"] for e in man["entries"]] == [30, 40]
    for e in man["entries"]:
        assert set(e) == {"file", "step", "sha256", "bytes", "unix_time", "health"}
        data = open(os.path.join(store, e["file"]), "rb").read()
        assert e["sha256"] == hashlib.sha256(data).hexdigest() and e["bytes"] == len(data)
    path = os.path.join(store, checkpoint.versioned_name(40))
    assert checkpoint.manifest_entry_for(path) == jax_checkpoint.manifest_entry_for(path)


def test_check_cursor_resume_gives_the_jax_packages_note(tmp_path):
    state = _port_state("sgd", False, False, seed=12)._replace(step=torch.tensor(16))
    cursor = {"version": 1, "kind": "epoch", "seed": 1, "epoch": 2, "batch": 0, "step": 16}
    path = checkpoint.save_versioned(str(tmp_path), state, cursor=cursor)
    assert checkpoint.cursor_for(path) == jax_checkpoint.cursor_for(path) == cursor
    for kw in (dict(seed=1, step=16), dict(seed=2, step=16),
               dict(seed=2, step=17, start_epoch=3)):
        ours = checkpoint.check_cursor_resume(path, **kw)
        assert ours == jax_checkpoint.check_cursor_resume(path, **kw)
        assert (ours is None) == (kw == dict(seed=1, step=16))
    assert "cursor seed 1 != config seed 2" in checkpoint.check_cursor_resume(
        path, seed=2, step=16)


# -- savers -----------------------------------------------------------------------------


def test_async_saver_writes_the_sync_savers_bytes_from_a_host_copy(tmp_path):
    """The async saver copies the state before it returns: training that then updates the
    tensors in place (as the fused kernels and a graph replay do) cannot reach the file.
    Writes to one path coalesce to the newest."""
    state = _port_state("sgd", True, True, seed=13)
    checkpoint.save_train_state(str(tmp_path / "sync.ckpt"), state)
    saver = checkpoint.make_saver(async_=True)
    with saver:
        saver.save_train_state(str(tmp_path / "async.ckpt"), state)
        for tree in (state.params, state.velocity, state.ema):
            for t in tree.values():
                t.add_(1.0)                                  # the next step, in place
        saver.save_train_state(str(tmp_path / "async2.ckpt"), state)
        for _ in range(5):
            saver.save_train_state(str(tmp_path / "async2.ckpt"), state)
    checkpoint.save_train_state(str(tmp_path / "sync2.ckpt"), state)
    assert (tmp_path / "async.ckpt").read_bytes() == (tmp_path / "sync.ckpt").read_bytes()
    assert (tmp_path / "async2.ckpt").read_bytes() == (tmp_path / "sync2.ckpt").read_bytes()
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert not [t for t in threading.enumerate() if t.name == "async-checkpoint"]


def test_async_saver_reraises_a_background_error_on_flush(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = checkpoint.AsyncCheckpointer()
    saver.save_train_state(str(blocker / "model.ckpt"), _port_state("sgd", False, False))
    with pytest.raises(OSError):
        saver.flush()
    saver.flush()                                            # the error is reported once


def test_saves_are_rank_0_gated(tmp_path, monkeypatch):
    monkeypatch.setenv("RANK", "1")
    state = _port_state("sgd", False, False)
    checkpoint.save_train_state(str(tmp_path / "a.ckpt"), state)
    checkpoint.save_params(str(tmp_path / "b.msgpack"), state.params)
    assert checkpoint.save_versioned(str(tmp_path / "store"), state) is None
    with checkpoint.make_saver(async_=True) as saver:
        saver.save_train_state(str(tmp_path / "c.ckpt"), state)
    assert os.listdir(tmp_path) == []


def test_the_port_checkpoints_where_msgpack_and_flax_are_absent(tmp_path):
    """A fresh interpreter in which msgpack, flax and jax cannot be imported saves,
    restores and exports through the port alone."""
    code = f"""
import sys
for name in ("msgpack", "flax", "jax"):
    sys.modules[name] = None
import torch
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import step
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import checkpoint
state = step.create_train_state(cnn.Net(), torch.Generator().manual_seed(0), ema=True,
                                guard=True)
checkpoint.save_train_state({str(tmp_path / "s.ckpt")!r}, state)
back = checkpoint.restore_train_state({str(tmp_path / "s.ckpt")!r}, state)
assert all(torch.equal(back.params[k], v) for k, v in state.params.items())
checkpoint.save_params({str(tmp_path / "p.msgpack")!r}, state.params)
checkpoint.load_params({str(tmp_path / "p.msgpack")!r}, state.params)
assert "msgpack" not in [m for m in sys.modules if sys.modules[m] is not None]
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]
