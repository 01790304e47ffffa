"""PyTorch port, the prefill/decode tiers' codec and handoff wire (``serving/tiers.py``),
against the JAX package's.

Seeded numpy planes in f32, bf16, int8 with f32 scales and fp8 e4m3fn (``ml_dtypes`` on
the JAX side; the port needs none): the JAX ``encode_planes`` payload decodes in the port
to tensors bitwise equal to the planes and the port's own payload of those tensors is the
same dict; the port's payload decodes in the JAX package to the planes. One flipped byte
raises ``WireCorrupt`` and a layout mismatch ``ValueError`` in both. ``parse_tier_spec``
and ``parse_shard_spec`` agree on a table of specs, errors included. Each package's
``ship_planes`` talks to the other's ``read_handoff``/``send_ack`` over a local socket.
"""

import base64
import copy
import socket
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    tiers as jax_tiers,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving import (
    wire as jax_wire,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import tiers, wire

# numpy's dtype on the JAX side -> the torch dtype the port decodes to
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
          "int8": (np.int8, torch.int8),
          "float8_e4m3fn": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn)}
LAYOUT = "layers=2;k:bfloat16[32, 2, 8],v:bfloat16[32, 2, 8]"


def _planes(kind: str, seed: int = 0) -> dict:
    """One slot's plane tree of two layers as numpy arrays: ``kind`` planes, and the int8
    layout's f32 scale planes beside its codes."""
    rng = np.random.default_rng(seed)
    np_dtype = DTYPES[kind][0]
    tree = {}
    for layer in ("layer_0", "layer_1"):
        if kind == "int8":
            tree[layer] = {
                "k": rng.integers(-127, 128, size=(32, 2, 8)).astype(np.int8),
                "v": rng.integers(-127, 128, size=(32, 2, 8)).astype(np.int8),
                "k_scale": rng.random((32, 2)).astype(np.float32),
                "v_scale": rng.random((32, 2)).astype(np.float32)}
        else:
            tree[layer] = {name: (rng.standard_normal((32, 2, 8)) * 2).astype(np_dtype)
                           for name in ("k", "v")}
    return tree


def _as_torch(tree: dict) -> dict:
    """The numpy planes as torch tensors of the same bits (bf16/fp8 through a uint view)."""
    return {name: {key: torch.from_numpy(np.ascontiguousarray(arr).view(np.uint8).copy())
                   .view(DTYPES[arr.dtype.name][1])
                   for key, arr in layer.items()}
            for name, layer in tree.items()}


def _same_bits(t: torch.Tensor, arr: np.ndarray) -> bool:
    return (t.dtype == DTYPES[arr.dtype.name][1] and list(t.shape) == list(arr.shape)
            and t.contiguous().view(torch.uint8).numpy().tobytes() == arr.tobytes())


@pytest.mark.parametrize("kind", list(DTYPES))
def test_codec_is_bitwise_both_ways(kind):
    planes = _planes(kind, seed=len(kind))
    jax_payload = jax_tiers.encode_planes(planes, layout=LAYOUT)
    back = tiers.decode_planes(jax_payload, layout=LAYOUT)
    assert sorted(back) == sorted(planes)
    for name, layer in planes.items():
        assert sorted(back[name]) == sorted(layer)
        for key, arr in layer.items():
            assert _same_bits(back[name][key], arr), (name, key)
    ours = tiers.encode_planes(_as_torch(planes), layout=LAYOUT)
    assert ours == jax_payload
    jax_back = jax_tiers.decode_planes(ours, layout=LAYOUT)
    for name, layer in planes.items():
        for key, arr in layer.items():
            assert jax_back[name][key].dtype == arr.dtype
            assert jax_back[name][key].tobytes() == arr.tobytes()


def test_numpy_leaves_and_the_echo_payload_match():
    """An echo replica ships numpy (no torch): the same payload as the JAX codec's."""
    prompt = np.arange(7, dtype=np.int32)
    assert tiers.encode_planes({"echo": prompt}) == jax_tiers.encode_planes({"echo": prompt})
    back = tiers.decode_planes(jax_tiers.encode_planes({"echo": prompt}))
    assert back["echo"].dtype == torch.int32 and back["echo"].tolist() == prompt.tolist()
    empty = {"l": {"k": np.zeros((0, 2, 8), np.float32)}}
    assert tiers.encode_planes(empty) == jax_tiers.encode_planes(empty)
    assert tuple(tiers.decode_planes(tiers.encode_planes(empty))["l"]["k"].shape) == (0, 2, 8)


@pytest.mark.parametrize("where", ["first", "last"])
def test_a_flipped_byte_is_wire_corrupt_in_both(where):
    payload = jax_tiers.encode_planes(_planes("bfloat16"), layout=LAYOUT)
    bad = copy.deepcopy(payload)
    entry = bad["planes"][0 if where == "first" else -1]
    raw = bytearray(base64.b64decode(entry["data"]))
    raw[len(raw) // 2] ^= 0x40
    entry["data"] = base64.b64encode(bytes(raw)).decode("ascii")
    with pytest.raises(jax_wire.WireCorrupt) as jax_err:
        jax_tiers.decode_planes(bad, layout=LAYOUT)
    with pytest.raises(wire.WireCorrupt) as err:
        tiers.decode_planes(bad, layout=LAYOUT)
    assert str(err.value) == str(jax_err.value)


def test_a_layout_mismatch_is_a_value_error_in_both():
    payload = tiers.encode_planes(_as_torch(_planes("int8")), layout="int8-planes")
    with pytest.raises(ValueError) as jax_err:
        jax_tiers.decode_planes(payload, layout="fp32-planes")
    with pytest.raises(ValueError) as err:
        tiers.decode_planes(payload, layout="fp32-planes")
    assert str(err.value) == str(jax_err.value)


TIER_SPECS = ["", None, "prefill:1,decode:2", "prefill,decode", " prefill : 1 , decode:1",
              "unified:3", "decode:2,prefill:1", "prefil:1", "prefill:0", "prefill:x",
              "decode:-1", ",,prefill:1,,"]
SHARD_SPECS = ["", None, "tp=2,dp=4", "dp=2", "tp=1", " tp = 2 ", "tp=0", "pp=2", "tp=x",
               "tp=2,tp=4", "tp"]


def _outcome(fn, spec):
    try:
        return ("ok", fn(spec))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", TIER_SPECS)
def test_parse_tier_spec_agrees(spec):
    assert _outcome(tiers.parse_tier_spec, spec) == _outcome(jax_tiers.parse_tier_spec, spec)


@pytest.mark.parametrize("spec", SHARD_SPECS)
def test_parse_shard_spec_agrees(spec):
    assert _outcome(tiers.parse_shard_spec, spec) == _outcome(
        jax_tiers.parse_shard_spec, spec)


def test_roles_are_the_jax_roles():
    assert (tiers.ROLES, tiers.ROLE_UNIFIED, tiers.ROLE_PREFILL, tiers.ROLE_DECODE) == (
        jax_tiers.ROLES, jax_tiers.ROLE_UNIFIED, jax_tiers.ROLE_PREFILL,
        jax_tiers.ROLE_DECODE)


def _listener(mod, seen: list):
    """A one-shot handoff listener of ``mod`` on a free local port: reads one message,
    acks it ok with its byte count (or not ok naming the layout problem)."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)

    def serve():
        conn, _ = sock.accept()
        with conn:
            msg = mod.read_handoff(conn)
            seen.append(msg)
            ok = msg.get("layout") == LAYOUT
            mod.send_ack(conn, request_id=msg["id"], ok=ok, nbytes=msg["bytes"],
                         reason=None if ok else "layout")
        sock.close()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    return sock.getsockname()[1], thread


@pytest.mark.parametrize("sender,receiver", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("layout", [LAYOUT, "other"])
def test_ship_planes_talks_to_the_other_package(sender, receiver, layout):
    planes = _planes("bfloat16", seed=5)
    send_mod, recv_mod = ((tiers, jax_tiers) if sender == "port" else (jax_tiers, tiers))
    payload = (tiers.encode_planes(_as_torch(planes), layout=layout) if sender == "port"
               else jax_tiers.encode_planes(planes, layout=layout))
    seen: list = []
    port, thread = _listener(recv_mod, seen)
    ack = send_mod.ship_planes("127.0.0.1", port, request_id=17, tokens=np.arange(5),
                               payload=payload, timeout_s=30.0)
    thread.join(timeout=30)
    assert seen[0] == {"op": "kv_handoff", "id": 17, "tokens": [0, 1, 2, 3, 4], **payload}
    want = {"op": "kv_handoff_ack", "id": 17, "ok": layout == LAYOUT,
            "bytes": payload["bytes"]}
    if layout != LAYOUT:
        want["reason"] = "layout"
    assert ack == want
