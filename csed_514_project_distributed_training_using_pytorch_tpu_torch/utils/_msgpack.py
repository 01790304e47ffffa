"""A first-party msgpack codec for the subset that ``flax.serialization.to_bytes`` emits.

The JAX package writes its checkpoints with flax, which packs a state dict with
msgpack-python (``packb(tree, default=_msgpack_ext_pack, strict_types=True)``, binary type
on). The port reads and writes the same files, on machines that have neither flax nor
msgpack, so it carries its own codec for that subset:

- maps with str keys, str, bin, nil, bool, ints over the whole int64/uint64 range,
  float64 and (inside ext payloads) arrays;
- ext 1 (an ndarray) and ext 3 (a numpy scalar). Each payload is itself the msgpack of the
  tuple ``(shape, dtype.name, C-order bytes)``, as in flax's ``_ndarray_to_bytes``. Other
  ext codes pass through as ``ExtType`` when written, and reach ``unpackb``'s ``ext_hook``
  when read (by default they raise).

``packb`` emits the bytes msgpack-python 1.1 emits for the same tree: the smallest form of
every int, str, bin, map, array and ext header, fixext 1/2/4/8/16 included. Types are
checked exactly, as under ``strict_types``: a numpy float64 is a numpy scalar (ext 3), not
a float. ``unpackb`` reads any such stream and raises ``ValueError`` on a truncated stream,
on trailing bytes and on a type outside the subset.

flax writes an array over ``MAX_CHUNK_SIZE`` bytes (2^30) in a chunked form (a map with the
key ``__msgpack_chunked_array__``, the shape and the flat chunks as maps keyed "0", "1",
...). ``from_bytes`` reads it back, as flax's ``msgpack_restore`` does; ``packb`` raises on
such an array rather than write it unchunked. No CNN state comes near that size.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30          # flax's limit for one array leaf before it chunks
_CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    """A raw ext object (msgpack-python's ``ExtType``): ``packb`` writes one as it is,
    and ``unpackb(..., ext_hook=...)`` hands each ext's code and payload to the hook."""

    code: int
    data: bytes


# -- the encoder ------------------------------------------------------------------------


def _pack_int(v: int, out: bytearray) -> None:
    if v < -(1 << 5):
        if v < -(1 << 15):
            if v < -(1 << 31):
                if v < -(1 << 63):
                    raise OverflowError(f"int {v} is below the int64 range")
                out += b"\xd3" + struct.pack(">q", v)
            else:
                out += b"\xd2" + struct.pack(">i", v)
        elif v < -(1 << 7):
            out += b"\xd1" + struct.pack(">h", v)
        else:
            out += b"\xd0" + struct.pack(">b", v)
    elif v < (1 << 7):
        out += struct.pack(">b", v)                   # positive or negative fixint
    elif v < (1 << 8):
        out += b"\xcc" + struct.pack(">B", v)
    elif v < (1 << 16):
        out += b"\xcd" + struct.pack(">H", v)
    elif v < (1 << 32):
        out += b"\xce" + struct.pack(">I", v)
    elif v < (1 << 64):
        out += b"\xcf" + struct.pack(">Q", v)
    else:
        raise OverflowError(f"int {v} is above the uint64 range")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16- or 32-bit form
    (``codes``; None where the type has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < (1 << 8):
        out += bytes((codes[0], n))
    elif n < (1 << 16):
        out += bytes((codes[1],)) + struct.pack(">H", n)
    elif n < (1 << 32):
        out += bytes((codes[2],)) + struct.pack(">I", n)
    else:
        raise ValueError(f"length {n} is over msgpack's 2^32 - 1")


def _pack_bin(data: bytes, out: bytearray) -> None:
    _pack_len(len(data), None, 0, (0xc4, 0xc5, 0xc6), out)
    out += data


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(n)
    if fixext is not None:
        out.append(fixext)
    else:
        _pack_len(n, None, 0, (0xc7, 0xc8, 0xc9), out)
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: the msgpack of ``(shape, dtype.name, C bytes)``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {arr.nbytes} bytes is over {MAX_CHUNK_SIZE}: flax "
                         f"writes it as {_CHUNKED} chunks, which this encoder does not")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(obj, out: bytearray) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xc0)
    elif t is bool:
        out.append(0xc3 if obj else 0xc2)
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out += data
    elif t is bytes or t is bytearray:
        _pack_bin(bytes(obj), out)
    elif t is dict:
        _pack_len(len(obj), 0x80, 16, (None, 0xde, 0xdf), out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif t is list or t is tuple:
        _pack_len(len(obj), 0x90, 16, (None, 0xdc, 0xdd), out)
        for value in obj:
            _pack(value, out)
    elif t is ExtType:
        _pack_ext(obj.code, obj.data, out)
    elif t is np.ndarray:
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialize {t.__name__}: outside the flax msgpack subset")


def packb(obj) -> bytes:
    """The msgpack bytes of ``obj`` (see the module docstring for the subset)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# -- the decoder ------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, ext_hook):
        self.data = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack stream: {n} byte(s) wanted at offset "
                             f"{self.pos}, {len(self.data) - self.pos} left")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _read_str(r: _Reader, n: int) -> str:
    return bytes(r.take(n)).decode("utf-8")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    return out


def _read_ext(r: _Reader, n: int):
    code = r.unpack(">b")
    return r.ext_hook(code, bytes(r.take(n)))


def flax_ext_hook(code: int, payload: bytes):
    """The ext types flax writes: an ndarray (ext 1) and a numpy scalar (ext 3)."""
    if code == EXT_NDARRAY:
        return _ndarray_from_payload(payload)
    if code == EXT_NPSCALAR:
        return _ndarray_from_payload(payload)[()]
    raise ValueError(f"msgpack ext type {code} is outside the flax subset (ext 1, ext 3)")


def _read(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_read(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return _read_str(r, b & 0x1f)
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in (0xc4, 0xc5, 0xc6):
        return bytes(r.take(r.unpack(_LEN[1 << (b - 0xc4)])))
    if b in (0xd9, 0xda, 0xdb):
        return _read_str(r, r.unpack(_LEN[1 << (b - 0xd9)]))
    if b in (0xdc, 0xdd):
        n = r.unpack(_LEN[2 if b == 0xdc else 4])
        return [_read(r) for _ in range(n)]
    if b in (0xde, 0xdf):
        return _read_map(r, r.unpack(_LEN[2 if b == 0xde else 4]))
    if 0xd4 <= b <= 0xd8:
        return _read_ext(r, 1 << (b - 0xd4))
    if b in (0xc7, 0xc8, 0xc9):
        return _read_ext(r, r.unpack(_LEN[1 << (b - 0xc7)]))
    raise ValueError(f"msgpack type byte 0x{b:02x} at offset {r.pos - 1} is outside "
                     f"the flax subset")


def unpackb(data: bytes, ext_hook=flax_ext_hook):
    """Decode one msgpack object that fills ``data`` exactly; ``ext_hook(code, payload)``
    makes each ext object's value."""
    r = _Reader(data, ext_hook)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing byte(s) after the msgpack object")
    return obj


def _ndarray_from_payload(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(payload)
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as e:
        raise ValueError(f"array dtype {dtype_name!r} is not a numpy dtype") from e
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def _unchunk(tree):
    if type(tree) is dict:
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def from_bytes(data: bytes):
    """What ``flax.serialization.msgpack_restore`` reads: ``unpackb``, then chunked
    arrays joined back."""
    return _unchunk(unpackb(data))
