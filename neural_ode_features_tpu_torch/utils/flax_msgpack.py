"""A decoder, written by hand, of the msgpack that flax's
``serialization.to_bytes`` writes for a param tree: what the JAX package's
``.msgpack`` checkpoints hold (``neural_ode_features_tpu/utils/
checkpoint.py`` ``save_checkpoint``).  Neither flax nor the ``msgpack``
package is needed.

The subset read (the msgpack spec's formats by first byte):

* nil, false, true; positive and negative fixint, uint8–64, int8–64;
  float32 and float64; str and bin of every length; arrays; maps whose keys
  are strings (flax's state dicts: a list's items under ``'0'``, ``'1'``, …);
* flax's extension types (``flax.serialization._MsgpackExtType``):
  1 ndarray and 3 numpy scalar, each a packed ``(shape, dtype name, raw
  bytes)`` in C order; 2 a Python complex, a packed ``(real, imag)``.  The
  array dtypes read are float32, float64, int32, int64 and uint8, little
  endian.

Anything else (another extension type or dtype, a map key that is not a
string, flax's chunked form of an array over 1 GB, a truncated or trailing
byte) raises ``ValueError``: the decoder never guesses.  Encoding is not
provided; the port writes ``.pt`` checkpoints.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["unpackb", "EXT_NDARRAY", "EXT_COMPLEX", "EXT_NPSCALAR"]

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_DTYPES = {name: np.dtype(name).newbyteorder("<")
           for name in ("float32", "float64", "int32", "int64", "uint8")}

# First byte -> struct format of a fixed-width scalar.
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# First byte -> (kind, width of its big-endian length field).
_SIZED = {0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
          0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
          0xdc: ("array", 2), 0xdd: ("array", 4),
          0xde: ("map", 2), 0xdf: ("map", 4),
          0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(wanted {n} more of {len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_decode(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return _str(r, b & 0x1f)
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _SCALARS:
        return r.unpack(_SCALARS[b])
    if b in _FIXEXT:
        return _ext(r, r.unpack(">b"), _FIXEXT[b])
    if b in _SIZED:
        kind, width = _SIZED[b]
        n = r.unpack(_LEN[width])
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "str":
            return _str(r, n)
        if kind == "array":
            return [_decode(r) for _ in range(n)]
        if kind == "map":
            return _map(r, n)
        return _ext(r, r.unpack(">b"), n)
    raise ValueError(f"msgpack: byte 0x{b:02x} at {r.pos - 1} is not a type "
                     "this decoder reads")


def _str(r: _Reader, n: int) -> str:
    return bytes(r.take(n)).decode("utf-8")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r)
        if not isinstance(key, str):
            raise ValueError(f"msgpack: a map key {key!r} is not a string")
        out[key] = _decode(r)
    if "__msgpack_chunked_array__" in out:
        raise ValueError("msgpack: flax's chunked form of an array over 1 GB "
                         "is not read")
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    fields = unpackb(payload)
    if not (isinstance(fields, list) and len(fields) == 3):
        raise ValueError("msgpack: an ndarray extension is not "
                         "(shape, dtype, bytes)")
    shape, name, raw = fields
    if isinstance(name, bytes):
        name = name.decode()
    if name not in _DTYPES:
        raise ValueError(f"msgpack: arrays of dtype {name!r} are not read "
                         f"(only {sorted(_DTYPES)})")
    if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0
                                            for d in shape)
            and isinstance(raw, bytes)):
        raise ValueError("msgpack: an ndarray extension is not "
                         "(shape, dtype, bytes)")
    dtype = _DTYPES[name]
    if len(raw) != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
        raise ValueError(f"msgpack: {len(raw)} bytes for a {name} array of "
                         f"shape {tuple(shape)}")
    return np.frombuffer(raw, dtype=dtype).astype(dtype.newbyteorder("="))\
        .reshape(shape)


def _ext(r: _Reader, code: int, n: int):
    payload = bytes(r.take(n))
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == EXT_COMPLEX:
        parts = unpackb(payload)
        if not (isinstance(parts, list) and len(parts) == 2):
            raise ValueError("msgpack: a complex extension is not "
                             "(real, imag)")
        return complex(parts[0], parts[1])
    raise ValueError(f"msgpack: extension type {code} is not one of flax's "
                     f"({EXT_NDARRAY} ndarray, {EXT_COMPLEX} complex, "
                     f"{EXT_NPSCALAR} numpy scalar)")


def unpackb(data: bytes):
    """The one msgpack object that ``data`` holds, in full: dicts, lists,
    str, bytes, int, float, bool, None, complex, numpy arrays and scalars."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return out
