"""flax's `serialization.to_bytes` format, read and written in plain Python.

The JAX package stores weights as `params.msgpack`:
`flax.serialization.to_bytes({"params": ..., "batch_stats": ...})`. That is
MessagePack of a tree of maps whose leaves are arrays; a list node is a map
with the keys "0", "1", ...; an array is MessagePack's extension type 1
holding the MessagePack array (shape, dtype name, raw C-order bytes), a
NumPy scalar type 3 with the same payload. Neither flax nor the msgpack
package is needed here (the card's machine has neither).
"""

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3


# -- encoding -------------------------------------------------------------------


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + data)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_header(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject:
            raise TypeError("object arrays cannot be serialized")
        payload = packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        out.append(_ext(EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR, payload))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _header(n: int, fix: Any, fix_limit: int, codes) -> bytes:
    if fix is not None and n < fix_limit:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"object of length {n} too large")


def _pack_int(i: int) -> bytes:
    if 0 <= i < 128:
        return bytes([i])
    if -32 <= i < 0:
        return struct.pack(">b", i)
    if i >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if i < limit:
                return bytes([code]) + struct.pack(fmt, i)
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15), (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if i >= -limit:
                return bytes([code]) + struct.pack(fmt, i)
    raise ValueError(f"integer {i} out of range")


def _ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        return bytes([fixed[len(data)], code]) + data
    for head, fmt, limit in ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32)):
        if len(data) < limit:
            return bytes([head]) + struct.pack(fmt, len(data)) + bytes([code]) + data
    raise ValueError("extension payload too large")


def packb(obj) -> bytes:
    """MessagePack bytes of obj (maps, lists, str, bytes, ints, floats,
    None, bools, NumPy arrays as flax's extension type)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# -- decoding -------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        b = self.data[self.pos: self.pos + n]
        self.pos += n
        return bytes(b)

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_SIZED = {  # code: (kind, length format)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


def _unpack(r: _Reader):
    c = r.take(1)[0]
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0x80 <= c <= 0x8F:
        return _items(r, "map", c & 0x0F)
    if 0x90 <= c <= 0x9F:
        return _items(r, "array", c & 0x0F)
    if 0xA0 <= c <= 0xBF:
        return r.take(c & 0x1F).decode("utf-8")
    if c == 0xC0:
        return None
    if c in (0xC2, 0xC3):
        return c == 0xC3
    if c in _SCALARS:
        return r.unpack(_SCALARS[c])
    if c in _SIZED:
        kind, fmt = _SIZED[c]
        n = r.unpack(fmt)
        if kind == "bin":
            return r.take(n)
        if kind == "str":
            return r.take(n).decode("utf-8")
        return _items(r, kind, n)
    if c in _FIXEXT or c in _EXT:
        n = _FIXEXT[c] if c in _FIXEXT else r.unpack(_EXT[c])
        code = struct.unpack(">b", r.take(1))[0]
        return _ext_value(code, r.take(n))
    raise ValueError(f"unknown MessagePack type byte 0x{c:02x}")


def _items(r: _Reader, kind: str, n: int):
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def _dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _ext_value(code: int, data: bytes):
    if code == EXT_COMPLEX:
        re_, im = unpackb(data)
        return complex(re_, im)
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"unknown MessagePack extension type {code}")
    shape, name, buf = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    arr = np.frombuffer(buf, dtype=_dtype(name)).reshape(shape)
    if name == "bfloat16":                      # the upper 16 bits of a float32
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr[()] if code == EXT_NPSCALAR else arr


def unpackb(data: bytes):
    """The object MessagePack bytes hold, arrays as NumPy arrays (bfloat16
    widened to float32; the others read-only views of `data`)."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the MessagePack object")
    return obj


# -- flax's state dicts -----------------------------------------------------------


def to_state_dict(tree):
    """flax's state dict of a tree: lists become maps with "0", "1", ... keys."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def to_bytes(tree) -> bytes:
    """flax.serialization.to_bytes of a tree of dicts, lists and NumPy arrays."""
    return packb(to_state_dict(tree))


def restore(data: bytes):
    """flax.serialization.msgpack_restore: the state dict (list nodes stay
    maps with "0", "1", ... keys)."""
    return unpackb(data)


def as_list(node) -> list:
    """A list node of a restored state dict as a list."""
    if isinstance(node, list):
        return node
    keys = sorted(node, key=int)
    if keys != [str(i) for i in range(len(keys))]:
        raise ValueError(f"not a list node: keys {keys[:5]}...")
    return [node[k] for k in keys]
