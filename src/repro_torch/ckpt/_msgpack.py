"""A small MessagePack codec for the checkpoint manifest.

The JAX package writes ``manifest.msgpack`` with the ``msgpack`` library's
``packb`` and reads it with ``unpackb``; the port must read and write the
same bytes without that library.  ``packb`` gives the bytes of
``msgpack.packb(obj)`` under the library's defaults (``use_bin_type=True``,
integers in their shortest form, floats as float64, maps in insertion
order, tuples as arrays); ``unpackb`` reads what it writes, float32 too,
as ``msgpack.unpackb`` does (arrays as lists, map keys str or bytes).
Covered types: None, bool, int, float, str, bytes, list/tuple, dict.
"""
from __future__ import annotations

import struct

_U = ((0xff, 0xcc, ">B"), (0xffff, 0xcd, ">H"), (0xffffffff, 0xce, ">I"),
      (0xffffffffffffffff, 0xcf, ">Q"))
_S = ((-0x80, 0xd0, ">b"), (-0x8000, 0xd1, ">h"), (-0x80000000, 0xd2, ">i"),
      (-0x8000000000000000, 0xd3, ">q"))


def _int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80 or -32 <= x < 0:
        out += struct.pack(">b" if x < 0 else ">B", x)
        return
    for lim, tag, fmt in (_U if x >= 0 else _S):
        if (x <= lim) if x >= 0 else (x >= lim):
            out.append(tag)
            out += struct.pack(fmt, x)
            return
    raise OverflowError(f"int {x} does not fit in 64 bits")


def _head(n: int, fix: int, fixmax: int, tags, out: bytearray) -> None:
    """The header of a str/bin/array/map of length ``n``: a fix form below
    ``fixmax`` (when ``fix`` is given), else the shortest of ``tags``
    (8-, 16- and 32-bit lengths; None where the type has no such form)."""
    if fix is not None and n < fixmax:
        out.append(fix | n)
        return
    for lim, tag, fmt in ((0xff, tags[0], ">B"), (0xffff, tags[1], ">H"),
                          (0xffffffff, tags[2], ">I")):
        if tag is not None and n <= lim:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        _int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(len(data), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(len(data), None, 0, (0xc4, 0xc5, 0xc6), out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _head(len(obj), 0x90, 16, (None, 0xdc, 0xdd), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _head(len(obj), 0x80, 16, (None, 0xde, 0xdf), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes, equal to ``msgpack.packb(obj)``."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:end].tobytes()
        self.pos = end
        return chunk

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xc0: None, 0xc2: False, 0xc3: True}
_NUMS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
         0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# tag -> (kind, length format)
_SIZED = {0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}


def _unpack(r: _Reader):
    tag = r.num(">B")
    if tag <= 0x7f:
        return tag
    if tag >= 0xe0:
        return tag - 0x100
    if tag in _FIXED:
        return _FIXED[tag]
    if tag in _NUMS:
        return r.num(_NUMS[tag])
    if 0xa0 <= tag <= 0xbf:
        kind, n = "str", tag & 0x1f
    elif 0x90 <= tag <= 0x9f:
        kind, n = "array", tag & 0x0f
    elif 0x80 <= tag <= 0x8f:
        kind, n = "map", tag & 0x0f
    elif tag in _SIZED:
        kind, fmt = _SIZED[tag]
        n = r.num(fmt)
    else:
        raise ValueError(f"unsupported msgpack type 0x{tag:02x}")
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "bin":
        return r.take(n)
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes):
    """The object in ``data`` (one MessagePack value, nothing after it)."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("extra data after the msgpack object")
    return obj
