"""MessagePack for the API's bodies, on the standard library.

The JSON-like subset the API's clients send and read: nil, bool, int
(fixint, int and uint of 8-64 bits), float32/64, str (fixstr, str8/16/32),
bin (bin8/16/32), arrays (fixarray, array16/32) and maps (fixmap,
map16/32). `packb` writes what `msgpack.packb(obj)` writes (msgpack >= 1.0,
use_bin_type=True): the smallest int encoding, float64 for floats, bin for
bytes. `unpackb` reads what `msgpack.unpackb(data)` reads (raw=False):
str as str, bin as bytes, arrays as lists, maps as dicts with str or bytes
keys. An ext type, a reserved byte, a truncated buffer or bytes after the
object raise `UnpackError`, a ValueError.
"""

from __future__ import annotations

import struct

MAX_DEPTH = 512


class UnpackError(ValueError):
    pass


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, hi in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < hi:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} too big to pack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)),
                              (0xD3, ">q", -(1 << 63))):
            if n >= lo:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} too small to pack")


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int,
              codes: tuple) -> None:
    """A length header: the fix form below fix_max, else the 8/16/32-bit
    code (a code of None is absent for this kind)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, hi in zip(codes, (">B", ">H", ">I"),
                             (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < hi:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too big to pack")


def _pack(obj, out: bytearray, depth: int) -> None:
    if depth > MAX_DEPTH:
        raise ValueError("object nested too deeply to pack")
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out, depth + 1)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out, depth + 1)
            _pack(v, out, depth + 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out, 0)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise UnpackError("truncated msgpack data")
        b = self.data[self.pos:end].tobytes()
        self.pos = end
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",            # str
        0xC4: ">B", 0xC5: ">H", 0xC6: ">I",            # bin
        0xDC: ">H", 0xDD: ">I",                        # array
        0xDE: ">H", 0xDF: ">I"}                        # map


def _str(b: bytes) -> str:
    try:
        return b.decode("utf-8")
    except UnicodeDecodeError as e:
        raise UnpackError(f"invalid utf-8 in a msgpack str: {e}") from e


def _unpack(r: _Reader, depth: int):
    if depth > MAX_DEPTH:
        raise UnpackError("msgpack data nested too deeply")
    c = r.take(1)[0]
    if c < 0x80:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0xA0 <= c < 0xC0:
        return _str(r.take(c & 0x1F))
    if 0x90 <= c < 0xA0:
        return [_unpack(r, depth + 1) for _ in range(c & 0x0F)]
    if 0x80 <= c < 0x90:
        return _map(r, c & 0x0F, depth)
    if c == 0xC0:
        return None
    if c == 0xC2:
        return False
    if c == 0xC3:
        return True
    if c in _FIXED:
        return r.num(_FIXED[c])
    if c in _LEN:
        n = r.num(_LEN[c])
        if c in (0xD9, 0xDA, 0xDB):
            return _str(r.take(n))
        if c in (0xC4, 0xC5, 0xC6):
            return r.take(n)
        if c in (0xDC, 0xDD):
            return [_unpack(r, depth + 1) for _ in range(n)]
        return _map(r, n, depth)
    if c in (0xC7, 0xC8, 0xC9) or 0xD4 <= c <= 0xD8:
        raise UnpackError(f"msgpack ext type (0x{c:02x}) is not accepted")
    raise UnpackError(f"reserved msgpack byte 0x{c:02x}")


def _map(r: _Reader, n: int, depth: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, depth + 1)
        if not isinstance(k, (str, bytes)):
            raise UnpackError(f"{type(k).__name__} is not allowed for map "
                              "key")
        out[k] = _unpack(r, depth + 1)
    return out


def unpackb(data: bytes):
    r = _Reader(data)
    obj = _unpack(r, 0)
    if r.pos != len(r.data):
        raise UnpackError(f"{len(r.data) - r.pos} bytes of extra data after "
                          "the msgpack object")
    return obj
