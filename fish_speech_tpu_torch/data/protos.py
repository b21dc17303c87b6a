"""The training corpus messages and their proto3 wire format.

The port's own reader and writer for the four messages of
`text-data.proto` (the reference corpus format: same messages, field
numbers and bytes, so existing .protos shards interoperate):

    message Semantics   { repeated uint32 values = 1; }
    message Sentence    { repeated string texts = 1;
                          repeated Semantics semantics = 3; }
    message TextData    { string source = 1; string name = 2;
                          repeated Sentence sentences = 4; }
    message SampledData { string source = 1; string name = 2;
                          repeated Sentence samples = 3; }

Serialization writes what `google.protobuf` writes: fields in number
order, an empty singular string left out, `repeated uint32` packed (one
length-delimited run of varints), every element of a repeated string or
message written, empty or not. Parsing takes packed and unpacked uint32
runs, keeps the last value of a singular field and skips unknown fields
(varint, fixed 32 / 64-bit and length-delimited).
"""

from __future__ import annotations

import numpy as np

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
_U32_MAX = (1 << 32) - 1


class DecodeError(ValueError):
    """The bytes are not a valid encoding of the message."""


def _varint(n: int) -> bytes:
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def _pack_u32(values) -> bytes:
    """Varints of uint32 values, vectorised: byte k of a value is its bits
    [7k, 7k + 7) with the continuation bit on all but its last byte."""
    v = np.asarray(values, dtype=np.int64).reshape(-1)
    if v.size and (v.min() < 0 or v.max() > _U32_MAX):
        raise ValueError("uint32 value out of range")
    v = v.astype(np.uint64)
    n = 1 + sum((v >> np.uint64(7 * k)) > 0 for k in range(1, 5))
    out = np.zeros((v.size, 5), np.uint8)
    for k in range(5):
        byte = (v >> np.uint64(7 * k)) & np.uint64(0x7F)
        more = (k + 1 < n).astype(np.uint64) << np.uint64(7)
        out[:, k] = (byte | more).astype(np.uint8)
    return out[np.arange(5)[None, :] < n[:, None]].tobytes()


def _unpack_u32(buf: bytes) -> list[int]:
    """Decode a packed run of varints, each truncated to 32 bits (as
    protobuf reads a uint32)."""
    b = np.frombuffer(buf, np.uint8)
    if b.size == 0:
        return []
    ends = np.flatnonzero(b < 0x80)
    if ends.size == 0 or ends[-1] != b.size - 1:
        raise DecodeError("truncated packed varint")
    starts = np.concatenate([[0], ends[:-1] + 1])
    if (ends - starts).max() >= 10:
        raise DecodeError("varint longer than 10 bytes")
    pos = np.arange(b.size) - np.repeat(starts, ends - starts + 1)
    low = (b & 0x7F).astype(np.uint64)
    shifted = np.where(pos < 5, low << (7 * np.minimum(pos, 4)).astype(
        np.uint64), np.uint64(0))
    vals = np.add.reduceat(shifted, starts) & np.uint64(_U32_MAX)
    return vals.tolist()


class RepeatedMessage(list):
    """A repeated message field: a list with protobuf's `add(**fields)`."""

    def __init__(self, cls):
        super().__init__()
        self._cls = cls

    def add(self, **fields):
        m = self._cls(**fields)
        self.append(m)
        return m


class Message:
    """A proto3 message of string, repeated string, repeated uint32 and
    repeated message fields. FIELDS: {number: (name, kind)}, kind one of
    "string", "strings", "uint32s" or a Message subclass (repeated)."""

    FIELDS: dict = {}

    def __init__(self, **fields):
        for name, kind in self.FIELDS.values():
            if kind == "string":
                setattr(self, name, "")
            elif isinstance(kind, type):
                setattr(self, name, RepeatedMessage(kind))
            else:
                setattr(self, name, [])
        for name, value in fields.items():
            cur = getattr(self, name)
            if isinstance(cur, list):
                cur.extend(value)
            else:
                setattr(self, name, value)

    def SerializeToString(self) -> bytes:
        out = bytearray()
        for num in sorted(self.FIELDS):
            name, kind = self.FIELDS[num]
            value = getattr(self, name)
            tag = _varint(num << 3 | _LEN)
            if kind == "string":
                if value:
                    raw = value.encode("utf-8")
                    out += tag + _varint(len(raw)) + raw
            elif kind == "strings":
                for s in value:
                    raw = s.encode("utf-8")
                    out += tag + _varint(len(raw)) + raw
            elif kind == "uint32s":
                if len(value):
                    raw = _pack_u32(value)
                    out += tag + _varint(len(raw)) + raw
            else:
                for m in value:
                    raw = m.SerializeToString()
                    out += tag + _varint(len(raw)) + raw
        return bytes(out)

    def ParseFromString(self, data: bytes) -> int:
        """Replace this message's fields by those encoded in `data`;
        returns len(data), as protobuf does."""
        data = bytes(data)
        self.__init__()
        pos = 0
        while pos < len(data):
            tag, pos = _read_varint(data, pos)
            num, wt = tag >> 3, tag & 7
            if num == 0:
                raise DecodeError("field number 0")
            name, kind = self.FIELDS.get(num, (None, None))
            if wt == _VARINT:
                value, pos = _read_varint(data, pos)
                if kind == "uint32s":
                    getattr(self, name).append(value & _U32_MAX)
                continue
            if wt in (_I64, _I32):
                pos += 8 if wt == _I64 else 4
                if pos > len(data):
                    raise DecodeError("truncated fixed-width field")
                continue
            if wt != _LEN:
                raise DecodeError(f"wire type {wt} is not supported")
            size, pos = _read_varint(data, pos)
            raw, pos = data[pos:pos + size], pos + size
            if pos > len(data):
                raise DecodeError("truncated length-delimited field")
            if kind in ("string", "strings"):
                try:
                    s = raw.decode("utf-8")
                except UnicodeDecodeError as e:
                    raise DecodeError(f"field {name}: {e}") from None
                if kind == "string":
                    setattr(self, name, s)
                else:
                    getattr(self, name).append(s)
            elif kind == "uint32s":
                getattr(self, name).extend(_unpack_u32(raw))
            elif kind is not None:
                m = kind()
                m.ParseFromString(raw)
                getattr(self, name).append(m)
        return len(data)

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and all(
            getattr(self, n) == getattr(other, n)
            for n, _ in self.FIELDS.values())

    def __repr__(self) -> str:
        body = ", ".join(f"{n}={getattr(self, n)!r}"
                         for n, _ in self.FIELDS.values())
        return f"{type(self).__name__}({body})"


class Semantics(Message):
    FIELDS = {1: ("values", "uint32s")}


class Sentence(Message):
    FIELDS = {1: ("texts", "strings"), 3: ("semantics", Semantics)}


class TextData(Message):
    FIELDS = {1: ("source", "string"), 2: ("name", "string"),
              4: ("sentences", Sentence)}


class SampledData(Message):
    FIELDS = {1: ("source", "string"), 2: ("name", "string"),
              3: ("samples", Sentence)}
