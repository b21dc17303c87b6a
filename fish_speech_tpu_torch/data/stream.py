"""Length-prefixed protobuf stream format: uint32 little-endian size, then
a serialized TextData, repeated.

Counterpart of `fish_speech_tpu/data/stream.py` (ref
fish_speech/datasets/protos/text_data_stream.py:6-36), on the port's own
wire codec (data/protos.py).
"""

from __future__ import annotations

import struct

from .protos import TextData


def read_pb_stream(f):
    while True:
        buf = f.read(4)
        if len(buf) == 0:
            break
        size = struct.unpack("<I", buf)[0]
        buf = f.read(size)
        text_data = TextData()
        text_data.ParseFromString(buf)
        yield text_data


def write_pb_stream(f, text_data) -> None:
    buf = text_data.SerializeToString()
    f.write(struct.pack("<I", len(buf)))
    f.write(buf)


def pack_pb_stream(text_data) -> bytes:
    buf = text_data.SerializeToString()
    return struct.pack("<I", len(buf)) + buf


def split_pb_stream(f):
    while True:
        head = f.read(4)
        if len(head) == 0:
            break
        size = struct.unpack("<I", head)[0]
        yield head + f.read(size)
