"""The safetensors file format, read and written with the standard library
and torch.

A file is an 8-byte little-endian header length N, a JSON header of N bytes
({name: {"dtype", "shape", "data_offsets": [begin, end]}} and an optional
"__metadata__" of strings, padded with spaces to a multiple of 8), then the
tensors' raw little-endian bytes, offsets relative to the end of the
header. `load_file` maps the file and hands out tensors that share the
mapping, so a tensor is read from disk once, where it is first used (a
`.to("cuda")` copies the pages straight to the card); "__metadata__" is
skipped. `save_file` writes what `safetensors.numpy.save_file` writes for
the same tensors (it writes no metadata): keys by
dtype (widest first, the format's dtype order) then by name, no gaps, so
every tensor starts aligned to its own width and the data to 8 bytes.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import torch

# the format's dtype names in its own order (safetensors' Dtype enum); a
# file's tensors are laid out by descending position here, then by name
DTYPES = {
    "BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
    "I16": torch.int16, "U16": torch.uint16, "F16": torch.float16,
    "BF16": torch.bfloat16, "I32": torch.int32, "U32": torch.uint32,
    "F32": torch.float32, "F64": torch.float64, "I64": torch.int64,
    "U64": torch.uint64,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_RANK = {name: i for i, name in enumerate(DTYPES)}
_MAX_HEADER = 100 * 1024 * 1024


def read_header(path: str | Path) -> tuple[dict, int]:
    """(header without "__metadata__", byte offset of the data)."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """{name: CPU tensor} backed by a private (copy-on-write) mapping of
    the file: nothing is read until a tensor's pages are touched, and a
    tensor that is written to never writes the file."""
    header, base = read_header(path)
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        mm = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
              if size > base else None)
    out = {}
    for name, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             "which the reader does not take")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * dtype.itemsize or base + end > size:
            raise ValueError(f"{path}: {name}'s offsets {begin}..{end} do "
                             f"not hold {info['dtype']}{list(shape)}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin,
                             offset=base + begin)
        # a byte view reinterpreted: the format stores each tensor at an
        # offset aligned to its width, so the view needs no copy
        out[name] = t.view(dtype).reshape(shape)
    return out


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous()
    import numpy as np

    return torch.from_numpy(np.ascontiguousarray(x))


def save_file(tensors: dict, path: str | Path) -> None:
    """Write `tensors` ({name: torch tensor or numpy array}) to `path`.
    Tensors on the card are copied to the host one at a time."""
    items = []
    for name, x in tensors.items():
        dtype = x.dtype if isinstance(x, torch.Tensor) else \
            _as_tensor(x[:0]).dtype
        if dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {dtype} has no safetensors name")
        items.append((name, x, _NAMES[dtype]))
    items.sort(key=lambda it: (-_RANK[it[2]], it[0]))
    header: dict = {}
    offset = 0
    for name, x, dname in items:
        n = x.numel() if isinstance(x, torch.Tensor) else x.size
        nbytes = n * DTYPES[dname].itemsize
        header[name] = {"dtype": dname, "shape": list(x.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, x, _ in items:
            t = _as_tensor(x)
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
