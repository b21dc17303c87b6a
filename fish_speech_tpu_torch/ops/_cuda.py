"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into its own shared library
with a plain C interface, loaded with ctypes. `build_all` starts one nvcc
per source, all at once. Libraries go under `_build/` beside this package
(listed in .gitignore), in a directory named by the hash of the sources, so
an edited source is rebuilt and an unchanged one is reused.

Nothing here runs at import: the first launch builds.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("decode_attention", "decode_attention_head", "fast_sweep",
           "voc_fused", "voc_fused_i8", "w4a8")
# -fmad=false: no contraction of a*b + c into one rounding, so the kernels'
# f32 epilogues round as their plain PyTorch twins do
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: name -> (source, argtypes); every function returns the
# cudaError_t of its launches as an int
SIGNATURES = {
    # q k v ks vs lengths starts out part | L S B Hkv G D layer n_split
    # whole hs (ops/attention.py::cta_plan) | scale | int8_scores | stream
    "decode_attention_stream": ("decode_attention", [_P] * 9 + [_I] * 10
                                + [_F, _I, _P]),
    # q k v lengths starts out part | L S B Hkv G D layer n_split whole hs |
    # scale | stream
    "decode_attention_stream_bf16": ("decode_attention", [_P] * 7 + [_I] * 10
                                     + [_F, _P]),
    # q k v ks vs lengths starts out part new_k new_v | L S B Hkv G D layer
    # write_pos n_split whole hs | scale | int8_scores | stream
    "decode_attention_stream_fold": ("decode_attention", [_P] * 11
                                     + [_I] * 11 + [_F, _I, _P]),
    # the head-major entries, one per JAX entry: q k v ks vs lengths starts
    # out part | L S B Hkv G D layer n_split whole hs | scale | int8_scores
    # cache_kind q_f32 | stream
    **{name: ("decode_attention_head", [_P] * 9 + [_I] * 10 + [_F]
              + [_I] * 3 + [_P])
       for name in ("decode_attention_stream_head", "decode_attention_blocks",
                    "decode_attention_stacked_rows", "decode_attention",
                    "decode_attention_stacked", "decode_attention_chunked")},
    # x8 q4 gs out | M N K G | tile n_split part (ops/w4a8.py::w4a8_plan)
    # | stream
    "w4a8_matmul": ("w4a8", [_P] * 4 + [_I] * 7 + [_P]),
    "w4a8_matmul_pc": ("w4a8", [_P] * 4 + [_I] * 7 + [_P]),
    # x_in x_out w s norms freqs ck cv cks cvs x8 xs buf hmax trace | B dim
    # L K pos n_head grid ks_wo ks_w2 | eps | stream
    "fast_sweep": ("fast_sweep", [_P] * 15 + [_I] * 9 + [_F, _P]),
    # n_sm per_sm (out): no launch, no stream
    "fast_sweep_grid": ("fast_sweep", [ctypes.POINTER(_I)] * 2),
    # no arguments: the sweep CTA's threads (no launch)
    "fast_sweep_threads": ("fast_sweep", []),
    # x y w7t w1t vec tail sn s2 | tile_k7 tile_1x1 (ops/voc_fused.py::
    # voc_res_plan) B T C d has_tail | stream
    "voc_res_stack": ("voc_fused", [_P] * 8 + [_I] * 7 + [_P]),
    # x y pwt pb w7t w1t vec tail fw xs sn s2 | tiles (7 ints) | B T_in C_in
    # C stride d0 d1 d2 final | stream
    "voc_block": ("voc_fused", [_P] * 12 + [ctypes.POINTER(_I)] + [_I] * 9
                  + [_P]),
    # the int8 packs: x y w7t w1t vec tail st q s2 amax | tiles (2 ints:
    # k7, 1x1; ops/voc_fused.py::voc_i8_plan) | B T C d tt halo has_tail |
    # stream
    "voc_res_stack_i8": ("voc_fused_i8", [_P] * 10 + [ctypes.POINTER(_I)]
                         + [_I] * 7 + [_P]),
    # x y pwt pb w7t w1t vec tail fw st q s2 amax | tiles (7 ints) | B T_in
    # C_in C stride d0 d1 d2 tt halo final | stream
    "voc_block_i8": ("voc_fused_i8", [_P] * 13 + [ctypes.POINTER(_I)]
                     + [_I] * 11 + [_P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) of the last build
BUILD_LOGS: dict[str, str] = {}


def _digest() -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc")


def build_all() -> dict[str, str]:
    """Compile every source (in parallel) unless already built; returns
    {source: path of its .so}. Raises with the compiler output on failure;
    on success the output is kept in BUILD_LOGS."""
    out_dir = BUILD_ROOT / _digest()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {s: str(out_dir / f"lib{s}.so") for s in SOURCES}
    todo = [s for s in SOURCES if not Path(paths[s]).exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for s in todo:
        tmp = paths[s] + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               str(CSRC / f"{s}.cu")]
        procs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    errors = []
    for s, (tmp, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            errors.append(f"--- nvcc {s}.cu failed ---\n{log}")
            continue
        os.replace(tmp, paths[s])
        BUILD_LOGS[s] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def lib(source: str) -> ctypes.CDLL:
    with _lock:
        if source not in _libs:
            path = build_all()[source]
            dll = ctypes.CDLL(path)
            for fn, (src, argtypes) in SIGNATURES.items():
                if src == source:
                    f = getattr(dll, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
            _libs[source] = dll
        return _libs[source]


# the counts of the CUDA graph this thread is capturing (`capturing`)
_capture = threading.local()


class Kernel:
    """A C entry point of one of the libraries, with its launch count.

    `launches` is a plain integer: the wrapper adds one each time it calls
    the kernel, and nowhere else. A call made while this thread captures a
    CUDA graph launches nothing (the graph records it), so it is counted
    into the capture's counts instead, which the graph's owner adds at
    each replay (`capturing`, `replayed`)."""

    def __init__(self, name: str):
        self.name = name
        self.source = SIGNATURES[name][0]
        self.launches = 0

    def __call__(self, *args) -> None:
        fn = getattr(lib(self.source), self.name)
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        counts = getattr(_capture, "counts", None)
        if counts is None:
            self.launches += 1
        else:
            counts[self] = counts.get(self, 0) + 1
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")


@contextlib.contextmanager
def capturing():
    """Around a CUDA graph's capture on this thread: yields {Kernel: calls}
    of the kernels the capture recorded, left out of their `launches`.
    Other threads' calls meanwhile are counted as launched."""
    counts: dict = {}
    _capture.counts = counts
    try:
        yield counts
    finally:
        _capture.counts = None


def replayed(counts: dict) -> None:
    """A replay of a graph whose capture recorded `counts`: each kernel's
    `launches` rises by its calls in the graph."""
    for kernel, n in counts.items():
        kernel.launches += n


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of card `index`, which the kernels' plans read."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          device: torch.device | None = None) -> None:
    """Validate a kernel argument before its pointer is handed to C."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
