"""Weight quantization and the W8A8 / W4A8 products.

Counterpart of `fish_speech_tpu/ops/quant.py`. A quantized weight is one of
two dicts:
  int8 per output channel: {"q": int8 (..., out, in), "s": f32 (..., out)};
  groupwise int4, two nibbles per byte: {"q4": int8 (..., out, in/2),
    "gs": f32 (..., out, in/groupsize)}, SPLIT-HALF packed: byte j holds
    value j in its low nibble and value j + in/2 in its high nibble.
Plain and quantized parameter trees share every code path through
`as_weight`, `matmul_t`, `take_rows` and `slice_rows`. The JAX package's
native int4 ({"q": int4, "gs"}, its checkpoint form) is carried here as
{"q": int8 values in [-8, 7], "gs"}: written by `quantize_lm_params(mode=
"int4")` and `save_params`, packed on load (`pack_int4_params`).
"""

from __future__ import annotations

import torch


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded once, as the JAX package and the CUDA kernels divide.
    On CUDA, PyTorch divides a tensor by a Python number as x * (1 / d),
    two roundings that miss the quotient by one ulp for ~5% of f32 values;
    a divisor tensor on the same device takes the true division."""
    return x / torch.full_like(x, d)


def quantize_weight(w: torch.Tensor) -> dict:
    """(..., out, in) -> {"q": int8, "s": f32 (..., out)}."""
    wf = w.float()
    scale = div_exact(wf.abs().amax(dim=-1), 127.0).clamp_min(1e-12)
    q = torch.round(wf / scale[..., None]).clamp(-128, 127).to(torch.int8)
    return {"q": q, "s": scale}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] (..., in) -> split-half packed (..., in/2)."""
    half = q.shape[-1] // 2
    return (q[..., half:] << 4) | (q[..., :half] & 0xF)


def quantize_weight_int4_packed(w: torch.Tensor, groupsize: int = 128) -> dict:
    """(..., out, in) -> {"q4": int8 (..., out, in/2), "gs": f32 (..., out,
    in/groupsize)}: symmetric int4 per (out channel, input group), scale
    max|w|/7. Needs groupsize | in/2, so that group boundaries line up in
    both halves."""
    *lead, out, inner = w.shape
    if inner % groupsize or (inner // 2) % groupsize:
        raise ValueError(f"groupsize {groupsize} must divide in/2 = "
                         f"{inner // 2}")
    wf = w.float().reshape(*lead, out, inner // groupsize, groupsize)
    scale = div_exact(wf.abs().amax(dim=-1), 7.0).clamp_min(1e-12)
    q = torch.round(wf / scale[..., None]).clamp(-8, 7).to(torch.int8)
    return {"q4": pack_int4(q.reshape(*lead, out, inner)), "gs": scale}


def unpack_int4(q4: torch.Tensor) -> torch.Tensor:
    """Split-half packed (..., in/2) -> int8 values (..., in); arithmetic
    shifts sign-extend the nibbles."""
    return torch.cat([(q4 << 4) >> 4, q4 >> 4], dim=-1)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and (("q" in w and "s" in w)
                                    or ("q4" in w and "gs" in w))


def _dequant_groups(q: torch.Tensor, gs: torch.Tensor, dtype) -> torch.Tensor:
    groups = gs.shape[-1]
    deq = (q.to(dtype).reshape(*q.shape[:-1], groups, -1)
           * gs.to(dtype)[..., None])
    return deq.reshape(q.shape)


def as_weight(w, dtype=torch.bfloat16) -> torch.Tensor:
    """The dequantized weight (or the plain one unchanged)."""
    if not is_quantized(w):
        return w
    if "s" in w:
        return w["q"].to(dtype) * w["s"].to(dtype)[..., None]
    return _dequant_groups(unpack_int4(w["q4"]), w["gs"], dtype)


def int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric activation quantization: (int8, f32 scale (..., 1))."""
    xf = x.float()
    xs = div_exact(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8),
                   127.0)
    return torch.round(xf / xs).to(torch.int8), xs


def int8_matmul_t(x8: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact int32 x8 @ q.T for x8 (M, K) and q (N, K), both int8.

    Outside any hand-written kernel this product goes to `torch._int_mm`.
    On CUDA that call refuses M <= 16, and a decode step at batch 1 has
    M = 1, so the rows are zero-padded to 24 there and cut off after."""
    m = x8.shape[0]
    if x8.is_cuda and m <= 16:
        x8 = torch.cat([x8, x8.new_zeros(24 - m, x8.shape[1])])
    return torch._int_mm(x8, q.t())[:m]


def matmul_t(x: torch.Tensor, w, *, w8a8: bool = False) -> torch.Tensor:
    """x @ W.T for a plain or quantized weight.

    w8a8=True with an int8 weight: per-row activation quantization, an
    int8 x int8 -> int32 product, and the rank-1 rescale by the activation
    and channel scales (the serving path). With a packed int4 weight: the
    W4A8 product of ops/w4a8.py (its kernel on CUDA tensors)."""
    if not is_quantized(w):
        return x @ w.T
    if w8a8 and "gs" in w:
        from .w4a8 import matmul_t_w4a8

        return matmul_t_w4a8(x, w)
    if w8a8:
        lead = x.shape[:-1]
        x8, xs = int8_rows(x.reshape(-1, x.shape[-1]))
        acc = int8_matmul_t(x8, w["q"])
        y = acc.float() * xs * w["s"].float()
        return y.to(x.dtype).reshape(*lead, -1)
    return x @ as_weight(w, x.dtype).T


def matmul_t_row_parallel(x: torch.Tensor, w, group, *,
                          w8a8: bool = False) -> torch.Tensor:
    """x @ W.T for a row-parallel weight (wo, w2): x holds this rank's
    columns of the input and w its input columns, except a packed int4
    weight, which is whole on every rank (its packed axis is replicated).
    The result is whole, and the same on every rank of `group`.

    - W8A8 int8: the row absmax is reduced (MAX) over the group before
      quantizing, so every rank quantizes with the single-device scale;
      the int32 accumulators are summed over the group, then rescaled as
      `matmul_t` does: bit for bit the single-device product.
    - W4A8: the input columns are gathered and the whole product is taken
      (`matmul_t`): bit for bit the single-device product.
    - Otherwise (a float product): the partial products are summed over
      the group in f32, which rounds as a psum does."""
    from ..parallel.collectives import (all_gather, all_reduce_max,
                                        all_reduce_sum)

    if is_quantized(w) and "q4" in w:
        return matmul_t(all_gather(x, group), w, w8a8=w8a8)
    if is_quantized(w) and w8a8:
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1]).float()
        amax = all_reduce_max(xf.abs().amax(dim=-1, keepdim=True), group)
        xs = div_exact(amax.clamp_min(1e-8), 127.0)
        acc = all_reduce_sum(int8_matmul_t(torch.round(xf / xs).to(
            torch.int8), w["q"]), group)
        y = acc.float() * xs * w["s"].float()
        return y.to(x.dtype).reshape(*lead, -1)
    return all_reduce_sum(matmul_t(x, w, w8a8=w8a8), group)


def take_rows(w, idx: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding-style row gather that dequantizes only the gathered rows."""
    if not is_quantized(w):
        return w[idx]
    if "s" in w:
        rows = w["q"][idx].to(dtype)
        return rows * w["s"][idx].to(dtype)[..., None]
    return _dequant_groups(unpack_int4(w["q4"][idx]), w["gs"][idx], dtype)


def slice_rows(w, start: int, stop: int):
    """Row slice [start, stop) of a (possibly quantized) (V, D) weight."""
    if not is_quantized(w):
        return w[start:stop]
    return {k: v[start:stop] for k, v in w.items()}


def pack_int4_params(params: dict) -> dict:
    """Native int4 leaves {"q": int8 values in [-8, 7], "gs"} (the JAX
    checkpoint form, carried as int8) -> the packed serving form {"q4",
    "gs"}; other leaves pass through."""
    if isinstance(params, dict) and set(params) == {"q", "gs"}:
        return {"q4": pack_int4(params["q"].to(torch.int8)),
                "gs": params["gs"]}
    if isinstance(params, dict):
        return {k: pack_int4_params(v) for k, v in params.items()}
    return params


_LM_QUANT_LEAVES = {"wqkv", "wo", "w1", "w2", "w3"}
_LM_QUANT_TOP = {"embeddings", "codebook_embeddings", "fast_embeddings",
                 "output", "fast_output"}


def quantize_weight_int4(w: torch.Tensor, groupsize: int = 128) -> dict:
    """(..., out, in) -> {"q": int8 values in [-8, 7] (..., out, in), "gs":
    f32 (..., out, in/groupsize)}: the JAX package's native int4 (its
    checkpoint form, `quantize_weight_int4`), carried as int8.
    `save_params` lists such "q" leaves in quant_meta.json, as JAX writes
    them; `pack_int4_params` turns them into the packed serving form."""
    *lead, out, inner = w.shape
    if inner % groupsize:
        raise ValueError(f"groupsize {groupsize} must divide {inner}")
    wf = w.float().reshape(*lead, out, inner // groupsize, groupsize)
    scale = div_exact(wf.abs().amax(dim=-1), 7.0).clamp_min(1e-12)
    q = torch.round(wf / scale[..., None]).clamp(-8, 7).to(torch.int8)
    return {"q": q.reshape(*lead, out, inner), "gs": scale}


def _by_layer(fn, w: torch.Tensor):
    """fn (a quantizer, or a cast) one leading-axis slice at a time, so a
    layer-stacked leaf's f32 temporaries are one layer's (a whole (36,
    9728, 2560) leaf's would take 3.6 GB). Every quantizer here works row
    by row, so the result is the whole leaf's, bit for bit."""
    if w.ndim < 3:
        return fn(w)
    first = fn(w[0])
    if isinstance(first, torch.Tensor):
        out = first.new_empty((w.shape[0], *first.shape))
        out[0] = first
        for i in range(1, w.shape[0]):
            out[i] = fn(w[i])
        return out
    out = {k: v.new_empty((w.shape[0], *v.shape)) for k, v in first.items()}
    for i in range(w.shape[0]):
        part = first if i == 0 else fn(w[i])
        for k in out:
            out[k][i] = part[k]
    return out


def _int4_by_layer(w: torch.Tensor, groupsize: int) -> dict:
    """quantize_weight_int4_packed one layer at a time (`_by_layer`)."""
    return _by_layer(lambda v: quantize_weight_int4_packed(v, groupsize), w)


QUANT_MODES = ("int8", "int4", "w4a8")


def _quantize_leaf(keys: tuple, w: torch.Tensor, mode: str,
                   groupsize: int):
    """One leaf of the Dual-AR tree as the JAX `quantize_lm_params`
    selects it: the large matrices quantized (the slow stack's ("layers")
    in int4 / w4a8 mode when `groupsize` divides their input width, every
    other one int8), other floating leaves cast to bf16, the rest as is.
    A layer-stacked leaf goes one layer at a time."""
    leaf = keys[-1]
    target = leaf in _LM_QUANT_LEAVES or (leaf in _LM_QUANT_TOP
                                          and len(keys) == 1)
    if target and w.ndim >= 2:
        if (mode != "int8" and keys[0] == "layers"
                and w.shape[-1] % groupsize == 0):
            if mode == "w4a8":
                return _int4_by_layer(w, groupsize)
            return _by_layer(lambda v: quantize_weight_int4(v, groupsize), w)
        return _by_layer(quantize_weight, w)
    if w.is_floating_point():
        return w.to(torch.bfloat16)
    return w


def _check_mode(mode: str) -> None:
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")


def quantize_lm_params(params: dict, mode: str = "int8",
                       groupsize: int = 128) -> dict:
    """Quantize the Dual-AR tree's large matrices; other floating leaves
    become bf16. Same leaf selection as the JAX `quantize_lm_params`:
    mode "int8" quantizes per output channel; "w4a8" packs the slow
    stack's ("layers") matrices whose input width divides by `groupsize`
    as groupwise int4 (the runnable form), "int4" keeps them as the JAX
    native int4 checkpoint form ({"q", "gs"}, `quantize_weight_int4`);
    every other matrix (fast stack, embeddings) is int8. Leaves are
    replaced one at a time and layer-stacked ones quantized a layer at a
    time, so the peak memory is one layer's temporaries."""
    _check_mode(mode)

    def visit(keys: tuple, w):
        if isinstance(w, dict):
            return {k: visit(keys + (k,), v) for k, v in w.items()}
        return _quantize_leaf(keys, w, mode, groupsize)

    return {k: visit((k,), v) for k, v in params.items()}


def quantize_lm_params_incremental(params: dict, mode: str = "int8",
                                   groupsize: int = 128) -> dict:
    """quantize_lm_params, freeing as it goes (the JAX
    `quantize_lm_params_incremental`): DESTRUCTIVE, `params` and its
    sub-dicts are emptied first, so each bf16 leaf is freed once its
    quantized form exists (a full-width S2-Pro bf16 tree is ~8 GB beside
    its ~4 GB int8 form). Rebind the result."""
    _check_mode(mode)
    flat = []

    def take(keys: tuple, node: dict):
        for k in list(node):
            v = node.pop(k)
            if isinstance(v, dict):
                take(keys + (k,), v)
            else:
                flat.append((keys + (k,), v))

    take((), params)
    out: dict = {}
    for i in range(len(flat)):
        keys, w = flat[i]
        flat[i] = None          # the leaf's last reference but `w`
        y = _quantize_leaf(keys, w, mode, groupsize)
        del w
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = y
    return out
