"""Int8 per-output-channel weight quantization and the W8A8 product.

Counterpart of `fish_speech_tpu/ops/quant.py` (int8 mode only). A quantized
weight is the dict {"q": int8 (..., out, in), "s": f32 (..., out)}; plain and
quantized parameter trees share every code path through `as_weight`,
`matmul_t`, `take_rows` and `slice_rows`.
"""

from __future__ import annotations

import torch


def quantize_weight(w: torch.Tensor) -> dict:
    """(..., out, in) -> {"q": int8, "s": f32 (..., out)}."""
    wf = w.float()
    scale = (wf.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    q = torch.round(wf / scale[..., None]).clamp(-128, 127).to(torch.int8)
    return {"q": q, "s": scale}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def as_weight(w, dtype=torch.bfloat16) -> torch.Tensor:
    """The dequantized weight (or the plain one unchanged)."""
    if not is_quantized(w):
        return w
    return w["q"].to(dtype) * w["s"].to(dtype)[..., None]


def int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric activation quantization: (int8, f32 scale (..., 1))."""
    xf = x.float()
    xs = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
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
    and channel scales (the serving path)."""
    if not is_quantized(w):
        return x @ w.T
    if w8a8:
        lead = x.shape[:-1]
        x8, xs = int8_rows(x.reshape(-1, x.shape[-1]))
        acc = int8_matmul_t(x8, w["q"])
        y = acc.float() * xs * w["s"].float()
        return y.to(x.dtype).reshape(*lead, -1)
    return x @ as_weight(w, x.dtype).T


def take_rows(w, idx: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding-style row gather that dequantizes only the gathered rows."""
    if not is_quantized(w):
        return w[idx]
    rows = w["q"][idx].to(dtype)
    return rows * w["s"][idx].to(dtype)[..., None]


def slice_rows(w, start: int, stop: int):
    """Row slice [start, stop) of a (possibly quantized) (V, D) weight."""
    if not is_quantized(w):
        return w[start:stop]
    return {"q": w["q"][start:stop], "s": w["s"][start:stop]}


_LM_QUANT_LEAVES = {"wqkv", "wo", "w1", "w2", "w3"}
_LM_QUANT_TOP = {"embeddings", "codebook_embeddings", "fast_embeddings",
                 "output", "fast_output"}


def quantize_lm_params(params: dict) -> dict:
    """Int8-quantize the Dual-AR tree's large matrices (per output channel);
    other floating leaves become bf16. Same leaf selection as the JAX
    `quantize_lm_params` in int8 mode. Leaves are replaced one at a time, so
    the peak memory is one leaf's temporaries."""

    def visit(keys: tuple, w):
        if isinstance(w, dict):
            return {k: visit(keys + (k,), v) for k, v in w.items()}
        leaf = keys[-1]
        target = leaf in _LM_QUANT_LEAVES or (leaf in _LM_QUANT_TOP
                                              and len(keys) == 1)
        if target and w.ndim >= 2:
            return quantize_weight(w)
        if w.is_floating_point():
            return w.to(torch.bfloat16)
        return w

    return {k: visit((k,), v) for k, v in params.items()}
