"""The reference's own quantization, in float32.

Every function takes float weights or activations and returns their
quantized values already scaled back (fake quantization), so the reference
runs plain float32 products on them:

- weights int8 per output channel: scale max|w| / 127;
- weights int4 per (output channel, group of `group` inputs): scale
  max|w| / 7, values in [-8, 7];
- activations int8 (or `bits`) per row: scale max|x| / (2^(bits-1) - 1);
- cache rows int8 per row: scale max|x| / 127, clamped at 1e-8, optionally
  rounded to bf16 (the fast head's cache keeps bf16 scales).

Rounding is to nearest, ties to even (torch.round).
"""

from __future__ import annotations

import torch


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded once (a tensor divisor, not a product with 1/d)."""
    return x / torch.full_like(x, d)


def weight_int8(w: torch.Tensor) -> torch.Tensor:
    wf = w.float()
    s = _div(wf.abs().amax(dim=-1), 127.0).clamp_min(1e-12)[..., None]
    return torch.round(wf / s).clamp(-128, 127) * s


def weight_int4(w: torch.Tensor, group: int = 128) -> torch.Tensor:
    wf = w.float()
    out, inner = wf.shape[-2:]
    g = wf.reshape(*wf.shape[:-1], inner // group, group)
    s = _div(g.abs().amax(dim=-1), 7.0).clamp_min(1e-12)[..., None]
    return (torch.round(g / s).clamp(-8, 7) * s).reshape(wf.shape)


def weight(w: torch.Tensor, kind: str) -> torch.Tensor:
    """kind: "int8" or "int4_g<group>"."""
    if kind == "int8":
        return weight_int8(w)
    if kind.startswith("int4_g"):
        return weight_int4(w, int(kind.removeprefix("int4_g")))
    raise ValueError(f"unknown weight precision {kind!r}")


def rows(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Per-row symmetric activation quantization."""
    top = float(2 ** (bits - 1) - 1)
    s = _div(x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), top)
    return torch.round(x / s).clamp(-top - 1, top) * s


def cache_rows(x: torch.Tensor, bf16_scale: bool = False) -> torch.Tensor:
    """A cache row's int8 quantization (scale per row of the last axis)."""
    s = _div(x.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(1e-8)
    q = torch.round(x / s)
    if bf16_scale:
        s = s.to(torch.bfloat16).float()
    return q * s
