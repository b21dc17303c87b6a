"""Fused vocoder residual-unit stacks and decoder blocks.

Counterpart of `fish_speech_tpu/ops/voc_fused.py`. A residual unit is
snake -> causal k7 conv (dilation 1, 3, 9) -> snake -> 1x1 conv -> residual;
`fused_res_stack` applies such units to a (B, T, C) activation and
`fused_block` computes a whole decoder block: the transposed conv (k =
2*stride) as two phase products, the three units, the next block's entry
snake (tail) and, on the last block, the final k7 conv and tanh.

The snake is the TPU kernel's degree-7 polynomial for sin^2 with alpha/pi
premultiplied. The state between units is kept in the input dtype (bf16 on
the serving path) with f32 accumulation in the convolutions.

Semantics are the TPU kernel's, including its left context: units inside
one call see the state that zero input before the sequence start produces
(with zero biases, as the random init has, that state stays zero).

The wrappers launch the CUDA kernels (csrc/voc_fused.cu) for CUDA tensors
and run the plain versions for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

RES_STACK = _cuda.Kernel("voc_res_stack")
BLOCK = _cuda.Kernel("voc_block")

DILATIONS = (1, 3, 9)
_S2C = (9.86943246, -32.46507037, 42.68612315, -29.93828299, 12.78106835,
        -3.38355759, 0.45029592)
_INV_PI = 1.0 / math.pi


def pack_res_stack(units: list[dict], dtype=torch.bfloat16) -> dict:
    """Stack per-unit params: w7 (U, 7, C, C), w1 (U, C, C) in `dtype`, and
    vec (U, 6, C) f32 rows [alpha1/pi, 1/(alpha1+eps), alpha2/pi,
    1/(alpha2+eps), b1, b2] (eps = 1e-9)."""
    w7 = torch.stack([u["conv1_w"] for u in units]).to(dtype)
    w1 = torch.stack([u["conv2_w"][0] for u in units]).to(dtype)

    def vec(u):
        a1 = u["snake1_alpha"].float()
        a2 = u["snake2_alpha"].float()
        return torch.stack([a1 * _INV_PI, 1.0 / (a1 + 1e-9), a2 * _INV_PI,
                            1.0 / (a2 + 1e-9), u["conv1_b"].float(),
                            u["conv2_b"].float()])

    return {"w7": w7.contiguous(), "w1": w1.contiguous(),
            "vec": torch.stack([vec(u) for u in units]).contiguous()}


def snake_poly(x: torch.Tensor, alpha_pi, inv_alpha) -> torch.Tensor:
    """x + sin^2(alpha x) / (alpha + eps), f32, through the polynomial."""
    y = alpha_pi * x
    t = y - y.to(torch.int32).to(torch.float32)     # fraction, truncated
    v = t * t
    s2 = torch.full_like(v, _S2C[-1])
    for cc in _S2C[-2::-1]:
        s2 = cc + v * s2
    return x + (v * s2) * inv_alpha


def _run_units(cur: torch.Tensor, packed: dict, dilations, tail_vec,
               extra: int = 0) -> torch.Tensor:
    """cur: (B, n, C) state with 6*sum(dilations) + extra rows of left
    context; returns the last n - 6*sum(dilations) rows (+ `extra`)."""
    w7, w1, vec = packed["w7"], packed["w1"], packed["vec"]
    wt = w7.dtype
    for u, d in enumerate(dilations):
        rf = 6 * d
        n = cur.shape[1] - rf
        a1, ia1, a2, ia2, b1, b2 = vec[u]
        s = snake_poly(cur.float(), a1, ia1).to(wt).float()
        acc = b1.expand(cur.shape[0], n, -1)
        for i in range(7):
            acc = acc + s[:, i * d:i * d + n] @ w7[u, i].float()
        s2 = snake_poly(acc, a2, ia2).to(w1.dtype).float()
        y = s2 @ w1[u].float() + b2
        cur = (cur[:, rf:].float() + y).to(cur.dtype)
    out = cur
    if tail_vec is not None:
        out = snake_poly(out.float(), tail_vec[0], tail_vec[1]).to(out.dtype)
    return out


def fused_res_stack_plain(x: torch.Tensor, packed: dict, dilations=DILATIONS,
                          tail_vec: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: x (B, T, C) -> (B, T, C) in x.dtype."""
    halo = 6 * sum(dilations)
    xp = torch.nn.functional.pad(x, (0, 0, halo, 0))
    return _run_units(xp, packed, dilations, tail_vec)


def fused_res_stack(x: torch.Tensor, packed: dict, dilations=DILATIONS,
                    tail_vec: torch.Tensor | None = None) -> torch.Tensor:
    """The residual units of `packed` over x (B, T, C). The CUDA kernel
    takes one unit per call (the 768-channel decoder block's use)."""
    if not x.is_cuda:
        return fused_res_stack_plain(x, packed, dilations, tail_vec)
    b, t, c = x.shape
    if len(dilations) != 1 or c % 16:
        raise ValueError("the residual-stack kernel takes one unit per call "
                         "and channels a multiple of 16")
    dev = x.device
    _cuda.check(x, "x", torch.bfloat16, device=dev)
    _cuda.check(packed["w7"], "w7", torch.bfloat16, (1, 7, c, c), dev)
    _cuda.check(packed["w1"], "w1", torch.bfloat16, (1, c, c), dev)
    _cuda.check(packed["vec"], "vec", torch.float32, (1, 6, c), dev)
    if tail_vec is not None:
        _cuda.check(tail_vec, "tail_vec", torch.float32, (2, c), dev)
    y = torch.empty_like(x)
    RES_STACK(x.data_ptr(), y.data_ptr(), packed["w7"].data_ptr(),
              packed["w1"].data_ptr(), packed["vec"].data_ptr(),
              _cuda.ptr(tail_vec), b, t, c, 1, dilations[0], 0, 0,
              int(tail_vec is not None))
    return y


def fused_block_plain(x: torch.Tensor, packed: dict, *, stride: int,
                      dilations=DILATIONS,
                      tail_vec: torch.Tensor | None = None,
                      final_w: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version. x: (B, T_in, C_in) pre-tconv activation.
    Returns (B, T_in*stride, C) in x.dtype, or with final_w ((8, C) f32:
    7 conv taps and a bias row) the (B, T_in*stride) waveform."""
    b, t_in, _ = x.shape
    pw, pb = packed["tconv_pw"], packed["tconv_pb"]
    c = pw.shape[2] // stride
    xf = x.float()
    lag = torch.nn.functional.pad(xf, (0, 0, 1, 0))[:, :-1]
    acc = xf @ pw[0].float() + lag @ pw[1].float() + pb
    cur = acc.reshape(b, t_in * stride, c)
    extra = 0 if final_w is None else final_w.shape[0] - 2
    halo = 6 * sum(dilations) + extra
    cur = torch.nn.functional.pad(cur, (0, 0, halo, 0)).to(x.dtype)
    out = _run_units(cur, packed, dilations, tail_vec)
    if final_w is None:
        return out
    ext = out.float()                                   # (B, T + extra, C)
    t = t_in * stride
    m = ext[:, 0:t] * final_w[0]
    for i in range(1, extra + 1):
        m = m + ext[:, i:i + t] * final_w[i]
    return torch.tanh(m.sum(-1) + final_w[extra + 1, 0]).to(x.dtype)


def fused_block(x: torch.Tensor, packed: dict, *, stride: int,
                dilations=DILATIONS, tail_vec: torch.Tensor | None = None,
                final_w: torch.Tensor | None = None) -> torch.Tensor:
    """One decoder block; see fused_block_plain for shapes."""
    if not x.is_cuda:
        return fused_block_plain(x, packed, stride=stride,
                                 dilations=dilations, tail_vec=tail_vec,
                                 final_w=final_w)
    b, t_in, c_in = x.shape
    pw = packed["tconv_pw"]
    c = pw.shape[2] // stride
    if len(dilations) != 3 or c % 16 or c_in % 16 or 16 % stride:
        raise ValueError("the block kernel takes three units, channels a "
                         "multiple of 16 and a stride dividing 16")
    dev = x.device
    _cuda.check(x, "x", torch.bfloat16, device=dev)
    _cuda.check(pw, "tconv_pw", torch.bfloat16, (2, c_in, stride * c), dev)
    _cuda.check(packed["tconv_pb"], "tconv_pb", torch.float32,
                (stride * c,), dev)
    _cuda.check(packed["w7"], "w7", torch.bfloat16, (3, 7, c, c), dev)
    _cuda.check(packed["w1"], "w1", torch.bfloat16, (3, c, c), dev)
    _cuda.check(packed["vec"], "vec", torch.float32, (3, 6, c), dev)
    if tail_vec is not None:
        _cuda.check(tail_vec, "tail_vec", torch.float32, (2, c), dev)
    if final_w is not None:
        _cuda.check(final_w, "final_w", torch.float32, (8, c), dev)
        y = torch.empty((b, t_in * stride), dtype=x.dtype, device=dev)
    else:
        y = torch.empty((b, t_in * stride, c), dtype=x.dtype, device=dev)
    BLOCK(x.data_ptr(), y.data_ptr(), pw.data_ptr(),
          packed["tconv_pb"].data_ptr(), packed["w7"].data_ptr(),
          packed["w1"].data_ptr(), packed["vec"].data_ptr(),
          _cuda.ptr(tail_vec), _cuda.ptr(final_w), b, t_in, c_in, c, stride,
          *dilations, int(final_w is not None))
    return y
