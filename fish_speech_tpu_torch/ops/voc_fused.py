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

int8 packs (`pack_res_stack(quant=True)`, the VOC_QUANT vocoder) are a
different function: int8 weights per output channel, activations quantized
with one scale per TPU-kernel tile (`quantize_tile`), int32 sums. The scale
of a tile covers its halo rows too, so the result depends on the tiling:
the int8 forms take the TPU kernel's time tile `tt` and reproduce its
(batch row, tile) grid, each tile recomputing its halo with its own scales.

The wrappers launch the CUDA kernels (csrc/voc_fused.cu for bf16 packs,
csrc/voc_fused_i8.cu for int8 packs) for CUDA tensors and run the plain
versions for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _cuda
from .quant import div_exact

RES_STACK = _cuda.Kernel("voc_res_stack")
BLOCK = _cuda.Kernel("voc_block")
RES_STACK_I8 = _cuda.Kernel("voc_res_stack_i8")
BLOCK_I8 = _cuda.Kernel("voc_block_i8")

DILATIONS = (1, 3, 9)
_S2C = (9.86943246, -32.46507037, 42.68612315, -29.93828299, 12.78106835,
        -3.38355759, 0.45029592)
_INV_PI = 1.0 / math.pi


def halo_for(dilations=DILATIONS, extra: int = 0) -> int:
    """The TPU kernels' left context: 6*sum(dilations) (+ `extra` rows for a
    fused final conv) rounded up to 16 rows. It sets the int8 tiles."""
    return -(-(6 * sum(dilations) + extra) // 16) * 16


def pack_res_stack(units: list[dict], dtype=torch.bfloat16,
                   quant: bool = False) -> dict:
    """Stack per-unit params: w7 (U, 7, C, C), w1 (U, C, C) in `dtype`, and
    vec (U, 6, C) f32 rows [alpha1/pi, 1/(alpha1+eps), alpha2/pi,
    1/(alpha2+eps), b1, b2] (eps = 1e-9).

    quant=True: w7 and w1 int8, quantized per (unit, output channel) with
    one scale shared by the 7 taps (so all taps sum in int32), rounded half
    to even; vec gains two rows [s7/127, s1/127]."""
    w7 = torch.stack([u["conv1_w"] for u in units])
    w1 = torch.stack([u["conv2_w"][0] for u in units])

    def vec(u):
        a1 = u["snake1_alpha"].float()
        a2 = u["snake2_alpha"].float()
        return torch.stack([a1 * _INV_PI, 1.0 / (a1 + 1e-9), a2 * _INV_PI,
                            1.0 / (a2 + 1e-9), u["conv1_b"].float(),
                            u["conv2_b"].float()])

    vecs = torch.stack([vec(u) for u in units])
    if not quant:
        return {"w7": w7.to(dtype).contiguous(),
                "w1": w1.to(dtype).contiguous(), "vec": vecs.contiguous()}
    w7, w1 = w7.float(), w1.float()
    s7 = w7.abs().amax(dim=(1, 2)).clamp_min(1e-12)                # (U, C)
    s1 = w1.abs().amax(dim=1).clamp_min(1e-12)
    return {
        "w7": torch.round(w7 / s7[:, None, None, :] * 127.0).to(
            torch.int8).contiguous(),
        "w1": torch.round(w1 / s1[:, None, :] * 127.0).to(
            torch.int8).contiguous(),
        "vec": torch.cat([vecs, div_exact(s7, 127.0)[:, None],
                          div_exact(s1, 127.0)[:, None]], dim=1).contiguous()}


def quantize_tile(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's per-tile activation quantization, one tile per
    leading index: s (N, R, C) f32 -> int8 codes and the scales m (N, 1, 1),
    m = max(max|s|, 1e-12), codes trunc(s * (127/m) +- 0.5) (half away from
    zero; 127/m one true division)."""
    m = s.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-12)
    k = torch.full_like(m, 127.0) / m
    q = torch.trunc(s * k + torch.where(s >= 0, 0.5, -0.5))
    return q.to(torch.int8), m


def _int_dot(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 x int8 products with exact sums (float64 holds every int32 sum
    of these widths exactly, on the CPU and on the card)."""
    return q.double() @ w.double()


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
               keep: int | None = None) -> torch.Tensor:
    """cur: (N, n, C) state, its first rows left context; each unit drops
    6*d rows. Returns the last `keep` rows (all by default). An int8 pack
    quantizes each snake output with one scale per leading index (a TPU
    kernel tile)."""
    w7, w1, vec = packed["w7"], packed["w1"], packed["vec"]
    wt = w7.dtype
    quant = wt == torch.int8
    for u, d in enumerate(dilations):
        rf = 6 * d
        n = cur.shape[1] - rf
        a1, ia1, a2, ia2, b1, b2 = vec[u, :6]
        s = snake_poly(cur.float(), a1, ia1)
        if quant:
            q, m = quantize_tile(s)
            acc = sum(_int_dot(q[:, i * d:i * d + n], w7[u, i])
                      for i in range(7)).float()
            acc = acc * (vec[u, 6] * (m * (1.0 / 127.0))) + b1
        else:
            s = s.to(wt).float()
            acc = b1.expand(cur.shape[0], n, -1)
            for i in range(7):
                acc = acc + s[:, i * d:i * d + n] @ w7[u, i].float()
        s2 = snake_poly(acc, a2, ia2)
        if quant:
            q2, m2 = quantize_tile(s2)
            y = (_int_dot(q2, w1[u]).float()
                 * (vec[u, 7] * (m2 * (1.0 / 127.0))) + b2)
        else:
            y = s2.to(w1.dtype).float() @ w1[u].float() + b2
        cur = (cur[:, rf:].float() + y).to(cur.dtype)
    out = cur if keep is None else cur[:, cur.shape[1] - keep:]
    if tail_vec is not None:
        out = snake_poly(out.float(), tail_vec[0], tail_vec[1]).to(out.dtype)
    return out


def _tiles(xp: torch.Tensor, rows: int, step: int) -> torch.Tensor:
    """(B, L, C) -> (B*n, rows, C): the windows of `rows` rows starting
    every `step` rows, ordered (batch row, tile) as the TPU kernel's grid."""
    c = xp.shape[2]
    return xp.unfold(1, rows, step).permute(0, 1, 3, 2).reshape(-1, rows, c)


def _check_tile(t: int, tt: int | None) -> None:
    if tt is None or tt < 1 or t % tt:
        raise ValueError(f"an int8 pack runs in the TPU kernel's time tiles: "
                         f"give tt dividing T={t} (got {tt})")


def _final_conv(ext: torch.Tensor, final_w: torch.Tensor,
                t: int) -> torch.Tensor:
    """The decoder-final conv (C -> 1, k = final_w.shape[0] - 1 taps, bias
    at final_w[k, 0]) and tanh over ext (N, t + k - 1, C): (N, t) f32."""
    fk = final_w.shape[0] - 1
    ext = ext.float()
    m = ext[:, 0:t] * final_w[0]
    for i in range(1, fk):
        m = m + ext[:, i:i + t] * final_w[i]
    return torch.tanh(m.sum(-1) + final_w[fk, 0])


def fused_res_stack_plain(x: torch.Tensor, packed: dict, dilations=DILATIONS,
                          tail_vec: torch.Tensor | None = None,
                          tt: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: x (B, T, C) -> (B, T, C) in x.dtype. An int8
    pack runs tile by tile (tt rows plus halo_for(dilations) rows of left
    context each, T % tt == 0)."""
    if packed["w7"].dtype != torch.int8:
        xp = F.pad(x, (0, 0, 6 * sum(dilations), 0))
        return _run_units(xp, packed, dilations, tail_vec)
    b, t, c = x.shape
    _check_tile(t, tt)
    halo = halo_for(dilations)
    tiles = _tiles(F.pad(x, (0, 0, halo, 0)), halo + tt, tt)
    return _run_units(tiles, packed, dilations, tail_vec,
                      keep=tt).reshape(b, t, c)


def _check_weights(packed: dict, c: int, n_units: int, quant: bool,
                   dev) -> None:
    wt = torch.int8 if quant else torch.bfloat16
    _cuda.check(packed["w7"], "w7", wt, (n_units, 7, c, c), dev)
    _cuda.check(packed["w1"], "w1", wt, (n_units, c, c), dev)
    _cuda.check(packed["vec"], "vec", torch.float32,
                (n_units, 8 if quant else 6, c), dev)


def fused_res_stack(x: torch.Tensor, packed: dict, dilations=DILATIONS,
                    tail_vec: torch.Tensor | None = None,
                    tt: int | None = None) -> torch.Tensor:
    """The residual units of `packed` over x (B, T, C). The CUDA kernels
    take one unit per call (the 768-channel decoder block's use): a bf16
    pack runs as whole-sequence passes (`voc_res_plan`) in scratch
    allocated here; an int8 pack as int8 passes over the per-tile state
    (`voc_i8_plan`), in the tiles `tt` (see fused_res_stack_plain)."""
    if not x.is_cuda:
        return fused_res_stack_plain(x, packed, dilations, tail_vec, tt)
    b, t, c = x.shape
    quant = packed["w7"].dtype == torch.int8
    if len(dilations) != 1 or c % GEMM_K:
        raise ValueError(f"the residual-stack kernel takes one unit per call "
                         f"and channels a multiple of {GEMM_K}")
    dev = x.device
    _cuda.check(x, "x", torch.bfloat16, device=dev)
    _check_weights(packed, c, 1, quant, dev)
    if tail_vec is not None:
        _cuda.check(tail_vec, "tail_vec", torch.float32, (2, c), dev)
    y = torch.empty_like(x)
    if not quant:
        plan = voc_res_plan(b, t, c, dilations[0], _cuda.sm_count(dev.index))
        w7t, w1t = res_weights_t(packed)
        _cuda.check(w7t, "w7t", torch.bfloat16, (1, 7, c, c), dev)
        _cuda.check(w1t, "w1t", torch.bfloat16, (1, c, c), dev)
        # the passes' scratch: the entry snake, the second snake
        sn, s2 = torch.empty_like(x), torch.empty_like(x)
        RES_STACK(x.data_ptr(), y.data_ptr(), w7t.data_ptr(), w1t.data_ptr(),
                  packed["vec"].data_ptr(), _cuda.ptr(tail_vec),
                  sn.data_ptr(), s2.data_ptr(), *plan["tiles"], b, t, c,
                  dilations[0], int(tail_vec is not None))
        return y
    plan = voc_i8_plan(b, t, c, dilations, tt,
                       n_sm=_cuda.sm_count(dev.index))
    w7t, w1t = res_weights_t(packed)
    _cuda.check(w7t, "w7t", torch.int8, (1, 7, c, c), dev)
    _cuda.check(w1t, "w1t", torch.int8, (1, c, c), dev)
    st, q, s2, amax = _i8_scratch(plan, c, dev, 2)
    tiles = (ctypes.c_int * 2)(*plan["tiles"])
    RES_STACK_I8(x.data_ptr(), y.data_ptr(), w7t.data_ptr(), w1t.data_ptr(),
                 packed["vec"].data_ptr(), _cuda.ptr(tail_vec),
                 st.data_ptr(), q.data_ptr(), s2.data_ptr(), amax.data_ptr(),
                 tiles, b, t, c, dilations[0], tt, plan["halo"],
                 int(tail_vec is not None))
    return y


def _i8_scratch(plan: dict, c: int, dev, n_max: int) -> tuple:
    """The int8 kernels' scratch for `plan` (voc_i8_plan): the per-tile
    state (bf16), the codes (int8, q_bytes), the second snake (f32) and
    n_max tile maxima a tile (f32, zeroed by the C entry: the passes take
    their maxima with atomics)."""
    shape = (plan["n"], plan["rows"], c)
    return (torch.empty(shape, dtype=torch.bfloat16, device=dev),
            torch.empty(plan["q_bytes"], dtype=torch.int8, device=dev),
            torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty((n_max, plan["n"]), dtype=torch.float32, device=dev))


def _block_i8_plain(x: torch.Tensor, packed: dict, stride: int, dilations,
                    tail_vec, final_w, tt) -> torch.Tensor:
    """fused_block_plain of an int8 pack, tile by tile as the TPU kernel:
    each tile quantizes its transposed conv's input slab ((halo+tt)/stride
    + 1 rows, zero before the sequence start) with one scale, zeroes the
    state rows before the sequence start, then runs the units on its own
    halo+tt rows."""
    b, t_in, _ = x.shape
    pw, pb = packed["tconv_pw"], packed["tconv_pb"]
    c = pw.shape[2] // stride
    t = t_in * stride
    _check_tile(t, tt)
    fk = 0 if final_w is None else final_w.shape[0] - 1
    extra = max(fk - 1, 0)
    halo = halo_for(dilations, extra)
    if tt % stride or halo % stride:
        raise ValueError(f"stride {stride} must divide tt={tt} and the "
                         f"halo {halo}")
    n_in, tt_in = (halo + tt) // stride, tt // stride
    slab = _tiles(F.pad(x, (0, 0, halo // stride + 1, 0)), n_in + 1,
                  tt_in).float()
    q, m = quantize_tile(slab)
    acc = (_int_dot(q[:, 1:], pw[0]) + _int_dot(q[:, :-1], pw[1])).float()
    acc = acc * (pb[1] * (m * (1.0 / 127.0))) + pb[0]
    cur = acc.reshape(-1, halo + tt, c)
    j = torch.arange(t // tt, device=x.device).repeat(b)
    row = torch.arange(halo + tt, device=x.device)
    real = (row[None, :] >= halo - j[:, None] * tt)[..., None]
    cur = torch.where(real, cur, 0.0).to(x.dtype)
    out = _run_units(cur, packed, dilations, tail_vec, keep=tt + extra)
    if final_w is None:
        return out.reshape(b, t, c)
    return _final_conv(out, final_w, tt).reshape(b, t).to(x.dtype)


def fused_block_plain(x: torch.Tensor, packed: dict, *, stride: int,
                      dilations=DILATIONS,
                      tail_vec: torch.Tensor | None = None,
                      final_w: torch.Tensor | None = None,
                      tt: int | None = None) -> torch.Tensor:
    """Plain PyTorch version. x: (B, T_in, C_in) pre-tconv activation.
    Returns (B, T_in*stride, C) in x.dtype, or with final_w ((8, C) f32:
    7 conv taps and a bias row) the (B, T_in*stride) waveform. An int8 pack
    (tconv_pb then (2, stride*C): the bias and the phase scales / 127) runs
    in the TPU kernel's tiles of `tt` rows."""
    pw, pb = packed["tconv_pw"], packed["tconv_pb"]
    if pw.dtype == torch.int8:
        return _block_i8_plain(x, packed, stride, dilations, tail_vec,
                               final_w, tt)
    b, t_in, _ = x.shape
    c = pw.shape[2] // stride
    xf = x.float()
    lag = F.pad(xf, (0, 0, 1, 0))[:, :-1]
    acc = xf @ pw[0].float() + lag @ pw[1].float() + pb
    cur = acc.reshape(b, t_in * stride, c)
    extra = 0 if final_w is None else final_w.shape[0] - 2
    halo = 6 * sum(dilations) + extra
    cur = F.pad(cur, (0, 0, halo, 0)).to(x.dtype)
    out = _run_units(cur, packed, dilations, tail_vec)
    if final_w is None:
        return out
    return _final_conv(out, final_w, t_in * stride).to(x.dtype)


# The bf16 kernels' GEMM passes (csrc/voc_fused.cu, voc_block and
# voc_res_stack): tiles (BM, BN) by the C entries' tile id; K (a multiple of
# GEMM_K) in steps of 64 where 64 divides it, else of 32
TILE_SHAPES = ((64, 32), (64, 64), (64, 96), (64, 128), (128, 32), (128, 64),
               (128, 96), (128, 128))
GEMM_K = 32
SMEM_LIMIT = 227 * 1024


def _ring_smem(bm: int, bn: int, step_bytes: int) -> int:
    """Dynamic shared memory (bytes) of one pass CTA: 1024 bytes of
    alignment, then the ring of A (bm rows) and W^T (bn rows) stages of
    step_bytes a row, as many (up to 8) as let two CTAs share an SM, whose
    bytes then hold the 4-byte output tile (rows of bn + 8); the C
    launchers' rule (csrc/voc_common.cuh, wg_stages)."""
    stage = (bm + bn) * step_bytes
    stages = 8
    while stages > 2 and 2 * (stages * stage + 1024 + 2048) > SMEM_LIMIT:
        stages -= 1
    return 1024 + max(stages * stage, bm * (bn + 8) * 4)


def tile_smem(bm: int, bn: int, k: int) -> int:
    """The bf16 passes' `_ring_smem` over K = k: steps of 64 elements
    where 64 divides k, else of 32."""
    return _ring_smem(bm, bn, 2 * (64 if k % 64 == 0 else 32))


def res_weights_t(packed: dict) -> tuple:
    """The residual units' weights as the K-major (taps, N, K) tiles the
    passes load (bf16 or int8, the pack's dtype): w7 (U, 7, C, C) and w1
    (U, C, C), each [.., out, in]. `pack_decoder` keeps them in block 0's
    pack ("w7t", "w1t"); a pack without them is transposed here, per
    call."""
    if "w7t" in packed:
        return packed["w7t"], packed["w1t"]
    return (packed["w7"].transpose(2, 3).contiguous(),
            packed["w1"].transpose(1, 2).contiguous())


def block_weights_t(packed: dict) -> tuple:
    """The block kernels' weights as the K-major (taps, N, K) tiles their
    passes load (bf16 or int8, the pack's dtype): the tconv phases (2,
    stride*C, C_in), then w7 and w1 as `res_weights_t` gives them.
    `pack_decoder` keeps them in the pack ("wt"); a pack without them is
    transposed here, per call."""
    if "wt" in packed:
        return packed["wt"]
    return (packed["tconv_pw"].transpose(1, 2).contiguous(),
            *res_weights_t(packed))


def _plan_pass(b: int, name: str, m_lo: int, m_hi: int, n: int, taps: int,
               k: int, n_sm: int, shapes=TILE_SHAPES, smem=tile_smem) -> dict:
    """One GEMM pass of output rows [m_lo, m_hi) and n columns over `taps`
    taps of K = k, b times (the grid's third axis), with its tile from
    `shapes` (its index is the tile id): the largest (BM x BN, then BM)
    whose grid has at least n_sm CTAs, else the one with the most CTAs
    (then the smaller BM); `smem(bm, bn, k)` its CTA's dynamic shared
    memory. Raises if no tile's BN divides n."""
    def ctas(i):
        bm, bn = shapes[i]
        return -(-(m_hi - m_lo) // bm) * (n // bn) * b

    fit = sorted((i for i, (_, bn) in enumerate(shapes) if n % bn == 0),
                 key=lambda i: (shapes[i][0] * shapes[i][1], shapes[i][0]),
                 reverse=True)
    if not fit:
        raise ValueError(f"no tile of the pass kernel divides {n} columns")
    full = [i for i in fit if ctas(i) >= n_sm]
    tile = full[0] if full else max(fit, key=lambda i: (ctas(i),
                                                        -shapes[i][0]))
    bm, bn = shapes[tile]
    return {"name": name, "m_lo": m_lo, "m_hi": m_hi, "n": n, "taps": taps,
            "k": k, "bm": bm, "bn": bn, "tile": tile, "ctas": ctas(tile),
            "smem": smem(bm, bn, k)}


def voc_block_plan(b: int, t_in: int, c_in: int, c: int, stride: int,
                   dilations=DILATIONS, final: bool = False,
                   n_sm: int = 132) -> dict:
    """The bf16 block kernel's passes at these shapes on a card of n_sm
    SMs: the state's left context `halo` and its `rows` (halo + T); per
    pass (the transposed conv, then each unit's k7 and 1x1 convs) its
    output rows [m_lo, m_hi), columns n, taps and K a tap, and the tile
    (`_plan_pass`). `tiles`: the tile ids the C entry takes;
    `device_kernels`: what one call runs (two memsets, the passes, the
    final conv; a pack without "wt" adds three transposes). Raises if no
    tile's BN divides a pass's columns."""
    if c % GEMM_K or c_in % GEMM_K or len(dilations) != 3:
        raise ValueError(f"the bf16 block kernel takes three units and "
                         f"channels a multiple of {GEMM_K}")
    halo = 6 * sum(dilations) + (6 if final else 0)
    rows = halo + t_in * stride
    spans = [("tconv", 0, t_in, stride * c, 2, c_in)]
    lo = 0
    for u, d in enumerate(dilations):
        lo += 6 * d
        spans += [(f"k7 u{u}", lo, rows, c, 7, c),
                  (f"1x1 u{u}", lo, rows, c, 1, c)]
    passes = [_plan_pass(b, *span, n_sm) for span in spans]
    return {"halo": halo, "rows": rows, "passes": passes,
            "tiles": [q["tile"] for q in passes],
            "device_kernels": 2 + len(passes) + int(final)}


def voc_res_plan(b: int, t: int, c: int, d: int, n_sm: int = 132) -> dict:
    """The bf16 residual-unit kernel's passes over x (b, t, c), dilation d,
    on a card of n_sm SMs: the k7 conv (7 taps of K = c, tap i reading rows
    r - 6d + i*d) and the 1x1 conv, each over output rows [0, t) and c
    columns, with its tile as `voc_block_plan` picks one. `tiles`: the tile
    ids the C entry takes; `device_kernels`: what one call runs (the entry
    snake and the two passes; a pack without "w7t" adds two transposes).
    Raises unless c is a multiple of GEMM_K."""
    if c % GEMM_K:
        raise ValueError(f"the bf16 residual-unit kernel takes channels a "
                         f"multiple of {GEMM_K}")
    passes = [_plan_pass(b, f"k7 d{d}", 0, t, c, 7, c, n_sm),
              _plan_pass(b, f"1x1 d{d}", 0, t, c, 1, c, n_sm)]
    return {"passes": passes, "tiles": [q["tile"] for q in passes],
            "device_kernels": 1 + len(passes)}


# The int8 kernels' GEMM passes (csrc/voc_fused_i8.cu, i8_pass_kernel):
# tiles (BM, BN) by the C entries' tile id; K (a multiple of GEMM_K bytes)
# in steps of 128 bytes where 128 divides it, else of 64 or 32
I8_TILES = ((64, 32), (128, 96), (128, 128))


def i8_k_step(k: int) -> int:
    """The int8 passes' K step (bytes) for K = k: 128, 64 or 32."""
    return 128 if k % 128 == 0 else 64 if k % 64 == 0 else 32


def i8_tile_smem(bm: int, bn: int, k: int) -> int:
    """The int8 passes' `_ring_smem` over K = k (steps of i8_k_step(k)
    bytes; the int32 output tile)."""
    return _ring_smem(bm, bn, i8_k_step(k))


def voc_i8_plan(b: int, t: int, c: int, dilations, tt: int,
                tconv: tuple | None = None, final: bool = False,
                n_sm: int = 132) -> dict:
    """The int8 kernels' passes over b batch rows of t output rows and c
    channels in the TPU kernel's tiles of tt rows, on a card of n_sm SMs:
    a block (`tconv` = (c_in, stride): voc_block_i8, `final` with the final
    conv) or a residual stack (voc_res_stack_i8, one unit). Gives the
    tiles' `halo`, `rows` (halo + tt) and count `n`, the bytes of the codes'
    scratch `q_bytes` (a tile's state or, larger at block 3, its slab), and
    per pass (the transposed conv over the slab's rows [0, rows/stride);
    per unit a k7 and a 1x1 pass over rows [v + 6d, rows)) its tile as
    `_plan_pass` picks one from I8_TILES, with its K step `bk`. `tiles`:
    the tile ids the C entry takes; `device_kernels`: what one call runs (a
    memset; the slab max, its quantize and the tconv pass, or the gather;
    per unit two quantize kernels and two passes; out or the final conv; a
    pack without "wt" / "w7t" adds three / two transposes). Raises unless
    the channels are multiples of GEMM_K and the tiles divide t."""
    if c % GEMM_K or (tconv and tconv[0] % GEMM_K):
        raise ValueError(f"the int8 vocoder kernels take channels a "
                         f"multiple of {GEMM_K}")
    _check_tile(t, tt)
    halo = halo_for(dilations, 6 if final else 0)
    rows, n = halo + tt, b * (t // tt)
    spans, q_rows = [], rows * c
    if tconv:
        c_in, stride = tconv
        if tt % stride or halo % stride:
            raise ValueError(f"stride {stride} must divide tt={tt} and the "
                             f"halo {halo}")
        spans.append(("tconv", 0, rows // stride, stride * c, 2, c_in))
        q_rows = max(q_rows, (rows // stride + 1) * c_in)
    v = 0
    for d in dilations:
        v += 6 * d
        spans += [(f"k7 d{d}", v, rows, c, 7, c), (f"1x1 d{d}", v, rows, c,
                                                   1, c)]
    passes = [{**q, "bk": i8_k_step(q["k"])} for q in (
        _plan_pass(n, *span, n_sm, I8_TILES, i8_tile_smem) for span in spans)]
    return {"halo": halo, "rows": rows, "n": n, "q_bytes": n * q_rows,
            "passes": passes, "tiles": [q["tile"] for q in passes],
            "device_kernels": 1 + (3 if tconv else 1) + 4 * len(dilations)
            + 1}


def fused_block(x: torch.Tensor, packed: dict, *, stride: int,
                dilations=DILATIONS, tail_vec: torch.Tensor | None = None,
                final_w: torch.Tensor | None = None,
                tt: int | None = None) -> torch.Tensor:
    """One decoder block; see fused_block_plain for shapes. The bf16 kernel
    runs whole-sequence passes (`voc_block_plan`) in scratch allocated
    here; an int8 pack int8 passes over the per-tile state (`voc_i8_plan`)
    in the TPU kernel's tiles `tt`."""
    if not x.is_cuda:
        return fused_block_plain(x, packed, stride=stride,
                                 dilations=dilations, tail_vec=tail_vec,
                                 final_w=final_w, tt=tt)
    b, t_in, c_in = x.shape
    pw = packed["tconv_pw"]
    c = pw.shape[2] // stride
    quant = pw.dtype == torch.int8
    if quant and (len(dilations) != 3 or c % 32 or c_in % 32 or 16 % stride):
        raise ValueError("the int8 block kernel takes three units, channels "
                         "a multiple of 32 and a stride dividing 16")
    dev = x.device
    _cuda.check(x, "x", torch.bfloat16, device=dev)
    _cuda.check(pw, "tconv_pw", torch.int8 if quant else torch.bfloat16,
                (2, c_in, stride * c), dev)
    _cuda.check(packed["tconv_pb"], "tconv_pb", torch.float32,
                (2, stride * c) if quant else (stride * c,), dev)
    _check_weights(packed, c, 3, quant, dev)
    if tail_vec is not None:
        _cuda.check(tail_vec, "tail_vec", torch.float32, (2, c), dev)
    t = t_in * stride
    if final_w is not None:
        _cuda.check(final_w, "final_w", torch.float32, (8, c), dev)
        y = torch.empty((b, t), dtype=x.dtype, device=dev)
    else:
        y = torch.empty((b, t, c), dtype=x.dtype, device=dev)
    if not quant:
        # the passes' scratch: the state, its entry snake, the second snake
        plan = voc_block_plan(b, t_in, c_in, c, stride, dilations,
                              final_w is not None, _cuda.sm_count(dev.index))
        xs, sn, s2 = (torch.empty((b, plan["rows"], c), dtype=torch.bfloat16,
                                  device=dev) for _ in range(3))
        pwt, w7t, w1t = block_weights_t(packed)
        for name, w, shape in (("tconv_pwt", pwt, (2, stride * c, c_in)),
                               ("w7t", w7t, (3, 7, c, c)),
                               ("w1t", w1t, (3, c, c))):
            _cuda.check(w, name, torch.bfloat16, shape, dev)
        tiles = (ctypes.c_int * len(plan["tiles"]))(*plan["tiles"])
        BLOCK(x.data_ptr(), y.data_ptr(), pwt.data_ptr(),
              packed["tconv_pb"].data_ptr(), w7t.data_ptr(), w1t.data_ptr(),
              packed["vec"].data_ptr(), _cuda.ptr(tail_vec),
              _cuda.ptr(final_w), xs.data_ptr(), sn.data_ptr(),
              s2.data_ptr(), tiles, b, t_in, c_in, c, stride, *dilations,
              int(final_w is not None))
        return y
    plan = voc_i8_plan(b, t, c, dilations, tt, (c_in, stride),
                       final_w is not None, _cuda.sm_count(dev.index))
    pwt, w7t, w1t = block_weights_t(packed)
    for name, w, shape in (("tconv_pwt", pwt, (2, stride * c, c_in)),
                           ("w7t", w7t, (3, 7, c, c)),
                           ("w1t", w1t, (3, c, c))):
        _cuda.check(w, name, torch.int8, shape, dev)
    st, q, s2, amax = _i8_scratch(plan, c, dev, 1 + 2 * len(dilations))
    tiles = (ctypes.c_int * len(plan["tiles"]))(*plan["tiles"])
    BLOCK_I8(x.data_ptr(), y.data_ptr(), pwt.data_ptr(),
             packed["tconv_pb"].data_ptr(), w7t.data_ptr(), w1t.data_ptr(),
             packed["vec"].data_ptr(), _cuda.ptr(tail_vec),
             _cuda.ptr(final_w), st.data_ptr(), q.data_ptr(), s2.data_ptr(),
             amax.data_ptr(), tiles, b, t_in, c_in, c, stride, *dilations,
             tt, plan["halo"], int(final_w is not None))
    return y
