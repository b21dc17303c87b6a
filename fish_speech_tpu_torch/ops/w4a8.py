"""W4A8 products: int8 activations x nibble-packed int4 groupwise weights.

Counterpart of `fish_speech_tpu/ops/w4a8.py`. Weight layout (ops/quant.py
`quantize_weight_int4_packed`): q4 (N, K/2) int8, split-half packed (byte j
holds k = j in its low nibble and k = j + K/2 in its high nibble); gs (N, G)
f32 scales per (output channel, group of K/G inputs).

Two kernels compute x8 (M, K) @ unpack(q4).T -> f32 (M, N), before the
activation scale:
  w4a8_matmul     each group's exact int32 dot, rescaled by gs[n, g] and
                  summed in f32 in group order g = 0..G-1;
  w4a8_matmul_pc  the int4 values requantized to int8 per channel inside
                  the kernel, w8 = (q * r16[n, g] + 128) >> 8 with
                  r16 = round(256 * (gs / cs) * 127 / 8), cs = max_g gs, then
                  one int32 dot over K, times s8 = cs * 8 / 127.
`matmul_t_w4a8` quantizes the activations per row outside the kernel and
applies their scale after it; W4A8_KERNEL=pc selects the second kernel, as
in the JAX package.

Each wrapper launches its CUDA kernel (csrc/w4a8.cu) for CUDA tensors, at
any M, with the tiles and K split of `w4a8_plan` (up to 8 rows a weight
stream, one cluster of K parts a column tile), and runs its plain PyTorch
version for CPU tensors.
"""

from __future__ import annotations

import os

import torch

from . import _cuda
from .quant import int8_matmul_t, int8_rows, unpack_int4

KERNEL = _cuda.Kernel("w4a8_matmul")
KERNEL_PC = _cuda.Kernel("w4a8_matmul_pc")

# (BM, BN) of the kernel's tiled products 1 and 2 (csrc/w4a8.cu)
TILES = {1: (64, 64), 2: (128, 128)}


def _group_size(x8: torch.Tensor, q4: torch.Tensor, gs: torch.Tensor) -> int:
    m, k = x8.shape
    n, kh = q4.shape
    g = gs.shape[-1]
    if kh * 2 != k or k % g or tuple(gs.shape) != (n, g):
        raise ValueError(f"W4A8 shapes do not match: x8 {tuple(x8.shape)}, "
                         f"q4 {tuple(q4.shape)}, gs {tuple(gs.shape)}")
    return k // g


def pc_weights(q4: torch.Tensor, gs: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 weights w8 (N, K) that w4a8_matmul_pc reconstructs, and
    their per-channel scales s8 (N,), in the f32 steps of the JAX kernel's
    wrapper."""
    n, g = gs.shape
    cs = gs.amax(dim=-1).clamp_min(1e-12)
    r16 = torch.round(256.0 * (gs / cs[:, None]) * (127.0 / 8.0))
    unp = unpack_int4(q4).to(torch.int32).reshape(n, g, -1)
    w8 = (unp * r16.to(torch.int32)[:, :, None] + 128) >> 8
    return w8.to(torch.int8).reshape(n, -1), cs * (8.0 / 127.0)


def w4a8_matmul_plain(x8: torch.Tensor, q4: torch.Tensor,
                      gs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the grouped product, same group order."""
    gsz = _group_size(x8, q4, gs)
    unp = unpack_int4(q4)
    acc = torch.zeros((x8.shape[0], q4.shape[0]), dtype=torch.float32,
                      device=x8.device)
    for g in range(gs.shape[-1]):
        sl = slice(g * gsz, (g + 1) * gsz)
        dot = int8_matmul_t(x8[:, sl].contiguous(), unp[:, sl].contiguous())
        acc = acc + dot.float() * gs[:, g]
    return acc


def w4a8_matmul_pc_plain(x8: torch.Tensor, q4: torch.Tensor,
                         gs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the per-channel-requantized product."""
    _group_size(x8, q4, gs)
    w8, s8 = pc_weights(q4, gs)
    return int8_matmul_t(x8, w8).float() * s8


# The weight stream (tile 0, M <= 8; csrc/w4a8.cu SB_*): output columns a
# CTA, packed bytes a stage row, ring stages, the largest cluster (the
# portable limit), the largest dynamic shared memory a CTA takes and the
# shared memory of an SM (the card keeps 1 KB of it a CTA)
STREAM_BN, STREAM_SK, STREAM_STAGES, MAX_CLUSTER = 32, 256, 3, 8
STREAM_SMEM_MAX, SM_SMEM = 225 * 1024, 228 * 1024
# CTAs an SM the stream's cluster size aims at
STREAM_CTAS_PER_SM = 4


def stream_smem(m: int, g: int, gsz: int, part: int, n_split: int,
                pc: bool) -> int:
    """Dynamic shared memory of a stream CTA at K parts of `part` packed
    bytes (csrc/w4a8.cu `stream_layout`): the ring, x's rows, the sums of
    the outputs the CTA finishes (grouped: f32 products a (group, output);
    pc: an int32 a (part, output)) and the scales (grouped: gs of its
    part's groups; pc: r16 of them, cs and the tile's gs)."""
    gpp = part // gsz
    stages = min(STREAM_STAGES, -(-part // STREAM_SK))
    per = -(-m * STREAM_BN // n_split)
    ring = stages * STREAM_BN * (STREAM_SK + 64)
    xs = m * (2 * part + 64)
    sums = 4 * per * (n_split if pc else g)
    scales = 4 * STREAM_BN * (2 * gpp + 1 + g if pc else 2 * gpp)
    return ring + xs + sums + scales


def stream_plan(m: int, n: int, k: int, g: int, n_sm: int,
                pc: bool) -> tuple[int, int]:
    """(n_split, part) of the weight stream: a column tile's cluster of
    n_split CTAs, each a K part of `part` packed bytes (whole groups; the
    last part may hold fewer). The smallest cluster that gives every SM
    STREAM_CTAS_PER_SM CTAs (N/32 tiles x n_split), at most 8 and one a
    group; then smaller while the grid would not fit on the card at once
    (a second wave of CTAs waits for the first), and larger while a CTA's
    shared memory would not fit."""
    units, gsz = g // 2, k // g
    tiles = -(-n // STREAM_BN)

    def split(c):
        per = -(-units // c)
        return -(-units // per), per * gsz

    def smem(c):
        n_split, part = split(c)
        return stream_smem(m, g, gsz, part, n_split, pc)

    top = min(MAX_CLUSTER, units)
    c = 1
    while c < top and tiles * split(c)[0] < STREAM_CTAS_PER_SM * n_sm:
        c += 1
    while c > 1 and tiles * split(c)[0] > n_sm * (SM_SMEM // (smem(c) + 1024)):
        c -= 1
    while c < top and smem(c) > STREAM_SMEM_MAX:
        c += 1
    return split(c)


def w4a8_plan(m: int, n: int, k: int, g: int, n_sm: int,
              pc: bool) -> tuple[int, int, int]:
    """(tile, n_split, part) of the kernel at these shapes, from the shapes
    and the SM count only. tile 0 is the weight stream (M <= 8, a cluster
    of n_split CTAs along K, `stream_plan`); 1 and 2 the 64 x 64 and
    128 x 128 int8 tensor-core tiles. The packed K (K/2 bytes) is cut into
    n_split parts of `part` bytes (the last may be shorter), each of whole
    groups. Of the tiles only the per-channel product (pc) splits, its
    int32 sum being exact in any order; the grouped one adds its groups in
    order and takes smaller tiles instead."""
    kh = k // 2
    if m <= 8:
        return (0, *stream_plan(m, n, k, g, n_sm, pc))

    def ctas(tile):
        bm, bn = TILES[tile]
        return -(-m // bm) * -(-n // bn)

    # 64 x 64 (two CTAs an SM) up to 64 rows, and wherever 128 x 128 would
    # take more than one wave or (grouped) leave half the SMs idle
    slots = n_sm
    if m <= TILES[1][0] or ctas(2) > n_sm or (not pc and 2 * ctas(2) <= n_sm):
        tile, slots = 1, 2 * n_sm
    else:
        tile = 2
    if not pc or 3 * ctas(tile) > slots:
        return tile, 1, kh
    # pc on under a third of the slots: split the packed K's G/2 groups
    # over the slots
    units = g // 2
    per = -(-units // min(units, slots // ctas(tile)))
    return tile, -(-units // per), per * (k // g)


def _launch(kernel: _cuda.Kernel, x8, q4, gs) -> torch.Tensor:
    gsz = _group_size(x8, q4, gs)
    m, k = x8.shape
    n, g = gs.shape
    if gsz % 64 or gsz > 512 or gsz & (gsz - 1) or g % 2 or g > 160:
        raise ValueError(f"W4A8 kernels take a power-of-two group size from "
                         f"64 to 512 that divides K/2, and at most 160 "
                         f"groups (got {gsz}, {g})")
    dev = x8.device
    _cuda.check(x8, "x8", torch.int8, (m, k), dev)
    _cuda.check(q4, "q4", torch.int8, (n, k // 2), dev)
    _cuda.check(gs, "gs", torch.float32, (n, g), dev)
    plan = w4a8_plan(m, n, k, g, _cuda.sm_count(dev.index),
                     kernel is KERNEL_PC)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    kernel(x8.data_ptr(), q4.data_ptr(), gs.data_ptr(), out.data_ptr(), m, n,
           k, g, *plan)
    return out


def w4a8_matmul(x8: torch.Tensor, q4: torch.Tensor,
                gs: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x unpack(q4 (N, K/2)).T, groupwise rescaled -> (M, N)
    f32 (before the activation scale)."""
    if not x8.is_cuda:
        return w4a8_matmul_plain(x8, q4, gs)
    return _launch(KERNEL, x8, q4, gs)


def w4a8_matmul_pc(x8: torch.Tensor, q4: torch.Tensor,
                   gs: torch.Tensor) -> torch.Tensor:
    """The per-channel-requantized W4A8 product -> (M, N) f32 (before the
    activation scale; the per-channel weight scale s8 included)."""
    if not x8.is_cuda:
        return w4a8_matmul_pc_plain(x8, q4, gs)
    return _launch(KERNEL_PC, x8, q4, gs)


def matmul_t_w4a8(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x @ W.T for a packed int4 weight {"q4", "gs"}: per-row int8
    activations, the W4A8 product, then the activation scale."""
    lead = x.shape[:-1]
    x8, xs = int8_rows(x.reshape(-1, x.shape[-1]))
    fn = (w4a8_matmul_pc if os.environ.get("W4A8_KERNEL") == "pc"
          else w4a8_matmul)
    y = fn(x8, w["q4"], w["gs"]) * xs
    return y.to(x.dtype).reshape(*lead, -1)
