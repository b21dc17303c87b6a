"""Single-query GQA decode attention over the position-major int8 KV cache.

Counterpart of `fish_speech_tpu/ops/attention.py::pallas_decode_attention_
stream` with pos_major=True and an int8 cache: for each row b, attend the
G query heads of each kv head over the filled key range [starts[b],
lengths[b]) of one layer of the stacked (L, S, B, Hkv, D) cache, read in
place. The int8 scales (flat (L, B, S*Hkv), element [l, b, s*Hkv + h]) are
folded into the scores and the probabilities instead of dequantizing the
cache; with int8_scores the query is quantized per (row, query head) and
the score dot runs int8 x int8 -> int32.

`decode_attention_stream_fold`, the counterpart of the JAX function of the
same name with the `pallas_` prefix, first quantizes the decode step's new
(B, Hkv, D) k and v rows to int8 per (row, kv head), writes them and their
scales IN PLACE at `write_pos` of `layer`, then attends as above, the new
row included.

Each wrapper launches its CUDA kernel (csrc/decode_attention.cu) for CUDA
tensors and runs its plain version for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from . import _cuda
from .quant import div_exact

KERNEL = _cuda.Kernel("decode_attention_stream")
FOLD_KERNEL = _cuda.Kernel("decode_attention_stream_fold")


def _int8_query(q: torch.Tensor):
    qf = q.float()
    qsc = div_exact(qf.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(
        1e-8)
    return torch.round(qf / qsc), qsc


def decode_attention_stream_plain(q, k_full, v_full, ks_full, vs_full,
                                  layer: int, lengths, starts,
                                  int8_scores: bool = True) -> torch.Tensor:
    """Plain PyTorch version. q (B, Hkv, G, D) -> (B, Hkv, G, D) in q.dtype.

    One exact softmax over the key axis where the kernels run an online
    softmax over chunks; the probabilities times the value scales are
    rounded to bf16 before the value product, as in both kernels."""
    b, hkv, g, d = q.shape
    s = k_full.shape[1]
    scale = 1.0 / math.sqrt(d)
    k = k_full[layer].permute(1, 2, 0, 3).float()          # (B, Hkv, S, D)
    v = v_full[layer].permute(1, 2, 0, 3).float()
    ks = ks_full[layer].reshape(b, s, hkv).transpose(1, 2)  # (B, Hkv, S)
    vs = vs_full[layer].reshape(b, s, hkv).transpose(1, 2)
    if int8_scores:
        qi, qsc = _int8_query(q)
        sc = (qi @ k.transpose(-1, -2)) * (qsc * scale)     # exact int sums
    else:
        sc = (q.float() @ k.transpose(-1, -2)) * scale
    sc = sc * ks[:, :, None, :]
    pos = torch.arange(s, device=q.device)
    valid = ((pos[None, :] < lengths[:, None])
             & (pos[None, :] >= starts[:, None]))[:, None, None, :]
    sc = torch.where(valid, sc, torch.tensor(-torch.inf, device=q.device))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    pv = (p * vs[:, :, None, :]).to(torch.bfloat16).float()
    return ((pv @ v) / den.clamp_min(1e-20)).to(q.dtype)


def _check_stream_args(q, k_full, v_full, ks_full, vs_full, layer: int,
                       lengths, starts) -> None:
    b, hkv, g, d = q.shape
    n_layer, s = k_full.shape[:2]
    if d != 128 or g > 8:
        raise ValueError(f"decode attention kernel takes head_dim 128 and "
                         f"at most 8 query heads per kv head (got {d}, {g})")
    if not 0 <= layer < n_layer:
        raise ValueError(f"layer {layer} out of range")
    dev = q.device
    _cuda.check(q, "q", torch.bfloat16, device=dev)
    _cuda.check(k_full, "k", torch.int8, (n_layer, s, b, hkv, d), dev)
    _cuda.check(v_full, "v", torch.int8, (n_layer, s, b, hkv, d), dev)
    _cuda.check(ks_full, "ks", torch.float32, (n_layer, b, s * hkv), dev)
    _cuda.check(vs_full, "vs", torch.float32, (n_layer, b, s * hkv), dev)
    _cuda.check(lengths, "lengths", torch.int32, (b,), dev)
    _cuda.check(starts, "starts", torch.int32, (b,), dev)


def decode_attention_stream(q, k_full, v_full, ks_full, vs_full, layer: int,
                            lengths, starts,
                            int8_scores: bool = True) -> torch.Tensor:
    """q (B, Hkv, G, D) bf16; k/v (L, S, B, Hkv, D) int8; ks/vs (L, B, S*Hkv)
    f32; lengths/starts (B,) int32 -> (B, Hkv, G, D) bf16."""
    if not q.is_cuda:
        return decode_attention_stream_plain(q, k_full, v_full, ks_full,
                                             vs_full, layer, lengths, starts,
                                             int8_scores)
    _check_stream_args(q, k_full, v_full, ks_full, vs_full, layer, lengths,
                       starts)
    b, hkv, g, d = q.shape
    n_layer, s = k_full.shape[:2]
    out = torch.empty_like(q)
    KERNEL(q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
           ks_full.data_ptr(), vs_full.data_ptr(), lengths.data_ptr(),
           starts.data_ptr(), out.data_ptr(), n_layer, s, b, hkv, g, d,
           layer, 1.0 / math.sqrt(d), int(int8_scores))
    return out


def quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> int8 rows and f32 scales (...): max|x| / 127 clamped at
    1e-8, rounded half to even (the KV cache's quantization)."""
    xf = x.float()
    sc = div_exact(xf.abs().amax(dim=-1), 127.0).clamp_min(1e-8)
    return torch.round(xf / sc[..., None]).to(torch.int8), sc


def decode_attention_stream_fold_plain(q, k_full, v_full, ks_full, vs_full,
                                       layer: int, lengths, starts, new_k,
                                       new_v, write_pos: int,
                                       int8_scores: bool = True
                                       ) -> torch.Tensor:
    """Plain PyTorch version: quantize and write the new rows, then
    `decode_attention_stream_plain`."""
    hkv = new_k.shape[1]
    sl = slice(write_pos * hkv, (write_pos + 1) * hkv)
    k_full[layer, write_pos], ks_full[layer, :, sl] = quantize_kv_rows(new_k)
    v_full[layer, write_pos], vs_full[layer, :, sl] = quantize_kv_rows(new_v)
    return decode_attention_stream_plain(q, k_full, v_full, ks_full, vs_full,
                                         layer, lengths, starts, int8_scores)


def decode_attention_stream_fold(q, k_full, v_full, ks_full, vs_full,
                                 layer: int, lengths, starts, new_k, new_v,
                                 write_pos: int,
                                 int8_scores: bool = True) -> torch.Tensor:
    """`decode_attention_stream` after writing the new (B, Hkv, D) bf16 k/v
    rows, int8-quantized, at `write_pos` of `layer` (caches updated in
    place) -> (B, Hkv, G, D) bf16."""
    if not q.is_cuda:
        return decode_attention_stream_fold_plain(
            q, k_full, v_full, ks_full, vs_full, layer, lengths, starts,
            new_k, new_v, write_pos, int8_scores)
    _check_stream_args(q, k_full, v_full, ks_full, vs_full, layer, lengths,
                       starts)
    b, hkv, g, d = q.shape
    n_layer, s = k_full.shape[:2]
    if not 0 <= write_pos < s:
        raise ValueError(f"write_pos {write_pos} out of range")
    _cuda.check(new_k, "new_k", torch.bfloat16, (b, hkv, d), q.device)
    _cuda.check(new_v, "new_v", torch.bfloat16, (b, hkv, d), q.device)
    out = torch.empty_like(q)
    FOLD_KERNEL(q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
                ks_full.data_ptr(), vs_full.data_ptr(), lengths.data_ptr(),
                starts.data_ptr(), out.data_ptr(), new_k.data_ptr(),
                new_v.data_ptr(), n_layer, s, b, hkv, g, d, layer, write_pos,
                1.0 / math.sqrt(d), int(int8_scores))
    return out
