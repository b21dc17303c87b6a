"""Single-query GQA decode attention over the int8 or bf16 KV cache.

Counterparts of the decode-attention entries of
`fish_speech_tpu/ops/attention.py`, each named after its JAX entry without
the `pallas_` prefix. All take q (B, Hkv, G, D) and return (B, Hkv, G, D)
in q.dtype: for each row b, the G query heads of each kv head attend over
the filled key range [starts[b], lengths[b]).

Position-major cache (L, S, B, Hkv, D), int8 with flat (L, B, S*Hkv)
scales (element [l, b, s*Hkv + h]) or bf16 with none,
csrc/decode_attention.cu:
- `decode_attention_stream(..., pos_major=True)`: one layer read in place;
  on an int8 cache the scales are folded into the scores and the
  probabilities instead of dequantizing the cache, and with int8_scores the
  query is quantized per (row, query head) and the score dot runs int8 x
  int8 -> int32; a bf16 cache goes to its own C entry
  (`decode_attention_stream_bf16`), bf16 products with f32 sums;
- `decode_attention_stream_fold`: first quantizes the decode step's new
  (B, Hkv, D) k and v rows to int8 per (row, kv head), writes them and their
  scales IN PLACE at `write_pos` of `layer`, then attends as above.

Head-major cache (L, B, Hkv, S, D), int8 with (L, B, Hkv, S) scales or bf16
with none, csrc/decode_attention_head.cu (one C entry each):
- `decode_attention_stream(..., pos_major=False)` and
  `decode_attention_blocks`: the block-of-rows numerics (int8 scores
  optional, scales folded, p * v_scale rounded to bf16);
- `decode_attention_stacked_rows`: dequantizes k and v to bf16 first;
- `decode_attention_stacked`: f32 throughout, scales folded unrounded;
- `decode_attention` and `decode_attention_chunked`: one layer's
  (B, Hkv, S, D) cache of any float type, f32 throughout.
`rows` and `chunk` group the TPU kernels' work; the CUDA kernels take their
own tiles, and the plain versions one exact softmax. Both CUDA kernels
reduce each row's keys in chunks of CHUNK = 128 positions, JAX's
`pallas_attn_chunk` (`head_split`), each chunk one softmax at its own
maximum, and fold the chunks in order, so a row's result does not depend
on the batch or the card. `cta_plan` maps the chunks onto CTAs: where the
rows alone fill the card, one CTA a row walks them all; at small batches
one CTA a chunk (and a group of query heads) writes its partial softmax
results to f32 scratch the wrapper allocates, and a second pass folds
them; one call is then two device launches (and one count of
`launches`).

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from . import _cuda
from .quant import div_exact

KERNEL = _cuda.Kernel("decode_attention_stream")
BF16_KERNEL = _cuda.Kernel("decode_attention_stream_bf16")
FOLD_KERNEL = _cuda.Kernel("decode_attention_stream_fold")
STREAM_HEAD_KERNEL = _cuda.Kernel("decode_attention_stream_head")
BLOCKS_KERNEL = _cuda.Kernel("decode_attention_blocks")
ROWS_KERNEL = _cuda.Kernel("decode_attention_stacked_rows")
DENSE_KERNEL = _cuda.Kernel("decode_attention")
STACKED_KERNEL = _cuda.Kernel("decode_attention_stacked")
CHUNKED_KERNEL = _cuda.Kernel("decode_attention_chunked")


def _int8_query(q: torch.Tensor):
    qf = q.float()
    qsc = div_exact(qf.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(
        1e-8)
    return torch.round(qf / qsc), qsc


def decode_attention_stream_plain(q, k_full, v_full, ks_full, vs_full,
                                  layer: int, lengths, starts,
                                  int8_scores: bool = True, *,
                                  pos_major: bool = False) -> torch.Tensor:
    """Plain PyTorch version. q (B, Hkv, G, D) -> (B, Hkv, G, D) in q.dtype.

    One exact softmax over the key axis where the kernels run an online
    softmax over chunks; the probabilities times the value scales are
    rounded to bf16 before the value product, as in both kernels. The
    head-major form and both position-major caches are
    `decode_attention_blocks_plain`'s arithmetic, the position-major layer
    read through head-major views (`_pos_layer`)."""
    layer_of = _pos_layer if pos_major else _layer_of
    return _head_plain(q, *layer_of(k_full, v_full, ks_full, vs_full, layer),
                       lengths, starts, "blocks", int8_scores)


def _pos_layer(k_full, v_full, ks_full, vs_full, layer: int):
    """One layer of a position-major cache (L, S, B, Hkv, D) with flat
    (L, B, S*Hkv) scales, as head-major views: (B, Hkv, S, D) values and
    (B, Hkv, S) scales (None for a bf16 cache)."""
    k = k_full[layer].permute(1, 2, 0, 3)
    v = v_full[layer].permute(1, 2, 0, 3)
    if ks_full is None:
        return k, v, None, None
    s, b, hkv = k_full.shape[1:4]
    return (k, v, ks_full[layer].reshape(b, s, hkv).transpose(1, 2),
            vs_full[layer].reshape(b, s, hkv).transpose(1, 2))


def _check_query(d: int, g: int) -> None:
    if d != 128 or g not in (1, 2, 4, 8):
        raise ValueError(f"decode attention kernel takes head_dim 128 and "
                         f"1, 2, 4 or 8 query heads per kv head (got {d}, "
                         f"{g})")


def _check_stream_args(q, k_full, v_full, ks_full, vs_full, layer: int,
                       lengths, starts) -> None:
    b, hkv, g, d = q.shape
    n_layer, s = k_full.shape[:2]
    _check_query(d, g)
    if not 0 <= layer < n_layer:
        raise ValueError(f"layer {layer} out of range")
    dev = q.device
    kind = torch.int8 if ks_full is not None else torch.bfloat16
    _cuda.check(q, "q", torch.bfloat16, device=dev)
    _cuda.check(k_full, "k", kind, (n_layer, s, b, hkv, d), dev)
    _cuda.check(v_full, "v", kind, (n_layer, s, b, hkv, d), dev)
    if ks_full is not None:
        _cuda.check(ks_full, "ks", torch.float32, (n_layer, b, s * hkv), dev)
        _cuda.check(vs_full, "vs", torch.float32, (n_layer, b, s * hkv), dev)
    elif vs_full is not None:
        raise ValueError("a bf16 cache takes no scales")
    _cuda.check(lengths, "lengths", torch.int32, (b,), dev)
    _cuda.check(starts, "starts", torch.int32, (b,), dev)


def decode_attention_stream(q, k_full, v_full, ks_full, vs_full, layer: int,
                            lengths, starts, int8_scores: bool = True, *,
                            pos_major: bool = False) -> torch.Tensor:
    """q (B, Hkv, G, D) bf16; lengths/starts (B,) int32 -> (B, Hkv, G, D)
    bf16. pos_major: k/v (L, S, B, Hkv, D) int8 with ks/vs (L, B, S*Hkv)
    f32, or bf16 with ks/vs None (int8_scores does not apply). Head-major:
    k/v (L, B, Hkv, S, D) int8 with ks/vs (L, B, Hkv, S) f32, or bf16 with
    ks/vs None."""
    if not q.is_cuda:
        return decode_attention_stream_plain(q, k_full, v_full, ks_full,
                                             vs_full, layer, lengths, starts,
                                             int8_scores, pos_major=pos_major)
    if not pos_major:
        return _launch_head(STREAM_HEAD_KERNEL, q, k_full, v_full, ks_full,
                            vs_full, layer, lengths, starts, int8_scores)
    _check_stream_args(q, k_full, v_full, ks_full, vs_full, layer, lengths,
                       starts)
    b, hkv, g, d = q.shape
    n_layer, s = k_full.shape[:2]
    out = torch.empty_like(q)
    plan, part = _split(q, s)
    if ks_full is None:
        BF16_KERNEL(q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
                    lengths.data_ptr(), starts.data_ptr(), out.data_ptr(),
                    _cuda.ptr(part), n_layer, s, b, hkv, g, d, layer, *plan,
                    1.0 / math.sqrt(d))
        return out
    KERNEL(q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
           ks_full.data_ptr(), vs_full.data_ptr(), lengths.data_ptr(),
           starts.data_ptr(), out.data_ptr(), _cuda.ptr(part), n_layer, s, b,
           hkv, g, d, layer, *plan, 1.0 / math.sqrt(d), int(int8_scores))
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
                                         layer, lengths, starts, int8_scores,
                                         pos_major=True)


def decode_attention_stream_fold(q, k_full, v_full, ks_full, vs_full,
                                 layer: int, lengths, starts, new_k, new_v,
                                 write_pos: int,
                                 int8_scores: bool = True) -> torch.Tensor:
    """`decode_attention_stream` after writing the new (B, Hkv, D) bf16 k/v
    rows, int8-quantized, at `write_pos` of `layer` (caches updated in
    place) -> (B, Hkv, G, D) bf16."""
    if ks_full is None:
        raise ValueError("the fold writes the int8 cache: give its scales")
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
    plan, part = _split(q, s)
    FOLD_KERNEL(q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
                ks_full.data_ptr(), vs_full.data_ptr(), lengths.data_ptr(),
                starts.data_ptr(), out.data_ptr(), _cuda.ptr(part),
                new_k.data_ptr(), new_v.data_ptr(), n_layer, s, b, hkv, g, d,
                layer, write_pos, *plan, 1.0 / math.sqrt(d),
                int(int8_scores))
    return out


# --- the head-major entries ------------------------------------------------


def _layer_of(k_full, v_full, ks_full, vs_full, layer: int):
    """One layer of a stacked head-major cache: (B, Hkv, S, D) values and
    (B, Hkv, S) scales (None for a bf16 cache)."""
    if ks_full is None:
        return k_full[layer], v_full[layer], None, None
    return k_full[layer], v_full[layer], ks_full[layer], vs_full[layer]


def _head_scores(q, k, v, ks, vs, variant: str, int8_scores: bool = False):
    """The head-major entries' scores (B, Hkv, G, S) and the values the
    weights multiply (B, Hkv, S, D), both f32 and unmasked; arguments as
    `_head_plain`'s."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    i8 = ks is not None
    bf = torch.bfloat16
    kt = k.float().transpose(-1, -2)
    vf = v.float()
    if variant == "f32":
        sc = (q.float() @ kt) * scale
        if i8:
            sc = sc * ks[:, :, None, :]
    elif variant == "rows" and i8:
        kt = (k.float() * ks[..., None]).to(bf).float().transpose(-1, -2)
        vf = (vf * vs[..., None]).to(bf).float()
        sc = (q.to(bf).float() @ kt) * scale
    else:
        if i8 and int8_scores:
            qi, qsc = _int8_query(q)
            sc = (qi @ kt) * (qsc * scale)                  # exact int sums
        else:
            sc = (q.to(bf).float() @ kt) * scale
        if i8:
            sc = sc * ks[:, :, None, :]
    return sc, vf


def _head_weights(p, vs, variant: str) -> torch.Tensor:
    """The value weights of probabilities p (B, Hkv, G, S'), rounded as the
    variant's TPU kernel rounds them; vs: the keys' (B, Hkv, S') value
    scales of an int8 cache, else None."""
    if variant == "f32":
        return p * vs[:, :, None, :] if vs is not None else p
    if variant == "blocks" and vs is not None:
        return (p * vs[:, :, None, :]).to(torch.bfloat16).float()
    return p.to(torch.bfloat16).float()


def _head_valid(lengths, starts, s: int, device) -> torch.Tensor:
    """(B, 1, 1, S): the keys in [starts[b], lengths[b])."""
    pos = torch.arange(s, device=device)
    return ((pos[None, :] < lengths[:, None])
            & (pos[None, :] >= starts[:, None]))[:, None, None, :]


def _head_plain(q, k, v, ks, vs, lengths, starts, variant: str,
                int8_scores: bool = False) -> torch.Tensor:
    """The head-major entries' arithmetic, with one exact softmax.

    k/v (B, Hkv, S, D); ks/vs (B, Hkv, S) f32 for an int8 cache, else None.
    variant "blocks" (stream, blocks), "rows" (stacked_rows) or "f32"
    (dense, stacked, chunked) places the roundings as the TPU kernel of
    that name does (csrc/decode_attention_head.cu lists them). Masked keys
    score -1e30, as in the TPU kernels."""
    sc, vf = _head_scores(q, k, v, ks, vs, variant, int8_scores)
    valid = _head_valid(lengths, starts, k.shape[2], q.device)
    sc = torch.where(valid, sc, torch.full((), -1e30, device=q.device))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True)
    pv = _head_weights(p, vs, variant)
    return ((pv @ vf) / den.clamp_min(1e-20)).to(q.dtype)


# keys a chunk: JAX's `pallas_attn_chunk`. Both CUDA kernels take a chunk
# as one tile and one softmax
CHUNK = 128
# cta_plan: whole rows where the rows alone give this many CTAs an SM, else
# head groups until the chunks' CTAs give this many an SM (per kernel: one
# CTA of the head-major kernel's value product takes fewer rows of work)
WHOLE_ROWS_PER_SM = 2
SPLIT_CTAS_PER_SM = {"pos": 0.5, "head": 1.0}


def head_split(s: int) -> tuple[int, int]:
    """(n_split, chunk) of a row's keys in a cache of S positions: chunk c
    takes keys [c * CHUNK, (c + 1) * CHUNK). The kernels take each chunk
    as one softmax at its own maximum and fold the chunks in order
    (csrc/decode_split.cuh), so the rule reads S alone: a row's f32 sums
    are the same at every batch size and on every card, as the TPU
    kernel's fixed `pallas_attn_chunk` walk is."""
    return max(1, -(-s // CHUNK)), CHUNK


def cta_plan(n_split: int, b: int, hkv: int, g: int, n_sm: int,
             kernel: str = "pos") -> tuple[bool, int]:
    """(whole, hs): how the chunks of B * Hkv rows with G query heads a kv
    head map onto CTAs of `kernel` ("pos" or "head") on a card of n_sm
    SMs; it changes no sum. whole: one CTA a (kv head, row) walks its
    chunks (one chunk, or rows that give WHOLE_ROWS_PER_SM CTAs an SM);
    else one CTA a chunk and a group of G / hs query heads, hs doubled
    until the CTAs reach SPLIT_CTAS_PER_SM[kernel] an SM or hs = G. Shapes
    only, never the lengths: no host sync, and a fixed launch for a
    captured step."""
    rows = b * hkv
    if n_split == 1 or rows >= WHOLE_ROWS_PER_SM * n_sm:
        return True, 1
    hs = 1
    while hs < g and n_split * rows * hs < SPLIT_CTAS_PER_SM[kernel] * n_sm:
        hs *= 2
    return False, hs


def _split(q, s: int, kernel: str = "pos"):
    """((n_split, whole, hs), part) for q (B, Hkv, G, D) over a cache of S
    positions on q's card (`head_split`, `cta_plan` for `kernel`), and the
    f32 scratch of the chunks' partials (None for whole rows): per chunk
    the unnormalised accumulators (G, D), then the max and the sum, at
    most B * Hkv * ceil(S / 128) * G * (D + 2) floats."""
    b, hkv, g, d = q.shape
    n_split, _ = head_split(s)
    whole, hs = cta_plan(n_split, b, hkv, g,
                         _cuda.sm_count(q.device.index), kernel)
    part = None if whole else torch.empty(
        b * hkv * n_split * g * (d + 2), dtype=torch.float32, device=q.device)
    return (n_split, int(whole), hs), part


_CACHE_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def _launch_head(kernel: _cuda.Kernel, q, k_full, v_full, ks_full, vs_full,
                 layer: int, lengths, starts,
                 int8_scores: bool = False) -> torch.Tensor:
    """Check the arguments and launch one of the head-major entries. k/v
    (L, B, Hkv, S, D), or one layer's (B, Hkv, S, D) for the per-layer
    entries (then `layer` is 0)."""
    b, hkv, g, d = q.shape
    _check_query(d, g)
    per_layer = k_full.dim() == 4
    n_layer = 1 if per_layer else k_full.shape[0]
    s = k_full.shape[-2]
    if not 0 <= layer < n_layer:
        raise ValueError(f"layer {layer} out of range")
    kind = _CACHE_KIND.get(k_full.dtype)
    if kind is None or (kind == 2 and not per_layer) or (
            kind == 0 and ks_full is None):
        raise ValueError(f"{kernel.name} does not take a {k_full.dtype} "
                         f"cache{' without scales' if kind == 0 else ''}")
    dev = q.device
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bf16 or f32, got {q.dtype}")
    _cuda.check(q, "q", q.dtype, device=dev)
    shape = tuple(k_full.shape[:-4]) + (b, hkv, s, d)
    _cuda.check(k_full, "k", k_full.dtype, shape, dev)
    _cuda.check(v_full, "v", k_full.dtype, shape, dev)
    if kind == 0:
        _cuda.check(ks_full, "ks", torch.float32, shape[:-1], dev)
        _cuda.check(vs_full, "vs", torch.float32, shape[:-1], dev)
    elif ks_full is not None or vs_full is not None:
        raise ValueError("a bf16 or f32 cache takes no scales")
    _cuda.check(lengths, "lengths", torch.int32, (b,), dev)
    _cuda.check(starts, "starts", torch.int32, (b,), dev)
    plan, part = _split(q, s, "head")
    out = torch.empty_like(q)
    kernel(q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
           _cuda.ptr(ks_full), _cuda.ptr(vs_full), lengths.data_ptr(),
           starts.data_ptr(), out.data_ptr(), _cuda.ptr(part), n_layer, s, b,
           hkv, g, d, layer, *plan, 1.0 / math.sqrt(d), int(int8_scores),
           kind, int(q.dtype == torch.float32))
    return out


def decode_attention_blocks_plain(q, k_full, v_full, ks_full, vs_full,
                                  layer: int, lengths, starts, rows: int = 16,
                                  chunk: int = 128,
                                  int8_scores: bool = True) -> torch.Tensor:
    return _head_plain(q, *_layer_of(k_full, v_full, ks_full, vs_full, layer),
                       lengths, starts, "blocks", int8_scores)


def decode_attention_blocks(q, k_full, v_full, ks_full, vs_full, layer: int,
                            lengths, starts, rows: int = 16, chunk: int = 128,
                            int8_scores: bool = True) -> torch.Tensor:
    """One layer of the stacked head-major cache (L, B, Hkv, S, D), int8
    with (L, B, Hkv, S) scales or bf16 with None; int8_scores quantizes q
    per (row, query head) for an int8 cache. rows/chunk: the TPU kernel's
    grouping, taken for its signature."""
    if not q.is_cuda:
        return decode_attention_blocks_plain(q, k_full, v_full, ks_full,
                                             vs_full, layer, lengths, starts,
                                             rows, chunk, int8_scores)
    return _launch_head(BLOCKS_KERNEL, q, k_full, v_full, ks_full, vs_full,
                        layer, lengths, starts, int8_scores)


def decode_attention_stacked_rows_plain(q, k_full, v_full, ks_full, vs_full,
                                        layer: int, lengths, starts,
                                        chunk: int = 128) -> torch.Tensor:
    return _head_plain(q, *_layer_of(k_full, v_full, ks_full, vs_full, layer),
                       lengths, starts, "rows")


def decode_attention_stacked_rows(q, k_full, v_full, ks_full, vs_full,
                                  layer: int, lengths, starts,
                                  chunk: int = 128) -> torch.Tensor:
    """As `decode_attention_blocks`, with an int8 cache dequantized to bf16
    (k8 * ks rounded) before the bf16 score and value products."""
    if not q.is_cuda:
        return decode_attention_stacked_rows_plain(
            q, k_full, v_full, ks_full, vs_full, layer, lengths, starts, chunk)
    return _launch_head(ROWS_KERNEL, q, k_full, v_full, ks_full, vs_full,
                        layer, lengths, starts)


def decode_attention_stacked_plain(q, k_full, v_full, ks_full, vs_full,
                                   layer: int, lengths, starts,
                                   chunk: int = 128) -> torch.Tensor:
    return _head_plain(q, *_layer_of(k_full, v_full, ks_full, vs_full, layer),
                       lengths, starts, "f32")


def decode_attention_stacked(q, k_full, v_full, ks_full, vs_full, layer: int,
                             lengths, starts,
                             chunk: int = 128) -> torch.Tensor:
    """As `decode_attention_blocks`, in f32 throughout (int8 scales folded
    into scores and probabilities unrounded)."""
    if not q.is_cuda:
        return decode_attention_stacked_plain(q, k_full, v_full, ks_full,
                                              vs_full, layer, lengths, starts,
                                              chunk)
    return _launch_head(STACKED_KERNEL, q, k_full, v_full, ks_full, vs_full,
                        layer, lengths, starts)


def decode_attention_plain(q, k_cache, v_cache, lengths,
                           starts) -> torch.Tensor:
    return _head_plain(q, k_cache, v_cache, None, None, lengths, starts,
                       "f32")


def decode_attention(q, k_cache, v_cache, lengths, starts) -> torch.Tensor:
    """One layer's (B, Hkv, S, D) cache, bf16 or f32 (an int8 layer is
    dequantized by the caller); f32 arithmetic, output in q.dtype."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, lengths, starts)
    return _launch_head(DENSE_KERNEL, q, k_cache, v_cache, None, None, 0,
                        lengths, starts)


def decode_attention_chunked_plain(q, k_cache, v_cache, lengths, starts,
                                   chunk: int = 128) -> torch.Tensor:
    return _head_plain(q, k_cache, v_cache, None, None, lengths, starts,
                       "f32")


def decode_attention_chunked(q, k_cache, v_cache, lengths, starts,
                             chunk: int = 128) -> torch.Tensor:
    """`decode_attention` walking only the filled range (as every entry
    here does); the TPU kernel's online softmax over `chunk`-row chunks."""
    if not q.is_cuda:
        return decode_attention_chunked_plain(q, k_cache, v_cache, lengths,
                                              starts, chunk)
    return _launch_head(CHUNKED_KERNEL, q, k_cache, v_cache, None, None, 0,
                        lengths, starts)
