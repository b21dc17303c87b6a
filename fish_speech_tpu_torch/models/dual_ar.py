"""Dual-AR transformer (slow token decoder + fast residual-codebook head).

Counterpart of `fish_speech_tpu/models/dual_ar.py`: the teacher-forced
training forward (`forward_train`, plain PyTorch with gradients, the layers
optionally recomputed in the backward pass) and the branches the serving
paths take (int8 W8A8 or packed-int4 W4A8 weights, fused fast-head
sweeps; the position-major int8 KV cache read by the stream attention
kernel, optionally written by it too (`kv_fold_write`), or the head-major
int8 or native cache read by the stream, blocks, rows or per-layer kernel)
and the unquantized head-major branch the parity goldens need.

Tensor parallelism (`cfg.tp_shards > 1`, run under
`parallel.tp.decode_mesh`): every rank holds its own slices of the
weights (`parallel.mesh.shard_dual_ar_params`) and of the KV cache (its
Hkv / tp heads and its batch rows), and the collectives that GSPMD
inserts in the JAX package are written out here: wqkv's columns are
gathered (its row split is not head-aligned) and each rank keeps its
heads; wo and w2 are row-parallel products (`ops.quant.
matmul_t_row_parallel`); the row-sharded heads (`output`, `fast_output`,
`fast_project_in`, `codebook_output`) gather their columns; the fused
fast sweep splits the batch over the model group
(`parallel.tp.fused_fast_sweep_tp`). `forward_train` takes the same
branches with gradients: each collective is one of the differentiable
operators of parallel/collectives.py, chosen by what consumes its
result, and every column-parallel product's input passes Megatron's
copy operator (`copy_to_group`), which sums the input's partial
gradients over the model group.

A decode step writes every row at one shared slot, or (continuous
batching) each row at its own slot given as a (B,) tensor on the device.

Parameters are the nested dicts of models/init.py, layers stacked along a
leading depth axis. Unlike the JAX package, which threads immutable caches
through a scan, the caches here are written IN PLACE (one slab per layer
and step), so a step never copies the multi-GB KV cache.

Shapes: activations (B, T, D); token matrices (B, K+1, T) with row 0 the
text token and rows 1..K the codebook codes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (
    decode_attention,
    decode_attention_blocks,
    decode_attention_stacked_rows,
    decode_attention_stream,
    decode_attention_stream_fold,
    quantize_kv_rows,
)
from ..ops.quant import (
    as_weight,
    is_quantized,
    matmul_t,
    matmul_t_row_parallel,
    slice_rows,
    take_rows,
)
from ..parallel.collectives import (copy_to_group, gather_for_partial,
                                    gather_for_replicated)
from ..parallel.tp import (
    blocks_attention_tp,
    fused_fast_sweep_tp,
    stream_attention_tp,
    tp_mesh,
)
from .config import AttnDims, DualARConfig


def param_dtype(params: dict) -> torch.dtype:
    emb = params["embeddings"]
    return torch.bfloat16 if is_quantized(emb) else emb.dtype


# ---------------------------------------------------------------------------
# Shared primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 statistics; the result is cast back to x.dtype BEFORE the weight
    multiply, as in the JAX function. The mean of squares is summed in
    float64 and rounded to f32 once: torch orders an f32 sum by the
    tensor's shape, which made a row's last bit, and then a bf16 rounding,
    depend on the batch (a request alone and inside a batch parted)."""
    xf = x.float()
    ms = xf.double().square().mean(dim=-1, keepdim=True).float()
    normed = xf * torch.rsqrt(ms + eps)
    return normed.to(x.dtype) * weight.to(x.dtype)


def precompute_freqs_cis(seq_len: int, n_elem: int, base: float,
                         device=None) -> torch.Tensor:
    """(T, n_elem//2, 2) bf16 table of (cos, sin), computed in f32 numpy."""
    freqs = 1.0 / (base ** (np.arange(0, n_elem, 2)[: n_elem // 2]
                            .astype(np.float32) / n_elem))
    t = np.arange(seq_len, dtype=np.float32)
    angles = np.outer(t, freqs)
    cache = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    return torch.from_numpy(cache).to(device=device, dtype=torch.bfloat16)


def apply_rotary_emb(x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, D); freqs_cis: (T, D//2, 2) or per-row (B, T, D//2, 2).
    f32 math on interleaved (real, imag) pairs."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    if freqs_cis.ndim == 4:
        fc = freqs_cis.float()[:, :, None]
    else:
        fc = freqs_cis.float()[None, :, None]
    real = xf[..., 0] * fc[..., 0] - xf[..., 1] * fc[..., 1]
    imag = xf[..., 1] * fc[..., 0] + xf[..., 0] * fc[..., 1]
    return torch.stack([real, imag], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


@dataclass
class KVCache:
    """Stacked per-layer KV cache, written in place.

    head-major: k, v (L, B, Hkv, S, D); int8 scales (L, B, Hkv, S) f32.
    position-major: k, v (L, S, B, Hkv, D); int8 scales FLAT (L, B, S*Hkv)
    f32 with element [l, b, s*Hkv + h] (the stream kernel's layout)."""
    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor | None = None
    vs: torch.Tensor | None = None
    pos_major: bool = False

    @staticmethod
    def create(n_layer: int, batch: int, seq: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, pos_major: bool = False,
               device=None) -> "KVCache":
        if pos_major:
            shape = (n_layer, seq, batch, n_kv, head_dim)
            sshape = (n_layer, batch, seq * n_kv)
        else:
            shape = (n_layer, batch, n_kv, seq, head_dim)
            sshape = (n_layer, batch, n_kv, seq)
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
        ks = vs = None
        if dtype == torch.int8:
            ks = torch.zeros(sshape, dtype=torch.float32, device=device)
            vs = torch.zeros(sshape, dtype=torch.float32, device=device)
        return KVCache(k, v, ks, vs, pos_major)

    @property
    def seq_len(self) -> int:
        return self.k.shape[1] if self.pos_major else self.k.shape[3]

    def layer_view(self, i: int) -> "KVCache":
        """Layer i as a depth-1 cache of views: writes through it land in
        this cache (the per-layer stack modes' cache, kept in place)."""
        def one(a):
            return None if a is None else a[i:i + 1]
        return KVCache(one(self.k), one(self.v), one(self.ks), one(self.vs),
                       self.pos_major)


def _write_cache(cache: KVCache, layer: int, pos: int | torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor) -> None:
    """Write new (B, T, Hkv, D) k/v rows of `layer`: at slots [pos, pos+T)
    for a host int `pos`, or each row b at its own slots [pos[b],
    pos[b]+T) for a (B,) tensor (`_scatter_cache`)."""
    b, t, hkv, _ = k.shape
    k_sc = v_sc = None
    if cache.ks is not None:
        k, k_sc = quantize_kv_rows(k)   # scales (B, T, Hkv)
        v, v_sc = quantize_kv_rows(v)
    k = k.to(cache.k.dtype)
    v = v.to(cache.v.dtype)
    if isinstance(pos, torch.Tensor):
        _scatter_cache(cache, layer, pos, k, v, k_sc, v_sc)
        return
    if cache.pos_major:
        cache.k[layer, pos:pos + t] = k.transpose(0, 1)
        cache.v[layer, pos:pos + t] = v.transpose(0, 1)
        if cache.ks is not None:
            cache.ks[layer, :, pos * hkv:(pos + t) * hkv] = k_sc.reshape(b, -1)
            cache.vs[layer, :, pos * hkv:(pos + t) * hkv] = v_sc.reshape(b, -1)
    else:
        cache.k[layer, :, :, pos:pos + t] = k.transpose(1, 2)
        cache.v[layer, :, :, pos:pos + t] = v.transpose(1, 2)
        if cache.ks is not None:
            cache.ks[layer, :, :, pos:pos + t] = k_sc.transpose(1, 2)
            cache.vs[layer, :, :, pos:pos + t] = v_sc.transpose(1, 2)


def _scatter_cache(cache: KVCache, layer: int, pos: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor,
                   k_sc: torch.Tensor | None = None,
                   v_sc: torch.Tensor | None = None) -> None:
    """Per-row write positions (continuous batching: rows decode at
    different offsets): row b's T new rows go to slots pos[b] + [0, T),
    one indexed write per tensor. k/v (B, T, Hkv, D) in the cache's type;
    scales (B, T, Hkv). Position-major flat scales take element [b,
    slot*Hkv + h]."""
    b, t, hkv, _ = k.shape
    rows = torch.arange(b, device=k.device)[:, None]              # (B, 1)
    cols = pos.long()[:, None] + torch.arange(t, device=k.device)  # (B, T)
    if cache.pos_major:
        # a (B, T) pair of indices on the (S, B) axes: values (B, T, Hkv, D)
        cache.k[layer].index_put_((cols, rows), k)
        cache.v[layer].index_put_((cols, rows), v)
        if k_sc is not None:
            flat = (cols[:, :, None] * hkv
                    + torch.arange(hkv, device=k.device)).reshape(b, -1)
            cache.ks[layer].index_put_((rows, flat), k_sc.reshape(b, -1))
            cache.vs[layer].index_put_((rows, flat), v_sc.reshape(b, -1))
        return
    # head-major (B, Hkv, S, D): the indices on B and S, split by the head
    # slice, put (B, T) first, so the values keep k/v's own (B, T, Hkv, D)
    cache.k[layer][rows, :, cols] = k
    cache.v[layer][rows, :, cols] = v
    if k_sc is not None:
        cache.ks[layer][rows, :, cols] = k_sc
        cache.vs[layer][rows, :, cols] = v_sc


def _read_cache(cache: KVCache, layer: int):
    """One layer's cache as head-major (B, Hkv, S, D) values and (B, Hkv, S)
    scales (None for a native cache). Position-major layouts pay one
    transposing copy here: only prefill reads them this way."""
    if not cache.pos_major:
        ks = cache.ks[layer] if cache.ks is not None else None
        vs = cache.vs[layer] if cache.vs is not None else None
        return cache.k[layer], cache.v[layer], ks, vs
    k = cache.k[layer].permute(1, 2, 0, 3)
    v = cache.v[layer].permute(1, 2, 0, 3)
    if cache.ks is None:
        return k, v, None, None
    b = k.shape[0]
    s = cache.seq_len

    def unflat(a):
        return a[layer].reshape(b, s, -1).transpose(1, 2)

    return k, v, unflat(cache.ks), unflat(cache.vs)


def _gather_columns(y: torch.Tensor, mesh) -> torch.Tensor:
    """A row-sharded head's output columns, gathered over the model group
    (exact: bits move) for a consumer that every rank computes whole."""
    return y if mesh is None else gather_for_replicated(y, mesh.model_group)


def _column_input(x: torch.Tensor, mesh) -> torch.Tensor:
    """The input of a column-parallel product (Megatron's copy)."""
    return x if mesh is None else copy_to_group(x, mesh.model_group)


class DecodeBounds(NamedTuple):
    """Per-row filled key range [starts, lengths) for the T=1 kernel path."""
    lengths: torch.Tensor  # (B,) int32
    starts: torch.Tensor   # (B,) int32


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _decode_kernel(ad: AttnDims, q: torch.Tensor, cache: KVCache, layer: int,
                   stacked: bool, bounds: DecodeBounds,
                   dtype: torch.dtype) -> torch.Tensor:
    """A T=1 step's attention through the kernel the configuration selects
    (the dispatch of the JAX function). q (B, Hkv, G, D) -> (B, Hkv, G, D);
    under tensor parallelism the rank's own heads and rows, through the
    wrappers of parallel/tp.py (#1, #6; the per-row kernel has none)."""
    lengths, starts = bounds
    if not stacked:
        # a per-layer cache: the dense kernel reads a float layer, so an
        # int8 one is dequantized to the activation type first (bf16
        # products, as the JAX function does)
        k, v = cache.k[layer], cache.v[layer]
        if cache.ks is not None:
            k = k.to(dtype) * cache.ks[layer][..., None].to(dtype)
            v = v.to(dtype) * cache.vs[layer][..., None].to(dtype)
        return decode_attention(q, k, v, lengths, starts)
    args = (q, cache.k, cache.v, cache.ks, cache.vs, layer, lengths, starts)
    tp = ad.tp_shards
    if ad.pallas_block_rows > 0 and (ad.pallas_stream or ad.kv_pos_major):
        # a position-major cache is readable by the stream kernel only
        if tp > 1:
            return stream_attention_tp(
                *args, int8_scores=ad.pallas_int8_scores,
                pos_major=ad.kv_pos_major, tp_shards=tp)
        return decode_attention_stream(*args, ad.pallas_int8_scores,
                                       pos_major=ad.kv_pos_major)
    if ad.pallas_block_rows > 0:
        if tp > 1:
            return blocks_attention_tp(
                *args, rows=ad.pallas_block_rows, chunk=ad.pallas_chunk,
                int8_scores=ad.pallas_int8_scores, tp_shards=tp)
        return decode_attention_blocks(*args, rows=ad.pallas_block_rows,
                                       chunk=ad.pallas_chunk,
                                       int8_scores=ad.pallas_int8_scores)
    if tp > 1:
        raise ValueError("the per-row kernel has no tensor-parallel wrapper; "
                         "use stream[N] or blocks[N]")
    return decode_attention_stacked_rows(*args)


def attention(p: dict, ad: AttnDims, x: torch.Tensor, freqs_cis: torch.Tensor,
              mask: torch.Tensor, cache: KVCache | None = None,
              layer: int = 0, input_pos: int | torch.Tensor = 0,
              bounds: DecodeBounds | None = None,
              stacked: bool = True) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D). mask: (B or 1, 1, T, S) bool. With
    `bounds`, a T=1 step goes through the decode attention kernel the
    configuration selects (`_decode_kernel`); with `ad.kv_fold` as well, on
    a position-major int8 cache and a host-int `input_pos`, the fold kernel
    writes this step's k/v rows itself (the gate of the JAX function; a
    per-row (B,) `input_pos` takes the scatter write and the read kernel). stacked=False: `cache` is one
    layer's depth-1 view (the per-layer stack modes).

    Under tensor parallelism (ad.tp_shards > 1) x is whole, the weights
    and the cache are the rank's, and so is the attention: its n_head / tp
    query and n_local_heads / tp KV heads."""
    b, t, _ = x.shape
    h, hkv, d = ad.n_head, ad.n_local_heads, ad.head_dim
    mesh = tp_mesh(ad.tp_shards)
    qkv = matmul_t(_column_input(x, mesh), p["wqkv"], w8a8=ad.w8a8)
    if ad.qkv_bias:
        qkv = qkv + p["wqkv_b"]
    # wqkv's rows are [q | k | v], so its contiguous row split does not
    # follow the heads: gather the columns, then keep the rank's heads (so
    # a rank's gradient of the gathered columns is partial)
    if mesh is not None:
        qkv = gather_for_partial(qkv, mesh.model_group)
    q, k, v = torch.split(qkv, [h * d, hkv * d, hkv * d], dim=-1)
    q = q.reshape(b, t, h, d)
    k = k.reshape(b, t, hkv, d)
    v = v.reshape(b, t, hkv, d)
    if mesh is not None:
        if h % mesh.model or hkv % mesh.model:
            raise ValueError(f"tp_shards={mesh.model} must divide "
                             f"n_head={h} and n_local_heads={hkv}")
        h, hkv = h // mesh.model, hkv // mesh.model
        r = mesh.model_index
        q = q[:, :, r * h:(r + 1) * h]
        k = k[:, :, r * hkv:(r + 1) * hkv]
        v = v[:, :, r * hkv:(r + 1) * hkv]
    if ad.qk_norm:
        # replicated weights applied to the rank's heads only
        q = rms_norm(q, _column_input(p["q_norm"], mesh), 1e-5)
        k = rms_norm(k, _column_input(p["k_norm"], mesh), 1e-5)
    q = apply_rotary_emb(q, freqs_cis)
    k = apply_rotary_emb(k, freqs_cis)

    g = h // hkv
    qg = q.reshape(b, t, hkv, g, d)
    scale = 1.0 / math.sqrt(d)
    k_scale = v_scale = None
    if cache is not None:
        fold = (ad.kv_fold and stacked and cache.pos_major
                and cache.ks is not None
                and ad.pallas_stream and ad.pallas_block_rows > 0
                and ad.tp_shards == 1 and t == 1
                and isinstance(input_pos, int) and bounds is not None)
        if not fold:
            _write_cache(cache, layer, input_pos, k, v)
        if bounds is not None and t == 1:
            if fold:
                # the raw post-RoPE rows; the kernel quantizes and writes
                y = decode_attention_stream_fold(
                    qg[:, 0], cache.k, cache.v, cache.ks, cache.vs, layer,
                    bounds.lengths, bounds.starts, k[:, 0].contiguous(),
                    v[:, 0].contiguous(), input_pos,
                    int8_scores=ad.pallas_int8_scores)
            else:
                y = _decode_kernel(ad, qg[:, 0], cache, layer, stacked,
                                   bounds, x.dtype)
            return _out_proj(p, ad, y.reshape(b, 1, h * d), mesh)
        k, v, k_scale, v_scale = _read_cache(cache, layer)

    if cache is not None and t == 1 and g > 1:
        # GQA decode step over the full cache extent (head-major form)
        qd = qg[:, 0]                                         # (B,Hkv,G,D)
        m = mask[:, :, -1, :, None]                           # (B|1,1,S,1)
        if k_scale is not None:
            st = torch.einsum("bhkd,bhgd->bhkg", k.to(qd.dtype), qd)
            st = st.float() * (k_scale[..., None].float() * scale)
        else:
            st = torch.einsum("bhkd,bhgd->bhkg", k, qd).float() * scale
        st = torch.where(m, st, torch.tensor(-1e30, device=st.device))
        pt = torch.softmax(st, dim=2)
        if v_scale is not None:
            pt = pt * v_scale[..., None].float()
        y = torch.einsum("bhkg,bhkd->bhgd", pt.to(x.dtype), v.to(x.dtype))
    else:
        if cache is not None and k_scale is not None:
            scores = torch.einsum("bqhgd,bhkd->bhgqk", qg, k.to(qg.dtype))
            scores = scores.float() * (
                k_scale[:, :, None, None, :].float() * scale)
        elif cache is not None:
            scores = torch.einsum("bqhgd,bhkd->bhgqk", qg, k) * scale
        else:
            scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
        # large-finite mask value: fully masked pad rows stay finite
        scores = torch.where(mask[:, :, None], scores.float(),
                             torch.tensor(-1e30, device=scores.device))
        probs = torch.softmax(scores, dim=-1)
        if cache is not None and v_scale is not None:
            pv = (probs * v_scale[:, :, None, None, :].float()).to(x.dtype)
            y = torch.einsum("bhgqk,bhkd->bqhgd", pv, v.to(x.dtype))
        elif cache is not None:
            y = torch.einsum("bhgqk,bhkd->bqhgd", probs.to(x.dtype), v)
        else:
            y = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(x.dtype), v)
    return _out_proj(p, ad, y.reshape(b, t, h * d), mesh)


def _out_proj(p: dict, ad: AttnDims, y: torch.Tensor, mesh) -> torch.Tensor:
    """wo (row-parallel under tensor parallelism) and its bias."""
    if mesh is None:
        out = matmul_t(y, p["wo"], w8a8=ad.w8a8)
    else:
        out = matmul_t_row_parallel(y, p["wo"], mesh.model_group,
                                    w8a8=ad.w8a8)
    return out + p["wo_b"] if ad.o_bias else out


def _ffn(p: dict, x: torch.Tensor, w8a8: bool = False,
         mesh=None) -> torch.Tensor:
    """The gated MLP; under tensor parallelism w1 and w3 give the rank's
    hidden columns and w2 is row-parallel."""
    x = _column_input(x, mesh)
    gate = torch.nn.functional.silu(matmul_t(x, p["w1"], w8a8=w8a8))
    hidden = gate * matmul_t(x, p["w3"], w8a8=w8a8)
    if mesh is None:
        return matmul_t(hidden, p["w2"], w8a8=w8a8)
    return matmul_t_row_parallel(hidden, p["w2"], mesh.model_group,
                                 w8a8=w8a8)


def _layer(layers: dict, i: int) -> dict:
    def pick(x):
        if isinstance(x, dict):
            return {k: pick(v) for k, v in x.items()}
        return x[i]
    return pick(layers)


def _unbind_layers(layers: dict, n_layer: int) -> list[dict]:
    """The stacked layer tree as one dict a layer, through one `unbind` a
    leaf: its backward stacks the layers' gradients once, where indexing a
    layer at a time would add a full-depth zero gradient per layer."""
    out = [{} for _ in range(n_layer)]
    for k, v in layers.items():
        parts = (_unbind_layers(v, n_layer) if isinstance(v, dict)
                 else torch.unbind(v))
        for d, part in zip(out, parts):
            d[k] = part
    return out


def _block(p: dict, ad: AttnDims, eps: float, x: torch.Tensor, freqs_cis,
           mask, cache: KVCache | None = None, layer: int = 0,
           input_pos: int | torch.Tensor = 0,
           bounds: DecodeBounds | None = None,
           stacked: bool = True) -> torch.Tensor:
    a = attention(p["attention"], ad, rms_norm(x, p["attention_norm"], eps),
                  freqs_cis, mask, cache, layer, input_pos, bounds,
                  stacked=stacked)
    h = x + a
    return h + _ffn(p["feed_forward"], rms_norm(h, p["ffn_norm"], eps),
                    w8a8=ad.w8a8, mesh=tp_mesh(ad.tp_shards))


def run_stack(layers: dict, ad: AttnDims, eps: float, x: torch.Tensor,
              freqs_cis, mask, cache: KVCache | None = None,
              input_pos: int | torch.Tensor = 0,
              bounds: DecodeBounds | None = None,
              mode: str = "", remat: bool = False) -> torch.Tensor:
    """The layer stack, one layer at a time, each writing its own slab of
    the stacked cache in place. `mode` is the JAX function's cached-decode
    stack mode: "carry" (or "") hands every layer the stacked cache and its
    index; "scan" and "unrolled" hand each layer its own cache (a depth-1
    view), which the kernel path reads with the dense per-layer kernel.
    "unrolled" on an int8 cache falls back to "carry", as in JAX.

    Without a cache (training) gradients flow through every layer; with
    `remat` each layer keeps only its input and is recomputed in the
    backward pass (the JAX function's `jax.checkpoint` per layer)."""
    n_layer = layers["attention_norm"].shape[0]
    if cache is None:
        for p in _unbind_layers(layers, n_layer):
            if remat:
                x = checkpoint(_block, p, ad, eps, x, freqs_cis, mask,
                               use_reentrant=False)
            else:
                x = _block(p, ad, eps, x, freqs_cis, mask)
        return x
    mode = mode or "carry"
    if mode not in ("carry", "scan", "unrolled"):
        raise ValueError(f"unknown decode stack mode {mode!r}")
    if mode == "unrolled" and cache.k.dtype == torch.int8:
        mode = "carry"
    per_layer = mode != "carry"
    if per_layer and cache.pos_major:
        raise ValueError("kv_cache_layout='pos' needs the carry-mode "
                         "stacked cache")
    for i in range(n_layer):
        c, li = (cache.layer_view(i), 0) if per_layer else (cache, i)
        x = _block(_layer(layers, i), ad, eps, x, freqs_cis, mask, c, li,
                   input_pos, bounds, stacked=not per_layer)
    return x


# ---------------------------------------------------------------------------
# Embedding of (K+1)-row token matrices
# ---------------------------------------------------------------------------


def embed_tokens(params: dict, cfg: DualARConfig,
                 inp: torch.Tensor) -> torch.Tensor:
    """inp: (B, K+1, T) int -> (B, T, D)."""
    emb_dtype = param_dtype(params)
    codes = inp[:, 1:, :].long()
    offsets = torch.arange(cfg.num_codebooks, device=inp.device) \
        * cfg.codebook_size
    vq = take_rows(params["codebook_embeddings"], codes + offsets[None, :, None])
    vq_sum = vq.sum(dim=1).to(emb_dtype)                       # (B, T, D)
    tok = inp[:, 0, :].long()
    is_sem = ((tok >= cfg.semantic_begin_id)
              & (tok <= cfg.semantic_end_id))[..., None]
    vq_sum = torch.where(is_sem, vq_sum, torch.zeros((), dtype=emb_dtype,
                                                     device=inp.device))
    x = take_rows(params["embeddings"], tok).to(emb_dtype) + vq_sum
    if cfg.scale_codebook_embeddings:
        # a fill on the device (the same rounding as torch.tensor's), not a
        # copy from the host, which a CUDA graph's capture refuses
        scale = torch.full((), 1.0 / math.sqrt(cfg.num_codebooks + 1),
                           dtype=emb_dtype, device=inp.device)
        x = torch.where(is_sem, x * scale, x)
    return x


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


class SlowOut(NamedTuple):
    logits: torch.Tensor   # (B, Tq, vocab or support)
    hidden: torch.Tensor   # (B, Tq, fast_dim), already fast_project_in'ed


def _token_logits(params: dict, cfg: DualARConfig, slow_out: torch.Tensor,
                  logit_support: tuple | None = None) -> torch.Tensor:
    """Logits over the vocabulary, or with `logit_support` = (semantic
    begin, semantic end, im_end) over just those n_s + 1 rows (exact under
    the semantic bias, which is -inf everywhere else). An untied `output`
    is row-sharded under tensor parallelism: the rank's vocabulary rows,
    gathered."""
    w = params["embeddings"] if cfg.tie_word_embeddings else params["output"]
    mesh = None if cfg.tie_word_embeddings else tp_mesh(cfg.tp_shards)
    if mesh is not None:
        logits = _gather_columns(_column_input(slow_out, mesh)
                                 @ as_weight(w, slow_out.dtype).T, mesh)
        if logit_support is None:
            return logits
        sb, se, im = logit_support
        return torch.cat([logits[..., sb:se + 1], logits[..., im:im + 1]],
                         dim=-1)
    if logit_support is not None:
        sb, se, im = logit_support
        sem = slow_out @ as_weight(slice_rows(w, sb, se + 1), slow_out.dtype).T
        eos = slow_out @ as_weight(slice_rows(w, im, im + 1), slow_out.dtype).T
        return torch.cat([sem, eos], dim=-1)
    return slow_out @ as_weight(w, slow_out.dtype).T


def _fast_input(params: dict, cfg: DualARConfig, x: torch.Tensor,
                slow_normed: torch.Tensor) -> torch.Tensor:
    h = slow_normed if cfg.norm_fastlayer_input else x
    if "fast_project_in" in params:
        mesh = tp_mesh(cfg.tp_shards)
        h = (_column_input(h, mesh) @ params["fast_project_in"]["w"].T
             + params["fast_project_in"]["b"])
        h = _gather_columns(h, mesh)
    return h


def forward_generate(params: dict, cfg: DualARConfig, inp: torch.Tensor,
                     cache: KVCache, input_pos: int | torch.Tensor,
                     freqs_table: torch.Tensor, *, last_only: bool = True,
                     rope_positions: torch.Tensor | None = None,
                     key_valid_from: torch.Tensor | None = None,
                     logit_support: tuple | None = None) -> SlowOut:
    """Slow-stack forward with the KV cache (prefill T>=1 or decode T=1).

    input_pos: first cache slot written by `inp`: a host int shared by all
    rows, or a (B,) int tensor on the device, each row's own (continuous
    batching; the causal mask, the default RoPE rows and the decode
    kernels' bounds are then per row, and the cache write a scatter).
    rope_positions: optional (B, T) per-row RoPE positions (left-padded
    batches); defaults to input_pos + arange(T).
    key_valid_from: optional (B,) — keys before this slot are masked out."""
    b, _, t = inp.shape
    dev = inp.device
    x = embed_tokens(params, cfg, inp)
    per_row = isinstance(input_pos, torch.Tensor)
    if per_row:
        positions = input_pos.long()[:, None] + torch.arange(t, device=dev)
    else:
        positions = input_pos + torch.arange(t, device=dev)
    if rope_positions is None:
        freqs_cis = freqs_table[positions]                # (T | B, T, ., 2)
    else:
        freqs_cis = freqs_table[rope_positions.long()]         # (B, T, ., 2)
    key_pos = torch.arange(cache.seq_len, device=dev)
    if per_row:
        mask = (key_pos <= positions[:, :, None])[:, None]       # (B,1,T,S)
    else:
        mask = (key_pos[None, :] <= positions[:, None])[None, None]
    if key_valid_from is not None:
        valid = key_pos[None, :] >= key_valid_from[:, None]        # (B, S)
        mask = mask & valid[:, None, None, :]

    bounds = None
    if cfg.use_pallas_attention and t == 1:
        starts = (key_valid_from.int() if key_valid_from is not None
                  else torch.zeros(b, dtype=torch.int32, device=dev))
        if per_row:
            lengths = (positions[:, -1] + 1).int()
        else:
            lengths = torch.full((b,), input_pos + 1, dtype=torch.int32,
                                 device=dev)
        bounds = DecodeBounds(lengths, starts)
    x = run_stack(params["layers"], cfg.slow_attn, cfg.norm_eps, x, freqs_cis,
                  mask, cache, input_pos, bounds, mode=cfg.decode_stack_mode)
    if last_only and t > 1:
        x = x[:, -1:, :]
    slow_normed = rms_norm(x, params["norm"], cfg.norm_eps)
    logits = _token_logits(params, cfg, slow_normed, logit_support)
    hidden = _fast_input(params, cfg, x, slow_normed)
    return SlowOut(logits=logits, hidden=hidden)


def forward_generate_fast(params: dict, cfg: DualARConfig, x: torch.Tensor,
                          fast_cache, input_pos: int,
                          fast_freqs_table: torch.Tensor,
                          want_logits: bool = True):
    """One fast-head step at codebook position `input_pos` (host int).
    x: (B, fast_dim). Returns codebook logits (B, codebook_size), or None
    with want_logits=False (the priming sweep only writes its cache).
    The cache is updated in place.

    Under tensor parallelism the fused sweep takes the rank's rows of the
    batch, padded with zero rows to the cache's rows x tp (the padding is
    cut off before the logits); the row-sharded `fast_output` gives the
    rank's codebook columns, gathered."""
    mesh = tp_mesh(cfg.tp_shards)
    if "fast_packed" in params:
        from ..ops.fast_fused import fused_fast_sweep

        kw = dict(pos=input_pos, n_head=cfg.fast_n_head, eps=cfg.norm_eps)
        if mesh is None:
            x = fused_fast_sweep(params["fast_packed"], x, fast_cache,
                                 fast_freqs_table, **kw)
        else:
            b = x.shape[0]
            pad = fast_cache.k.shape[2] * mesh.model - b
            if pad:
                x = torch.cat([x, x.new_zeros(pad, x.shape[1])])
            x = fused_fast_sweep_tp(params["fast_packed"], x, fast_cache,
                                    fast_freqs_table, tp_shards=mesh.model,
                                    **kw)[:b]
        if not want_logits:
            return None
        x = rms_norm(x, params["fast_norm"], cfg.norm_eps)
        return _gather_columns(matmul_t(x, params["fast_output"], w8a8=True),
                               mesh)

    x = x[:, None, :]                                          # (B, 1, D)
    freqs_cis = fast_freqs_table[input_pos:input_pos + 1]
    key_pos = torch.arange(cfg.num_codebooks, device=x.device)
    mask = (key_pos <= input_pos)[None, None, None]            # (1,1,1,K)
    x = run_stack(params["fast_layers"], cfg.fast_attn, cfg.norm_eps, x,
                  freqs_cis, mask, fast_cache, input_pos)
    if not want_logits:
        return None
    x = rms_norm(x, params["fast_norm"], cfg.norm_eps)
    return _gather_columns(matmul_t(x[:, 0, :], params["fast_output"],
                                    w8a8=cfg.w8a8_matmuls), mesh)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


class TrainOut(NamedTuple):
    token_logits: torch.Tensor     # (B, T, vocab)
    codebook_logits: torch.Tensor  # (B, T, K, codebook_size)


def forward_train(params: dict, cfg: DualARConfig, inp: torch.Tensor,
                  labels: torch.Tensor | None = None,
                  key_padding_mask: torch.Tensor | None = None,
                  remat: bool = True) -> TrainOut:
    """Teacher-forced forward for training, with gradients. The fast head
    runs over EVERY position (the positions folded into the batch) and the
    loss mask selects the semantic ones, as in the JAX function.

    inp: (B, K+1, T) int; labels: (B, K+1, T), whose codes (clipped to the
    codebook) feed the fast head, `inp`'s when None; key_padding_mask: (B,
    T) bool, True at PAD positions. Codebook k >= 1 conditions on codes
    [..., :k]. The naive head (`cfg.is_naive`) predicts all K codebooks at
    once from the slow stack's output.

    Under tensor parallelism (`cfg.tp_shards > 1`, run under
    `parallel.tp.decode_mesh`) the weights are the rank's slices and the
    batch is the rank's data rows; the logits come out whole on every
    rank of the model group."""
    b, _, t = inp.shape
    dev = inp.device
    x = embed_tokens(params, cfg, inp)
    freqs_cis = precompute_freqs_cis(t, cfg.head_dim, cfg.rope_base, dev)
    q_pos = torch.arange(t, device=dev)
    causal = (q_pos[None, :] <= q_pos[:, None])[None, None]     # (1,1,T,T)
    if key_padding_mask is not None:
        mask = causal & ~key_padding_mask.bool()[:, None, None, :]
    else:
        mask = causal.expand(b, 1, t, t)
    x = run_stack(params["layers"], cfg.slow_attn, cfg.norm_eps, x, freqs_cis,
                  mask, remat=remat)
    slow_normed = rms_norm(x, params["norm"], cfg.norm_eps)
    token_logits = _token_logits(params, cfg, slow_normed)
    k = cfg.num_codebooks

    if cfg.is_naive:
        h = slow_normed if cfg.norm_fastlayer_input else x
        cb = rms_norm(h, params["codebook_norm"], cfg.norm_eps)
        mesh = tp_mesh(cfg.tp_shards)
        cb_logits = _gather_columns(
            _column_input(cb, mesh)
            @ as_weight(params["codebook_output"], cb.dtype).T, mesh)
        return TrainOut(token_logits,
                        cb_logits.reshape(b, t, k, cfg.codebook_size))

    h = _fast_input(params, cfg, x, slow_normed)                 # (B, T, Df)
    src = labels if labels is not None else inp
    codes = src[:, 1:, :].long().clamp(0, cfg.codebook_size - 1)   # (B,K,T)
    code_emb = take_rows(params["fast_embeddings"], codes[:, :-1, :])
    # the fast input sequence: [h, emb(c_0), ..., emb(c_{K-2})]
    fast_in = torch.cat([h[:, None], code_emb.to(h.dtype)], dim=1)  # B,K,T,Df
    fast_in = fast_in.transpose(1, 2).reshape(b * t, k, -1)
    fast_freqs = precompute_freqs_cis(k, cfg.fast_head_dim, cfg.rope_base,
                                      dev)
    kq = torch.arange(k, device=dev)
    fmask = (kq[None, :] <= kq[:, None])[None, None]
    fx = run_stack(params["fast_layers"], cfg.fast_attn, cfg.norm_eps,
                   fast_in, fast_freqs, fmask, remat=remat)
    fx = rms_norm(fx, params["fast_norm"], cfg.norm_eps)
    mesh = tp_mesh(cfg.tp_shards)
    codebook_logits = _gather_columns(
        _column_input(fx, mesh) @ as_weight(params["fast_output"], fx.dtype).T,
        mesh)
    return TrainOut(token_logits,
                    codebook_logits.reshape(b, t, k, cfg.codebook_size))
