"""Autoregressive decode loop for the Dual-AR transformer.

Counterpart of `fish_speech_tpu/models/decode.py`. The JAX package runs
prefill and a `lax.while_loop` as one program; here a host loop launches one
step at a time. The KV caches, the RAS window (recent main tokens checked by
`ras_select`), the emitted codes and the stop flags stay on the device, every
step has the same shapes (full cache extent, fixed batch), and the host only
syncs every `sync_every` steps to test whether all rows have finished.

Batching: prompts are LEFT-padded to a common length; `start_offsets (B,)`
marks each row's first real slot. RoPE positions are shifted per row and
the attention mask excludes pad slots.

Under a decode mesh (`parallel.tp.decode_mesh`) every rank passes the
whole prompt and gets the whole result: `generate` keeps the data rank's
rows, creates the cache at those rows and the rank's Hkv / tp heads, and
gathers the codes over the data group at the end. Every rank of a model
group reads the same gathered logits, so greedy codes, and draws from
generators seeded alike, agree across it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..ops.quant import as_weight, take_rows
from ..ops.sampling import (
    RAS_WIN_SIZE,
    greedy_one,
    push_window,
    ras_select,
    sample_main_and_high,
    sample_one,
)
from ..parallel.collectives import all_gather
from ..parallel.mesh import shard_batch
from ..parallel.tp import active_mesh, tp_mesh
from ..utils.profiling import span
from .config import DualARConfig
from .dual_ar import (
    KVCache,
    SlowOut,
    forward_generate,
    forward_generate_fast,
    param_dtype,
    precompute_freqs_cis,
    rms_norm,
)


@dataclass
class SamplingConfig:
    """temperature and top_p: Python floats or per-row (B,) f32 tensors;
    top_k_row: None, or each row's top-k (an int or a (B,) int32 tensor)
    inside the static top_k roof that `decode_one_token` extracts, so one
    decode step serves rows with different k."""
    temperature: float | torch.Tensor = 0.7
    top_p: float | torch.Tensor = 0.7
    top_k_row: int | torch.Tensor | None = None

    @staticmethod
    def create(temperature: float = 0.7, top_p: float = 0.7) -> "SamplingConfig":
        return SamplingConfig(float(temperature), float(top_p))


def new_fast_cache(params: dict, cfg: DualARConfig, batch: int, device,
                   dtype=torch.bfloat16):
    """The fast head's per-step cache. Every position is written before it
    is read within a step, so one cache serves all steps of a decode.
    Under tensor parallelism (`batch` the data rank's rows): the fused
    sweep's cache holds this rank's block of the batch padded to a
    multiple of the model-group size, the plain one its fast KV heads."""
    tp = cfg.tp_shards
    tp_mesh(tp)
    if "fast_packed" in params:
        from ..ops.fast_fused import FusedFastCache

        return FusedFastCache.create(cfg.n_fast_layer, cfg.num_codebooks,
                                     -(-batch // tp), cfg.fast_dim, device)
    kv_dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else dtype
    return KVCache.create(cfg.n_fast_layer, batch, cfg.num_codebooks,
                          cfg.fast_n_local_heads // tp, cfg.fast_head_dim,
                          dtype=kv_dtype, device=device)


def _sample(logits, sampling: SamplingConfig, top_k: int, greedy: bool, gen):
    if greedy:
        return greedy_one(logits)
    return sample_one(logits, sampling.temperature, sampling.top_p, top_k,
                      sampling.top_k_row, gen=gen)


def _naive_codes(params: dict, cfg: DualARConfig, hidden: torch.Tensor,
                 sampling: SamplingConfig, top_k: int, greedy: bool,
                 gen) -> torch.Tensor:
    """The naive (parallel) codebook head: all K codes of a step at once
    from the slow hidden state (B, D), each codebook a row of its own in
    the sampler, a per-row parameter repeated over its K rows. -> (B, K)
    int32."""
    b, k = hidden.shape[0], cfg.num_codebooks
    cb = rms_norm(hidden, params["codebook_norm"], cfg.norm_eps)
    logits = (cb @ as_weight(params["codebook_output"], cb.dtype).T)
    mesh = tp_mesh(cfg.tp_shards)
    if mesh is not None:   # row-sharded: the rank's columns, gathered
        logits = all_gather(logits, mesh.model_group)
    logits = logits.reshape(b * k, cfg.codebook_size).float()
    if greedy:
        return greedy_one(logits).reshape(b, k)

    def rows(x):
        if isinstance(x, torch.Tensor) and x.ndim == 1:
            return x.repeat_interleave(k)
        return x

    codes = sample_one(logits, rows(sampling.temperature),
                       rows(sampling.top_p), top_k,
                       rows(sampling.top_k_row), gen=gen)
    return codes.reshape(b, k).to(torch.int32)


def decode_one_token(params: dict, cfg: DualARConfig, x: torch.Tensor,
                     cache: KVCache, input_pos: int | torch.Tensor,
                     freqs_table: torch.Tensor, fast_freqs_table: torch.Tensor,
                     bias: torch.Tensor, sampling: SamplingConfig,
                     prev_window: torch.Tensor | None, *, top_k: int,
                     greedy: bool, gen: torch.Generator | None = None,
                     rope_positions: torch.Tensor | None = None,
                     key_valid_from: torch.Tensor | None = None,
                     sample_support: tuple | None = None,
                     sample_at: int | None = None,
                     fast_cache=None) -> torch.Tensor:
    """One full Dual-AR step. x: (B, K+1, T) — the prompt on prefill (T>1)
    or the last column (T=1). input_pos: a host int, or a (B,) int32
    tensor of per-row write positions (`forward_generate`).
    sample_support: optional (semantic_begin, semantic_end, im_end): logits
    and sampling over only those rows (the bias must be -inf elsewhere, as
    semantic_logit_bias is). sample_at: the column to sample from instead
    of the last (a right-padded prefill block's last real column).
    Returns the new column (B, K+1) int32: the slow forward, then
    `decode_fast` on its output."""
    with span("decode.slow", graph=False):
        out = forward_generate(params, cfg, x, cache, input_pos, freqs_table,
                               rope_positions=rope_positions,
                               key_valid_from=key_valid_from,
                               logit_support=sample_support,
                               last_only=sample_at is None)
    return decode_fast(params, cfg, out, fast_freqs_table, bias, sampling,
                       prev_window, top_k=top_k, greedy=greedy, gen=gen,
                       sample_support=sample_support, sample_at=sample_at,
                       fast_cache=fast_cache)


def decode_fast(params: dict, cfg: DualARConfig, out: SlowOut,
                fast_freqs_table: torch.Tensor, bias: torch.Tensor,
                sampling: SamplingConfig, prev_window: torch.Tensor | None, *,
                top_k: int, greedy: bool, gen: torch.Generator | None = None,
                sample_support: tuple | None = None,
                sample_at: int | None = None,
                fast_cache=None) -> torch.Tensor:
    """The rest of a step after the slow forward's `out`: the main token's
    sampling (and RAS with `prev_window`), then the fast head's codebooks
    (or the naive head's). -> the new column (B, K+1) int32."""
    b = out.hidden.shape[0]
    with span("decode.fast"):
        col = -1 if sample_at is None else sample_at
        logits_col = out.logits[:, col, :]
        hidden = out.hidden[:, col, :]
        if sample_support is not None:
            sb, se, im = sample_support
            bias_r = torch.cat([bias[sb:se + 1], bias[im:im + 1]])
            logits = logits_col.float() + bias_r
            n_sem = se - sb + 1

            def unmap(t):
                return torch.where(t == n_sem, im, t + sb).to(torch.int32)
        else:
            logits = logits_col.float() + bias

            def unmap(t):
                return t

        if prev_window is not None and not greedy:
            tn, th = sample_main_and_high(logits, sampling.temperature,
                                          sampling.top_p, top_k,
                                          sampling.top_k_row, gen=gen)
            token = ras_select(unmap(tn), unmap(th), prev_window,
                               cfg.semantic_begin_id, cfg.semantic_end_id)
        else:
            token = unmap(_sample(logits, sampling, top_k, greedy, gen))

        if cfg.is_naive:
            return torch.cat([token[:, None].to(torch.int32),
                              _naive_codes(params, cfg, hidden, sampling,
                                           top_k, greedy, gen)], dim=1)

        # fast head: prime position 0 with the slow hidden state, then emit
        # the residual codebooks one position at a time
        if fast_cache is None:
            fast_cache = new_fast_cache(params, cfg, b, hidden.device,
                                        hidden.dtype)
        forward_generate_fast(params, cfg, hidden, fast_cache, 0,
                              fast_freqs_table, want_logits=False)
        code = (token - cfg.semantic_begin_id).clamp(0, cfg.codebook_size - 1)
        codes = [token, code]
        for idx in range(1, cfg.num_codebooks):
            emb = take_rows(params["fast_embeddings"], code.long())
            logits_f = forward_generate_fast(params, cfg, emb, fast_cache,
                                             idx, fast_freqs_table)
            code = _sample(logits_f.float(), sampling, top_k, greedy, gen)
            codes.append(code)
        return torch.stack([c.to(torch.int32) for c in codes], dim=1)


def generate(params: dict, cfg: DualARConfig, prompt: torch.Tensor,
             start_offsets: torch.Tensor, gen: torch.Generator | None,
             sampling: SamplingConfig, bias: torch.Tensor, *,
             max_new_tokens: int, im_end_id: int, top_k: int = 30,
             greedy: bool = False, cache_len: int | None = None,
             restrict_sampling: bool = True, sync_every: int = 8,
             device=None):
    """Prefill + decode loop on `device` (CUDA by default; the inputs are
    moved there). prompt: (B, K+1, T) int, left-padded; start_offsets:
    (B,) first real slot. Returns (codes (B, K+1, max_new_tokens) int32,
    lengths (B,)) on that device, lengths counting the columns before each
    row's im_end. The parameters must already be on it.

    Under a decode mesh: the rank's parameter slices, the whole prompt in
    and the whole result out; B must divide by the data axis."""
    dev = resolve_device(device)
    mesh = active_mesh(cfg.tp_shards)
    split = mesh is not None and mesh.data > 1
    prompt = prompt.to(dev)
    if split:
        prompt = shard_batch(prompt, mesh)
        start_offsets = shard_batch(start_offsets, mesh)
    support = None
    if (restrict_sampling and cfg.semantic_begin_id is not None
            and cfg.semantic_end_id is not None):
        support = (cfg.semantic_begin_id, cfg.semantic_end_id, im_end_id)
    b, cb, t = prompt.shape
    s = cache_len or cfg.max_seq_len
    if t + max_new_tokens > s + 1:
        raise ValueError(f"prompt {t} + {max_new_tokens} new tokens exceed "
                         f"the cache ({s})")
    start_offsets = start_offsets.to(dev)
    kv_dtype = (torch.int8 if cfg.kv_cache_dtype == "int8"
                else param_dtype(params))
    cache = KVCache.create(cfg.n_layer, b, s,
                           cfg.n_local_heads // cfg.tp_shards, cfg.head_dim,
                           dtype=kv_dtype,
                           pos_major=cfg.kv_cache_layout == "pos", device=dev)
    freqs_table = precompute_freqs_cis(s, cfg.head_dim, cfg.rope_base, dev)
    fast_freqs_table = precompute_freqs_cis(cfg.num_codebooks,
                                            cfg.fast_head_dim, cfg.rope_base,
                                            dev)
    fast_cache = (None if cfg.is_naive else
                  new_fast_cache(params, cfg, b, dev, param_dtype(params)))
    rope_positions = (torch.arange(t, device=dev)[None, :]
                      - start_offsets[:, None]).clamp_min(0)
    bias = bias.to(dev)
    step_kw = dict(top_k=top_k, greedy=greedy, gen=gen,
                   key_valid_from=start_offsets, sample_support=support,
                   fast_cache=fast_cache)

    first = decode_one_token(params, cfg, prompt, cache, 0, freqs_table,
                             fast_freqs_table, bias, sampling, None,
                             rope_positions=rope_positions, **step_kw)
    window = push_window(torch.zeros(b, RAS_WIN_SIZE, dtype=torch.int32,
                                     device=dev), first[:, 0])
    out = torch.zeros(b, cb, max_new_tokens, dtype=torch.int32, device=dev)
    out[:, :, 0] = first
    finished = first[:, 0] == im_end_id
    lengths = torch.where(finished, 0, max_new_tokens).to(torch.int32)
    cur = first
    pos = t
    for step in range(1, max_new_tokens):
        if step % sync_every == 0 and bool(finished.all()):
            break
        col = decode_one_token(params, cfg, cur[:, :, None], cache, pos,
                               freqs_table, fast_freqs_table, bias, sampling,
                               window,
                               rope_positions=(pos - start_offsets)[:, None],
                               **step_kw)
        now = col[:, 0] == im_end_id
        lengths = torch.where(now & ~finished,
                              torch.clamp_max(lengths, step), lengths)
        out[:, :, step] = torch.where(finished[:, None], out[:, :, step], col)
        window = push_window(window, col[:, 0])
        finished = finished | now
        cur = col
        pos += 1
    if split:
        out = all_gather(out, mesh.data_group, dim=0)
        lengths = all_gather(lengths, mesh.data_group, dim=0)
    return out, lengths
