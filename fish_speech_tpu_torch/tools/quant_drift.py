"""Quantization drift at the S2-Pro shape, teacher-forced.

    python -m fish_speech_tpu_torch.tools.quant_drift [--layers N]
        [--steps 16] [--batch 8] [--prompt-len 48] [--cache-len 256]
        [--seed 0] [--misses] [--twins] [--device cpu]

Counterpart of `tools/quant_drift.py`. Random weights drawn from a fixed
seed suffice for drift bounds: quantization error is a property of the
weight and activation distributions and the arithmetic, not of what the
logits mean. Every configuration is fed the same token stream (a prompt,
then N forced columns), so they are compared step for step without
autoregressive divergence. Against the bf16 model (plain attention,
unfused fast head) it measures, over the restricted sampling support:
  1. int8 weight-only;
  2. + W8A8 products and the int8 KV cache (plain attention);
  3. the full serving configuration: + the position-major cache read by
     the stream kernel (#1) and the fused fast head (#2);
  4. W4A8: the slow stack's matrices as packed int4 (#11) with W8A8
     products and the int8 KV cache;
each on the prefill's last logits, the decode steps' slow logits and the
fast head's codebook-1 logits: max and mean |dlogit|, top-1 agreement and
top-1 in the reference's top-5. One JSON line a comparison; with
--misses, one more for each that has top-5 misses, listing them. --seed
draws other weights and tokens. --twins adds three witnesses: 3 again
with the stream kernel and the fused sweep replaced by their plain
PyTorch versions, against bf16 and against the kernels' run (the
kernels' own share of the drift), and 3 against 2 (what the serving
path's int8 scores and fused head add). Runs on the CUDA card unless
given --device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys

import numpy as np

COMPARISONS = ("int8_weights", "w8a8_int8kv", "serving_full", "w4a8_int8kv")
WITNESSES = ("serving_twins", "serving_vs_twins", "serving_vs_plain")
PARTS = ("prefill", "decode_slow", "decode_fast")


def drift_stats(name: str, ref: np.ndarray, got: np.ndarray) -> dict:
    """The drift of `got` from `ref` (..., n) over their last axis, printed
    as one JSON line."""
    ref = ref.astype(np.float64).reshape(-1, ref.shape[-1])
    got = got.astype(np.float64).reshape(-1, got.shape[-1])
    d = np.abs(ref - got)
    top1_ref = ref.argmax(-1)
    top1_got = got.argmax(-1)
    top5_ref = np.argsort(ref, axis=-1)[:, -5:]
    in_top5 = np.mean([g in t5 for g, t5 in zip(top1_got, top5_ref)])
    out = {
        "compare": name,
        "max_abs_dlogit": round(float(d.max()), 4),
        "mean_abs_dlogit": round(float(d.mean()), 5),
        "top1_agree": round(float((top1_ref == top1_got).mean()), 4),
        "top1_in_ref_top5": round(float(in_top5), 4),
        "rows": int(ref.shape[0]),
    }
    print(json.dumps(out), flush=True)
    return out


def make_teacher_forced_inputs(base, batch: int, prompt_len: int,
                               steps: int, seed: int = 0):
    """Fixed-seed semantic-range prompt + forced continuation columns."""
    sem_begin, sem_end = base.semantic_begin_id, base.semantic_end_id
    rng = np.random.default_rng(seed)
    prompt = np.concatenate([
        rng.integers(sem_begin, sem_end + 1, (batch, 1, prompt_len)),
        rng.integers(0, base.codebook_size,
                     (batch, base.num_codebooks, prompt_len)),
    ], axis=1).astype(np.int32)
    forced = np.concatenate([
        rng.integers(sem_begin, sem_end + 1, (batch, 1, steps)),
        rng.integers(0, base.codebook_size, (batch, base.num_codebooks,
                                             steps)),
    ], axis=1).astype(np.int32)
    return prompt, forced


def run_teacher_forced(cfg, params, prompt: np.ndarray, forced: np.ndarray,
                       cache_len: int, *, fused: bool,
                       support: tuple | None = None, device=None):
    """Teacher-forced prefill + one cached decode step a forced column, on
    `device` (where the parameters lie; the CUDA card unless named).
    Returns (prefill slow logits over the support (B, n), per-step slow
    logits (steps, B, n), per-step fast-head logits for codebook 1
    (steps, B, codebook_size)), f32 numpy. fused: the fast head through
    the fused sweep (params from `enable_fused_fast_head`)."""
    import torch

    from ..device import resolve_device
    from ..models.decode import new_fast_cache
    from ..models.dual_ar import (KVCache, forward_generate,
                                  forward_generate_fast, param_dtype,
                                  precompute_freqs_cis)
    from ..ops.quant import take_rows

    dev = resolve_device(device)
    if support is None:
        support = (cfg.semantic_begin_id, cfg.semantic_end_id, 5)
    b, _, t = prompt.shape
    freqs = precompute_freqs_cis(cache_len, cfg.head_dim, cfg.rope_base, dev)
    fast_freqs = precompute_freqs_cis(cfg.num_codebooks, cfg.fast_head_dim,
                                      cfg.rope_base, dev)
    kv_dtype = (torch.int8 if cfg.kv_cache_dtype == "int8"
                else param_dtype(params))
    cache = KVCache.create(cfg.n_layer, b, cache_len, cfg.n_local_heads,
                           cfg.head_dim, dtype=kv_dtype,
                           pos_major=cfg.kv_cache_layout == "pos", device=dev)
    if fused != ("fast_packed" in params):
        raise ValueError("fused=True needs the fused fast head's params "
                         "and fused=False the plain fast stack")
    # every step writes positions 0 and 1 before reading them: one cache
    # serves all steps
    fc = new_fast_cache(params, cfg, b, dev, param_dtype(params))
    with torch.no_grad():
        out = forward_generate(params, cfg, torch.from_numpy(prompt).to(dev),
                               cache, 0, freqs, logit_support=support)
        pre = out.logits[:, -1].float()
        forced_d = torch.from_numpy(forced).to(dev)
        slow, fast = [], []
        for i in range(forced.shape[2]):
            col = forced_d[:, :, i]
            o = forward_generate(params, cfg, col[:, :, None], cache, t + i,
                                 freqs, logit_support=support)
            forward_generate_fast(params, cfg, o.hidden[:, -1], fc, 0,
                                  fast_freqs, want_logits=False)
            emb = take_rows(params["fast_embeddings"], col[:, 1].long())
            fl = forward_generate_fast(params, cfg, emb, fc, 1, fast_freqs)
            slow.append(o.logits[:, -1].float())
            fast.append(fl.float())
    return (pre.cpu().numpy(), torch.stack(slow).cpu().numpy(),
            torch.stack(fast).cpu().numpy())


def drift_config(base):
    """(config, support) of the drift runs on `base`: its semantic range
    set to the codebook's rows at the vocabulary's end, as JAX's tool
    does."""
    sem_begin = base.vocab_size - base.codebook_size - 8
    sem_end = base.vocab_size - 8 - 1
    return (base.with_semantic_range(sem_begin, sem_end),
            (sem_begin, sem_end, 5))


def top5_misses(ref: np.ndarray, got: np.ndarray) -> list[dict]:
    """The rows whose top-1 in `got` is outside `ref`'s top 5 as
    `drift_stats` counts them: the row, that token's rank in `ref` (0 the
    top; a tie at the fifth place can count as a miss at rank 4), its
    margin (how far its `ref` logit lies below `ref`'s fifth) and the row's
    max |dlogit|. A miss whose margin is below the drift is a near-tie the
    drift alone explains."""
    ref = ref.astype(np.float64).reshape(-1, ref.shape[-1])
    got = got.astype(np.float64).reshape(-1, got.shape[-1])
    out = []
    for i, (r, g) in enumerate(zip(ref, got)):
        t = int(g.argmax())
        top5 = np.argsort(r)[-5:]
        if t not in top5:
            out.append({"row": i, "ref_rank": int((r > r[t]).sum()),
                        "margin": round(float(r[top5[0]] - r[t]), 4),
                        "row_max_abs_dlogit": round(
                            float(np.abs(r - g).max()), 4)})
    return out


def compare(ref: tuple, got: tuple, name: str,
            misses: bool = False) -> list[dict]:
    """drift_stats of each part (printed as JAX prints them); with
    `misses`, one more line a part that has top-5 misses, listing them."""
    out = []
    for part, r, g in zip(PARTS, ref, got):
        out.append(drift_stats(f"{name}/{part}", r, g))
        rows = top5_misses(r, g) if misses else []
        if rows:
            print(json.dumps({"top5_misses": f"{name}/{part}",
                              "rows": rows}), flush=True)
    return out


def serving_full(cfg):
    """The full serving configuration of the drift runs: W8A8, the
    position-major int8 cache read by the stream kernel (#1) and, with
    `enable_fused_fast_head` params, the fused fast head (#2)."""
    from ..models.config import apply_pallas_attn_mode

    return apply_pallas_attn_mode(dataclasses.replace(
        cfg, w8a8_matmuls=True, kv_cache_dtype="int8",
        kv_cache_layout="pos", unroll_fast_sweeps=True), "stream")


@contextlib.contextmanager
def plain_twins():
    """Within the block the serving path calls the plain PyTorch versions
    of the stream kernel (#1) and the fused sweep (#2) in place of their
    wrappers, on whatever device the tensors lie: on the card, the full
    serving configuration's arithmetic without its kernels."""
    from ..models import dual_ar
    from ..ops import attention, fast_fused

    saved = dual_ar.decode_attention_stream, fast_fused.fused_fast_sweep
    dual_ar.decode_attention_stream = attention.decode_attention_stream_plain
    fast_fused.fused_fast_sweep = fast_fused.fused_fast_sweep_plain
    try:
        yield
    finally:
        dual_ar.decode_attention_stream, fast_fused.fused_fast_sweep = saved


def main(argv=None) -> dict:
    """Run the four comparisons; returns {comparison: [prefill,
    decode_slow, decode_fast stats]}."""
    from ..device import resolve_device
    from ..models.config import s2_pro_lm_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="override n_layer (0 = the full 36 layers)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the token stream")
    ap.add_argument("--misses", action="store_true",
                    help="list each comparison's top-5 misses")
    ap.add_argument("--twins", action="store_true",
                    help="also run the full serving configuration with #1 "
                         "and #2 through their plain PyTorch versions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    base = s2_pro_lm_config(max_seq_len=max(args.cache_len, 256))
    if args.layers:
        base = dataclasses.replace(base, n_layer=args.layers,
                                   n_fast_layer=min(args.layers,
                                                    base.n_fast_layer))
    return run_all(base, args.batch, args.prompt_len, args.steps,
                   args.cache_len, 128, args.seed, dev, args.misses,
                   args.twins)


def run_all(base, batch: int, prompt_len: int, steps: int, cache_len: int,
            groupsize: int, seed: int, dev, misses: bool = False,
            twins: bool = False) -> dict:
    """The four comparisons on `base` (its semantic range set by
    `drift_config`), weights and tokens drawn from `seed` on `dev`. With
    `twins`, the WITNESSES too: the full serving configuration again with
    #1 and #2 on their plain versions (`plain_twins`) against bf16
    (`serving_twins`) and against the kernels' run (`serving_vs_twins`),
    and the kernels' run against the plain W8A8 + int8 KV one of the same
    weights (`serving_vs_plain`)."""
    import torch

    from ..models.init import init_dual_ar_params
    from ..ops.fast_fused import enable_fused_fast_head
    from ..ops.quant import quantize_lm_params_incremental

    base, support = drift_config(base)
    prompt, forced = make_teacher_forced_inputs(base, batch, prompt_len,
                                                steps, seed)
    print(f"# shape: layers={base.n_layer} dim={base.dim} "
          f"fast_layers={base.n_fast_layer} B={batch} T={prompt_len} "
          f"steps={steps} seed={seed}", file=sys.stderr)

    def draw():
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_dual_ar_params(gen, base, dtype=torch.bfloat16,
                                   device=dev)

    def run(cfg, params, fused=False):
        return run_teacher_forced(cfg, params, prompt, forced, cache_len,
                                  fused=fused, support=support, device=dev)

    params = draw()
    ref = run(base, params)
    params = quantize_lm_params_incremental(params)
    results = {}
    # int8 weight-only (the reference's own PTQ level)
    results["int8_weights"] = compare(ref, run(base, params), "int8_weights",
                                      misses)
    # + W8A8 + int8 KV (plain attention)
    cfg_w = dataclasses.replace(base, w8a8_matmuls=True,
                                kv_cache_dtype="int8")
    plain = run(cfg_w, params)
    results["w8a8_int8kv"] = compare(ref, plain, "w8a8_int8kv", misses)
    # the full serving configuration: + pos-major, #1 stream, #2 fused
    params = enable_fused_fast_head(params)
    full = run(serving_full(base), params, fused=True)
    results["serving_full"] = compare(ref, full, "serving_full", misses)
    if twins:
        with plain_twins():
            twin = run(serving_full(base), params, fused=True)
        results["serving_twins"] = compare(ref, twin, "serving_twins", misses)
        results["serving_vs_twins"] = compare(twin, full, "serving_vs_twins")
        results["serving_vs_plain"] = compare(plain, full, "serving_vs_plain")
    del params
    # W4A8 (#11): quantized from the bf16 draw, not from int8
    params = quantize_lm_params_incremental(draw(), mode="w4a8",
                                            groupsize=groupsize)
    results["w4a8_int8kv"] = compare(ref, run(cfg_w, params), "w4a8_int8kv",
                                     misses)
    return results


if __name__ == "__main__":
    main()
