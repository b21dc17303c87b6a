"""Profile the batched decode step at the S2-Pro shape and print where the
device time goes.

    python -m fish_speech_tpu_torch.tools.profile_decode [--batch 64]
        [--cache 384] [--steps 32] [--no-quant] [--kv-int8] [--no-w8a8]
        [--pallas stream] [--fused-fast] [--kv-layout pos]
        [--logdir DIR] [--summarize-only] [--device cpu]

Counterpart of `tools/profile_decode.py`: `--steps` decode steps
(`decode_one_token`, sampled, from position 128 of a cache of `--cache`
positions) at `--batch` rows on the chosen serving configuration, once to
warm up and once under torch.profiler. The summary (`utils/profiling`'s
accounting): the device's busy ms, its idle share of the window, and the
kernels by self device time with their counts, from the profiler's own
record. With `--logdir` the chrome trace also goes to DIR/trace.json with
the window's wall time (writing it for 32 S2-Pro steps takes tens of
seconds); `--summarize-only` summarises a saved one. Runs on the CUDA card
unless given --device (a CPU run records no device time).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

START_POS = 128


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--cache", type=int, default=384)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--quant", action="store_true", default=True)
    ap.add_argument("--no-quant", dest="quant", action="store_false")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--w8a8", action="store_true", default=True)
    ap.add_argument("--no-w8a8", dest="w8a8", action="store_false")
    ap.add_argument("--pallas", default="0",
                    help="decode attention kernel: 0 | rows | "
                         "blocks[N][-bf16] | stream[N]")
    ap.add_argument("--pallas-chunk", type=int, default=128)
    ap.add_argument("--fused-fast", action="store_true",
                    help="fused fast-head sweep kernel (needs --quant)")
    ap.add_argument("--kv-layout", choices=["head", "pos"], default="head")
    ap.add_argument("--top", type=int, default=40,
                    help="kernels listed in the summary")
    ap.add_argument("--logdir", type=Path, default=None,
                    help="also write the chrome trace here")
    ap.add_argument("--summarize-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.fused_fast and not args.quant:
        raise SystemExit("--fused-fast needs --quant (the fused sweep "
                         "streams int8 weight tiles)")
    if args.summarize_only and args.logdir is None:
        raise SystemExit("--summarize-only reads --logdir DIR/trace.json")
    if START_POS + 2 * args.steps > args.cache and not args.summarize_only:
        raise SystemExit(f"--cache must hold {START_POS} + 2 x --steps "
                         f"positions")
    return args


def workload_config(args, base=None):
    """The S2-Pro configuration (or `base`) with the command line's
    serving flags, its semantic range at the vocabulary's end."""
    from ..models.config import apply_pallas_attn_mode, s2_pro_lm_config

    cfg = base or s2_pro_lm_config(max_seq_len=max(args.cache, 2048))
    sem_begin = cfg.vocab_size - cfg.codebook_size - 8
    cfg = dataclasses.replace(
        cfg, semantic_begin_id=sem_begin,
        semantic_end_id=cfg.vocab_size - 8 - 1,
        kv_cache_dtype="int8" if args.kv_int8 else "native",
        w8a8_matmuls=args.w8a8)
    cfg = apply_pallas_attn_mode(cfg, args.pallas, chunk=args.pallas_chunk)
    if args.kv_layout != "head":
        cfg = dataclasses.replace(cfg, kv_cache_layout=args.kv_layout)
    return cfg


def run_workload(args, base=None) -> dict:
    """Warm up, then run the profiled steps; returns the window's device
    table."""
    import torch

    from ..device import resolve_device
    from ..models.decode import SamplingConfig, decode_one_token, \
        new_fast_cache
    from ..models.dual_ar import KVCache, param_dtype, precompute_freqs_cis
    from ..models.init import init_dual_ar_params
    from ..ops.sampling import RAS_WIN_SIZE, semantic_logit_bias
    from ..utils.profiling import profile_table, save_wall, trace

    dev = resolve_device(args.device)
    cfg = workload_config(args, base)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_dual_ar_params(gen, cfg, dtype=torch.bfloat16, device=dev)
    if args.quant:
        from ..ops.quant import quantize_lm_params_incremental

        params = quantize_lm_params_incremental(params)
    if args.fused_fast:
        from ..ops.fast_fused import enable_fused_fast_head

        params = enable_fused_fast_head(params)
    b = args.batch
    sem = (cfg.semantic_begin_id, cfg.semantic_end_id, 5)
    cache = KVCache.create(cfg.n_layer, b, args.cache, cfg.n_local_heads,
                           cfg.head_dim,
                           dtype=(torch.int8 if args.kv_int8
                                  else param_dtype(params)),
                           pos_major=args.kv_layout == "pos", device=dev)
    freqs = precompute_freqs_cis(args.cache, cfg.head_dim, cfg.rope_base,
                                 dev)
    fast_freqs = precompute_freqs_cis(cfg.num_codebooks, cfg.fast_head_dim,
                                      cfg.rope_base, dev)
    bias = semantic_logit_bias(cfg.vocab_size, *sem, device=dev)
    fast_cache = new_fast_cache(params, cfg, b, dev, param_dtype(params))
    prev_win = torch.zeros(b, RAS_WIN_SIZE, dtype=torch.int32, device=dev)
    sampling = SamplingConfig.create()

    def run_chunk(cur, pos):
        for i in range(args.steps):
            col = decode_one_token(
                params, cfg, cur, cache, pos + i, freqs, fast_freqs, bias,
                sampling, prev_win, top_k=30, greedy=False, gen=gen,
                sample_support=sem, fast_cache=fast_cache)
            cur = col[:, :, None]
        return cur

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cur = torch.zeros(b, cfg.num_codebooks + 1, 1, dtype=torch.int32,
                      device=dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        cur = run_chunk(cur, START_POS)
        sync()
        print(f"# warmup {time.perf_counter() - t0:.1f}s", file=sys.stderr)
        with trace(args.logdir, cuda=dev.type == "cuda") as prof:
            t0 = time.perf_counter()
            run_chunk(cur, START_POS + args.steps)
            sync()
            wall = time.perf_counter() - t0
    if args.logdir is not None:
        save_wall(args.logdir / "trace.json", wall)
    return profile_table(prof, wall)


def summarize(table: dict, top: int = 40) -> dict:
    """Print and return a device table."""
    from ..utils.profiling import table_lines

    for line in table_lines(table, f"profile_decode: wall "
                            f"{table['wall_ms']:.1f} ms", top):
        print(line)
    return table


def main(argv=None) -> dict:
    from ..utils.profiling import trace_table

    args = parse_args(argv)
    if args.summarize_only:
        table = trace_table(args.logdir / "trace.json")
    else:
        table = run_workload(args)
    return summarize(table, args.top)


if __name__ == "__main__":
    main()
