"""Serving latency: time to the first audio (TTFA) and single-stream RTF
through the token-streaming path (the scheduler and the streaming
vocoder).

    python -m fish_speech_tpu_torch.tools.latency_bench [--full] [--quant]
        [--kv-int8] [--w8a8] [--pallas-attn stream] [--fused-fast]
        [--kv-layout pos] [--chunk-frames 8] [--first-chunk-frames 4]
        [--scheduler-chunk 1] [--slots 2] [--cache-len 1024]
        [--max-new 128] [--device cpu]

Counterpart of `tools/latency_bench.py`: `TTSEngine.stream_tts` through
the continuous-batching scheduler, one warm-up request (the kernels'
first use) and then one measured. --full: the S2-Pro LM and codec with
weights drawn from seeds 0 and 1; without it the tiny LM and the demo
codec of the server CLI. --fused-fast needs --quant (the fused sweep
streams int8 weight tiles). Prints one JSON line {"ttfa_s", "rtf", "audio_s",
"device", ...}, the device as `torch.cuda.get_device_name` gives it (or
"cpu"). Runs on the CUDA card unless given --device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="S2-Pro-scale LM + codec (random weights)")
    ap.add_argument("--quant", action="store_true", help="int8 weights")
    ap.add_argument("--kv-int8", action="store_true", help="int8 KV cache")
    ap.add_argument("--w8a8", action="store_true",
                    help="int8 activation x int8 weight products")
    ap.add_argument("--pallas-attn", default="0",
                    help="decode attention kernel: 0 | rows | "
                         "blocks[N][-bf16] | stream[N]")
    ap.add_argument("--fused-fast", action="store_true",
                    help="fused fast-head sweep kernel (needs --quant)")
    ap.add_argument("--kv-layout", choices=["head", "pos"], default="head")
    ap.add_argument("--chunk-frames", type=int, default=8,
                    help="acoustic frames per emitted audio chunk")
    ap.add_argument("--first-chunk-frames", type=int, default=4,
                    help="frames in the FIRST audio chunk (smaller = lower "
                         "TTFA; 0 disables the small-first-chunk schedule)")
    ap.add_argument("--scheduler-chunk", type=int, default=1,
                    help="decode ticks per read-back")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--cache-len", type=int, default=1024)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--text", default="Latency benchmark sentence, spoken "
                    "aloud to measure time to first audio.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.fused_fast and not args.quant:
        # timing "--fused-fast" without quantized weights would time the
        # plain fast head
        raise SystemExit("--fused-fast needs --quant (the fused sweep "
                         "streams int8 weight tiles)")
    return args


def build(args):
    """The engine of the command line: LM and codec drawn from seeds 0
    and 1, the flags applied, the scheduler on."""
    import torch

    from ..codec.config import s2_pro_codec_config
    from ..codec.init import init_dac_params
    from ..device import resolve_device
    from ..engine.generate import TTSEngine
    from ..models.config import apply_pallas_attn_mode
    from ..models.init import init_dual_ar_params
    from ..text.tokenizer import ByteTokenizer

    dev = resolve_device(args.device)
    if args.full:
        from ..models.config import s2_pro_lm_config

        cfg = s2_pro_lm_config(max_seq_len=args.cache_len)
        tokenizer = ByteTokenizer(n_semantic=cfg.codebook_size)
        cfg = dataclasses.replace(
            cfg, vocab_size=max(cfg.vocab_size, tokenizer.vocab_size))
        codec_cfg = s2_pro_codec_config()
        codec_params = init_dac_params(
            torch.Generator(device=dev).manual_seed(1),
            codec_cfg, device=dev)
    else:
        from ..models.config import tiny_dual_ar_config
        from .api_server import demo_codec

        tokenizer = ByteTokenizer(n_semantic=64)
        cfg = dataclasses.replace(tiny_dual_ar_config(),
                                  vocab_size=tokenizer.vocab_size,
                                  max_seq_len=args.cache_len)
        codec_cfg, codec_params = demo_codec(dev)
    cfg = cfg.with_semantic_range(tokenizer.semantic_begin_id,
                                  tokenizer.semantic_end_id)
    if args.kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if args.w8a8:
        cfg = dataclasses.replace(cfg, w8a8_matmuls=True)
    if args.pallas_attn not in ("0", ""):
        cfg = apply_pallas_attn_mode(cfg, args.pallas_attn)
    if args.kv_layout != "head":
        cfg = dataclasses.replace(cfg, kv_cache_layout=args.kv_layout)
    params = init_dual_ar_params(
        torch.Generator(device=dev).manual_seed(0), cfg,
        dtype=torch.bfloat16, device=dev)
    if args.quant:
        from ..ops.quant import quantize_lm_params_incremental

        params = quantize_lm_params_incremental(params)
        print("# int8 weights", file=sys.stderr)
        if args.fused_fast:
            from ..ops.fast_fused import enable_fused_fast_head

            params = enable_fused_fast_head(params)
            print("# fused fast head", file=sys.stderr)
    return TTSEngine(params, cfg, tokenizer, codec_params=codec_params,
                     codec_cfg=codec_cfg, cache_len=args.cache_len,
                     device=dev, scheduler_slots=args.slots,
                     scheduler_chunk=args.scheduler_chunk)


def one_request(engine, args, tag: str) -> tuple:
    """(ttfa s, wall s, audio s) of one streamed request; the host clock
    after the card has finished each chunk (stream_tts yields host
    arrays)."""
    from ..engine.generate import GenerateLongRequest

    req = GenerateLongRequest(text=args.text, max_new_tokens=args.max_new,
                              chunk_length=400)
    t0 = time.perf_counter()
    ttfa = None
    samples = 0
    for wav in engine.stream_tts(req, chunk_frames=args.chunk_frames,
                                 first_chunk_frames=(
                                     args.first_chunk_frames or None)):
        if ttfa is None and len(wav):
            ttfa = time.perf_counter() - t0
        samples += len(wav)
    wall = time.perf_counter() - t0
    audio_s = samples / engine.codec_cfg.sample_rate
    first = "none" if ttfa is None else f"{ttfa:.3f}s"
    print(f"# {tag}: ttfa={first} wall={wall:.2f}s "
          f"audio={audio_s:.2f}s rtf={wall / max(audio_s, 1e-9):.3f}",
          file=sys.stderr)
    return ttfa, wall, audio_s


def main(argv=None) -> dict:
    """Warm up, measure one request; prints and returns the JSON line."""
    import torch

    args = parse_args(argv)
    engine = build(args)
    try:
        one_request(engine, args, "warmup")
        ttfa, wall, audio_s = one_request(engine, args, "measure")
    finally:
        engine.close()
    dev = engine.device
    out = {
        "ttfa_s": round(ttfa, 4) if ttfa else None,
        "rtf": round(wall / max(audio_s, 1e-9), 4),
        "audio_s": round(audio_s, 3),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "chunk_frames": args.chunk_frames,
        "first_chunk_frames": args.first_chunk_frames,
        "scheduler_chunk": args.scheduler_chunk,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
