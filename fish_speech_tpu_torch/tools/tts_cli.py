"""Text-to-speech from the command line on the port: text [+ a voice-clone
prompt as audio or codes] -> codes .npy [+ .wav].

    python -m fish_speech_tpu_torch.tools.tts_cli --text "..." --output x.wav
        [--checkpoint-path DIR --codec-checkpoint codec.pth] [--device cpu]
        [--vocoder-impl pallas|auto|lax|mm]

Counterpart of `tools/tts_cli.py` (ref text2semantic/inference.py:802-966),
with its flags and `--device`; the engine is the server CLI's
(`api_server.build_engine`), without the scheduler.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from .api_server import add_vocoder_impl, build_engine


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--text", default="<|speaker:0|>Hello from the card.")
    p.add_argument("--prompt-text", action="append", default=None)
    p.add_argument("--prompt-tokens", action="append", type=Path,
                   default=None)
    p.add_argument("--prompt-audio", action="append", type=Path,
                   default=None)
    p.add_argument("--output", type=Path, default=None, help="wav output path")
    p.add_argument("--output-dir", type=Path, default=Path("output"))
    p.add_argument("--num-samples", type=int, default=1)
    p.add_argument("--max-new-tokens", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.9)
    p.add_argument("--top-k", type=int, default=30)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--checkpoint-path", type=Path, default=None)
    p.add_argument("--codec-checkpoint", type=Path, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--chunk-length", type=int, default=300)
    p.add_argument("--kv-cache", choices=["native", "int8"], default="native")
    p.add_argument("--w8a8", action="store_true",
                   help="int8 activation x weight products (quantized "
                        "checkpoints)")
    p.add_argument("--pallas-attn", default="0",
                   help="decode attention: 0 | rows | blocks[N][-bf16] | "
                        "stream[N]")
    p.add_argument("--fused-fast", action="store_true",
                   help="fused fast-head sweep kernel (int8 checkpoints)")
    p.add_argument("--kv-layout", choices=["head", "pos"], default="head",
                   help="pos = position-major KV cache (needs stream attn)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    add_vocoder_impl(p)
    return p.parse_args(argv)


def main(argv=None) -> None:
    from ..engine.generate import GenerateLongRequest
    from ..serve.wav import decode_audio_bytes, encode_wav

    args = parse_args(argv)
    engine = build_engine(argparse.Namespace(
        checkpoint=str(args.checkpoint_path) if args.checkpoint_path
        else None,
        codec_checkpoint=(str(args.codec_checkpoint)
                          if args.codec_checkpoint else None),
        cache_len=4096 if args.checkpoint_path else 2048,
        kv_cache=args.kv_cache, w8a8=args.w8a8,
        pallas_attn=args.pallas_attn, fused_fast=args.fused_fast,
        kv_layout=args.kv_layout, device=args.device, scheduler_slots=0,
        scheduler_chunk=1, prefill_chunk=None,
        vocoder_impl=args.vocoder_impl, multihost=False))
    print(f"vocoder {engine.vocoder_impl}", flush=True)

    prompt_tokens = None
    prompt_text = list(args.prompt_text) if args.prompt_text else None
    if args.prompt_audio:
        prompt_tokens = []
        for path in args.prompt_audio:
            wav = decode_audio_bytes(path.read_bytes(),
                                     engine.codec_cfg.sample_rate)
            prompt_tokens.append(engine.encode_reference(wav))
    elif args.prompt_tokens:
        prompt_tokens = [np.load(path) for path in args.prompt_tokens]

    args.output_dir.mkdir(parents=True, exist_ok=True)
    for idx in range(args.num_samples):
        req = GenerateLongRequest(
            text=args.text, max_new_tokens=args.max_new_tokens,
            top_p=args.top_p, top_k=args.top_k,
            temperature=args.temperature, chunk_length=args.chunk_length,
            prompt_text=prompt_text, prompt_tokens=prompt_tokens,
            seed=args.seed + idx)
        codes_list = []
        t0 = time.perf_counter()
        for r in engine.generate_long(req):
            if r.action == "sample":
                codes_list.append(r.codes)
                print(f"  batch: {r.tokens_generated} tokens in "
                      f"{r.wall_s:.2f}s ({r.tokens_generated / max(r.wall_s, 1e-9):.1f}"
                      " tok/s)")
        merged = np.concatenate(codes_list, axis=1)
        npy_path = args.output_dir / f"codes_{idx}.npy"
        np.save(npy_path, merged)
        print(f"saved {npy_path} ({merged.shape})")
        if args.output:
            wav = engine.decode_codes(merged)
            out = (args.output if args.num_samples == 1 else
                   args.output.with_stem(f"{args.output.stem}_{idx}"))
            out.write_bytes(encode_wav(wav, engine.codec_cfg.sample_rate))
            dur = len(wav) / engine.codec_cfg.sample_rate
            wall = time.perf_counter() - t0
            print(f"saved {out} ({dur:.2f}s audio, RTF "
                  f"{wall / max(dur, 1e-9):.3f})")
    engine.close()


if __name__ == "__main__":
    main()
