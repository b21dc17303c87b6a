"""Launch the TTS HTTP server on the port.

    python -m fish_speech_tpu_torch.tools.api_server [--listen HOST:PORT]
        [--checkpoint DIR --codec-checkpoint codec.pth] [--device cpu] ...

Counterpart of `tools/api_server.py` (the JAX CLI), with its flags but the
multi-host ones. Without --checkpoint / --codec-checkpoint it serves the
JAX CLI's tiny random models (a demo: the audio is noise, the request path
is real); the demo codec's decoder is 256 wide instead of 128, so that every
vocoder block has a multiple of 32 channels, which the fused vocoder
kernels (#3/#4) need on the card. A checkpoint is loaded as the JAX CLI
loads it: the reference layout, converted to bf16. The engine runs on the
card unless --device names another.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--listen", default="127.0.0.1:8080")
    parser.add_argument("--checkpoint", default=None,
                        help="Dual-AR checkpoint dir (reference layout)")
    parser.add_argument("--codec-checkpoint", default=None,
                        help="codec.pth path")
    parser.add_argument("--references-dir", default="references")
    parser.add_argument("--api-key", default=None)
    parser.add_argument("--cache-len", type=int, default=2048)
    parser.add_argument("--scheduler-slots", type=int, default=0,
                        help=">0 enables continuous batching with N decode "
                             "slots")
    parser.add_argument("--kv-cache", choices=["native", "int8"],
                        default="native",
                        help="int8 halves KV-cache bandwidth/memory "
                             "(per-position symmetric quantization)")
    parser.add_argument("--scheduler-chunk", type=int, default=1,
                        help=">1 runs N decode ticks per read-back "
                             "(throughput mode; adds up to N tokens of "
                             "streaming latency)")
    add_vocoder_impl(parser)
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="prompts longer than N tokens prefill one "
                             "N-token chunk per scheduler tick, interleaved "
                             "with decode ticks (needs --scheduler-slots)")
    parser.add_argument("--w8a8", action="store_true",
                        help="int8 activation x int8 weight products for "
                             "quantized checkpoints")
    parser.add_argument("--pallas-attn", default="0",
                        help="decode attention: 0 (einsums), rows, or "
                             "blocks[N][-bf16] | stream[N] (the kernels)")
    parser.add_argument("--fused-fast", action="store_true",
                        help="fused fast-head sweep kernel (one launch a "
                             "codebook; needs an int8 checkpoint)")
    parser.add_argument("--kv-layout", choices=["head", "pos"],
                        default="head",
                        help="pos = position-major KV cache (needs "
                             "--pallas-attn stream)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    return parser.parse_args(argv)


def add_vocoder_impl(parser) -> None:
    parser.add_argument("--vocoder-impl", default="pallas",
                        choices=["pallas", "auto", "lax", "mm"],
                        help="serving vocoder: pallas (the fused kernels "
                             "#3/#4, the default), lax (plain), mm (matmul "
                             "form); auto probes pallas vs lax at startup "
                             "and keeps the faster, but on the card raises "
                             "if lax wins")


def demo_lm(device):
    """The JAX CLI's tiny random LM (seed 0) and its byte tokenizer."""
    import torch

    from ..models.config import DualARConfig
    from ..models.init import init_dual_ar_params
    from ..text.tokenizer import ByteTokenizer

    tokenizer = ByteTokenizer(n_semantic=64)
    cfg = DualARConfig(
        vocab_size=tokenizer.vocab_size,
        n_layer=2, n_head=2, n_local_heads=2, dim=64, head_dim=32,
        intermediate_size=128, max_seq_len=2048,
        codebook_size=64, num_codebooks=4,
        semantic_begin_id=tokenizer.semantic_begin_id,
        semantic_end_id=tokenizer.semantic_end_id,
        n_fast_layer=1, fast_dim=64, fast_n_head=2, fast_n_local_heads=2,
        fast_head_dim=32, fast_intermediate_size=128)
    params = init_dual_ar_params(
        torch.Generator(device=device).manual_seed(0), cfg, device=device)
    return cfg, tokenizer, params


def demo_codec(device):
    """The JAX CLI's tiny random codec (seed 1), its decoder widened from
    128 to 256: every block then has a multiple of 32 channels, the rule of
    the fused vocoder kernels (#3/#4)."""
    import torch

    from ..codec.config import tiny_codec_config
    from ..codec.init import init_dac_params

    codec_cfg = dataclasses.replace(tiny_codec_config(), decoder_dim=256)
    return codec_cfg, init_dac_params(
        torch.Generator(device=device).manual_seed(1), codec_cfg,
        device=device)


def apply_flags(cfg, params, args):
    """--kv-cache, --w8a8, --pallas-attn, --kv-layout and --fused-fast on
    the configuration and weights, accepting and refusing what the JAX CLI
    does, with its messages."""
    from ..models.config import apply_pallas_attn_mode

    if args.kv_cache != "native":
        cfg = dataclasses.replace(cfg, kv_cache_dtype=args.kv_cache)
    if args.w8a8:
        cfg = dataclasses.replace(cfg, w8a8_matmuls=True)
    if args.pallas_attn not in ("0", ""):
        cfg = apply_pallas_attn_mode(cfg, args.pallas_attn)
    if args.kv_layout != "head":
        if not (cfg.use_pallas_attention and cfg.pallas_attn_block_rows
                and cfg.pallas_attn_stream):
            raise SystemExit("--kv-layout pos needs --pallas-attn stream[N] "
                             "(the blocks/rows kernels index head-major)")
        cfg = dataclasses.replace(cfg, kv_cache_layout=args.kv_layout)
    if args.fused_fast:
        from ..ops.fast_fused import enable_fused_fast_head
        from ..ops.quant import is_quantized

        if not is_quantized(params["fast_layers"]["attention"]["wqkv"]):
            raise SystemExit("--fused-fast needs an int8-quantized "
                             "checkpoint (tools/quantize.py)")
        params = enable_fused_fast_head(params)
    return cfg, params


def build_engine(args):
    import torch

    from ..device import resolve_device
    from ..engine.generate import TTSEngine

    device = resolve_device(args.device)
    if args.checkpoint:
        from ..models.config import DualARConfig
        from ..models.init import convert_dual_ar_state_dict
        from ..text.tokenizer import load_tokenizer
        from ..utils.checkpoint import load_torch_lm_checkpoint

        cfg = DualARConfig.from_json(args.checkpoint)
        tokenizer = load_tokenizer(args.checkpoint)
        cfg = cfg.with_semantic_range(tokenizer.semantic_begin_id,
                                      tokenizer.semantic_end_id)
        params = convert_dual_ar_state_dict(
            load_torch_lm_checkpoint(args.checkpoint), cfg,
            dtype=torch.bfloat16, device=device)
    else:
        cfg, tokenizer, params = demo_lm(device)
    cfg, params = apply_flags(cfg, params, args)

    if args.codec_checkpoint:
        from ..codec.config import s2_pro_codec_config
        from ..codec.convert import convert_dac_state_dict
        from ..utils.checkpoint import load_torch_codec_checkpoint

        codec_cfg = s2_pro_codec_config()
        codec_params = convert_dac_state_dict(
            load_torch_codec_checkpoint(args.codec_checkpoint), codec_cfg,
            device=device)
    else:
        codec_cfg, codec_params = demo_codec(device)

    return TTSEngine(params, cfg, tokenizer, codec_params=codec_params,
                     codec_cfg=codec_cfg, cache_len=args.cache_len,
                     device=device, scheduler_slots=args.scheduler_slots,
                     scheduler_chunk=args.scheduler_chunk,
                     prefill_chunk=args.prefill_chunk,
                     vocoder_impl=args.vocoder_impl)


def warm_up(engine) -> None:
    """Run the decode path and the vocoder once before taking traffic
    (ref tools/server/model_manager.py:80-93), so that no request pays
    the kernels' first use."""
    from ..engine.generate import GenerateLongRequest

    list(engine.generate_long(GenerateLongRequest(text="warmup",
                                                  max_new_tokens=2)))
    if engine.codec_params is not None:
        engine.warmup_vocoder()


def main(argv=None) -> None:
    from ..serve.app import create_server

    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    engine = build_engine(args)
    warm_up(engine)
    host, port = args.listen.rsplit(":", 1)
    server = create_server(engine, host, int(port),
                           ref_dir=args.references_dir,
                           api_key=args.api_key)
    print(f"serving on http://{host}:{server.server_address[1]}, vocoder "
          f"{engine.vocoder_impl}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.app.close()
        engine.close()


if __name__ == "__main__":
    main()
