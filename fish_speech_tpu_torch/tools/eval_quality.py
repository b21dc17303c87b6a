"""Trained-weights quality harness (one command per weights drop).

    python -m fish_speech_tpu_torch.tools.eval_quality --lm-checkpoint DIR
        [--codec-checkpoint codec.pth] [--codec-config s2_pro|tiny]
        [--skip-drift] [--device cpu]

Counterpart of `tools/eval_quality.py`. Given a reference-layout checkpoint
directory (and optionally the codec .pth) it runs, in order:

  1. convert: the checkpoint through the port's loaders
     (`utils/checkpoint.load_torch_lm_checkpoint`,
     `models/init.convert_dual_ar_state_dict`), the parameter counts;
  2. quant drift on the real weights: `tools/quant_drift.py`'s teacher-forced
     comparisons of the serving quantizations against bf16 (the full
     serving configuration where the fast head packs for the fused sweep),
     gated on QUANT_DRIFT.md's go bounds;
  3. codec: a fixed code sequence through the converted codec, its
     waveform's length and finiteness.

The JAX tool's comparisons against the reference implementation (greedy
parity and the codec's log-mel drift) are not here: they need a builder of
the reference models from the port's configs, which the port does not have.
Their stage prints a "skipped" line. One JSON line a stage, then a summary
line; exit 1 if a stage fails. With no checkpoint it prints one "skip" line
and exits 0, so it can sit in CI. Runs on the CUDA card unless given
--device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np


def emit(obj):
    print(json.dumps(obj), flush=True)
    return obj


def stage_convert(args, dev):
    """Checkpoint dir -> (cfg, bf16 params on dev)."""
    import torch

    from ..models.config import DualARConfig
    from ..models.init import convert_dual_ar_state_dict
    from ..utils.checkpoint import load_torch_lm_checkpoint

    cfg = DualARConfig.from_json(args.lm_checkpoint)
    if args.cache_len:
        cfg = dataclasses.replace(cfg, max_seq_len=args.cache_len)
    sd = load_torch_lm_checkpoint(args.lm_checkpoint)
    params = convert_dual_ar_state_dict(sd, cfg, dtype=torch.bfloat16,
                                        device=dev)
    n_params = int(sum(v.numel() for v in sd.values()))
    emit({"stage": "convert", "ok": True, "torch_tensors": len(sd),
          "n_params": n_params, "model_type": cfg.model_type,
          "n_layer": cfg.n_layer, "dim": cfg.dim})
    return cfg, params


def _fused_head_packs(cfg) -> bool:
    """Whether the fast stack is in the fused sweep's 3x layer family."""
    return (not cfg.is_naive
            and cfg.fast_n_head * cfg.fast_head_dim == cfg.fast_dim
            and cfg.fast_intermediate_size == 3 * cfg.fast_dim)


def stage_quant_drift(args, cfg, params, dev):
    """Teacher-forced serving-config drift on the real weights, gated on
    the go bounds."""
    from ..ops.fast_fused import enable_fused_fast_head
    from ..ops.quant import quantize_lm_params
    from .quant_drift import (compare, make_teacher_forced_inputs,
                              run_teacher_forced, serving_full)

    prompt, forced = make_teacher_forced_inputs(cfg, args.batch,
                                                args.prompt_len, args.steps)
    s = args.cache_len or 256

    def run(c, p, fused=False):
        return run_teacher_forced(c, p, prompt, forced, s, fused=fused,
                                  device=dev)

    ref = run(cfg, params)
    params_q = quantize_lm_params(params)
    results = {"int8_weights": compare(ref, run(cfg, params_q),
                                       "int8_weights")}
    cfg_w = dataclasses.replace(cfg, w8a8_matmuls=True,
                                kv_cache_dtype="int8")
    results["w8a8_int8kv"] = compare(ref, run(cfg_w, params_q),
                                     "w8a8_int8kv")
    if _fused_head_packs(cfg):
        # the stream kernel (#1) and the fused fast head (#2)
        results["serving_full"] = compare(
            ref, run(serving_full(cfg), enable_fused_fast_head(params_q),
                     fused=True), "serving_full")
    worst = max(r["max_abs_dlogit"] for rs in results.values() for r in rs)
    worst_mean = max(r["mean_abs_dlogit"] for rs in results.values()
                     for r in rs)
    top5 = min(r["top1_in_ref_top5"] for rs in results.values() for r in rs)
    # QUANT_DRIFT.md's go / no-go bounds: a drop whose real-weight drift
    # exceeds them fails
    ok = (worst <= args.drift_max_dlogit
          and worst_mean <= args.drift_mean_dlogit
          and top5 >= args.drift_min_top5)
    return emit({"stage": "quant_drift", "ok": bool(ok),
                 "configs": list(results), "worst_max_abs_dlogit": worst,
                 "worst_mean_abs_dlogit": worst_mean,
                 "worst_top1_in_ref_top5": top5,
                 "bounds": {"max": args.drift_max_dlogit,
                            "mean": args.drift_mean_dlogit,
                            "top5": args.drift_min_top5}})


def stage_codec(args, dev):
    """A fixed code sequence through the converted codec: the waveform's
    length and finiteness."""
    import torch

    if not args.codec_checkpoint:
        return emit({"stage": "codec", "skipped": "no --codec-checkpoint"})
    from ..codec.config import s2_pro_codec_config, tiny_codec_config
    from ..codec.convert import convert_dac_state_dict
    from ..codec.model import dac_from_indices
    from ..utils.checkpoint import load_torch_codec_checkpoint

    ccfg = (s2_pro_codec_config() if args.codec_config == "s2_pro"
            else tiny_codec_config())
    csd = load_torch_codec_checkpoint(args.codec_checkpoint)
    cparams = convert_dac_state_dict(csd, ccfg, device=dev)

    rng = np.random.default_rng(11)
    n_q = ccfg.rvq.total_codebooks
    codes = np.concatenate(
        [rng.integers(0, ccfg.rvq.semantic_codebook_size,
                      (1, 1, args.frames)),
         rng.integers(0, ccfg.rvq.codebook_size,
                      (1, n_q - 1, args.frames))], axis=1).astype(np.int32)
    with torch.no_grad():
        wav = dac_from_indices(cparams, ccfg, torch.from_numpy(codes).to(
            dev)).float().cpu().numpy()
    return emit({"stage": "codec", "ok": bool(np.isfinite(wav).all()),
                 "frames": args.frames, "wav_samples": int(wav.shape[-1])})


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lm-checkpoint", default=None,
                    help="reference-layout checkpoint dir (config.json + "
                         "safetensors/.pth)")
    ap.add_argument("--codec-checkpoint", default=None,
                    help="codec .pth (generator state dict)")
    ap.add_argument("--codec-config", choices=["s2_pro", "tiny"],
                    default="s2_pro")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--drift-max-dlogit", type=float, default=1.0,
                    help="QUANT_DRIFT.md go bound: max |dlogit| over the "
                         "sampling support across serving quant configs")
    ap.add_argument("--drift-mean-dlogit", type=float, default=0.10)
    ap.add_argument("--drift-min-top5", type=float, default=0.99,
                    help="min fraction of quantized top-1 tokens inside "
                         "the bf16 top-5")
    ap.add_argument("--skip-drift", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..device import resolve_device

    args = parse_args(argv)
    if not args.lm_checkpoint and not args.codec_checkpoint:
        emit({"skip": "no checkpoint given; pass --lm-checkpoint DIR "
                      "(and optionally --codec-checkpoint PTH) when a "
                      "weights drop lands"})
        return 0
    dev = resolve_device(args.device)
    ok = True
    if args.lm_checkpoint:
        if not Path(args.lm_checkpoint).exists():
            emit({"skip": f"lm checkpoint {args.lm_checkpoint} not found"})
            return 0
        cfg, params = stage_convert(args, dev)
        emit({"stage": "reference_greedy",
              "skipped": "not in the port: no builder of the reference "
                         "models from the port's configs"})
        if not args.skip_drift:
            ok &= stage_quant_drift(args, cfg, params, dev)["ok"]
    ok &= stage_codec(args, dev).get("ok", True)
    emit({"stage": "summary", "ok": bool(ok)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
