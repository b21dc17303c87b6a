"""Quantize a native Dual-AR checkpoint (weight-only PTQ).

    python -m fish_speech_tpu_torch.tools.quantize --checkpoint DIR
        [--output OUT] [--mode int8|int4|w4a8] [--groupsize 128]
        [--device cpu]

Counterpart of `tools/quantize.py` (ref tools/llama/quantize.py): the
native safetensors layout in and out (utils/checkpoint.py), the tree
quantized one leaf at a time with each bf16 leaf freed once its quantized
form exists (`quantize_lm_params_incremental`). Modes: int8 per output
channel; int4 the JAX native int4 checkpoint form of the slow stack
(listed in quant_meta.json); w4a8 the packed serving form of the slow
stack (`build_engine(quant="w4a8")`). Runs on the CUDA card unless given
--device.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors as they are stored."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def main(argv=None) -> Path:
    """Quantize; returns the output directory."""
    from ..device import resolve_device
    from ..ops.quant import QUANT_MODES, quantize_lm_params_incremental
    from ..utils.checkpoint import load_params, save_params

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--output", type=Path, default=None,
                   help="default: <checkpoint>-<mode>")
    p.add_argument("--mode", choices=QUANT_MODES, default="int8",
                   help="int8 = per-channel weight-only; int4 = groupwise "
                        "native-int4 checkpoint form; w4a8 = the runnable "
                        "serving form (slow stack int4 nibble-packed in "
                        "int8, everything else int8)")
    p.add_argument("--groupsize", type=int, default=128,
                   help="int4 group size (ref uses g32/g64/g128)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    params, cfg = load_params(args.checkpoint, device=dev)
    orig = tree_bytes(params)
    quantized = quantize_lm_params_incremental(params, mode=args.mode,
                                               groupsize=args.groupsize)
    out = args.output or args.checkpoint.with_name(
        args.checkpoint.name + "-" + args.mode)
    save_params(out, quantized, cfg)
    print(f"quantized {args.checkpoint} -> {out}: "
          f"{orig / 1e9:.2f} GB -> {tree_bytes(quantized) / 1e9:.2f} GB")
    return out


if __name__ == "__main__":
    main()
