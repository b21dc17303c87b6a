"""Merge LoRA factors into base weights and save a standalone checkpoint.

    python -m fish_speech_tpu_torch.tools.merge_lora --base CKPT
        --lora LORA_CKPT --output OUT [--r 8 --alpha 16] [--device cpu]

Counterpart of `tools/merge_lora.py` (ref tools/llama/merge_lora.py, with
its check at 76-96 that the merged weights differ from the base): the
native layout in and out, the base's dtype kept.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> float:
    """Merge; returns the total L1 difference from the base."""
    import torch

    from ..device import resolve_device
    from ..train.lora import LoraConfig, merge_lora
    from ..train.step import tree_leaves
    from ..utils.checkpoint import load_params, save_params

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--base", type=Path, required=True,
                   help="base checkpoint dir (native safetensors layout)")
    p.add_argument("--lora", type=Path, required=True,
                   help="LoRA checkpoint dir (flat factors)")
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--r", type=int, default=8)
    p.add_argument("--alpha", type=float, default=16.0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    base, cfg = load_params(args.base, device=dev)
    lora, _ = load_params(args.lora, device=dev)
    merged = merge_lora(base, lora, LoraConfig(r=args.r,
                                               lora_alpha=args.alpha))

    # the merged weights must differ from the base
    diff = sum(float((a.float() - b.float()).abs().sum())
               for (_, a), (_, b) in zip(tree_leaves(base),
                                         tree_leaves(merged)))
    if diff == 0.0:
        raise SystemExit("merged == base: LoRA had no effect (all-zero b?)")
    print(f"total L1 difference vs base: {diff:.4f}")

    save_params(args.output, merged, cfg)
    print(f"saved merged checkpoint -> {args.output}")
    return diff


if __name__ == "__main__":
    main()
