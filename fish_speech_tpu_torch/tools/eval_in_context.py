"""In-context semantic loss across checkpoints: per-frame codebook loss
curves on a fixed prompt and continuation, one curve per checkpoint.

    python -m fish_speech_tpu_torch.tools.eval_in_context --checkpoints
        CKPT [CKPT ...] --proto SHARD.protos [--tokenizer DIR]
        [--max-length 1024] [--output eval_in_context.tsv] [--device cpu]

Counterpart of `tools/eval_in_context.py` (ref
tools/llama/eval_in_context.py): the first sample of the shard (seed 0)
through each checkpoint's `forward_train`, the codebook loss of every
semantic frame averaged over its codebooks. Writes one TSV (checkpoint,
frame, loss), one row a frame of each checkpoint, and prints each
checkpoint's mean. Runs on the CUDA card unless given --device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def frame_losses(codebook_logits: np.ndarray, tokens: np.ndarray,
                 labels: np.ndarray, cfg) -> np.ndarray:
    """Per-frame mean codebook NLL (T,) of one sample: codebook_logits
    (T, K, C) f32, tokens (K+1, T) and labels (K+1, T) of the sample; NaN
    where a frame is not semantic or has no label (the JAX tool's
    arithmetic, in numpy)."""
    logits = codebook_logits
    lab = np.transpose(labels[1:], (1, 0))                       # (T, K)
    tok = tokens[0]
    sem = (tok >= cfg.semantic_begin_id) & (tok <= cfg.semantic_end_id)
    top = logits.max(-1, keepdims=True)
    logp = logits - np.log(np.exp(logits - top).sum(-1, keepdims=True)) - top
    safe = np.clip(lab, 0, cfg.codebook_size - 1)
    nll = -np.take_along_axis(logp, safe[..., None], axis=-1)[..., 0]
    valid = sem[:, None] & (lab != -100)
    return np.where(valid.any(1),
                    (nll * valid).sum(1) / np.maximum(valid.sum(1), 1),
                    np.nan)


def main(argv=None) -> dict:
    """Write the TSV; returns {checkpoint name: per-frame losses}."""
    import torch

    from ..data import SemanticIterableDataset
    from ..device import resolve_device
    from ..models.config import DualARConfig
    from ..models.dual_ar import forward_train
    from ..text import load_tokenizer
    from ..utils.checkpoint import load_params

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoints", type=Path, nargs="+", required=True,
                   help="checkpoint dirs (native safetensors layout)")
    p.add_argument("--proto", type=Path, required=True,
                   help="a .protos shard to draw the eval sample from")
    p.add_argument("--tokenizer", type=Path, default=None)
    p.add_argument("--max-length", type=int, default=1024)
    p.add_argument("--output", type=Path,
                   default=Path("eval_in_context.tsv"))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    tokenizer = load_tokenizer(args.tokenizer)

    rows = ["checkpoint\tframe\tloss"]
    curves = {}
    for ckpt in args.checkpoints:
        params, cfg_dict = load_params(ckpt, device=dev)
        cfg = DualARConfig(**{k: v for k, v in (cfg_dict or {}).items()
                              if k in DualARConfig.__dataclass_fields__})
        ds = SemanticIterableDataset([str(args.proto)], tokenizer, seed=0,
                                     max_length=args.max_length,
                                     num_codebooks=cfg.num_codebooks)
        item = next(iter(ds))
        tokens = item["tokens"][:, :args.max_length].astype(np.int64)
        labels = item["labels"][:, :args.max_length].astype(np.int64)
        with torch.no_grad():
            out = forward_train(params, cfg,
                                torch.from_numpy(tokens[None]).to(dev),
                                labels=torch.from_numpy(labels[None]).to(dev),
                                remat=False)
        logits = out.codebook_logits[0].float().cpu().numpy()   # (T, K, C)
        per_frame = frame_losses(logits, tokens, labels, cfg)
        for t, v in enumerate(per_frame):
            if np.isfinite(v):
                rows.append(f"{ckpt.name}\t{t}\t{v:.4f}")
        curves[ckpt.name] = per_frame
        print(f"{ckpt}: mean in-context semantic loss "
              f"{np.nanmean(per_frame):.4f}")

    args.output.write_text("\n".join(rows))
    print(f"wrote {args.output}")
    return curves


if __name__ == "__main__":
    main()
