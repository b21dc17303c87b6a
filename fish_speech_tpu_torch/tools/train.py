"""Finetune the Dual-AR model (full or LoRA) on protobuf corpora, with
checkpoints and auto-resume, on one device.

    python -m fish_speech_tpu_torch.tools.train --proto-dir DIR
        [--checkpoint CKPT] [--lora] [--output-dir results] [--device cpu]

Counterpart of `tools/train.py` (ref fish_speech/train.py +
configs/text2semantic_finetune.yaml), with its flags and `--device` (the
CUDA card unless named). Without `--checkpoint` it trains a tiny random
model; with one, the native layout (utils/checkpoint.py) in bf16. It
writes `step_%09d` checkpoints every `--checkpoint-every` steps and a
`_final` one: the LoRA factors alone (flat, no config) or the full
parameters with their config. On start it resumes from the newest
`step_*` checkpoint in the output directory: the weights (the factors
under `--lora`), not the optimizer's state, as the JAX CLI does.
Data and tensor parallelism (`--data-parallel` above 1, `--model-parallel`
above 1, `--multihost`) are not ported: those flags raise.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--proto-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, default=Path("results"))
    p.add_argument("--checkpoint", type=Path, default=None,
                   help="base checkpoint (native layout); random tiny if "
                        "absent")
    p.add_argument("--tokenizer", type=Path, default=None)
    p.add_argument("--lora", action="store_true")
    p.add_argument("--lora-r", type=int, default=8)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--max-steps", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-length", type=int, default=4096)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--checkpoint-every", type=int, default=5000)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--data-parallel", type=int, default=0,
                   help="0 or 1: one device (more waits for A8, ROADMAP.md)")
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    for flag, bad in (("--data-parallel", args.data_parallel not in (0, 1)),
                      ("--model-parallel", args.model_parallel != 1),
                      ("--multihost", args.multihost)):
        if bad:
            p.error(f"{flag}: data and tensor parallelism are not ported; "
                    "this waits for A8 (ROADMAP.md)")
    return args


def main(argv=None) -> dict:
    """Train; returns {"cfg", "params" (the base), "state" (the trained
    tree: the factors under --lora), "history" (the logged metrics),
    "final" (the last checkpoint's path)}."""
    import torch

    from ..data import SemanticIterableDataset, TextDataCollator, data_loader
    from ..device import resolve_device
    from ..models.config import DualARConfig
    from ..models.init import init_dual_ar_params
    from ..text import load_tokenizer
    from ..train import (TrainBatch, cosine_warmup_schedule, make_optimizer,
                         make_train_step)
    from ..train.lora import (LoraConfig, init_lora_params,
                              make_lora_optimizer, make_lora_train_step)
    from ..utils.checkpoint import load_params, save_params
    from ..utils.file import get_latest_checkpoint

    args = parse_args(argv)
    dev = resolve_device(args.device)
    tokenizer = load_tokenizer(args.tokenizer)

    if args.checkpoint:
        params, cfg_dict = load_params(args.checkpoint, dtype=torch.bfloat16,
                                       device=dev)
        cfg = DualARConfig(**{k: v for k, v in cfg_dict.items()
                              if k in DualARConfig.__dataclass_fields__})
    else:
        cfg = DualARConfig(
            vocab_size=tokenizer.vocab_size, n_layer=4, n_head=4,
            n_local_heads=4, dim=128, head_dim=32, intermediate_size=256,
            max_seq_len=args.max_length, codebook_size=64, num_codebooks=4,
            semantic_begin_id=tokenizer.semantic_begin_id,
            semantic_end_id=tokenizer.semantic_end_id,
            n_fast_layer=2, fast_dim=128)
        params = init_dual_ar_params(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev)

    schedule = cosine_warmup_schedule(args.lr, args.warmup_steps,
                                      args.max_steps)

    start_step, resumed = 0, None
    args.output_dir.mkdir(parents=True, exist_ok=True)
    latest = get_latest_checkpoint(args.output_dir, "step_*")
    if latest is not None:
        resumed, _ = load_params(latest, device=dev)
        start_step = int(latest.name.split("_")[1])
        print(f"auto-resumed from {latest} (step {start_step})", flush=True)

    ds = SemanticIterableDataset([str(args.proto_dir)], tokenizer,
                                 max_length=args.max_length,
                                 num_codebooks=cfg.num_codebooks)
    loader = data_loader(ds, TextDataCollator(tokenizer, args.max_length),
                         args.batch_size)

    if args.lora:
        lcfg = LoraConfig(r=args.lora_r, lora_alpha=args.lora_alpha)
        state = resumed if resumed is not None else init_lora_params(
            torch.Generator(device=dev).manual_seed(1), params, lcfg)
        optimizer = make_lora_optimizer(schedule)
        step_fn = make_lora_train_step(cfg, params, lcfg, optimizer)
    else:
        if resumed is not None:
            params = resumed
        optimizer = make_optimizer(params, schedule,
                                   weight_decay=args.weight_decay)
        step_fn = make_train_step(cfg, optimizer)
        state = params
    opt_state = optimizer.init(state)

    def save(path: Path) -> None:
        save_params(path, state, None if args.lora else cfg)

    history = []
    t0 = time.perf_counter()
    for step_idx in range(start_step, args.max_steps):
        batch = TrainBatch.from_numpy(next(loader), dev)
        state, opt_state, metrics = step_fn(state, opt_state, batch)

        if (step_idx + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step_idx + 1, **m})
            dt = time.perf_counter() - t0
            print(f"step {step_idx + 1}: loss={m['loss']:.4f} "
                  f"base={m['base_loss']:.4f} sem={m['semantic_loss']:.4f} "
                  f"top5={m['top_5_accuracy']:.3f} "
                  f"gnorm={m['grad_norm']:.2f} "
                  f"({args.log_every / dt:.2f} it/s)", flush=True)
            t0 = time.perf_counter()

        if (step_idx + 1) % args.checkpoint_every == 0:
            ckpt = args.output_dir / f"step_{step_idx + 1:09d}"
            save(ckpt)
            print(f"saved {ckpt}", flush=True)

    final = args.output_dir / f"step_{args.max_steps:09d}_final"
    save(final)
    print(f"saved final {final}", flush=True)
    return {"cfg": cfg, "params": params, "state": state,
            "history": history, "final": final}


if __name__ == "__main__":
    main()
