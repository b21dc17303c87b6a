"""Finetune the Dual-AR model (full or LoRA) on protobuf corpora, with
checkpoints and auto-resume, on one device or a (data, model) mesh.

    python -m fish_speech_tpu_torch.tools.train --proto-dir DIR
        [--checkpoint CKPT] [--lora] [--output-dir results] [--device cpu]
    torchrun --nproc-per-node N -m fish_speech_tpu_torch.tools.train
        --proto-dir DIR [--model-parallel M] [--data-parallel D]

Counterpart of `tools/train.py` (ref fish_speech/train.py +
configs/text2semantic_finetune.yaml), with its flags and `--device` (the
CUDA card unless named). Without `--checkpoint` it trains a tiny random
model; with one, the native layout (utils/checkpoint.py) in bf16. It
writes `step_%09d` checkpoints every `--checkpoint-every` steps and a
`_final` one: the LoRA factors alone (flat, no config) or the full
parameters with their config. On start it resumes from the newest
`step_*` checkpoint in the output directory: the weights (the factors
under `--lora`), not the optimizer's state, as the JAX CLI does.
Python's `random`, which the dataset samples from, is seeded with 42 (the
reference's `seed_everything`), so every run, and every rank, reads the
same batches.

Parallelism, as the JAX CLI's mesh: whenever the environment says
WORLD_SIZE > 1 (torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), every process joins that world and builds the (data,
model) mesh; `--multihost` requires that environment. `--data-parallel
0` means WORLD_SIZE // model. A mesh that does not cover the world, or a
batch size that the data axis does not divide, exits before anything
trains: the CLI never trains on one device instead. The backend is NCCL
when each local rank owns a card of its own, gloo when the local ranks
share one (an explicit `--device cuda:N`, or more ranks than cards) or
run on the CPU. Every rank reads the same global batch and keeps its data
rows (`shard_batch`); the weights are sharded by
`parallel.mesh.shard_dual_ar_params` (the LoRA factors stay whole);
only rank 0 logs and writes, a full checkpoint whole
(`unshard_dual_ar_params`). Resume loads the whole tree on every rank
and shards it.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

WORLD_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
DATA_SEED = 42     # python's `random`, as the reference's seed_everything


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
                   help="0 = auto (WORLD_SIZE // model-parallel)")
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--multihost", action="store_true",
                   help="require torchrun's environment (" +
                        ", ".join(WORLD_ENV) + ")")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card, a rank's "
                        "own under torchrun)")
    args = p.parse_args(argv)
    env = os.environ
    missing = [k for k in WORLD_ENV if k not in env]
    if args.multihost and missing:
        p.error("--multihost needs the world's environment, as torchrun "
                f"sets it; missing {', '.join(missing)}")
    args.world = int(env.get("WORLD_SIZE", "1"))
    args.rank = int(env.get("RANK", "0"))
    if args.world > 1 and missing:
        p.error(f"WORLD_SIZE={args.world} without {', '.join(missing)}")
    model = args.model_parallel
    data = args.data_parallel or args.world // max(model, 1)
    if model < 1 or data < 1 or data * model != args.world:
        p.error(f"the mesh (data {data}, model {model}) does not cover the "
                f"world of WORLD_SIZE={args.world} processes")
    if args.batch_size % data:
        p.error(f"--batch-size {args.batch_size} does not split over the "
                f"data axis of {data}")
    args.mesh_shape = (data, model)
    return args


def rank_device(device, env=os.environ):
    """(device, backend) of this rank: with no device named (or "cuda"),
    the card of its LOCAL_RANK and NCCL when the host's ranks each own a
    card, else a shared card and gloo; a named card is shared by the
    host's ranks (gloo, unless it is the only rank there); the CPU runs
    gloo."""
    import torch

    from ..device import resolve_device

    local_rank = int(env.get("LOCAL_RANK", env.get("RANK", "0")))
    local_world = int(env.get("LOCAL_WORLD_SIZE",
                              env.get("WORLD_SIZE", "1")))
    if device in (None, "cuda"):
        resolve_device(None)       # raises without a card
        n = torch.cuda.device_count()
        return (torch.device("cuda", local_rank % n),
                "nccl" if local_world <= n else "gloo")
    dev = resolve_device(device)
    if dev.type == "cuda" and local_world == 1:
        return dev, "nccl"
    return dev, "gloo"


def join_mesh(args):
    """(mesh, device): this rank's mesh after joining the world from the
    environment, or (None, the device) for a single process."""
    import torch

    from ..device import resolve_device
    from ..parallel.mesh import TIMEOUT, MeshConfig, create_mesh

    if args.world == 1:
        return None, resolve_device(args.device)
    import torch.distributed as dist

    dev, backend = rank_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://",
                            world_size=args.world, rank=args.rank,
                            timeout=TIMEOUT)
    data, model = args.mesh_shape
    return create_mesh(MeshConfig(data, model), backend=backend,
                       device=dev), dev


def main(argv=None) -> dict:
    """Train; returns {"cfg", "params" (the base), "state" (the trained
    tree: the factors under --lora), "history" (the logged metrics),
    "final" (the last checkpoint's path), "mesh" (None on one device)}.
    On a mesh "params" and a full finetune's "state" are the rank's
    slices."""
    import random

    import torch

    from ..data import SemanticIterableDataset, TextDataCollator, data_loader
    from ..models.config import DualARConfig
    from ..models.init import init_dual_ar_params
    from ..parallel.mesh import (shard_batch, shard_dual_ar_params,
                                 unshard_dual_ar_params)
    from ..text import load_tokenizer
    from ..train import (TrainBatch, cosine_warmup_schedule, make_optimizer,
                         make_train_step)
    from ..train.lora import (LoraConfig, init_lora_params,
                              make_lora_optimizer, make_lora_train_step)
    from ..utils.checkpoint import load_params, save_params
    from ..utils.file import get_latest_checkpoint

    args = parse_args(argv)
    mesh, dev = join_mesh(args)
    lead = args.rank == 0
    data, model = args.mesh_shape

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    say(f"mesh: data {data} x model {model}, " + (
        f"{args.world} ranks over {mesh.backend}, rank 0 on {dev}"
        if mesh is not None else f"one process on {dev}"))
    random.seed(DATA_SEED)
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
        say(f"auto-resumed from {latest} (step {start_step})")

    ds = SemanticIterableDataset([str(args.proto_dir)], tokenizer,
                                 max_length=args.max_length,
                                 num_codebooks=cfg.num_codebooks)
    loader = data_loader(ds, TextDataCollator(tokenizer, args.max_length),
                         args.batch_size)

    def shard(tree: dict) -> dict:
        return tree if mesh is None else shard_dual_ar_params(tree, mesh)

    if args.lora:
        lcfg = LoraConfig(r=args.lora_r, lora_alpha=args.lora_alpha)
        # the factors are drawn from the whole tree: whole on every rank
        state = resumed if resumed is not None else init_lora_params(
            torch.Generator(device=dev).manual_seed(1), params, lcfg)
        params = shard(params)
        optimizer = make_lora_optimizer(schedule)
        step_fn = make_lora_train_step(cfg, params, lcfg, optimizer,
                                       mesh=mesh)
    else:
        params = shard(resumed if resumed is not None else params)
        optimizer = make_optimizer(params, schedule,
                                   weight_decay=args.weight_decay)
        step_fn = make_train_step(cfg, optimizer, mesh=mesh)
        state = params
    del resumed
    opt_state = optimizer.init(state)

    def save(path: Path) -> None:
        """Rank 0 writes the whole tree (every rank gathers a full
        finetune's slices first)."""
        tree = state
        if mesh is not None and not args.lora:
            tree = unshard_dual_ar_params(state, mesh)
        if lead:
            save_params(path, tree, None if args.lora else cfg)

    history = []
    t0 = time.perf_counter()
    for step_idx in range(start_step, args.max_steps):
        batch = TrainBatch.from_numpy(next(loader), dev)
        if mesh is not None:
            batch = TrainBatch(*(shard_batch(x, mesh) for x in batch))
        state, opt_state, metrics = step_fn(state, opt_state, batch)

        if (step_idx + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step_idx + 1, **m})
            dt = time.perf_counter() - t0
            say(f"step {step_idx + 1}: loss={m['loss']:.4f} "
                f"base={m['base_loss']:.4f} sem={m['semantic_loss']:.4f} "
                f"top5={m['top_5_accuracy']:.3f} "
                f"gnorm={m['grad_norm']:.2f} "
                f"({args.log_every / dt:.2f} it/s)")
            t0 = time.perf_counter()

        if (step_idx + 1) % args.checkpoint_every == 0:
            ckpt = args.output_dir / f"step_{step_idx + 1:09d}"
            save(ckpt)
            say(f"saved {ckpt}")

    final = args.output_dir / f"step_{args.max_steps:09d}_final"
    save(final)
    say(f"saved final {final}")
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    return {"cfg": cfg, "params": params, "state": state,
            "history": history, "final": final, "mesh": mesh}


if __name__ == "__main__":
    main()
