"""One rank of the multi-process tests of the port's parallel slice.

    python tests/torch_tp_worker.py mesh ADDR WORLD RANK DATA MODEL DIR
    python tests/torch_tp_worker.py plan ADDR WORLD RANK DIR

`mesh`: joins a gloo world of WORLD ranks on the CPU, builds the (DATA,
MODEL) mesh, and runs every case of DIR/cases.pt under it: "generate"
(greedy `generate` on the rank's parameter slices) or "batcher" (a greedy
`ContinuousBatcher` on them, its requests run to the end). Writes
DIR/rank{RANK}.npz with each case's codes.

`plan`: the two-process plan broadcast. The leader builds a TickPlan of
two assignments; every rank receives it through `broadcast_plan` and
applies it to a greedy batcher seeded alike; each writes its slot state
and results to DIR/plan{RANK}.npz.
"""

from __future__ import annotations

import os
import sys
from datetime import timedelta

import numpy as np
import torch

IM_END = 4


def _init(addr: str, world: int, rank: int) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))


def run_mesh(addr, world, rank, data, model, workdir) -> None:
    from fish_speech_tpu_torch.engine.scheduler import (ContinuousBatcher,
                                                        SlotRequest)
    from fish_speech_tpu_torch.models.decode import SamplingConfig, generate
    from fish_speech_tpu_torch.parallel.mesh import (MeshConfig, create_mesh,
                                                     shard_dual_ar_params)
    from fish_speech_tpu_torch.parallel.tp import decode_mesh

    _init(addr, world, rank)
    mesh = create_mesh(MeshConfig(data, model), backend="gloo", device="cpu")
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    out = {}
    for name, case in cases.items():
        local = shard_dual_ar_params(case["params"], mesh)
        cfg = case["cfg"]
        with decode_mesh(mesh):
            if case["kind"] == "generate":
                prompt = torch.from_numpy(case["prompt"])
                codes, _ = generate(
                    local, cfg, prompt,
                    torch.zeros(prompt.shape[0], dtype=torch.int32), None,
                    SamplingConfig.create(), case["bias"],
                    max_new_tokens=case["max_new"], im_end_id=IM_END,
                    greedy=True, cache_len=case["cache_len"], device="cpu")
                out[name] = codes.numpy()
            else:
                batcher = ContinuousBatcher(
                    local, cfg, num_slots=case["slots"],
                    cache_len=case["cache_len"], im_end_id=IM_END,
                    bias=case["bias"], greedy=True,
                    prompt_bucket=case["bucket"], device="cpu")
                res = batcher.run([SlotRequest(request_id=i, prompt=p,
                                               max_new_tokens=case["max_new"])
                                   for i, p in enumerate(case["prompts"])])
                for i, codes in res.items():
                    out[f"{name}_{i}"] = codes
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


def run_plan(addr, world, rank, workdir) -> None:
    from fish_speech_tpu_torch.engine.scheduler import (ContinuousBatcher,
                                                        SlotRequest)
    from fish_speech_tpu_torch.models.config import tiny_dual_ar_config
    from fish_speech_tpu_torch.models.init import init_dual_ar_params
    from fish_speech_tpu_torch.ops.sampling import semantic_logit_bias
    from fish_speech_tpu_torch.serve.multihost import (SlotAssignment,
                                                       TickPlan, apply_plan,
                                                       broadcast_plan)

    _init(addr, world, rank)
    cfg = tiny_dual_ar_config()
    params = init_dual_ar_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    bias = semantic_logit_bias(cfg.vocab_size, cfg.semantic_begin_id,
                               cfg.semantic_end_id, IM_END)
    batcher = ContinuousBatcher(params, cfg, num_slots=2, cache_len=64,
                                im_end_id=IM_END, bias=bias, greedy=True,
                                prompt_bucket=16, seed=3, device="cpu")
    plan = None
    if rank == 0:       # only the leader knows the requests
        rng = np.random.default_rng(7)
        k1 = cfg.num_codebooks + 1

        def prompt(t):
            p = rng.integers(0, 100, size=(k1, t)).astype(np.int32)
            p[1:] = rng.integers(0, cfg.codebook_size,
                                 size=(cfg.num_codebooks, t))
            return p

        reqs = [SlotRequest(request_id=i, prompt=prompt(6 + i),
                            max_new_tokens=8) for i in range(2)]
        plan = TickPlan(assignments=[
            SlotAssignment(slot=i, request_id=r.request_id, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens, temperature=0.7,
                           top_p=0.7) for i, r in enumerate(reqs)],
            n_ticks=8)
    plan = broadcast_plan(plan)
    registry: dict = {}
    apply_plan(batcher, plan, registry)
    dump = {k: getattr(batcher, k).numpy()
            for k in ("cur", "pos", "active", "prev_win")}
    for rid, req in registry.items():
        if req.result:
            dump[f"result_{rid}"] = np.stack(req.result, axis=1)
    np.savez(os.path.join(workdir, f"plan{rank}.npz"), **dump)


if __name__ == "__main__":
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "mesh":
        run_mesh(args[0], *map(int, args[1:5]), args[5])
    else:
        run_plan(args[0], int(args[1]), int(args[2]), args[3])
    import torch.distributed as dist

    dist.destroy_process_group()
