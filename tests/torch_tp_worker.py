"""One rank of the multi-process tests of the port's parallel slice.

    python tests/torch_tp_worker.py mesh ADDR WORLD RANK DATA MODEL DIR
    python tests/torch_tp_worker.py plan ADDR WORLD RANK DIR

`mesh`: joins a gloo world of WORLD ranks on the CPU, builds the (DATA,
MODEL) mesh, and runs every case of DIR/cases.pt under it: "generate"
(greedy `generate` on the rank's parameter slices), "batcher" (a greedy
`ContinuousBatcher` on them, its requests run to the end), "train" (the
first step's gradients, two full steps and two LoRA steps on the rank's
slices and data rows, `unshard_dual_ar_params` of the slices),
"collectives" (each differentiable collective's gradient) or "vocoder"
(`parallel.vocoder.decode_data_parallel`). Writes DIR/rank{RANK}.npz
with each case's results.

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
        if case["kind"] in SCENARIOS:
            for k, v in SCENARIOS[case["kind"]](case, mesh).items():
                out[f"{name}/{k}"] = v
            continue
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


def _flat(tree: dict, prefix: str) -> dict:
    from fish_speech_tpu_torch.train.step import tree_leaves

    return {f"{prefix}/{'/'.join(p)}": v.detach().numpy()
            for p, v in tree_leaves(tree)}


def _train(case, mesh) -> dict:
    """The first step's gradients (gathered whole), the metrics of two
    full steps and two LoRA steps and the trees after them (whole), from
    the whole tree and global batches of the case."""
    from fish_speech_tpu_torch.parallel.mesh import (shard_batch,
                                                     shard_dual_ar_params,
                                                     unshard_dual_ar_params)
    from fish_speech_tpu_torch.train import lora as tl
    from fish_speech_tpu_torch.train import step as ts
    from fish_speech_tpu_torch.train.scheduler import cosine_warmup_schedule

    cfg, whole = case["cfg"], case["params"]

    def batch(b):
        return ts.TrainBatch(*(shard_batch(torch.from_numpy(b[k]), mesh)
                               for k in ts.TrainBatch._fields))

    def fresh():
        return shard_dual_ar_params(_clone(whole), mesh)

    out = {}
    back = unshard_dual_ar_params(shard_dual_ar_params(whole, mesh), mesh)
    out["unshard_equal"] = np.array(all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            ts.tree_leaves(back), ts.tree_leaves(whole))))
    metrics, grads = ts.dual_ar_grads(fresh(), cfg, batch(case["batches"][0]),
                                      remat=True, mesh=mesh)
    out.update(_flat(unshard_dual_ar_params(grads, mesh), "grad"))
    out["grad_metrics"] = np.array([float(metrics[k]) for k in METRICS[:-1]])

    sched = cosine_warmup_schedule(case["lr"], 1, 10)
    params = fresh()
    opt = ts.make_optimizer(params, sched)
    fn = ts.make_train_step(cfg, opt, remat=True, mesh=mesh)
    state, rows = opt.init(params), []
    for b in case["batches"]:
        params, state, m = fn(params, state, batch(b))
        rows.append([float(m[k]) for k in METRICS])
    out["full_metrics"] = np.array(rows)
    out.update(_flat(unshard_dual_ar_params(params, mesh), "full"))

    lcfg = tl.LoraConfig(**case["lora_cfg"])
    lora = _clone(case["lora"])
    opt = tl.make_lora_optimizer(sched)
    fn = tl.make_lora_train_step(cfg, fresh(), lcfg, opt, remat=True,
                                 mesh=mesh)
    state, rows = opt.init(lora), []
    for b in case["batches"]:
        lora, state, m = fn(lora, state, batch(b))
        rows.append([float(m[k]) for k in METRICS])
    out["lora_metrics"] = np.array(rows)
    out.update(_flat(lora, "lora"))
    return out


METRICS = ("loss", "base_loss", "semantic_loss", "top_5_accuracy",
           "grad_norm")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _collectives(case, mesh) -> dict:
    """Each differentiable collective over the model group on the case's
    inputs: the gradient that reaches this rank's input."""
    from fish_speech_tpu_torch.parallel import collectives as col

    g, r = mesh.model_group, mesh.model_index
    c = torch.from_numpy(case["c"])                # (model, rows, cols)
    out = {}

    def leaf(a):
        return torch.from_numpy(a).clone().requires_grad_(True)

    x = leaf(case["x"])
    (col.copy_to_group(x, g) * c[r]).sum().backward()
    out["copy"] = x.grad.numpy()
    p = leaf(case["parts"][r])
    y = col.reduce_from_group(p, g)
    (y * y * c[0]).sum().backward()
    out["reduce"] = p.grad.numpy()
    for op in ("gather_for_replicated", "gather_for_partial"):
        p = leaf(case["halves"][r])
        y = getattr(col, op)(p, g, dim=-1)
        w = c[0] if op == "gather_for_replicated" else \
            c[0] * torch.from_numpy(case["masks"][r])
        (y * y * w).sum().backward()
        out[op] = p.grad.numpy()
    return out


def _vocoder(case, mesh) -> dict:
    from fish_speech_tpu_torch.parallel.vocoder import decode_data_parallel

    wav = decode_data_parallel(case["params"], case["cfg"],
                               torch.from_numpy(case["codes"]), mesh)
    return {"wav": wav.numpy()}


SCENARIOS = {"train": _train, "collectives": _collectives,
             "vocoder": _vocoder}


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
