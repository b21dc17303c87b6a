"""The port's parallel slice across processes, on the CPU over gloo.

- Decode under TP on a (data 2, model 2) mesh of four ranks: the port's
  greedy codes equal its TP=1 codes, for the configurations of
  tests/test_mesh.py (the plain model, the int8 serving path with the
  fused fast head, W4A8), and the ContinuousBatcher under TP and DP gives
  the TP=1 batcher's codes (the configuration of
  `__graft_entry__._dryrun_scheduler_tick`). The port's TP=1 codes equal
  the JAX package's single-device codes on the same weights, or part
  from them only at a near tie: where a row first parts, JAX's code is
  the port's runner-up and the port's two best logits lie within the
  tolerance to which tests/test_torch_lm.py holds the port's logits to
  JAX's (2e-2 absolute and relative: the int8 path's activations are
  bf16, summed in another order than JAX's).
- Training under the same (data 2, model 2) world, on the tiny
  configurations of `__graft_entry__.dryrun_multichip` (TP-divisible),
  the "wide" one (untied output, biases, q/k norms) and the naive head,
  in f32: each differentiable collective's gradient and the first step's
  gradients against the single-device ones; two full steps and two LoRA
  steps against the port's single-device steps and, for the dryrun
  configuration, against JAX's `make_train_step` /
  `make_lora_train_step` under a (2, 2) mesh of four of the test
  process's virtual devices (tests/test_torch_train.py and
  test_torch_naive.py hold the other two configurations' single-device
  losses and gradients to JAX's), on the same numpy weights and global
  batches of 4 (the two data halves hold different numbers of valid
  labels, so averaging the ranks' means would fail); the trees the
  same bit for bit on every rank; `unshard(shard(params))` the whole
  tree. The tolerances are tests/test_torch_train.py's.
- The vocoder over the data axis (`parallel.vocoder`): the tiny codec's
  data-split decode against the whole decode and against JAX's
  `dac_from_indices`.
- The two-process plan broadcast: every slot-state array and result is
  the same on both ranks (tests/test_multihost_2proc.py's counterpart).
- The two-process `--multihost` server: the leader answers /v1/tts with
  audio while the follower mirrors it, both logging the same codes.

One spawn a world (tests/torch_tp_worker.py) runs every scenario and
writes .npz files that the cases read; every process runs under a
timeout and is killed on its expiry. Codes are compared exactly.
"""

import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from fish_speech_tpu.codec import convert_dac_state_dict
from fish_speech_tpu.codec import tiny_codec_config as j_tiny_codec
from fish_speech_tpu.codec.model import dac_from_indices as j_dac
from fish_speech_tpu.models.config import tiny_dual_ar_config as j_tiny
from fish_speech_tpu.models.decode import SamplingConfig as JSampling
from fish_speech_tpu.models.decode import generate as j_generate
from fish_speech_tpu.models.init import init_dual_ar_params as j_init
from fish_speech_tpu.ops.fast_fused import enable_fused_fast_head as j_fused
from fish_speech_tpu.ops.quant import quantize_lm_params as j_quantize
from fish_speech_tpu.ops.sampling import semantic_logit_bias as j_bias
from fish_speech_tpu.parallel import mesh as jmesh
from fish_speech_tpu.train import lora as jlora
from fish_speech_tpu.train import scheduler as jsched
from fish_speech_tpu.train import step as jstep
from fish_speech_tpu_torch.codec.config import tiny_codec_config
from fish_speech_tpu_torch.codec.init import codec_params_from_jax
from fish_speech_tpu_torch.codec.model import dac_from_indices
from fish_speech_tpu_torch.engine.scheduler import (ContinuousBatcher,
                                                    SlotRequest)
from fish_speech_tpu_torch.models import decode as tdecode
from fish_speech_tpu_torch.models.config import DualARConfig
from fish_speech_tpu_torch.models.decode import SamplingConfig, generate
from fish_speech_tpu_torch.models.init import (init_dual_ar_params,
                                               lm_params_from_jax)
from fish_speech_tpu_torch.ops.fast_fused import enable_fused_fast_head
from fish_speech_tpu_torch.ops.quant import quantize_lm_params
from fish_speech_tpu_torch.ops.sampling import semantic_logit_bias
from fish_speech_tpu_torch.train import lora as tlora
from fish_speech_tpu_torch.train import scheduler as tsched
from fish_speech_tpu_torch.train import step as tstep

from test_torch_train import GRAD_RTOL, LOSS_RTOL, np_params

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_tp_worker.py"
IM_END = 4
SPAWN_TIMEOUT = 240
DATA, MODEL = 2, 2
MAX_NEW = 6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _start(argvs: list[list[str]]) -> list:
    return [subprocess.Popen([sys.executable, str(WORKER), *a], env=_env(),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for a in argvs]


def _spawn(argvs: list[list[str]], timeout: float) -> None:
    """Run one process per argv to its end; any that fails, or outlives
    `timeout`, fails the caller with every process's output."""
    _wait(_start(argvs), timeout)


def _wait(procs: list, timeout: float) -> None:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        raise AssertionError("a rank timed out:\n" + "\n".join(
            f"--- rank {r}\n{o[-2000:]}" for r, o in enumerate(outs)))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(f"--- rank {r} (exit {procs[r].returncode})\n"
                              f"{outs[r][-3000:]}" for r in bad)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_cfg(jcfg, **kw) -> DualARConfig:
    return DualARConfig(**{**dataclasses.asdict(jcfg), **kw})


def _prompt(cfg, t: int, rng) -> np.ndarray:
    """(K+1, T): text tokens, then semantic ones with codes (the JAX tests'
    random_lm_prompt)."""
    tokens = rng.integers(0, cfg.vocab_size, size=(t,))
    tokens[t // 2:] = rng.integers(cfg.semantic_begin_id,
                                   cfg.semantic_end_id + 1, size=(t - t // 2,))
    codes = rng.integers(0, cfg.codebook_size, size=(cfg.num_codebooks, t))
    codes[:, :t // 2] = 0
    return np.concatenate([tokens[None], codes]).astype(np.int32)


# the three decode configurations of tests/test_mesh.py; the fused fast
# head's plain twin takes heads of 32 (the TPU test's fast heads are 16)
_HEADS = dict(n_head=8, n_local_heads=4, dim=128, head_dim=16)
DECODE_CASES = {
    "plain": (dict(**_HEADS, fast_n_head=4, fast_n_local_heads=4,
                   fast_dim=64, fast_head_dim=16), None, False),
    "int8": (dict(**_HEADS, intermediate_size=256, max_seq_len=64,
                  fast_dim=64, fast_n_head=2, fast_n_local_heads=2,
                  fast_head_dim=32, fast_intermediate_size=192,
                  w8a8_matmuls=True, kv_cache_dtype="int8",
                  kv_cache_layout="pos", use_pallas_attention=True,
                  pallas_attn_block_rows=2, pallas_attn_stream=True,
                  pallas_attn_int8_scores=True, unroll_fast_sweeps=True),
             "int8", True),
    "w4a8": (dict(**_HEADS, fast_n_head=4, fast_n_local_heads=4,
                  fast_dim=64, fast_head_dim=16, w8a8_matmuls=True),
             "w4a8", False),
}
CACHE_LEN = 64


# the port's logits agree with JAX's to this on the int8 path
# (tests/test_torch_lm.py::test_serving_decode_step_matches_jax)
LOGIT_TOL = 2e-2


def _partings(want: np.ndarray, got: np.ndarray, logits: list,
              support: tuple) -> list:
    """Where `got` first parts from `want` in each batch row (frames in
    order, a frame's rows in sampling order), what the port sampled
    there: (row b, frame f, code row r, JAX's code, the port's runner-up,
    its top-2 logit gap, the tolerance at its top logit). logits: the
    (B, V) logits of every `_sample` call, K a frame: the token over the
    support (semantic ids, then im_end), whose code is row 1 too, then
    rows 2..K over the codebook."""
    sb, se, im = support
    k = want.shape[1] - 1
    out = []
    for b in range(want.shape[0]):
        diff = [(f, r) for f in range(want.shape[2]) for r in range(k + 1)
                if want[b, r, f] != got[b, r, f]]
        if not diff:
            continue
        f, r = diff[0]
        top = torch.topk(logits[f * k + max(r - 1, 0)][b].float(), 2)
        second = int(top.indices[1])
        if r <= 1:                 # the token: support index -> token id
            second = im if second == se - sb + 1 else second + sb
            r = 0
        v0, v1 = (float(v) for v in top.values)
        out.append((b, f, r, int(want[b, r, f]), second, v0 - v1,
                    LOGIT_TOL * (1 + abs(v0))))
    return out


def _decode_case(name: str, rng):
    fields, quant, fused = DECODE_CASES[name]
    jcfg = dataclasses.replace(j_tiny(), **fields)
    params = j_init(jax.random.key(0), jcfg)
    if quant is not None:
        params = j_quantize(params, mode=quant, groupsize=16)
    if fused:
        params = j_fused(params)
    prompt = np.stack([_prompt(jcfg, 12, rng) for _ in range(DATA)])
    bias = j_bias(jcfg.vocab_size, jcfg.semantic_begin_id,
                  jcfg.semantic_end_id, IM_END)
    codes, _ = j_generate(params, jcfg, jnp.asarray(prompt),
                          jnp.zeros((DATA,), jnp.int32), jax.random.key(0),
                          JSampling.create(), bias, max_new_tokens=MAX_NEW,
                          im_end_id=IM_END, greedy=True, cache_len=CACHE_LEN)
    tparams = lm_params_from_jax(_np(params), device="cpu")
    cfg = _torch_cfg(jcfg)
    tbias = torch.from_numpy(np.array(bias))
    logits = []
    sample = tdecode._sample

    def record(lg, *args, **kw):
        logits.append(lg.clone())
        return sample(lg, *args, **kw)

    tdecode._sample = record
    try:
        tp1, _ = generate(tparams, cfg, torch.from_numpy(prompt),
                          torch.zeros(DATA, dtype=torch.int32), None,
                          SamplingConfig.create(), tbias,
                          max_new_tokens=MAX_NEW, im_end_id=IM_END,
                          greedy=True, cache_len=CACHE_LEN, device="cpu")
    finally:
        tdecode._sample = sample
    case = dict(kind="generate", params=tparams,
                cfg=dataclasses.replace(cfg, tp_shards=MODEL), prompt=prompt,
                bias=tbias, max_new=MAX_NEW, cache_len=CACHE_LEN)
    support = (cfg.semantic_begin_id, cfg.semantic_end_id, IM_END)
    return case, _partings(np.asarray(codes), tp1.numpy(), logits,
                           support), tp1.numpy()


def _batcher_cfg(model: int) -> DualARConfig:
    """`__graft_entry__._dryrun_scheduler_tick`'s configuration (fast heads
    of 32, as above)."""
    base = DualARConfig(**dataclasses.asdict(j_tiny()))
    return dataclasses.replace(
        base, n_head=2 * model, n_local_heads=model, dim=16 * 2 * model,
        head_dim=16, intermediate_size=64, max_seq_len=64, fast_dim=64,
        fast_n_head=2, fast_n_local_heads=2, fast_head_dim=32,
        fast_intermediate_size=192, w8a8_matmuls=True,
        kv_cache_dtype="int8", kv_cache_layout="pos",
        use_pallas_attention=True, pallas_attn_block_rows=2,
        pallas_attn_stream=True, unroll_fast_sweeps=True)


def _batcher_case(rng):
    cfg = _batcher_cfg(MODEL)
    params = enable_fused_fast_head(quantize_lm_params(init_dual_ar_params(
        torch.Generator().manual_seed(0), cfg, device="cpu")))
    bias = semantic_logit_bias(cfg.vocab_size, cfg.semantic_begin_id,
                               cfg.semantic_end_id, IM_END)
    prompts = [np.concatenate([
        rng.integers(cfg.semantic_begin_id, cfg.semantic_end_id + 1, (1, t)),
        rng.integers(0, cfg.codebook_size, (cfg.num_codebooks, t)),
    ]).astype(np.int32) for t in (5, 7, 6, 9, 4)]
    slots = 2 * DATA
    single = ContinuousBatcher(params, cfg, num_slots=slots, cache_len=64,
                               im_end_id=IM_END, bias=bias, greedy=True,
                               prompt_bucket=8, device="cpu")
    tp1 = single.run([SlotRequest(request_id=i, prompt=p,
                                  max_new_tokens=MAX_NEW)
                      for i, p in enumerate(prompts)])
    case = dict(kind="batcher", params=params,
                cfg=dataclasses.replace(cfg, tp_shards=MODEL), slots=slots,
                prompts=prompts, bias=bias, max_new=MAX_NEW, cache_len=64,
                bucket=8)
    return case, tp1


# ---------------------------------------------------------------------------
# Training and the vocoder under the mesh
# ---------------------------------------------------------------------------

TRAIN_LR = 1e-2      # warm-up of 1: step 1 at LR 0, step 2 at LR
LORA_CFG = dict(r=4, lora_alpha=8.0)
METRICS = ("loss", "base_loss", "semantic_loss", "top_5_accuracy",
           "grad_norm")
TRAIN_B, TRAIN_T = 2 * DATA, 16


def _train_cfg(kind: str):
    cfg = j_tiny()
    if kind == "dryrun":      # __graft_entry__.dryrun_multichip's shapes
        return dataclasses.replace(
            cfg, n_head=8, n_local_heads=8, dim=64, head_dim=8,
            intermediate_size=128, fast_n_head=8, fast_n_local_heads=8,
            fast_dim=64, fast_head_dim=8, fast_intermediate_size=128)
    if kind == "wide":
        return dataclasses.replace(
            cfg, tie_word_embeddings=False, attention_qkv_bias=True,
            attention_o_bias=True, attention_qk_norm=True,
            scale_codebook_embeddings=True, norm_fastlayer_input=True)
    return dataclasses.replace(cfg, model_type="naive")


TRAIN_KINDS = ("dryrun", "wide", "naive")


def _train_batch(cfg, seed: int) -> dict:
    """A global batch of 4: text, then semantic tokens with codes; an
    ignored prefix, longer in rows 2-3 (the second data rank's), so the
    two halves hold different numbers of valid labels; a padded tail."""
    rng = np.random.default_rng(seed)
    b, t = TRAIN_B, TRAIN_T
    tokens = rng.integers(0, cfg.vocab_size, size=(b, 1, t))
    tokens[:, 0, t // 2:] = rng.integers(cfg.semantic_begin_id,
                                         cfg.semantic_end_id + 1,
                                         size=(b, t - t // 2))
    codes = rng.integers(0, cfg.codebook_size, size=(b, cfg.num_codebooks, t))
    inputs = np.concatenate([tokens, codes], axis=1).astype(np.int32)
    labels = inputs.copy()
    labels[:, :, :t // 4] = -100
    labels[b // 2:, :, :t // 2 + 2] = -100
    labels[0, 1:, t - 5] = 0           # a codebook pad label
    masks = np.zeros((b, t), dtype=bool)
    masks[0, -3:] = True
    return {"inputs": inputs, "labels": labels, "attention_masks": masks}


def _np_lora(jcfg, tree) -> dict:
    """JAX's factors as numpy, b drawn too (with b = 0 the first step
    gives a no gradient)."""
    lora = jax.tree.map(np.asarray, jlora.init_lora_params(
        jax.random.key(1), jax.tree.map(jnp.asarray, tree),
        jlora.LoraConfig(**LORA_CFG)))
    rng = np.random.default_rng(1)
    for v in lora.values():
        v["b"] = (0.02 * rng.normal(size=v["b"].shape)).astype(np.float32)
    return lora


def _flat(tree, prefix: str) -> dict:
    return {f"{prefix}/{'/'.join(p)}": np.asarray(
        v.detach() if isinstance(v, torch.Tensor) else v)
        for p, v in tstep.tree_leaves(tree)}


def _train_inputs(kind: str):
    jcfg = _train_cfg(kind)
    tree = np_params(jcfg)
    lora = _np_lora(jcfg, tree)
    batches = [_train_batch(jcfg, seed) for seed in (0, 1)]
    case = dict(kind="train", cfg=_torch_cfg(jcfg),
                params=lm_params_from_jax(tree, device="cpu"),
                lora=tlora.lora_params_from_jax(lora, "cpu"),
                batches=batches, lr=TRAIN_LR, lora_cfg=LORA_CFG)
    return case, (jcfg, tree, lora, batches)


def _port_single(case) -> dict:
    """The port's single-device gradients and steps on the case."""
    def fresh():
        return _clone(case["params"])

    def batch(b):
        return tstep.TrainBatch.from_numpy(b, "cpu")

    cfg = case["cfg"]
    out = {}
    m, g = tstep.dual_ar_grads(fresh(), cfg, batch(case["batches"][0]))
    out.update(_flat(g, "grad"))
    out["grad_metrics"] = np.array([float(m[k]) for k in METRICS[:-1]])
    sched = tsched.cosine_warmup_schedule(TRAIN_LR, 1, 10)
    params = fresh()
    opt = tstep.make_optimizer(params, sched)
    fn, state, rows = tstep.make_train_step(cfg, opt), opt.init(params), []
    for b in case["batches"]:
        params, state, m = fn(params, state, batch(b))
        rows.append([float(m[k]) for k in METRICS])
    out["full_metrics"] = np.array(rows)
    out.update(_flat(params, "full"))
    lora = _clone(case["lora"])
    opt = tlora.make_lora_optimizer(sched)
    fn = tlora.make_lora_train_step(cfg, fresh(), tlora.LoraConfig(
        **LORA_CFG), opt)
    state, rows = opt.init(lora), []
    for b in case["batches"]:
        lora, state, m = fn(lora, state, batch(b))
        rows.append([float(m[k]) for k in METRICS])
    out["lora_metrics"] = np.array(rows)
    out.update(_flat(lora, "lora"))
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _jax_meshed(jcfg, tree, lora, batches) -> dict:
    """JAX's two full steps and two LoRA steps with the params sharded on
    a (2, 2) mesh of four virtual devices and the batch on P(DATA)."""
    mesh = jmesh.create_mesh(jmesh.MeshConfig(DATA, MODEL),
                             devices=jax.devices()[:DATA * MODEL])
    sched = jsched.cosine_warmup_schedule(TRAIN_LR, 1, 10)
    on_data = NamedSharding(mesh, P(jmesh.DATA_AXIS))
    out = {}
    with jax.sharding.set_mesh(mesh):
        def batch(b):
            return jstep.TrainBatch(**{k: jax.device_put(v, on_data)
                                       for k, v in b.items()})

        params = jmesh.shard_dual_ar_params(
            jax.tree.map(jnp.asarray, tree), mesh)
        opt = jstep.make_optimizer(params, sched)
        state, fn, rows = opt.init(params), jstep.make_train_step(jcfg,
                                                                  opt), []
        for b in batches:
            params, state, m = fn(params, state, batch(b))
            rows.append([float(m[k]) for k in METRICS])
        out["full_metrics"] = np.array(rows)
        out.update(_flat(jax.tree.map(np.asarray, params), "full"))

        base = jmesh.shard_dual_ar_params(jax.tree.map(jnp.asarray, tree),
                                          mesh)
        factors = jax.device_put(jax.tree.map(jnp.asarray, lora),
                                 NamedSharding(mesh, P()))
        opt = optax.chain(optax.clip_by_global_norm(1.0),
                          optax.adamw(sched, b1=0.9, b2=0.95))
        fn = jlora.make_lora_train_step(jcfg, base,
                                        jlora.LoraConfig(**LORA_CFG), opt)
        state, rows = opt.init(factors), []
        for b in batches:
            factors, state, m = fn(factors, state, batch(b))
            rows.append([float(m[k]) for k in METRICS])
        out["lora_metrics"] = np.array(rows)
        out.update({f"lora/{k}/{n}": np.asarray(v[n])
                    for k, v in factors.items() for n in ("a", "b")})
    return out


def _collective_case(rng) -> dict:
    """Inputs of the collective checks: x whole; per-rank parts and
    halves; weights c; masks choosing columns across both halves (a
    rank-partial consumer of the gathered columns)."""
    rows, cols = 3, 8
    masks = np.zeros((MODEL, rows, cols), np.float32)
    for r in range(MODEL):
        masks[r][:, r::MODEL] = 1.0
    return dict(kind="collectives",
                x=rng.normal(size=(rows, cols)).astype(np.float32),
                parts=rng.normal(size=(MODEL, rows, cols)).astype(np.float32),
                halves=rng.normal(size=(MODEL, rows, cols // MODEL)
                                  ).astype(np.float32),
                c=rng.normal(size=(MODEL, rows, cols)).astype(np.float32),
                masks=masks)


def _collective_want(case) -> dict:
    """The single-device gradients of the same losses, summed over the
    ranks' terms (the loss a model group computes is one term a rank)."""
    c, want = case["c"], {}
    want["copy"] = c.sum(0)
    y = case["parts"].sum(0)
    want["reduce"] = np.broadcast_to(2 * y * c[0], (MODEL, *y.shape))
    y = np.concatenate(list(case["halves"]), axis=-1)
    gr = 2 * y * c[0]
    gp = 2 * y * c[0] * case["masks"].sum(0)
    want["gather_for_replicated"] = np.stack(np.split(gr, MODEL, axis=-1))
    want["gather_for_partial"] = np.stack(np.split(gp, MODEL, axis=-1))
    return want


def _golden_codec() -> dict:
    """The tiny codec's JAX tree from the reference golden's state dict."""
    golden = np.load(ROOT / "tests" / "goldens" / "codec_tiny.npz")
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("sd:")}
    return jax.tree.map(np.asarray, convert_dac_state_dict(
        sd, j_tiny_codec()))


def _vocoder_codes() -> np.ndarray:
    """The vocoder case's (4, K+1, 12) codes."""
    return np.random.default_rng(11).integers(
        0, 16, (2 * DATA, tiny_codec_config().rvq.total_codebooks, 12))


JAX_MESHED = ("dryrun",)   # the configurations held to JAX's meshed steps
JAX_REFS = (*JAX_MESHED, "vocoder")


def jax_references(kind: str, out: Path) -> None:
    """JAX's side of one check into an .npz: a training configuration's
    meshed steps (`_jax_meshed`), or "vocoder": `dac_from_indices` of the
    golden codec on the vocoder case's codes. Run as `python
    tests/test_torch_tp.py KIND OUT` by `mesh_run`, one process a check
    beside its other work: JAX's compiles are most of the fixture's
    time."""
    if kind == "vocoder":
        wav = j_dac(jax.tree.map(jnp.asarray, _golden_codec()),
                    j_tiny_codec(), jnp.asarray(_vocoder_codes()))
        np.savez(out, wav=np.asarray(wav))
    else:
        np.savez(out, **_jax_meshed(*_train_inputs(kind)[1]))


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every scenario of the (data 2, model 2) world, run once; the
    single-device and JAX references are computed while it runs (JAX's
    meshed steps in a process of their own, started first)."""
    d = tmp_path_factory.mktemp("tp_mesh")
    jax_refs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), kind,
         str(d / f"jax_{kind}.npz")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for kind in JAX_REFS]
    rng = np.random.default_rng(7)
    cases, ties, want_tp1 = {}, {}, {}
    for name in DECODE_CASES:
        cases[name], ties[name], want_tp1[name] = _decode_case(name, rng)
    cases["batcher"], batcher_tp1 = _batcher_case(rng)
    train_inputs = {}
    for kind in TRAIN_KINDS:
        cases[f"train_{kind}"], train_inputs[kind] = _train_inputs(kind)
    cases["collectives"] = _collective_case(rng)
    codec = codec_params_from_jax(_golden_codec(), device="cpu")
    codes = _vocoder_codes()
    cases["vocoder"] = dict(kind="vocoder", params=codec,
                            cfg=tiny_codec_config(), codes=codes)
    torch.save(cases, d / "cases.pt")
    addr = f"127.0.0.1:{_free_port()}"
    world = DATA * MODEL
    procs = _start([["mesh", addr, str(world), str(r), str(DATA),
                     str(MODEL), str(d)] for r in range(world)])
    try:
        single = {k: _port_single(cases[f"train_{k}"]) for k in TRAIN_KINDS}
        whole = dac_from_indices(codec, tiny_codec_config(),
                                 torch.from_numpy(codes)).numpy()
    finally:
        _wait(procs, SPAWN_TIMEOUT)
        _wait(jax_refs, SPAWN_TIMEOUT)
    jax_mesh = {kind: dict(np.load(d / f"jax_{kind}.npz"))
                for kind in JAX_REFS}
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]
    return dict(ties=ties, tp1=want_tp1, batcher_tp1=batcher_tp1,
                ranks=ranks, single=single, jax_mesh=jax_mesh,
                batches={k: v[3] for k, v in train_inputs.items()},
                collectives=_collective_want(cases["collectives"]),
                whole_wav=whole, jax_wav=jax_mesh.pop("vocoder")["wav"])


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_tp_decode_matches_single_device(mesh_run, name):
    """TP x DP (2 x 2) greedy codes on every rank == the port's TP=1
    codes; those equal the JAX package's single-device codes on the same
    weights, or part from them only at a near tie (`_partings`)."""
    for b, f, r, jax_code, second, gap, tol in mesh_run["ties"][name]:
        where = f"row {b} parts from JAX at frame {f}, code row {r}"
        assert jax_code == second, f"{where}: JAX's {jax_code} is not the " \
            f"port's runner-up {second}"
        assert gap <= tol, f"{where}: top-2 gap {gap} > {tol}"
    for r, got in enumerate(mesh_run["ranks"]):
        np.testing.assert_array_equal(got[name], mesh_run["tp1"][name],
                                      err_msg=f"rank {r}")


def test_tp_batcher_matches_single_device(mesh_run):
    """The ContinuousBatcher under TP x DP (its 4 slots split over the two
    data ranks) gives every request the TP=1 batcher's codes, on every
    rank."""
    want = mesh_run["batcher_tp1"]
    assert all(v.shape[1] > 0 for v in want.values())
    for r, got in enumerate(mesh_run["ranks"]):
        for i, codes in want.items():
            np.testing.assert_array_equal(got[f"batcher_{i}"], codes,
                                          err_msg=f"rank {r} request {i}")


def test_two_process_plan_broadcast(tmp_path):
    """The leader's TickPlan reaches the follower through broadcast_plan;
    both apply it to batchers seeded alike: every slot-state array and
    every result is the same on the two ranks."""
    addr = f"127.0.0.1:{_free_port()}"
    _spawn([["plan", addr, "2", str(r), str(tmp_path)] for r in range(2)],
           SPAWN_TIMEOUT)
    a = np.load(tmp_path / "plan0.npz")
    b = np.load(tmp_path / "plan1.npz")
    assert set(a.files) == set(b.files)
    assert any(k.startswith("result_") for k in a.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_process_multihost_server(tmp_path):
    """`tools.api_server --multihost` as leader and follower on the CPU:
    one /v1/tts to the leader returns audio; the follower mirrors every
    plan and, once the leader stops, exits cleanly with the same codes
    logged for every request (the warm-up's and the request's)."""
    coord = f"127.0.0.1:{_free_port()}"
    log = tmp_path / "codes"

    def launch(pid):
        return subprocess.Popen(
            [sys.executable, "-m", "fish_speech_tpu_torch.tools.api_server",
             "--device", "cpu", "--multihost", "--coordinator", coord,
             "--num-processes", "2", "--process-id", str(pid),
             "--scheduler-slots", "2", "--cache-len", "512",
             "--listen", "127.0.0.1:0", "--codes-log", str(log),
             "--references-dir", str(tmp_path / "refs")],
            cwd=tmp_path, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    procs = [launch(0), launch(1)]
    try:
        line = ""
        while "serving on" not in line:
            line = procs[0].stdout.readline()
            assert line, "the leader exited before serving"
        m = re.search(r"http://127\.0\.0\.1:(\d+),", line)
        req = urllib.request.Request(
            f"http://127.0.0.1:{m.group(1)}/v1/tts",
            data=json.dumps({"text": "hello multihost",
                             "max_new_tokens": 8}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read()
        assert body[:4] == b"RIFF" and len(body) > 44
        assert procs[1].poll() is None       # the follower still mirrors
        procs[0].send_signal(signal.SIGINT)  # the leader's shutdown plan
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0, 0], outs
    logs = [[json.loads(x) for x in Path(f"{log}.{r}").read_text()
             .splitlines()] for r in range(2)]
    assert len(logs[0]) == 2 and all(e["codes"] for e in logs[0])
    assert logs[0] == logs[1]


def _close(got: dict, want: dict, prefix: str, what: str, atol_of) -> None:
    keys = sorted(k for k in want if k.startswith(prefix + "/"))
    assert keys and keys == sorted(k for k in got
                                   if k.startswith(prefix + "/")), what
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=atol_of(want[k]), err_msg=f"{what} {k}")


def _leaf_scale(w) -> float:
    """1e-5 of a leaf's largest entry (test_torch_train.py's gradient
    tolerance)."""
    return GRAD_RTOL * max(float(np.abs(w).max()), 1e-30)


def _step_tol(w) -> float:
    """A parameter after the Adam steps: an Adam step moves a weight by ~LR
    whatever the size of its gradient, so a gradient's relative f32
    sum-order difference reaches the step whole. Most leaves agree within
    test_torch_train.py's 2e-4 of LR; an entry whose gradients are
    near-cancelling sums does not: "wide"'s fast_embeddings[63, 23] has a
    step-1 gradient of -1.18e-7 against its leaf's largest 0.071 (every
    gradient leaf agrees to 5.5e-7 of its largest), and its step parts by
    5.6e-4 of LR. Hence 1e-3 of LR, a thousandth of a step."""
    return 1e-3 * TRAIN_LR


@pytest.mark.parametrize("kind", TRAIN_KINDS)
def test_tp_train_batch_halves_differ(mesh_run, kind):
    """The global batches' two data halves hold different numbers of valid
    labels (token and codebook), so the ranks' means differ from the
    global mean."""
    for b in mesh_run["batches"][kind]:
        valid = (b["labels"] != -100).reshape(DATA, -1).sum(1)
        assert valid[0] != valid[1]


@pytest.mark.parametrize("kind", TRAIN_KINDS)
def test_tp_train_grads_match_single_device(mesh_run, kind):
    """The first step's gradients under the (2, 2) mesh, gathered whole,
    against the single-device gradients (every leaf, 1e-5 of its largest
    entry), the metrics to 1e-5; the same bits on every rank (the
    replicated leaves' gradients equal across the model ranks)."""
    want = mesh_run["single"][kind]
    for r, rank in enumerate(mesh_run["ranks"]):
        got = {k.split("/", 1)[1]: v for k, v in rank.items()
               if k.startswith(f"train_{kind}/")}
        np.testing.assert_allclose(got["grad_metrics"], want["grad_metrics"],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
        _close(got, want, "grad", f"rank {r}", _leaf_scale)
    first = mesh_run["ranks"][0]
    for r, rank in enumerate(mesh_run["ranks"][1:], 1):
        for k, v in first.items():
            if k.startswith(f"train_{kind}/grad/"):
                np.testing.assert_array_equal(rank[k], v,
                                              err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("part", ["full", "lora"])
@pytest.mark.parametrize("kind", TRAIN_KINDS)
def test_tp_train_steps_match(mesh_run, kind, part):
    """Two full (or LoRA) steps under the (2, 2) mesh against the port's
    single-device steps and (dryrun) JAX's meshed steps: the loss, its metrics and
    grad_norm of each step to 1e-5, every parameter (or factor) after
    them within test_torch_train.py's Adam-step tolerance; every rank
    holds the same bits."""
    refs = ("single", "jax_mesh") if kind in JAX_MESHED else ("single",)
    first = None
    for r, rank in enumerate(mesh_run["ranks"]):
        got = {k.split("/", 1)[1]: v for k, v in rank.items()
               if k.startswith(f"train_{kind}/")}
        for ref in refs:
            want = mesh_run[ref][kind]
            np.testing.assert_allclose(
                got[f"{part}_metrics"], want[f"{part}_metrics"],
                rtol=LOSS_RTOL, err_msg=f"rank {r} against {ref}")
            _close(got, want, part, f"rank {r} against {ref}", _step_tol)
        if first is None:
            first = got
        for k, v in got.items():
            if k.startswith(part + "/"):
                np.testing.assert_array_equal(v, first[k],
                                              err_msg=f"rank {r} {k}")


def test_tp_unshard_inverts_shard(mesh_run):
    """`unshard_dual_ar_params(shard_dual_ar_params(p))` is `p` bit for
    bit, on every rank, for every training configuration."""
    for r, rank in enumerate(mesh_run["ranks"]):
        for kind in TRAIN_KINDS:
            assert bool(rank[f"train_{kind}/unshard_equal"]), (r, kind)


@pytest.mark.parametrize("op", ["copy", "reduce", "gather_for_replicated",
                                "gather_for_partial"])
def test_tp_collective_gradients(mesh_run, op):
    """Each differentiable collective's backward over the model group: the
    gradient reaching a rank's input equals the single-device gradient of
    the summed loss (copy: the ranks' weights summed; reduce: the whole
    gradient on every rank; the gathers: the rank's slice of the
    replicated consumer's gradient, or of the partial consumers' summed
    gradient)."""
    want = mesh_run["collectives"][op]
    for r, rank in enumerate(mesh_run["ranks"]):
        m = r % MODEL
        w = want if op == "copy" else want[m]
        np.testing.assert_allclose(rank[f"collectives/{op}"], w, rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {r}")


def test_tp_vocoder_data_split(mesh_run):
    """`parallel.vocoder.decode_data_parallel` on the (2, 2) mesh: each
    data rank decodes its two rows of the tiny codec's code batch and the
    gathered waveform equals the whole decode (1e-6) and JAX's
    `dac_from_indices` (the codec parity tolerance, f32)."""
    for r, rank in enumerate(mesh_run["ranks"]):
        wav = rank["vocoder/wav"]
        assert wav.shape == mesh_run["whole_wav"].shape
        np.testing.assert_allclose(wav, mesh_run["whole_wav"], rtol=0,
                                   atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(wav, mesh_run["jax_wav"], atol=2e-4,
                                   rtol=1e-3, err_msg=f"rank {r}")


if __name__ == "__main__":   # python tests/test_torch_tp.py KIND OUT.npz
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    jax_references(sys.argv[1], Path(sys.argv[2]))
