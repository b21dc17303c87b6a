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

from fish_speech_tpu.models.config import tiny_dual_ar_config as j_tiny
from fish_speech_tpu.models.decode import SamplingConfig as JSampling
from fish_speech_tpu.models.decode import generate as j_generate
from fish_speech_tpu.models.init import init_dual_ar_params as j_init
from fish_speech_tpu.ops.fast_fused import enable_fused_fast_head as j_fused
from fish_speech_tpu.ops.quant import quantize_lm_params as j_quantize
from fish_speech_tpu.ops.sampling import semantic_logit_bias as j_bias
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


def _spawn(argvs: list[list[str]], timeout: float) -> None:
    """Run one process per argv to its end; any that fails, or outlives
    `timeout`, fails the caller with every process's output."""
    procs = [subprocess.Popen([sys.executable, str(WORKER), *a], env=_env(),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
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


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every scenario of the (data 2, model 2) world, run once."""
    d = tmp_path_factory.mktemp("tp_mesh")
    rng = np.random.default_rng(7)
    cases, ties, want_tp1 = {}, {}, {}
    for name in DECODE_CASES:
        cases[name], ties[name], want_tp1[name] = _decode_case(name, rng)
    cases["batcher"], batcher_tp1 = _batcher_case(rng)
    torch.save(cases, d / "cases.pt")
    addr = f"127.0.0.1:{_free_port()}"
    world = DATA * MODEL
    _spawn([["mesh", addr, str(world), str(r), str(DATA), str(MODEL), str(d)]
            for r in range(world)], SPAWN_TIMEOUT)
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]
    return dict(ties=ties, tp1=want_tp1, batcher_tp1=batcher_tp1,
                ranks=ranks)


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
