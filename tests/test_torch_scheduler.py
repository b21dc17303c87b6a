"""The port's continuous-batching path against the JAX package on a tiny
serving model (int8 W8A8, fused fast head): per-row top-k sampling,
`forward_generate` with per-row write positions on three cache layouts,
`ContinuousBatcher` (prefix cache, chunked prefill, chunked ticks,
cancellation; against JAX's batcher on the unquantized tiny model) and
`TTSEngine(scheduler_slots=...)` called from threads."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.engine import scheduler as jsched
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.models.config import (
    DualARConfig,
    apply_pallas_attn_mode,
    tiny_dual_ar_config,
)
from fish_speech_tpu.models.init import init_dual_ar_params
from fish_speech_tpu.ops import sampling as jsamp
from fish_speech_tpu.ops.fast_fused import enable_fused_fast_head
from fish_speech_tpu.ops.quant import quantize_lm_params
from fish_speech_tpu_torch.engine import scheduler as tsched
from fish_speech_tpu_torch.engine.generate import (
    GenerateLongRequest,
    build_engine,
)
from fish_speech_tpu_torch.models import config as tconfig
from fish_speech_tpu_torch.models import decode as tdec
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.models.init import lm_params_from_jax
from fish_speech_tpu_torch.ops import sampling as tsamp

from ref_harness import random_lm_prompt

IM_END = 4
TINY = jnp.finfo(jnp.float32).tiny


def _cfg(attn: str = "stream", **flags) -> DualARConfig:
    """GQA slow stack (4 query heads over 2 kv heads, head_dim 32), fast
    stack in the fused sweep's 3x family, serving flags (by default the
    position-major int8 cache read by the stream kernel)."""
    kw = dict(w8a8_matmuls=True, kv_cache_dtype="int8",
              kv_cache_layout="pos")
    kw.update(flags)
    cfg = DualARConfig(
        vocab_size=160, n_layer=2, n_head=4, n_local_heads=2, dim=128,
        head_dim=32, intermediate_size=256, max_seq_len=64,
        rope_base=10000.0, codebook_size=32, num_codebooks=4,
        n_fast_layer=2, fast_dim=128, fast_n_head=2, fast_n_local_heads=2,
        fast_head_dim=64, fast_intermediate_size=384, semantic_begin_id=64,
        semantic_end_id=95, **kw)
    return apply_pallas_attn_mode(cfg, attn)


def _port_cfg(cfg: DualARConfig):
    return tconfig.DualARConfig(**dataclasses.asdict(cfg))


def _setup(cfg: DualARConfig):
    params = enable_fused_fast_head(quantize_lm_params(
        init_dual_ar_params(jax.random.key(3), cfg, dtype=jnp.bfloat16),
        mode="int8"))
    port = lm_params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, port


@pytest.fixture(scope="module")
def serving():
    return _setup(_cfg())


# --- per-row top-k sampling ------------------------------------------------


def test_mask_topk_rows_matches_jax():
    rng = np.random.default_rng(0)
    vals = -np.sort(-rng.standard_normal((5, 12)).astype(np.float32), axis=1)
    for k in (np.asarray([1, 3, 12, 7, 5], np.int32), 4, None):
        ref = np.asarray(jsamp._mask_topk_rows(jnp.asarray(vals), k))
        got = tsamp._mask_topk_rows(torch.from_numpy(vals),
                                    None if k is None else
                                    torch.as_tensor(k)).numpy()
        np.testing.assert_array_equal(got, ref)     # exact: a mask


def _uniforms(key, shape):
    return np.asarray(jax.random.uniform(key, shape, minval=TINY,
                                         maxval=1.0))


@pytest.mark.parametrize("fn", ["sample_one", "sample_main_and_high"])
def test_sample_per_row_params_match_jax(fn):
    """Per-row temperature, top_p and top_k inside a roof of 16, fed the
    same uniforms: the same tokens exactly."""
    rng = np.random.default_rng(7)
    b, roof = 6, 16
    logits = rng.standard_normal((b, 200)).astype(np.float32) * 3
    temp = np.asarray([0.3, 0.7, 1.0, 1.3, 0.9, 0.5], np.float32)
    top_p = np.asarray([0.5, 0.7, 0.9, 1.0, 0.8, 0.95], np.float32)
    top_k = np.asarray([1, 4, 16, 9, 2, 12], np.int32)
    key = jax.random.key(5)
    args = (jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_p), roof)
    targs = (torch.from_numpy(logits), torch.from_numpy(temp),
             torch.from_numpy(top_p), roof, torch.from_numpy(top_k))
    if fn == "sample_one":
        ref = [jsamp.sample_one(key, *args, jnp.asarray(top_k))]
        got = [tsamp.sample_one(*targs, u=torch.from_numpy(
            _uniforms(key, (b, roof))))]
    else:
        ref = jsamp.sample_main_and_high(key, *args, jnp.asarray(top_k))
        u = np.stack([_uniforms(k, (b, roof)) for k in jax.random.split(key)])
        got = tsamp.sample_main_and_high(*targs, u=torch.from_numpy(u))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_sampling_probs_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 100)).astype(np.float32) * 2
    temp = np.asarray([0.5, 0.7, 1.0, 1.5], np.float32)
    ref = jsamp.sampling_probs(jnp.asarray(logits), jnp.asarray(temp),
                               jnp.float32(0.8), 20)
    got = tsamp.sampling_probs(torch.from_numpy(logits),
                               torch.from_numpy(temp), 0.8, 20)
    # f32 softmax over the same candidates: within a few f32 ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    tok = tsamp.sample_token(torch.from_numpy(logits), 0.7, 0.8, greedy=True)
    np.testing.assert_array_equal(tok.numpy(), logits.argmax(-1))


# --- forward_generate with per-row write positions -------------------------

LAYOUTS = {
    "pos-int8": dict(kv_cache_layout="pos", kv_cache_dtype="int8"),
    "pos-native": dict(kv_cache_layout="pos", kv_cache_dtype="native"),
    "head-int8": dict(attn="stream16", kv_cache_layout="head",
                      kv_cache_dtype="int8"),
    # the per-layer stack: each layer's cache a depth-1 view
    "head-native-scan": dict(attn="rows", kv_cache_layout="head",
                             kv_cache_dtype="native",
                             decode_stack_mode="scan"),
}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def layout(request):
    return _setup(_cfg(**LAYOUTS[request.param]))


def _random_caches(cfg, b, s):
    """The same filled cache on both sides: random int8 (or bf16) rows and
    scales, numpy-seeded."""
    rng = np.random.default_rng(11)
    pos = cfg.kv_cache_layout == "pos"
    int8 = cfg.kv_cache_dtype == "int8"
    hkv, d, n = cfg.n_local_heads, cfg.head_dim, cfg.n_layer
    shape = (n, s, b, hkv, d) if pos else (n, b, hkv, s, d)
    sshape = (n, b, s * hkv) if pos else (n, b, hkv, s)
    if int8:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(1e-3, 3e-2, sshape).astype(np.float32)
                  for _ in range(2))
        jc = jdual.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks),
                           jnp.asarray(vs))
        tc = tdual.KVCache(*(torch.from_numpy(a.copy())
                             for a in (k, v, ks, vs)), pos_major=pos)
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        jc = jdual.KVCache(jnp.asarray(k, jnp.bfloat16),
                           jnp.asarray(v, jnp.bfloat16))
        tc = tdual.KVCache(torch.from_numpy(k).bfloat16(),
                           torch.from_numpy(v).bfloat16(), pos_major=pos)
    return jc, tc


@pytest.mark.parametrize("t", [1, 3])
def test_forward_per_row_positions_match_jax(layout, t):
    """Rows at different offsets (write positions 5, 17, 30; left-pad
    starts 2, 0, 4), T = 1 (the decode kernels' path) and T = 3 (the
    einsum path): the same logits, and the same caches with each row's new
    k/v at its own columns and every other column untouched."""
    cfg, params, port = layout
    cfg_t = _port_cfg(cfg)
    b, s = 3, cfg.max_seq_len
    pos = np.asarray([5, 17, 30], np.int32)
    starts = np.asarray([2, 0, 4], np.int32)
    rng = np.random.default_rng(t)
    inp = np.stack([random_lm_prompt(cfg, t, rng) for _ in range(b)])
    rope = (pos - starts)[:, None] + np.arange(t)[None]
    support = (cfg.semantic_begin_id, cfg.semantic_end_id, IM_END)
    jc, tc = _random_caches(cfg, b, s)
    table = jdual.precompute_freqs_cis(s, cfg.head_dim, cfg.rope_base)
    out_j = jdual.forward_generate(
        params, cfg, jnp.asarray(inp), jc, jnp.asarray(pos), table,
        rope_positions=jnp.asarray(rope), key_valid_from=jnp.asarray(starts),
        logit_support=support, last_only=False)
    out_t = tdual.forward_generate(
        port, cfg_t, torch.from_numpy(inp), tc, torch.from_numpy(pos),
        tdual.precompute_freqs_cis(s, cfg.head_dim, cfg.rope_base),
        rope_positions=torch.from_numpy(rope),
        key_valid_from=torch.from_numpy(starts), logit_support=support,
        last_only=False)
    # bf16 activations through two int8-quantized layers, f32 sums in
    # another order: the tolerance of the port's other serving tests
    ref = np.asarray(out_j.logits, np.float32)
    got = out_t.logits.float().numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999

    pos_major = cfg.kv_cache_layout == "pos"
    written = np.zeros((b, s), bool)
    for r in range(b):
        written[r, pos[r]:pos[r] + t] = True
    for name in ("k", "v", "ks", "vs"):
        a_j = getattr(out_j.cache, name)
        if a_j is None:
            continue
        a_j = np.asarray(a_j.astype(jnp.float32))
        a_t = getattr(tc, name).float().numpy()
        if name in ("k", "v"):
            # (L, B, S, ...) whatever the layout
            a_j = np.moveaxis(a_j, 1, 2) if pos_major else np.moveaxis(
                a_j, 3, 2)
            a_t = np.moveaxis(a_t, 1, 2) if pos_major else np.moveaxis(
                a_t, 3, 2)
        elif pos_major:
            a_j = a_j.reshape(cfg.n_layer, b, s, -1)
            a_t = a_t.reshape(cfg.n_layer, b, s, -1)
        else:
            a_j, a_t = np.moveaxis(a_j, 2, 3), np.moveaxis(a_t, 2, 3)
        # untouched columns: exactly the initial cache
        np.testing.assert_array_equal(a_t[:, ~written], a_j[:, ~written])
        new_j, new_t = a_j[:, written], a_t[:, written]
        if name in ("k", "v") and cfg.kv_cache_dtype == "int8":
            # each layer's rows from W8A8 products of bf16 activations whose
            # f32 sums (RMSNorm, attention) run in another order than
            # XLA's: layer 0 within one int8 step on under 2% of elements,
            # layer 1 within a few steps
            d = np.abs(new_t - new_j)
            assert d[0].max() <= 1 and (d[0] > 0).mean() < 0.02, (
                d[0].max(), (d[0] > 0).mean())
            assert d.max() <= 4 and d.mean() < 0.3, (d.max(), d.mean())
        else:
            # scales and bf16 rows: layer 0 to a bf16 rounding, layer 1 as
            # the logits
            np.testing.assert_allclose(new_t[0], new_j[0], rtol=1e-2,
                                       atol=1e-2)
            np.testing.assert_allclose(new_t, new_j, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("t", [1, 3])
def test_per_row_write_equals_rowwise_writes(layout, t):
    """Within the port, bit for bit: one step at per-row positions writes
    each row's cache exactly as that row alone, at batch 1 through its
    slot's view with a host-int position, does (and gives the same
    logits)."""
    cfg, _, port = layout
    cfg_t = _port_cfg(cfg)
    b, s = 3, cfg.max_seq_len
    pos = np.asarray([5, 17, 30], np.int32)
    starts = np.asarray([2, 0, 4], np.int32)
    rng = np.random.default_rng(t + 10)
    inp = torch.from_numpy(np.stack([random_lm_prompt(cfg, t, rng)
                                     for _ in range(b)]))
    rope = torch.from_numpy((pos - starts)[:, None] + np.arange(t)[None])
    table = tdual.precompute_freqs_cis(s, cfg.head_dim, cfg.rope_base)
    _, batched = _random_caches(cfg, b, s)
    _, rowwise = _random_caches(cfg, b, s)
    kw = dict(logit_support=(cfg.semantic_begin_id, cfg.semantic_end_id,
                             IM_END), last_only=False)
    out = tdual.forward_generate(
        port, cfg_t, inp, batched, torch.from_numpy(pos), table,
        rope_positions=rope, key_valid_from=torch.from_numpy(starts), **kw)
    for r in range(b):
        one = tdual.forward_generate(
            port, cfg_t, inp[r:r + 1], tsched.slice_slot_cache(rowwise, r),
            int(pos[r]), table, rope_positions=rope[r:r + 1],
            key_valid_from=torch.from_numpy(starts[r:r + 1]), **kw)
        np.testing.assert_array_equal(out.logits[r:r + 1].float().numpy(),
                                      one.logits.float().numpy())
    for name in ("k", "v", "ks", "vs"):
        if getattr(batched, name) is not None:
            assert torch.equal(getattr(batched, name),
                               getattr(rowwise, name)), name


# --- the batcher ----------------------------------------------------------


def _requests(cfg, mod, rng_seed=4, max_new=6):
    """Four requests of different lengths: a prefix pair (9 shared columns
    + 5 / 4), one prompt longer than the chunk (20 > 8), one short plain
    prompt."""
    rng = np.random.default_rng(rng_seed)
    prefix = random_lm_prompt(cfg, 9, rng)
    prompts = [np.concatenate([prefix, random_lm_prompt(cfg, t, rng)],
                              axis=1) for t in (5, 4)]
    prompts += [random_lm_prompt(cfg, 20, rng), random_lm_prompt(cfg, 7, rng)]
    return [mod.SlotRequest(request_id=i, prompt=p, max_new_tokens=max_new,
                            prefix_id="v" if i < 2 else None,
                            prefix_len=9 if i < 2 else 0)
            for i, p in enumerate(prompts)]


def _support(cfg):
    return (cfg.semantic_begin_id, cfg.semantic_end_id, IM_END)


def _port_batcher(cfg, port, **kw):
    args = dict(num_slots=2, cache_len=64, im_end_id=IM_END,
                bias=tsamp.semantic_logit_bias(cfg.vocab_size, *_support(cfg)),
                greedy=True, prompt_bucket=16, prefill_chunk=8, device="cpu")
    args.update(kw)
    return tsched.ContinuousBatcher(port, _port_cfg(cfg), **args)


@pytest.fixture(scope="module")
def f32_model():
    """The unquantized tiny model of the reference goldens (f32, head-major
    native cache, einsum attention), on which the port's greedy decode
    equals JAX's token for token (tests/test_torch_lm.py)."""
    cfg = tiny_dual_ar_config()
    params = init_dual_ar_params(jax.random.key(0), cfg)
    return cfg, params, lm_params_from_jax(jax.tree.map(np.asarray, params),
                                           device="cpu")


def test_batcher_matches_jax_batcher(f32_model):
    """The same requests through both batchers: the same greedy codes, and
    the same prefix hits and misses, chunked prefills and ticks run while
    a chunk was in flight.

    On the int8 serving model the port's and JAX's greedy streams part at
    near-ties of the fast head's logits: its W8A8 sums run in another f32
    order, and the logits agree to ~1e-2 (tests/test_torch_lm.py's
    tolerance), more than the top-two gap of some steps (one of these
    prompts has a 0.004 gap). There `test_batcher_matches_single_generate`
    holds the batcher to the port's own decode, bit for bit."""
    cfg, params, port = f32_model
    jb = jsched.ContinuousBatcher(
        params, cfg, num_slots=2, cache_len=64, im_end_id=IM_END,
        bias=jsamp.semantic_logit_bias(cfg.vocab_size, *_support(cfg)),
        greedy=True, prompt_bucket=16, prefill_chunk=8)
    ref = jb.run(_requests(cfg, jsched))
    tb = _port_batcher(cfg, port)
    got = tb.run(_requests(cfg, tsched))
    # one prefix miss and one hit, one chunked prompt decoding between
    # chunks, as in the JAX run
    assert (tb.prefix_misses, tb.prefix_hits) == (1, 1)
    assert (jb.prefix_misses, jb.prefix_hits) == (1, 1)
    assert tb.chunked_prefills == jb.chunked_prefills == 1
    assert tb.ticks_while_prefilling == jb.ticks_while_prefilling >= 1
    for i in ref:
        assert got[i].shape[1] >= 1
        np.testing.assert_array_equal(got[i], ref[i])


@pytest.mark.parametrize("model", ["serving", "f32_model"])
def test_batcher_matches_single_generate(model, request):
    """Each request against the port's own single-utterance decode of its
    whole prompt (no padding, no prefix cache, no chunks), bit for bit."""
    cfg, _, port = request.getfixturevalue(model)
    tb = _port_batcher(cfg, port)
    got = tb.run(_requests(cfg, tsched))
    assert (tb.prefix_misses, tb.prefix_hits) == (1, 1)
    assert tb.chunked_prefills == 1 and tb.ticks_while_prefilling >= 1
    for req in _requests(cfg, tsched):
        codes, lengths = tdec.generate(
            port, _port_cfg(cfg), torch.from_numpy(req.prompt)[None],
            torch.zeros(1, dtype=torch.int32), None,
            tdec.SamplingConfig.create(),
            tsamp.semantic_logit_bias(cfg.vocab_size, *_support(cfg)),
            max_new_tokens=req.max_new_tokens, im_end_id=IM_END, greedy=True,
            cache_len=64, device="cpu")
        want = codes[0, :, :int(lengths[0])].numpy()
        n = want.shape[1]
        # the batcher stops before im_end; generate's lengths count the
        # columns before it
        assert n >= 1
        np.testing.assert_array_equal(got[req.request_id][:, :n], want)
        assert got[req.request_id].shape[1] <= n + 1


def test_step_chunk_reproduces_step_sampled(serving):
    """Sampled decoding with per-request temperature, top_p and top_k:
    step_chunk(4) gives what step() gives for the same seed (the same
    uniforms in the same order), budgets ending inside a chunk."""
    cfg, _, port = serving
    params = [(0.7, 0.7, 30), (1.0, 0.9, 5), (0.4, 0.95, 12)]

    def run(chunk):
        b = _port_batcher(cfg, port, num_slots=3, greedy=False, seed=5,
                          top_k=16, prefill_chunk=None)
        r = np.random.default_rng(9)
        seen = {}

        def hook(rid, col):
            seen.setdefault(rid, []).append(col)

        reqs = [tsched.SlotRequest(
            request_id=i, prompt=random_lm_prompt(cfg, t, r),
            max_new_tokens=m, temperature=tp, top_p=pp, top_k=k,
            on_token=hook)
            for i, (t, m, (tp, pp, k)) in enumerate(
                zip((9, 14, 6), (11, 7, 10), params))]
        out = b.run(reqs, chunk_steps=chunk)
        # the streaming hook saw every emitted column, in order
        for i, codes in out.items():
            np.testing.assert_array_equal(np.stack(seen[i], axis=1), codes)
        return out, b

    per_step, b1 = run(1)
    chunked, b4 = run(4)
    assert b4.chunked_ticks > 0 and b1.chunked_ticks == 0
    for i in per_step:
        assert per_step[i].shape[1] >= 2
        np.testing.assert_array_equal(chunked[i], per_step[i])


@pytest.mark.parametrize("cache_len", [64, 63, 62])
def test_step_chunk_runs_to_cache_end(serving, cache_len):
    """A request whose budget is cut at the cache's end (its prompt's bucket
    ends at column 48) under step_chunk(4), its budget ending 1, 2 or 3
    ticks before a chunk's end: the ticks past its budget stay inside the
    cache, and every request's codes equal the per-step run's exactly."""
    cfg, _, port = serving
    bias = tsamp.semantic_logit_bias(cfg.vocab_size, *_support(cfg))
    bias[IM_END] = -torch.inf       # no im_end: the request runs to its budget

    def run(chunk):
        b = _port_batcher(cfg, port, cache_len=cache_len, bias=bias,
                          prefill_chunk=None)
        rng = np.random.default_rng(11)
        reqs = [tsched.SlotRequest(request_id=i,
                                   prompt=random_lm_prompt(cfg, t, rng),
                                   max_new_tokens=m)
                for i, (t, m) in enumerate(((40, 40), (9, 6)))]
        return b.run(reqs, chunk_steps=chunk)

    chunked, per_step = run(4), run(1)
    assert chunked[0].shape[1] == cache_len - 48
    assert chunked[1].shape[1] == 6
    for i in per_step:
        np.testing.assert_array_equal(chunked[i], per_step[i])


def test_fold_engine_tick_takes_scatter(monkeypatch):
    """On a KV-fold configuration a tick's per-row positions take the
    scatter write and the read kernel (#1), never the fold (#5), whose
    write position is one host int (the JAX gate); prefills write as
    before."""
    cfg, _, port = _setup(_cfg(kv_fold_write=True))
    calls = {"fold": 0, "stream": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tdual, "decode_attention_stream_fold",
                        counted("fold", tdual.decode_attention_stream_fold))
    monkeypatch.setattr(tdual, "decode_attention_stream",
                        counted("stream", tdual.decode_attention_stream))
    b = _port_batcher(cfg, port, prefill_chunk=None)
    assert b.cfg.slow_attn.kv_fold
    rng = np.random.default_rng(6)
    out = b.run([tsched.SlotRequest(request_id=i,
                                    prompt=random_lm_prompt(cfg, t, rng),
                                    max_new_tokens=4)
                 for i, t in enumerate((7, 12))])
    assert calls["fold"] == 0
    assert calls["stream"] == cfg.n_layer * b.ticks > 0
    assert all(c.shape[1] >= 1 for c in out.values())


def test_cancel_frees_slot_within_one_tick(serving):
    cfg, _, port = serving
    b = _port_batcher(cfg, port, prefill_chunk=None)
    rng = np.random.default_rng(3)
    reqs = [tsched.SlotRequest(request_id=i,
                               prompt=random_lm_prompt(cfg, 8 + i, rng),
                               max_new_tokens=20) for i in range(2)]
    for slot, r in enumerate(reqs):
        b._assign(r, slot)
    b.step()
    assert b.free_slots() == []
    reqs[0].cancel()
    n0, n1 = len(reqs[0].result), len(reqs[1].result)
    b.step()
    assert b.free_slots() == [0] and not b.active_h[0]
    assert not bool(b.active[0]) and bool(b.active[1])
    assert reqs[0].done.is_set() and b.cancelled_requests == 1
    assert len(reqs[0].result) == n0 and len(reqs[1].result) == n1 + 1


def test_scheduler_thread_hands_errors_to_requests(serving, monkeypatch):
    """A tick that raises fails the requests it held (their `error` set,
    `done` set, slots freed); the thread goes on and serves the next
    request."""
    cfg, _, port = serving
    b = _port_batcher(cfg, port, prefill_chunk=None)
    sched = tsched.SchedulerThread(b)
    rng = np.random.default_rng(12)
    try:
        tick = b._tick

        def broken():
            raise RuntimeError("tick failed")

        monkeypatch.setattr(b, "_tick", broken)
        bad = sched.submit(tsched.SlotRequest(
            request_id=0, prompt=random_lm_prompt(cfg, 8, rng),
            max_new_tokens=4))
        assert bad.done.wait(timeout=60)
        assert isinstance(bad.error, RuntimeError)
        assert b.free_slots() == [0, 1]
        monkeypatch.setattr(b, "_tick", tick)
        good = sched.submit(tsched.SlotRequest(
            request_id=1, prompt=random_lm_prompt(cfg, 9, rng),
            max_new_tokens=4))
        assert good.done.wait(timeout=60)
        assert good.error is None and len(good.result) >= 1
    finally:
        sched.stop()
    assert not sched.thread.is_alive()


# --- the engine's scheduler API -------------------------------------------


def tiny_lm_config():
    return tconfig.DualARConfig(
        vocab_size=320, n_layer=2, n_head=4, n_local_heads=2, dim=64,
        head_dim=16, intermediate_size=128, max_seq_len=256,
        rope_base=10000.0, codebook_size=32, num_codebooks=4,
        n_fast_layer=2, fast_dim=64, fast_n_head=2, fast_n_local_heads=2,
        fast_head_dim=32, fast_intermediate_size=192)


def test_engine_scheduler_threads_match_engine(monkeypatch):
    """Two threads through TTSEngine(scheduler_slots=2) get the greedy codes
    the engine without a scheduler gives, the second segment of each
    reusing the system prompt's cached rows; one prompt is chunked. Greedy
    is set on the batcher and, for the engine without a scheduler, on its
    decode loop (`generate`)."""
    from fish_speech_tpu_torch.codec.config import tiny_codec_config
    from fish_speech_tpu_torch.engine import generate as tgen

    monkeypatch.setattr(tgen, "generate", lambda *a, **kw: tdec.generate(
        *a, **kw, greedy=True))
    kw = dict(device="cpu", lm_cfg=tiny_lm_config(),
              codec_cfg=tiny_codec_config(), cache_len=256, seed=3)
    plain = build_engine(**kw)
    sched = build_engine(scheduler_slots=2, prefill_chunk=32, **kw)
    sched.scheduler.batcher.greedy = True
    texts = ["Hello there.",
             "<|speaker:0|>A longer request whose prompt is chunked."]
    reqs = [GenerateLongRequest(text=t, max_new_tokens=6, seed=i)
            for i, t in enumerate(texts)]

    def codes(engine, req):
        return [r.codes for r in engine.generate_long(req)
                if r.action == "sample"]

    try:
        want = [codes(plain, r) for r in reqs]
        got = {}
        threads = [threading.Thread(
            target=lambda i=i: got.__setitem__(i, codes(sched, reqs[i])))
            for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        batcher = sched.scheduler.batcher
        assert set(got) == {0, 1}
        assert batcher.prefix_misses == 1 and batcher.prefix_hits == 1
        assert batcher.chunked_prefills == 1
        for i in range(len(reqs)):
            assert [c.shape for c in got[i]] == [c.shape for c in want[i]]
            for g, w in zip(got[i], want[i]):
                np.testing.assert_array_equal(g, w)
    finally:
        sched.close()
    assert not sched.scheduler.thread.is_alive()


# --- the engine's streaming, batched-decode and encode entries --------------


@pytest.fixture(scope="module")
def stream_engine():
    """The tiny serving engine behind a greedy 1-slot scheduler."""
    from fish_speech_tpu_torch.codec.config import tiny_codec_config

    eng = build_engine(device="cpu", lm_cfg=tiny_lm_config(),
                       codec_cfg=tiny_codec_config(), cache_len=256, seed=3,
                       scheduler_slots=1)
    eng.scheduler.batcher.greedy = True
    yield eng
    eng.close()


def _codes_of(eng, req):
    return np.concatenate([r.codes for r in eng.generate_long(req)
                           if r.action == "sample"], axis=1)


@pytest.mark.parametrize("first", [4, None])
def test_stream_tts_matches_decode_codes(stream_engine, first):
    """The streamed chunks concatenate to decode_codes of the codes
    generate_long gives for the same request (greedy: the same stream),
    within 1e-5 (JAX's test): the stateful f32 streaming vocoder against
    the fused decoder's plain path. With a first cut of 4 frames the first
    chunk is 4 frames, then chunks of 8."""
    fl = stream_engine.codec_cfg.frame_length
    req = GenerateLongRequest(text="hello stream", max_new_tokens=21, seed=3)
    chunks = list(stream_engine.stream_tts(req, chunk_frames=8,
                                           first_chunk_frames=first))
    codes = _codes_of(stream_engine, req)
    full = stream_engine.decode_codes(codes)
    streamed = np.concatenate(chunks)
    assert codes.shape[1] > 8 and streamed.shape == full.shape
    assert len(chunks[0]) == (first or 8) * fl
    np.testing.assert_allclose(streamed, full, atol=1e-5)


def test_stream_tts_close_cancels_slot(stream_engine):
    """Closing the generator after its first chunk cancels the request:
    the scheduler frees the slot within a few ticks, long before the
    request's budget."""
    import time

    batcher = stream_engine.scheduler.batcher
    before = batcher.cancelled_requests
    gen = stream_engine.stream_tts(GenerateLongRequest(
        text="a long stream", max_new_tokens=200, seed=1), chunk_frames=4,
        first_chunk_frames=None)
    assert len(next(gen)) == 4 * stream_engine.codec_cfg.frame_length
    ticks = batcher.ticks
    gen.close()
    deadline = time.time() + 30
    while (batcher.has_active() or batcher.cancelled_requests == before) \
            and time.time() < deadline:
        time.sleep(0.01)
    assert batcher.cancelled_requests == before + 1
    assert not batcher.has_active()
    assert batcher.ticks - ticks < 100


def test_stream_tts_worker_errors_reach_caller(stream_engine, monkeypatch):
    """An error in the vocoder thread's warm start is raised by the
    generator (JAX's warm start swallows it), and the slot is freed."""
    from fish_speech_tpu_torch.codec import streaming

    def broken(*a, **kw):
        raise RuntimeError("stream step failed")

    monkeypatch.setattr(streaming.StatefulVocoder, "step", broken)
    stream_engine._stream_warm_widths.clear()
    with pytest.raises(RuntimeError, match="stream step failed"):
        list(stream_engine.stream_tts(GenerateLongRequest(
            text="hi", max_new_tokens=12, seed=2), chunk_frames=4))
    batcher = stream_engine.scheduler.batcher
    import time
    deadline = time.time() + 30
    while batcher.has_active() and time.time() < deadline:
        time.sleep(0.01)
    assert not batcher.has_active()


def test_decode_codes_batch_matches_single(stream_engine, monkeypatch):
    """Three sequences of 3, 5 and 2 frames: one call of the fused
    decoder at batch 4 (the power of two above 3) over 64 frames (the
    bucket max(32, ceil(5 / 64) * 64)), each waveform within
    1e-4 of its own decode_codes (JAX's test)."""
    from fish_speech_tpu_torch.codec import fastpath

    rng = np.random.default_rng(0)
    n_q = stream_engine.codec_cfg.rvq.total_codebooks
    codes = [rng.integers(0, 16, size=(n_q, t)).astype(np.int32)
             for t in (3, 5, 2)]
    singles = [stream_engine.decode_codes(c) for c in codes]
    calls = []
    inner = fastpath.dac_from_indices_fused

    def counting(p, cfg, c, **kw):
        calls.append(tuple(c.shape))
        return inner(p, cfg, c, **kw)

    monkeypatch.setattr(fastpath, "dac_from_indices_fused", counting)
    wavs = stream_engine.decode_codes_batch(codes)
    assert calls == [(4, n_q, 64)]
    for got, want in zip(wavs, singles):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # a group of micro_batch, then the rest
    wavs = stream_engine.decode_codes_batch(codes, micro_batch=2)
    assert calls[1:] == [(2, n_q, 64), (1, n_q, 64)]
    for got, want in zip(wavs, singles):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("frames,bucket", [(1, 64), (64, 64), (65, 128)])
def test_encode_reference_bucket_rule(frames, bucket, monkeypatch):
    """encode_reference zero-pads the samples to max(32, ceil(frames / 64)
    * 64) frames, JAX's rule, and keeps ceil(n / frame_length) frames of
    codes: on JAX's random codec carried over, the codes of JAX's
    dac_encode on the same padded waveform (match above 0.99, the encode
    tests' bound)."""
    from fish_speech_tpu.codec import dac_encode as jax_dac_encode
    from fish_speech_tpu.codec import init_dac_params as jax_init
    from fish_speech_tpu.codec import tiny_codec_config as jax_tiny
    from fish_speech_tpu_torch.codec import model as tmodel
    from fish_speech_tpu_torch.codec.config import tiny_codec_config
    from fish_speech_tpu_torch.codec.init import codec_params_from_jax
    from fish_speech_tpu_torch.engine.generate import TTSEngine

    ccfg = tiny_codec_config()
    jp = jax_init(jax.random.key(5), jax_tiny())
    base = build_engine(device="cpu", lm_cfg=tiny_lm_config(),
                        codec_cfg=ccfg, cache_len=256, seed=3)
    eng = TTSEngine(base.params, base.cfg, base.tokenizer,
                    codec_params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu"),
                    ccfg, cache_len=256, device="cpu")
    fl = ccfg.frame_length
    n = (frames - 1) * fl + 100
    wav = (np.random.default_rng(frames).standard_normal(n)
           * 0.1).astype(np.float32)
    seen = []
    inner = tmodel.dac_encode

    def recorded(p, cfg, audio, *a, **kw):
        seen.append(tuple(audio.shape))
        return inner(p, cfg, audio, *a, **kw)

    monkeypatch.setattr(tmodel, "dac_encode", recorded)
    got = eng.encode_reference(wav)
    assert seen == [(1, bucket * fl)]
    assert got.shape == (ccfg.rvq.total_codebooks, frames)
    padded = np.zeros((1, bucket * fl), np.float32)
    padded[0, :n] = wav
    want = np.asarray(jax_dac_encode(jp, jax_tiny(),
                                     jnp.asarray(padded)).codes[0, :,
                                                                :frames])
    assert (got == want).mean() > 0.99


def test_warmup_vocoder_runs_each_width(stream_engine):
    """warmup_vocoder decodes its buckets and, with the scheduler, runs the
    stream step at each width; stream_tts then warms nothing again."""
    stream_engine._stream_warm_widths.clear()
    stream_engine.warmup_vocoder(buckets=((1, 32), (2, 64)),
                                 stream_widths=(4, 8))
    assert stream_engine._stream_warm_widths == {4, 8}
