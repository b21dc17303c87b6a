"""Port's Dual-AR LM vs the JAX package: weight carry, the unquantized path
against the reference goldens, the serving configurations (int8 W8A8, or
packed-int4 W4A8 with the KV-write fold; position-major int8 KV cache,
stream attention, fused fast head; the head-major int8 or native cache
through the stream, blocks, rows and per-layer kernels) on a tiny model,
and sampling fed the same uniforms."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.models import decode as jdec
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.models.config import (
    DualARConfig,
    apply_pallas_attn_mode,
    tiny_dual_ar_config,
)
from fish_speech_tpu.models.init import (
    convert_dual_ar_state_dict,
    init_dual_ar_params,
)
from fish_speech_tpu.ops import sampling as jsamp
from fish_speech_tpu.ops.fast_fused import enable_fused_fast_head
from fish_speech_tpu.ops.quant import pack_int4_params, quantize_lm_params
from fish_speech_tpu_torch.models import decode as tdec
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.models.config import (
    tiny_dual_ar_config as tiny_t,
)
from fish_speech_tpu_torch.models.init import lm_params_from_jax
from fish_speech_tpu_torch.ops import quant as tquant
from fish_speech_tpu_torch.ops import sampling as tsamp

GOLDEN = Path(__file__).parent / "goldens" / "lm_tiny.npz"
IM_END_ID = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def golden_params(golden):
    cfg = tiny_dual_ar_config()
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("sd:")}
    return lm_params_from_jax(_np(convert_dual_ar_state_dict(sd, cfg)),
                              device="cpu")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_config_copy_matches():
    assert dataclasses.asdict(tiny_t()) == dataclasses.asdict(
        tiny_dual_ar_config())


@pytest.mark.parametrize("form", ["float", "int8", "fast_packed", "w4a8",
                                  "int4"])
def test_weight_carry(form):
    """"w4a8": the W4A8 serving tree (packed int4 slow stack, packed fast
    stack), carried as it is; "int4": the native-int4 checkpoint form,
    packed on the way in."""
    cfg = serving_cfg_jax()
    params = init_dual_ar_params(jax.random.key(0), cfg, dtype=jnp.bfloat16)
    if form in ("w4a8", "int4"):
        params = quantize_lm_params(params, mode=form, groupsize=32)
    elif form != "float":
        params = quantize_lm_params(params)
    if form in ("fast_packed", "w4a8"):
        params = enable_fused_fast_head(params)
    tree = _np(params)
    port = lm_params_from_jax(tree, device="cpu")
    if form == "int4":
        tree = _np(pack_int4_params(params))
        assert "q4" in port["layers"]["attention"]["wqkv"]
    got = dict(_leaves(port))
    for path, a in _leaves(tree):
        t = got[path]
        if path[0] == "fast_packed" and path[1] in ("w", "s"):
            a = a[:, :13] if path[1] == "w" else a[:, :13, 0]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).endswith(str(a.dtype)), (path, t.dtype, a.dtype)
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32), str(path))


def test_teacher_forced_logits_match_golden(golden, golden_params):
    """Prefill over the whole prompt with last_only=False gives the
    teacher-forced token logits of the reference."""
    cfg = tiny_t()
    prompt = torch.from_numpy(golden["prompt"])
    cache = tdual.KVCache.create(cfg.n_layer, 1, cfg.max_seq_len,
                                 cfg.n_local_heads, cfg.head_dim,
                                 dtype=torch.float32)
    table = tdual.precompute_freqs_cis(cfg.max_seq_len, cfg.head_dim,
                                       cfg.rope_base)
    out = tdual.forward_generate(golden_params, cfg, prompt, cache, 0, table,
                                 last_only=False)
    # the JAX parity test's tolerance (f32 everywhere)
    np.testing.assert_allclose(out.logits.numpy(),
                               golden["golden_token_logits"], atol=2e-4,
                               rtol=1e-3)


def test_greedy_stream_matches_golden(golden, golden_params):
    cfg = tiny_t()
    bias = tsamp.semantic_logit_bias(cfg.vocab_size, cfg.semantic_begin_id,
                                     cfg.semantic_end_id, IM_END_ID)
    codes, _ = tdec.generate(
        golden_params, cfg, torch.from_numpy(golden["prompt2"])[None],
        torch.zeros(1, dtype=torch.int32), None, tdec.SamplingConfig.create(),
        bias, max_new_tokens=24, im_end_id=IM_END_ID, greedy=True,
        device="cpu")
    ref = golden["golden_stream"]
    np.testing.assert_array_equal(codes[0, :, :ref.shape[1]].numpy(), ref)


# --- serving configuration on a tiny model --------------------------------


def serving_cfg_jax(attn: str = "stream", **kw) -> DualARConfig:
    """Slow stack with GQA (4 query heads over 2 kv heads), fast stack in
    the fused kernel's 3x family, serving flags: by default the
    position-major int8 cache read by the stream kernel; `attn` and
    kv_cache_layout / kv_cache_dtype / decode_stack_mode in `kw` select
    another route."""
    flags = dict(w8a8_matmuls=True, kv_cache_dtype="int8",
                 kv_cache_layout="pos")
    flags.update(kw)
    cfg = DualARConfig(
        vocab_size=160, n_layer=2, n_head=4, n_local_heads=2, dim=128,
        head_dim=32, intermediate_size=256, max_seq_len=64,
        rope_base=10000.0, codebook_size=32, num_codebooks=4,
        n_fast_layer=2, fast_dim=128, fast_n_head=2, fast_n_local_heads=2,
        fast_head_dim=64, fast_intermediate_size=384, semantic_begin_id=64,
        semantic_end_id=95, **flags)
    return apply_pallas_attn_mode(cfg, attn)


def _to_port_cfg(cfg):
    from fish_speech_tpu_torch.models.config import DualARConfig as T
    return T(**dataclasses.asdict(cfg))


def _serving_setup(quant: str = "int8", attn: str = "stream",
                   kv_layout: str = "pos", kv_cache: str = "int8",
                   stack_mode: str = "", **cfg_kw):
    cfg = serving_cfg_jax(attn, kv_cache_layout=kv_layout,
                          kv_cache_dtype=kv_cache,
                          decode_stack_mode=stack_mode, **cfg_kw)
    params = enable_fused_fast_head(quantize_lm_params(
        init_dual_ar_params(jax.random.key(3), cfg, dtype=jnp.bfloat16),
        mode=quant, groupsize=32))
    port = lm_params_from_jax(_np(params), device="cpu")
    rng = np.random.default_rng(4)
    t = 12
    prompt = np.zeros((2, cfg.num_codebooks + 1, t), np.int32)
    prompt[:, 0] = rng.integers(0, 64, (2, t))
    prompt[:, 0, -5:] = rng.integers(64, 96, (2, 5))        # semantic tail
    prompt[:, 1:, -5:] = rng.integers(0, 32, (2, cfg.num_codebooks, 5))
    starts = np.asarray([3, 0], np.int32)
    prompt[0, :, :3] = 0                                     # left pad
    return cfg, params, port, prompt, starts


@pytest.fixture(scope="module")
def serving():
    return _serving_setup()


@pytest.fixture(scope="module")
def serving_w4a8_fold():
    """Packed int4 slow stack in groups of 32 with W4A8 products, and the
    KV-write fold on the decode steps."""
    return _serving_setup("w4a8", kv_fold_write=True)


def _prefill_and_step(serving):
    """The prefill column and one decode step, JAX and port, from the same
    weights and prompt: {name: (JAX, port)} for the prefill's column
    ("col0"), the int8 k cache after the prefill ("k") and after the step
    ("k_step", "ks_step" its scales), and the step's logits."""
    cfg, params, port, prompt, starts = serving
    cfg_t = _to_port_cfg(cfg)
    b, _, t = prompt.shape
    s = cfg.max_seq_len
    support = (cfg.semantic_begin_id, cfg.semantic_end_id, IM_END_ID)
    bias = jsamp.semantic_logit_bias(cfg.vocab_size, *support)
    table = jdual.precompute_freqs_cis(s, cfg.head_dim, cfg.rope_base)
    ftable = jdual.precompute_freqs_cis(cfg.num_codebooks, cfg.fast_head_dim,
                                        cfg.rope_base)
    int8 = cfg.kv_cache_dtype == "int8"
    pos_major = cfg.kv_cache_layout == "pos"
    cache = jdual.KVCache.create(cfg.n_layer, b, s, cfg.n_local_heads,
                                 cfg.head_dim,
                                 dtype=jnp.int8 if int8 else jnp.bfloat16,
                                 pos_major=pos_major)
    rope = np.maximum(np.arange(t)[None] - starts[:, None], 0)
    kw = dict(top_k=8, greedy=True, key_valid_from=jnp.asarray(starts),
              sample_support=support)
    col0, cache = jdec.decode_one_token(
        params, cfg, jnp.asarray(prompt), cache, jnp.int32(0), table, ftable,
        bias, jax.random.key(0), jdec.SamplingConfig.create(), None,
        rope_positions=jnp.asarray(rope), **kw)
    # one decode step through the stream kernel, logits compared directly
    x1 = col0[:, :, None]
    slow = jdual.forward_generate(
        params, cfg, x1, cache, jnp.int32(t), table,
        rope_positions=jnp.asarray(t - starts)[:, None],
        key_valid_from=jnp.asarray(starts), logit_support=support)

    dev = "cpu"
    cache_t = tdual.KVCache.create(cfg.n_layer, b, s, cfg.n_local_heads,
                                   cfg.head_dim,
                                   dtype=torch.int8 if int8 else torch.bfloat16,
                                   pos_major=pos_major, device=dev)
    table_t = tdual.precompute_freqs_cis(s, cfg.head_dim, cfg.rope_base)
    ftable_t = tdual.precompute_freqs_cis(cfg.num_codebooks,
                                          cfg.fast_head_dim, cfg.rope_base)
    st = torch.from_numpy(starts)
    col0_t = tdec.decode_one_token(
        port, cfg_t, torch.from_numpy(prompt), cache_t, 0, table_t, ftable_t,
        tsamp.semantic_logit_bias(cfg.vocab_size, *support),
        tdec.SamplingConfig.create(), None, top_k=8, greedy=True,
        rope_positions=torch.from_numpy(rope), key_valid_from=st,
        sample_support=support)
    k_j = np.asarray(cache.k.astype(jnp.float32))
    k_t = cache_t.k.float().numpy()
    # the port's step runs on its own cache (the step writes it in place)
    slow_t = tdual.forward_generate(
        port, cfg_t, col0_t[:, :, None], cache_t, t, table_t,
        rope_positions=(t - st)[:, None], key_valid_from=st,
        logit_support=support)
    return {"col0": (np.asarray(col0), col0_t.numpy()), "k": (k_j, k_t),
            "k_step": (np.asarray(slow.cache.k.astype(jnp.float32)),
                       cache_t.k.float().numpy()),
            "ks_step": ((np.asarray(slow.cache.ks), cache_t.ks.numpy())
                        if int8 else None),
            "logits": (np.asarray(slow.logits, np.float32),
                       slow_t.logits.float().numpy())}


def test_serving_decode_step_matches_jax(serving):
    r = _prefill_and_step(serving)
    col0, col0_t = r["col0"]
    k_j, k_t = r["k"]
    ref, got = r["logits"]
    np.testing.assert_array_equal(col0_t, col0)
    # the prefill wrote the same int8 cache: layer 0 bit-equal; layer 1
    # inherits bf16 roundings of layer 0's einsums taken in another f32
    # summation order (measured: at most 3 int8 steps, mean ~0.1 step)
    np.testing.assert_array_equal(k_t[0], k_j[0])
    d = np.abs(k_j - k_t)
    assert d.max() <= 4 and d.mean() < 0.3, (d.max(), d.mean())
    # bf16 activations through two int8-quantized layers: logits of
    # magnitude ~0.1-0.5 agree to bf16 rounding of the hidden state
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


def test_w4a8_fold_decode_step_matches_jax(serving_w4a8_fold):
    """One W4A8 decode step with the fold (the port's plain fold, JAX's
    Pallas fold in interpret mode) after the prefill."""
    r = _prefill_and_step(serving_w4a8_fold)
    col0, col0_t = r["col0"]
    ref, got = r["logits"]
    np.testing.assert_array_equal(col0_t, col0)
    # the step's fold wrote its new k rows (slot t) in both caches: layer 0
    # bit-equal up to the bf16 roundings of the products feeding it, whose
    # f32 group sums run in another order; at most a few int8 steps after
    t = serving_w4a8_fold[3].shape[-1]
    k_j, k_t = r["k_step"]
    ks_j, ks_t = r["ks_step"]
    d = np.abs(k_j[:, t] - k_t[:, t])
    assert d.max() <= 4 and d.mean() < 0.3, (d.max(), d.mean())
    assert np.count_nonzero(k_t[:, t]) > 0 and np.count_nonzero(
        k_t[:, t + 1:]) == 0
    hkv = k_j.shape[3]
    np.testing.assert_allclose(ks_t[:, :, t * hkv:(t + 1) * hkv],
                               ks_j[:, :, t * hkv:(t + 1) * hkv], rtol=2e-2)
    # as the int8 test: bf16 activations, f32 group sums in another order
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


def _greedy_generate_check(serving):
    cfg, params, port, prompt, starts = serving
    support = (cfg.semantic_begin_id, cfg.semantic_end_id, IM_END_ID)
    codes_j, len_j = jdec.generate(
        params, cfg, jnp.asarray(prompt), jnp.asarray(starts),
        jax.random.key(0), jdec.SamplingConfig.create(),
        jsamp.semantic_logit_bias(cfg.vocab_size, *support),
        max_new_tokens=8, im_end_id=IM_END_ID, top_k=8, greedy=True)
    codes_t, len_t = tdec.generate(
        port, _to_port_cfg(cfg), torch.from_numpy(prompt),
        torch.from_numpy(starts), None, tdec.SamplingConfig.create(),
        tsamp.semantic_logit_bias(cfg.vocab_size, *support),
        max_new_tokens=8, im_end_id=IM_END_ID, top_k=8, greedy=True,
        device="cpu")
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))


def test_serving_greedy_generate_matches_jax(serving):
    _greedy_generate_check(serving)


def test_w4a8_fold_greedy_generate_matches_jax(serving_w4a8_fold):
    _greedy_generate_check(serving_w4a8_fold)


# --- the position-major native (bf16) cache --------------------------------


@pytest.fixture(scope="module")
def serving_pos_native():
    """The position-major bf16 cache read by the stream kernel (the JAX
    serving CLIs' --kv-cache native --kv-layout pos --pallas-attn stream)."""
    return _serving_setup(kv_cache="native")


def test_pos_native_decode_step_matches_jax(serving_pos_native):
    r = _prefill_and_step(serving_pos_native)
    col0, col0_t = r["col0"]
    ref, got = r["logits"]
    np.testing.assert_array_equal(col0_t, col0)
    # the head-major routes' tolerance: bf16 activations, f32 sums in
    # another order
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


def test_pos_native_greedy_generate_matches_jax(serving_pos_native):
    _greedy_generate_check(serving_pos_native)


# --- the head-major routes -------------------------------------------------

# (attention mode, kv cache, stack mode): each route's decode attention
# kernel, as the JAX function dispatches it
HEAD_ROUTES = {
    "blocks16-int8": ("blocks16", "int8", ""),           # #6, int8 scores
    "blocks16-bf16-int8": ("blocks16-bf16", "int8", ""),  # #6
    "stream16-int8": ("stream16", "int8", ""),           # #1 head-major
    "rows-native": ("rows", "native", ""),               # #7, bf16 cache
    "rows-int8": ("rows", "int8", ""),                   # #7, int8 cache
    "rows-native-scan": ("rows", "native", "scan"),      # #8 per layer
    "rows-int8-scan": ("rows", "int8", "scan"),          # dequant, then #8
}


@pytest.fixture(scope="module", params=list(HEAD_ROUTES))
def head_route(request):
    attn, kv_cache, stack_mode = HEAD_ROUTES[request.param]
    return _serving_setup(attn=attn, kv_layout="head", kv_cache=kv_cache,
                          stack_mode=stack_mode)


def test_head_route_decode_step_matches_jax(head_route):
    r = _prefill_and_step(head_route)
    col0, col0_t = r["col0"]
    ref, got = r["logits"]
    np.testing.assert_array_equal(col0_t, col0)
    # the int8 route's tolerance: bf16 activations, f32 sums in another
    # order (the per-layer routes dequantize to bf16 or read bf16 as JAX)
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999


def test_head_route_greedy_generate_matches_jax(head_route):
    _greedy_generate_check(head_route)


# --- sampling with the same uniforms --------------------------------------


@pytest.mark.parametrize("temp,top_p,top_k", [(0.7, 0.7, 30), (1.0, 0.9, 8),
                                              (0.3, 1.0, 5)])
def test_sample_one_same_uniforms(temp, top_p, top_k):
    rng = np.random.default_rng(top_k)
    logits = rng.standard_normal((6, 200)).astype(np.float32) * 3
    key = jax.random.key(top_k)
    ref = jsamp.sample_one(key, jnp.asarray(logits), jnp.float32(temp),
                           jnp.float32(top_p), top_k)
    u = jax.random.uniform(key, (6, top_k),
                           minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
    got = tsamp.sample_one(torch.from_numpy(logits), temp, top_p, top_k,
                           u=torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sample_main_and_high_same_uniforms():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((5, 300)).astype(np.float32) * 2
    temp = np.asarray([0.5, 0.7, 1.0, 1.2, 0.9], np.float32)  # per row
    key = jax.random.key(11)
    ref_n, ref_h = jsamp.sample_main_and_high(
        key, jnp.asarray(logits), jnp.asarray(temp), jnp.float32(0.8), 30)
    k1, k2 = jax.random.split(key)
    us = [np.asarray(jax.random.uniform(k, (5, 30),
                                        minval=jnp.finfo(jnp.float32).tiny,
                                        maxval=1.0)) for k in (k1, k2)]
    got_n, got_h = tsamp.sample_main_and_high(
        torch.from_numpy(logits), torch.from_numpy(temp), 0.8, 30,
        u=torch.from_numpy(np.stack(us)))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(ref_h))
    window = torch.from_numpy(np.asarray([[1] * 10, [got_n[1].item()] * 10,
                                          [0] * 10, [0] * 10, [0] * 10],
                                         np.int32))
    sel = tsamp.ras_select(got_n, got_h, window, 0, 299)
    ref_sel = jsamp.ras_select(ref_n, ref_h, jnp.asarray(window.numpy()), 0,
                               299)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref_sel))


def test_quantize_and_w8a8_match_jax():
    from fish_speech_tpu.ops import quant as jq

    rng = np.random.default_rng(2)
    w = rng.standard_normal((48, 64)).astype(np.float32)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    qj = jq.quantize_weight(jnp.asarray(w))
    qt = tquant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(qt["q"].numpy(), np.asarray(qj["q"]))
    np.testing.assert_array_equal(qt["s"].numpy(), np.asarray(qj["s"]))
    ref = jq.matmul_t(jnp.asarray(x), qj, w8a8=True)
    got = tquant.matmul_t(torch.from_numpy(x), qt, w8a8=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
