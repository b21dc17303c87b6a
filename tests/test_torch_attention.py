"""Port's stream decode attention and its KV-write fold (plain versions) vs
the JAX Pallas kernels (interpret mode on the CPU), position-major int8
and bf16 layouts; the CUDA kernel's split of the key range and combine pass
(in torch) against the same kernels, and its split rule."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fish_speech_tpu.ops.attention import (
    pallas_decode_attention_stream,
    pallas_decode_attention_stream_fold,
)
from fish_speech_tpu_torch.models.dual_ar import KVCache, _write_cache
from fish_speech_tpu_torch.ops import attention as ta
from fish_speech_tpu_torch.ops.attention import (
    BF16_KERNEL,
    FOLD_KERNEL,
    KERNEL,
    decode_attention_stream,
    decode_attention_stream_fold,
    decode_attention_stream_fold_plain,
    decode_attention_stream_plain,
)
from test_torch_attention_head import split_combine


def _inputs(seed=17):
    # shapes of tests/test_pallas_attention.py::test_stream_kernel_pos_major
    rng = np.random.default_rng(seed)
    L, b, hkv, g, d, s = 2, 4, 8, 4, 32, 128
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    lengths = np.asarray([100, 128, 37, 64], np.int32)
    starts = np.asarray([0, 30, 5, 0], np.int32)
    k8 = rng.integers(-127, 128, (L, s, b, hkv, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (L, s, b, hkv, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (L, b, s * hkv)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (L, b, s * hkv)).astype(np.float32)
    return q, k8, v8, ks, vs, lengths, starts


@pytest.mark.parametrize("int8_scores", [False, True])
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_matches_pallas_stream(int8_scores, layer):
    q, k8, v8, ks, vs, lengths, starts = _inputs()
    ref = pallas_decode_attention_stream(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(ks), jnp.asarray(vs), jnp.int32(layer),
        jnp.asarray(lengths), jnp.asarray(starts), rows=2, chunk=64,
        int8_scores=int8_scores, pos_major=True)
    t = torch.from_numpy
    got = decode_attention_stream_plain(
        t(q).to(torch.bfloat16), t(k8), t(v8), t(ks), t(vs), layer,
        t(lengths), t(starts), int8_scores=int8_scores, pos_major=True)
    assert got.dtype == torch.bfloat16
    # both round p * v_scale to bf16 before the value product, but at
    # different running maxima (the kernel's online softmax over 64-row
    # chunks vs one exact softmax), and the output is bf16: outputs of
    # magnitude <= ~1.1 agree to 2 bf16 ulps (2^-7); measured 1 ulp
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=2 ** -7,
                               rtol=0)


def test_wrapper_takes_plain_path_on_cpu():
    q, k8, v8, ks, vs, lengths, starts = _inputs(3)
    t = torch.from_numpy
    before = KERNEL.launches
    a = decode_attention_stream(t(q).to(torch.bfloat16), t(k8), t(v8), t(ks),
                                t(vs), 1, t(lengths), t(starts),
                                pos_major=True)
    b = decode_attention_stream_plain(t(q).to(torch.bfloat16), t(k8), t(v8),
                                      t(ks), t(vs), 1, t(lengths), t(starts),
                                      pos_major=True)
    assert torch.equal(a, b)
    assert KERNEL.launches == before   # a CPU call is not a kernel launch


# --- the position-major bf16 cache ------------------------------------------


def _bf16_inputs(seed=19):
    """Shapes of tests/test_pallas_attention.py::test_stream_kernel_pos_major
    with its bf16 cache (values rounded to bf16 once, shared by both)."""
    rng = np.random.default_rng(seed)
    L, b, hkv, g, d, s = 2, 4, 8, 4, 32, 128
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    q = bf(rng.standard_normal((b, hkv, g, d)))
    k = bf(rng.standard_normal((L, s, b, hkv, d)))
    v = bf(rng.standard_normal((L, s, b, hkv, d)))
    lengths = np.asarray([100, 128, 37, 64], np.int32)
    starts = np.asarray([0, 30, 5, 0], np.int32)
    return q, k, v, lengths, starts


@pytest.mark.parametrize("layer", [0, 1])
def test_plain_matches_pallas_stream_bf16_cache(layer):
    q, k, v, lengths, starts = _bf16_inputs()
    ref = pallas_decode_attention_stream(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), None, None, jnp.int32(layer),
        jnp.asarray(lengths), jnp.asarray(starts), rows=2, chunk=64,
        pos_major=True)
    b16 = torch.bfloat16
    t = torch.from_numpy
    got = decode_attention_stream_plain(
        t(q).to(b16), t(k).to(b16), t(v).to(b16), None, None, layer,
        t(lengths), t(starts), pos_major=True)
    assert got.dtype == b16
    ref = np.asarray(ref, np.float32)
    # p is rounded to bf16 at the kernel's running maxima (64-row chunks)
    # and at the plain version's exact one: 2 bf16 ulps of the largest
    # output (ulp = 2^-7 of its binade)
    tol = 2 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=0)


def test_bf16_wrapper_takes_plain_path_on_cpu():
    q, k, v, lengths, starts = _bf16_inputs(5)
    b16 = torch.bfloat16
    t = torch.from_numpy
    args = (t(q).to(b16), t(k).to(b16), t(v).to(b16), None, None, 1,
            t(lengths), t(starts))
    before = (KERNEL.launches, BF16_KERNEL.launches)
    a = decode_attention_stream(*args, pos_major=True)
    assert torch.equal(a, decode_attention_stream_plain(*args,
                                                        pos_major=True))
    assert (KERNEL.launches, BF16_KERNEL.launches) == before
    # the fold writes the int8 cache only
    with pytest.raises(ValueError, match="int8"):
        decode_attention_stream_fold(*args, args[1][1, 0], args[2][1, 0], 3)



# --- the KV-write fold ------------------------------------------------------


def _fold_inputs(seed=23, pos=33):
    """Shapes of tests/test_pallas_attention.py::test_stream_fold_matches_
    two_step: a cache filled below `pos`, the new rows written at `pos`."""
    rng = np.random.default_rng(seed)
    L, S, B, HKV, G, D = 2, 64, 8, 2, 2, 128
    li = 1
    kf = rng.standard_normal((L, S, B, HKV, D)).astype(np.float32)
    vf = rng.standard_normal((L, S, B, HKV, D)).astype(np.float32)
    ksc = np.maximum(np.abs(kf).max(-1) / np.float32(127), np.float32(1e-8))
    vsc = np.maximum(np.abs(vf).max(-1) / np.float32(127), np.float32(1e-8))
    filled = (np.arange(S) < pos)[None, :, None, None, None]
    k8 = np.where(filled, np.round(kf / ksc[..., None]), 0).astype(np.int8)
    v8 = np.where(filled, np.round(vf / vsc[..., None]), 0).astype(np.int8)
    ks = ksc.transpose(0, 2, 1, 3).reshape(L, B, S * HKV)
    vs = vsc.transpose(0, 2, 1, 3).reshape(L, B, S * HKV)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    q = bf(rng.standard_normal((B, HKV, G, D)))
    nk = bf(rng.standard_normal((B, HKV, D)))
    nv = bf(rng.standard_normal((B, HKV, D)))
    lengths = np.full((B,), pos + 1, np.int32)
    starts = np.asarray([0] * (B // 2) + [5] * (B // 2), np.int32)
    return (q, k8, v8, ks, vs, lengths, starts, nk, nv), pos, li


def _torch_fold_args(arrays):
    q, k8, v8, ks, vs, lengths, starts, nk, nv = (torch.from_numpy(a.copy())
                                                  for a in arrays)
    b16 = torch.bfloat16
    return q.to(b16), k8, v8, ks, vs, lengths, starts, nk.to(b16), nv.to(b16)


def test_fold_plain_matches_pallas_fold():
    arrays, pos, li = _fold_inputs()
    q, k8, v8, ks, vs, lengths, starts, nk, nv = arrays
    j = lambda a, dt=None: jnp.asarray(a, dt)
    ob, kb, vb, nks, nvs = pallas_decode_attention_stream_fold(
        j(q, jnp.bfloat16), j(k8), j(v8), j(ks), j(vs), li, j(lengths),
        j(starts), j(nk, jnp.bfloat16), j(nv, jnp.bfloat16), pos, rows=4,
        chunk=32, int8_scores=True)
    tq, tk, tv, tks, tvs, tl, ts, tnk, tnv = _torch_fold_args(arrays)
    got = decode_attention_stream_fold_plain(tq, tk, tv, tks, tvs, li, tl,
                                             ts, tnk, tnv, pos)
    # the whole caches, new rows included, are bit-equal
    np.testing.assert_array_equal(tk.numpy(), np.asarray(kb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vb))
    hkv = nk.shape[1]
    sl = slice(pos * hkv, (pos + 1) * hkv)
    np.testing.assert_allclose(tks[li, :, sl].numpy(), np.asarray(nks),
                               rtol=1e-6)
    np.testing.assert_allclose(tvs[li, :, sl].numpy(), np.asarray(nvs),
                               rtol=1e-6)
    # the stream test's tolerance: 2 bf16 ulps at outputs of magnitude ~1
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ob, np.float32), atol=2 ** -7,
                               rtol=0)


@pytest.mark.parametrize("int8_scores", [False, True])
def test_fold_plain_equals_write_then_stream(int8_scores):
    arrays, pos, li = _fold_inputs(29)
    tq, tk, tv, tks, tvs, tl, ts, tnk, tnv = _torch_fold_args(arrays)
    ref_cache = KVCache(tk.clone(), tv.clone(), tks.clone(), tvs.clone(),
                        pos_major=True)
    _write_cache(ref_cache, li, pos, tnk[:, None], tnv[:, None])
    ref = decode_attention_stream_plain(tq, ref_cache.k, ref_cache.v,
                                        ref_cache.ks, ref_cache.vs, li, tl,
                                        ts, int8_scores, pos_major=True)
    got = decode_attention_stream_fold(tq, tk, tv, tks, tvs, li, tl, ts, tnk,
                                       tnv, pos, int8_scores)
    for a, b in ((got, ref), (tk, ref_cache.k), (tv, ref_cache.v),
                 (tks, ref_cache.ks), (tvs, ref_cache.vs)):
        assert torch.equal(a, b)


def test_fold_wrapper_takes_plain_path_on_cpu():
    arrays, pos, li = _fold_inputs(31)
    args = _torch_fold_args(arrays)
    before = FOLD_KERNEL.launches
    decode_attention_stream_fold(*args[:5], li, *args[5:], pos)
    assert FOLD_KERNEL.launches == before


# --- the CUDA kernel's split of the key range, in torch ---------------------


def _pos_split_combine(q, k, v, ks, vs, layer, lengths, starts,
                       int8_scores, n_split):
    """`split_combine` (the kernels' split-and-combine arithmetic) on layer
    `layer` of a position-major cache, cut into n_split equal chunks; also
    whether some chunk lies wholly outside its row's [start, length)."""
    s = k.shape[1]
    chunk = s // n_split
    valid = ta._head_valid(lengths, starts, s, q.device)
    empty = not bool(valid.reshape(q.shape[0], n_split, chunk).any(-1).all())
    return split_combine(q, *ta._pos_layer(k, v, ks, vs, layer), lengths,
                         starts, "blocks", int8_scores, n_split,
                         chunk), empty


# (cache, int8_scores) of the position-major kernel
POS_CASES = [("int8", True), ("int8", False), ("bf16", False)]


@pytest.mark.parametrize("n_split", [1, 4, 8])
@pytest.mark.parametrize("cache,int8_scores", POS_CASES,
                         ids=["int8-i8", "int8", "bf16"])
def test_split_combine_matches_pallas_stream(cache, int8_scores, n_split):
    """The position-major kernel splits each row's keys over CTAs and
    combines the partial softmax results: that arithmetic, at the ragged
    rows of test_stream_kernel_pos_major, within the plain version's
    tolerance of the TPU kernel."""
    layer = 1
    b16 = torch.bfloat16
    t = torch.from_numpy
    if cache == "int8":
        q, k, v, ks, vs, lengths, starts = _inputs()
        jk, jv, jks, jvs = (jnp.asarray(a) for a in (k, v, ks, vs))
        tk, tv, tks, tvs = t(k), t(v), t(ks), t(vs)
    else:
        q, k, v, lengths, starts = _bf16_inputs()
        jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        jks = jvs = tks = tvs = None
        tk, tv = t(k).to(b16), t(v).to(b16)
    ref = np.asarray(pallas_decode_attention_stream(
        jnp.asarray(q, jnp.bfloat16), jk, jv, jks, jvs, jnp.int32(layer),
        jnp.asarray(lengths), jnp.asarray(starts), rows=2, chunk=64,
        int8_scores=int8_scores, pos_major=True), np.float32)
    got, empty = _pos_split_combine(t(q).to(b16), tk, tv, tks, tvs, layer,
                                    t(lengths), t(starts), int8_scores,
                                    n_split)
    assert got.dtype == b16 and got.shape == q.shape
    assert empty == (n_split > 1)
    # the value weights are rounded to bf16 at each split's maximum and at
    # the TPU kernel's running one: the plain versions' tolerances, 2 bf16
    # ulps at outputs of magnitude ~1 (int8) or of the largest output
    tol = 2 ** -7 if cache == "int8" else \
        2 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol, rtol=0)


# write_pos 5, 33, 60 of S = 64: the first, a middle and the last split at
# n_split 4 and 8 (at 5, the rows that start at 5 hold the new key alone)
@pytest.mark.parametrize("write_pos", [5, 33, 60])
@pytest.mark.parametrize("n_split", [1, 4, 8])
def test_fold_split_combine_matches_pallas_fold(n_split, write_pos):
    """The fold's rows written as the kernel writes them, then the split
    arithmetic, against the TPU fold kernel."""
    arrays, pos, li = _fold_inputs(37, pos=write_pos)
    q, k8, v8, ks, vs, lengths, starts, nk, nv = arrays
    j = lambda a, dt=None: jnp.asarray(a, dt)
    ref = pallas_decode_attention_stream_fold(
        j(q, jnp.bfloat16), j(k8), j(v8), j(ks), j(vs), li, j(lengths),
        j(starts), j(nk, jnp.bfloat16), j(nv, jnp.bfloat16), pos, rows=4,
        chunk=32, int8_scores=True)[0]
    tq, tk, tv, tks, tvs, tl, ts, tnk, tnv = _torch_fold_args(arrays)
    hkv = tnk.shape[1]
    sl = slice(pos * hkv, (pos + 1) * hkv)
    tk[li, pos], tks[li, :, sl] = ta.quantize_kv_rows(tnk)
    tv[li, pos], tvs[li, :, sl] = ta.quantize_kv_rows(tnv)
    got, empty = _pos_split_combine(tq, tk, tv, tks, tvs, li, tl, ts, True,
                                    n_split)
    # the cache is filled below write_pos: splits past it hold no key
    assert empty == (n_split > 1 and write_pos < 60)
    # the fold test's tolerance: 2 bf16 ulps at outputs of magnitude ~1
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=2 ** -7,
                               rtol=0)


# (S, B, Hkv, cache) -> (n_split, chunk) of the position-major kernel: the
# engine's batch 1 at S = 2048 on both caches, the bench's batch 256 at
# S = 384, the card test's batch 40 with 2 kv heads, and an S that is not a
# multiple of the chunk. The chunks are JAX's 128 keys whatever the batch.
POS_SPLITS = {"b1-s2048-int8": ((2048, 1, 8, torch.int8), (16, 128)),
              "b1-s2048-bf16": ((2048, 1, 8, torch.bfloat16), (16, 128)),
              "b256-s384-int8": ((384, 256, 8, torch.int8), (3, 128)),
              "b256-s384-bf16": ((384, 256, 8, torch.bfloat16), (3, 128)),
              "b40-s384-hkv2": ((384, 40, 2, torch.int8), (3, 128)),
              "b1-s1000": ((1000, 1, 8, torch.int8), (8, 128))}


@pytest.mark.parametrize("shape", list(POS_SPLITS))
def test_pos_split(shape):
    (s, b, hkv, dtype), want = POS_SPLITS[shape]
    n_split, chunk = ta.head_split(s)
    assert (n_split, chunk) == want
    # the chunks cover S and none lies wholly beyond it
    assert n_split * chunk >= s > (n_split - 1) * chunk
    # the CTAs: whole rows where the rows alone fill the card, else a chunk
    # and a group of the 4 query heads a CTA, SPLIT_CTAS_PER_SM CTAs an SM
    # at least unless every head has its own
    whole, hs = ta.cta_plan(n_split, b, hkv, 4, 132)
    if whole:
        assert hs == 1 and (n_split == 1 or b * hkv >= 2 * 132)
    else:
        assert n_split * b * hkv * hs >= ta.SPLIT_CTAS_PER_SM["pos"] * 132 \
            or hs == 4


@pytest.mark.parametrize("s", [1, 127, 128, 129, 384, 2048, 4096])
def test_split_rule_ignores_batch_and_card(s):
    """C2: a row's chunks, which fix its f32 sums, are the same at batch 1,
    4 and 256 and on cards of 114 and 132 SMs (the wrapper's `_split`
    reads the SM count through _cuda.sm_count); only the CTAs that take
    them change."""
    q_of = {b: torch.zeros((b, 8, 4, 128), dtype=torch.bfloat16)
            for b in (1, 4, 256)}
    seen = set()
    for n_sm in (114, 132):
        for b, q in q_of.items():
            old = ta._cuda.sm_count
            ta._cuda.sm_count = lambda index, n=n_sm: n
            try:
                (n_split, whole, hs), part = ta._split(q, s)
            finally:
                ta._cuda.sm_count = old
            seen.add((n_split, ta.head_split(s)[1]))
            assert (part is None) == bool(whole)
            if part is not None:
                # at most B * Hkv * ceil(S / 128) * G * (D + 2) floats
                assert part.numel() == b * 8 * n_split * 4 * 130
    assert seen == {(-(-s // 128), 128)}


@pytest.mark.parametrize("g", [3, 16])
def test_stream_args_refuse_query_groups(g):
    """The kernel takes 1, 2, 4 or 8 query heads per kv head: anything else
    is refused before a launch."""
    q = torch.zeros((1, 8, g, 128), dtype=torch.bfloat16)
    k = torch.zeros((2, 16, 1, 8, 128), dtype=torch.int8)
    sc = torch.zeros((2, 1, 16 * 8))
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="1, 2, 4 or 8"):
        ta._check_stream_args(q, k, k, sc, sc, 0, lengths, lengths)
