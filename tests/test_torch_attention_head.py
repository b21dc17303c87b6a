"""Port's decode attention over the head-major KV cache (plain versions) vs
the JAX Pallas kernels (interpret mode on the CPU): the stream kernel with
pos_major=False, blocks, stacked_rows, stacked, and the per-layer dense and
chunked kernels, on int8 and bf16 (or f32) caches; the CUDA kernel's
split of the key range and combine pass (in torch) against the same
kernels, and the split rule `head_split`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fish_speech_tpu.ops import attention as ja
from fish_speech_tpu_torch.ops import attention as ta

# shapes of tests/test_pallas_attention.py's stacked / blocks tests
L, B, HKV, G, D, S = 3, 4, 8, 4, 32, 256
LAYER = 1
LENGTHS = np.asarray([100, 256, 37, 130], np.int32)
STARTS = np.asarray([0, 30, 5, 0], np.int32)
CHUNK, ROWS = 64, 2


def _inputs(cache: str, seed: int):
    """q and a stacked (L, B, Hkv, S, D) cache: int8 with (L, B, Hkv, S)
    scales, or bf16 / f32 normals with no scales."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV, G, D)).astype(np.float32)
    if cache == "int8":
        k = rng.integers(-127, 128, (L, B, HKV, S, D)).astype(np.int8)
        v = rng.integers(-127, 128, (L, B, HKV, S, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (L, B, HKV, S)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (L, B, HKV, S)).astype(np.float32)
        return q, k, v, ks, vs
    k = rng.standard_normal((L, B, HKV, S, D)).astype(np.float32)
    v = rng.standard_normal((L, B, HKV, S, D)).astype(np.float32)
    return q, k, v, None, None


def _both(cache: str, seed: int):
    """The same inputs for JAX and the port: q and float caches in the
    working type (bf16, or f32 for the "f32" cache)."""
    q, k, v, ks, vs = _inputs(cache, seed)
    jdt, tdt = ((jnp.float32, torch.float32) if cache == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    j = dict(q=jnp.asarray(q, jdt),
             k=jnp.asarray(k) if cache == "int8" else jnp.asarray(k, jdt),
             v=jnp.asarray(v) if cache == "int8" else jnp.asarray(v, jdt),
             ks=None if ks is None else jnp.asarray(ks),
             vs=None if vs is None else jnp.asarray(vs),
             lengths=jnp.asarray(LENGTHS), starts=jnp.asarray(STARTS))
    t = lambda a: None if a is None else torch.from_numpy(a)
    p = dict(q=t(q).to(tdt),
             k=t(k) if cache == "int8" else t(k).to(tdt),
             v=t(v) if cache == "int8" else t(v).to(tdt),
             ks=t(ks), vs=t(vs), lengths=t(LENGTHS), starts=t(STARTS))
    return j, p


def _jax(entry: str, a: dict, int8_scores: bool):
    stacked = (a["q"], a["k"], a["v"], a["ks"], a["vs"], jnp.int32(LAYER),
               a["lengths"], a["starts"])
    one = (a["q"], a["k"][LAYER], a["v"][LAYER], a["lengths"], a["starts"])
    if entry == "stream":
        return ja.pallas_decode_attention_stream(
            *stacked, rows=ROWS, chunk=CHUNK, int8_scores=int8_scores,
            pos_major=False)
    if entry == "blocks":
        return ja.pallas_decode_attention_blocks(
            *stacked, rows=ROWS, chunk=CHUNK, int8_scores=int8_scores)
    if entry == "stacked_rows":
        return ja.pallas_decode_attention_stacked_rows(*stacked, chunk=CHUNK)
    if entry == "stacked":
        return ja.pallas_decode_attention_stacked(*stacked, chunk=CHUNK)
    if entry == "dense":
        return ja.pallas_decode_attention(*one)
    return ja.pallas_decode_attention_chunked(*one, chunk=CHUNK)


def _port(entry: str, a: dict, int8_scores: bool, plain: bool = True):
    suffix = "_plain" if plain else ""
    stacked = (a["q"], a["k"], a["v"], a["ks"], a["vs"], LAYER, a["lengths"],
               a["starts"])
    one = (a["q"], a["k"][LAYER], a["v"][LAYER], a["lengths"], a["starts"])
    if entry == "stream":
        return getattr(ta, "decode_attention_stream" + suffix)(
            *stacked, int8_scores, pos_major=False)
    if entry == "blocks":
        return getattr(ta, "decode_attention_blocks" + suffix)(
            *stacked, rows=ROWS, chunk=CHUNK, int8_scores=int8_scores)
    if entry in ("stacked_rows", "stacked"):
        return getattr(ta, f"decode_attention_{entry}{suffix}")(
            *stacked, chunk=CHUNK)
    if entry == "dense":
        return getattr(ta, "decode_attention" + suffix)(*one)
    return getattr(ta, "decode_attention_chunked" + suffix)(*one,
                                                            chunk=CHUNK)


# (entry, cache, int8_scores)
CASES = [
    ("stream", "int8", True), ("stream", "int8", False),
    ("stream", "bf16", False),
    ("blocks", "int8", True), ("blocks", "int8", False),
    ("blocks", "bf16", False),
    ("stacked_rows", "int8", False), ("stacked_rows", "bf16", False),
    ("stacked", "int8", False), ("stacked", "bf16", False),
    ("dense", "bf16", False), ("dense", "f32", False),
    ("chunked", "bf16", False), ("chunked", "f32", False),
]


@pytest.mark.parametrize("entry,cache,int8_scores", CASES,
                         ids=[f"{e}-{c}{'-i8' if i else ''}"
                              for e, c, i in CASES])
def test_plain_matches_pallas(entry, cache, int8_scores):
    j, p = _both(cache, seed=len(entry) + 7 * len(cache) + int8_scores)
    ref = np.asarray(_jax(entry, j, int8_scores), np.float32)
    got = _port(entry, p, int8_scores)
    assert got.dtype == p["q"].dtype and got.shape == p["q"].shape
    _assert_close(got, ref, cache)


def _assert_close(got: torch.Tensor, ref: np.ndarray, cache: str) -> None:
    got = got.float().numpy()
    if cache == "f32":
        # f32 throughout: one exact softmax against the TPU kernel's online
        # softmax over 64-key chunks; f32 rounding at outputs of magnitude ~1
        np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
        return
    # bf16 outputs. The value weights are rounded to bf16 (bf16(p * vs) or
    # bf16(p)) at the kernel's running maxima and at the plain version's
    # exact maximum, and the output is rounded to bf16: they agree to 2
    # bf16 ulps of the largest output (ulp = 2^-7 of its binade)
    top = np.abs(ref).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got, ref, atol=2 * ulp, rtol=0)


VARIANT = {"stream": "blocks", "blocks": "blocks", "stacked_rows": "rows",
           "stacked": "f32", "dense": "f32", "chunked": "f32"}


def split_combine(q, k, v, ks, vs, lengths, starts, variant: str,
                  int8_scores: bool, n_split: int,
                  chunk: int) -> torch.Tensor:
    """The CUDA kernels' split-and-combine arithmetic, in torch, on one
    layer's head-major (B, Hkv, S, D) k/v and (B, Hkv, S) scales (None for
    a float cache): the key range cut into n_split chunks, each chunk's
    softmax taken at its own maximum (an empty chunk: m = -inf, l = 0,
    acc = 0) with the value weights rounded there, then the chunks folded
    in order (csrc/decode_split.cuh fold_chunk): M' = max(M, m_i),
    num = num e^(M - M') + acc_i e^(m_i - M'), den likewise with l_i, an
    empty chunk skipped; out = num / max(den, 1e-20)."""
    sc, vf = ta._head_scores(q, k, v, ks, vs, variant, int8_scores)
    valid = ta._head_valid(lengths, starts, k.shape[2], q.device)
    parts = []
    for c in range(n_split):
        sl = slice(c * chunk, (c + 1) * chunk)
        ok = valid[..., sl]
        m = torch.where(ok, sc[..., sl], -torch.inf).amax(-1, keepdim=True)
        p = torch.where(ok, torch.exp(sc[..., sl] - m), 0.0)
        w = ta._head_weights(p, None if vs is None else vs[..., sl], variant)
        parts.append((m, p.sum(-1, keepdim=True), w @ vf[:, :, sl]))
    big = parts[0][0]
    run = torch.full_like(big, -torch.inf)
    num = den = 0.0
    for m, l, acc in parts:
        new = torch.maximum(run, m)
        skip = m == -torch.inf
        a = torch.where(skip, 1.0, torch.exp(run - new))
        w = torch.where(skip, 0.0, torch.exp(m - new))
        num = num * a + acc * w
        den = den * a + l * w
        run = torch.where(skip, run, new)
    return (num / den.clamp_min(1e-20)).to(q.dtype)


def _split_combine(entry: str, a: dict, int8_scores: bool,
                   n_split: int) -> torch.Tensor:
    """`split_combine` on LAYER of this file's stacked cache."""
    q = a["q"]
    k, v = a["k"][LAYER], a["v"][LAYER]
    ks = None if a["ks"] is None else a["ks"][LAYER]
    vs = None if a["vs"] is None else a["vs"][LAYER]
    # the fold holds for any even cut of the keys; the kernels' own chunks
    # are ta.CHUNK = 128 keys (n_split 2 here)
    chunk = S // n_split
    assert chunk * n_split == S
    # every row of the file has keys; with more than one split, some of
    # its chunks lie wholly outside [start, length)
    valid = ta._head_valid(a["lengths"], a["starts"], S, q.device)
    has_keys = valid.reshape(B, n_split, chunk).any(-1)
    assert bool(has_keys.all()) == (n_split == 1)
    return split_combine(q, k, v, ks, vs, a["lengths"], a["starts"],
                         VARIANT[entry], int8_scores, n_split, chunk)


@pytest.mark.parametrize("n_split", [1, 4, 8, 2])
@pytest.mark.parametrize("entry,cache,int8_scores", CASES,
                         ids=[f"{e}-{c}{'-i8' if i else ''}"
                              for e, c, i in CASES])
def test_split_combine_matches_pallas(entry, cache, int8_scores, n_split):
    """The CUDA kernel splits each row's keys over CTAs and combines the
    partial softmax results: that arithmetic, at the ragged rows of this
    file, within the plain version's tolerance of the TPU kernels."""
    j, p = _both(cache, seed=len(entry) + 7 * len(cache) + int8_scores)
    ref = np.asarray(_jax(entry, j, int8_scores), np.float32)
    got = _split_combine(entry, p, int8_scores, n_split)
    assert got.dtype == p["q"].dtype and got.shape == p["q"].shape
    _assert_close(got, ref, cache)


# (S, B, Hkv) -> (n_split, chunk) on a card of 132 SMs: the engine's batch
# 1 at S = 2048 (the stacked cache, and one layer of it for the per-layer
# entries), the bench's batch 256 at S = 384, the card test's batch 3 at
# S = 384, and an S that is not a multiple of the chunk; the chunks are
# JAX's 128 keys whatever the batch
SPLITS = {"b1-s2048": ((2048, 1, 8), (16, 128)),
          "b256-s384": ((384, 256, 8), (3, 128)),
          "b3-s384": ((384, 3, 8), (3, 128)),
          "b1-s1000": ((1000, 1, 8), (8, 128))}


@pytest.mark.parametrize("shape", list(SPLITS))
def test_head_split(shape):
    (s, b, hkv), want = SPLITS[shape]
    n_split, chunk = ta.head_split(s)
    assert (n_split, chunk) == want
    # the chunks cover S and none lies wholly beyond it
    assert n_split * chunk >= s > (n_split - 1) * chunk
    # the CTAs: whole rows (no scratch) where the rows alone fill the card,
    # else one a chunk and a group of the query heads
    whole, hs = ta.cta_plan(n_split, b, hkv, 4, 132, "head")
    assert whole == (b * hkv >= 2 * 132)
    ctas = (1 if whole else n_split * hs) * b * hkv
    assert ctas >= ta.SPLIT_CTAS_PER_SM["head"] * 132 or hs == 4


ENTRIES = ["stream", "blocks", "stacked_rows", "stacked", "dense",
           "chunked"]
KERNELS = {"stream": ta.STREAM_HEAD_KERNEL, "blocks": ta.BLOCKS_KERNEL,
           "stacked_rows": ta.ROWS_KERNEL, "stacked": ta.STACKED_KERNEL,
           "dense": ta.DENSE_KERNEL, "chunked": ta.CHUNKED_KERNEL}


@pytest.mark.parametrize("entry", ENTRIES)
def test_wrapper_takes_plain_path_on_cpu(entry):
    _, p = _both("bf16" if entry in ("dense", "chunked") else "int8", 3)
    before = {n: k.launches for n, k in KERNELS.items()}
    got = _port(entry, p, True, plain=False)
    ref = _port(entry, p, True, plain=True)
    assert torch.equal(got, ref)
    # a CPU call is not a kernel launch
    assert {n: k.launches for n, k in KERNELS.items()} == before


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """Checks that run before any launch: the per-layer entries' f32
    cache is refused by the stacked ones; an int8 cache needs scales."""
    q = torch.zeros((1, 8, 4, 128), dtype=torch.bfloat16)
    k = torch.zeros((2, 1, 8, 16, 128))
    lengths = torch.ones(1, dtype=torch.int32)
    starts = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        ta._launch_head(ta.BLOCKS_KERNEL, q, k, k, None, None, 0, lengths,
                        starts)
    with pytest.raises(ValueError, match="without scales"):
        ta._launch_head(ta.ROWS_KERNEL, q, k.to(torch.int8),
                        k.to(torch.int8), None, None, 0, lengths, starts)
    with pytest.raises(ValueError, match="head_dim 128"):
        ta._launch_head(ta.DENSE_KERNEL, q[..., :64], k[0, ..., :64],
                        k[0, ..., :64], None, None, 0, lengths, starts)
