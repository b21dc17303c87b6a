"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so on a machine that has only PyTorch it
runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.models.dual_ar import (
    KVCache,
    _write_cache,
    precompute_freqs_cis,
)
from fish_speech_tpu_torch.ops import _cuda
from fish_speech_tpu_torch.ops import attention as ta
from fish_speech_tpu_torch.ops import fast_fused as ff
from fish_speech_tpu_torch.ops import voc_fused as tv
from fish_speech_tpu_torch.ops import w4a8 as tw
from fish_speech_tpu_torch.ops.attention import (
    decode_attention_stream,
    decode_attention_stream_fold,
    decode_attention_stream_plain,
)
from fish_speech_tpu_torch.ops.fast_fused import (
    FusedFastCache,
    fused_fast_sweep,
    fused_fast_sweep_plain,
    pack_fast_stack,
)
from fish_speech_tpu_torch.ops.quant import (
    quantize_weight,
    quantize_weight_int4_packed,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("int8_scores", [True, False])
def test_decode_attention_stream(dev, int8_scores):
    g = _gen(dev, 5)
    L, b, hkv, grp, d, s = 2, 8, 8, 4, 128, 384
    k8 = torch.randint(-127, 128, (L, s, b, hkv, d), generator=g, device=dev,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, s, b, hkv, d), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand((L, b, s * hkv), generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand((L, b, s * hkv), generator=g, device=dev) * 0.02 + 1e-3
    q = torch.randn((b, hkv, grp, d), generator=g,
                    device=dev).to(torch.bfloat16)
    lengths = torch.tensor([384, 300, 129, 1, 200, 384, 77, 256],
                           dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 5, 128, 0, 0, 300, 70, 0], dtype=torch.int32,
                          device=dev)
    got = decode_attention_stream(q, k8, v8, ks, vs, 1, lengths, starts,
                                  int8_scores=int8_scores, pos_major=True)
    ref = decode_attention_stream_plain(q, k8, v8, ks, vs, 1, lengths, starts,
                                        int8_scores=int8_scores,
                                        pos_major=True)
    torch.cuda.synchronize()
    # outputs of magnitude <= ~1 in bf16; p * v_scale is rounded to bf16 at
    # the kernel's running maxima and at the plain version's exact maximum:
    # a few bf16 ulps (2^-7 each)
    assert (got.float() - ref.float()).abs().max().item() < 1.5e-2


@pytest.mark.parametrize("b", [1, 40])
def test_decode_attention_stream_fold(dev, b):
    """The fold equals writing the rows with _write_cache and then launching
    decode_attention_stream: output, int8 rows and scales bit for bit."""
    g = _gen(dev, 9)
    L, hkv, grp, d, s, layer, wpos = 2, 8, 4, 128, 384, 1, 300
    k8 = torch.randint(-127, 128, (L, s, b, hkv, d), generator=g, device=dev,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, s, b, hkv, d), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand((L, b, s * hkv), generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand((L, b, s * hkv), generator=g, device=dev) * 0.02 + 1e-3
    q = torch.randn((b, hkv, grp, d), generator=g,
                    device=dev).to(torch.bfloat16)
    nk = torch.randn((b, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    nv = torch.randn((b, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.full((b,), wpos + 1, dtype=torch.int32, device=dev)
    starts = torch.randint(0, 290, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    starts[0] = 0
    two = KVCache(k8.clone(), v8.clone(), ks.clone(), vs.clone(),
                  pos_major=True)
    _write_cache(two, layer, wpos, nk[:, None], nv[:, None])
    ref = decode_attention_stream(q, two.k, two.v, two.ks, two.vs, layer,
                                  lengths, starts, pos_major=True)
    got = decode_attention_stream_fold(q, k8, v8, ks, vs, layer, lengths,
                                       starts, nk, nv, wpos)
    torch.cuda.synchronize()
    for a, r in ((got, ref), (k8, two.k), (v8, two.v), (ks, two.ks),
                 (vs, two.vs)):
        assert torch.equal(a, r)


# (b, S, rows) of the position-major cases: batch 1 at the engine's
# S = 2048, where the kernel splits each row's keys over CTAs, over the full
# cache and early in a request (keys 0-255: most splits hold none); batch
# 40 over ragged rows (one split); batch 3 with a row whose start is past
# its length
POS_ROWS = {"1-s2048": (1, 2048, "full"), "1-s2048-len256": (1, 2048, 256),
            "40": (40, 384, "ragged"), "3-empty-row": (3, 384, "empty")}
POS_MODES = [("int8", True), ("int8", False), ("bf16", False)]


@pytest.mark.parametrize("rows", list(POS_ROWS))
@pytest.mark.parametrize("cache,int8_scores", POS_MODES,
                         ids=["int8-i8", "int8", "bf16"])
def test_decode_attention_pos_major(dev, cache, int8_scores, rows):
    """#1 on the position-major cache (csrc/decode_attention.cu) against its
    plain twin, with one launch count per call; an empty row gives 0."""
    b, s, fill = POS_ROWS[rows]
    g = _gen(dev, 41 + b)
    L, hkv, grp, d, layer = 2, 8, 4, 128, 1
    shape = (L, s, b, hkv, d)
    if cache == "int8":
        k = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        ks = torch.rand((L, b, s * hkv), generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand((L, b, s * hkv), generator=g, device=dev) * 0.02 + 1e-3
        kernel = ta.KERNEL
    else:
        k = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        ks = vs = None
        kernel = ta.BF16_KERNEL
    q = torch.randn((b, hkv, grp, d), generator=g,
                    device=dev).to(torch.bfloat16)
    starts = torch.zeros((b,), dtype=torch.int32, device=dev)
    if fill == "ragged":
        lengths = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                                dtype=torch.int32)
        starts = (torch.rand((b,), generator=g, device=dev)
                  * lengths.float()).int()            # start < length
    elif fill == "empty":
        lengths = torch.tensor([s, 300, 50], dtype=torch.int32, device=dev)
        starts = torch.tensor([0, 7, 60], dtype=torch.int32, device=dev)
    else:
        lengths = torch.full((b,), s if fill == "full" else fill,
                             dtype=torch.int32, device=dev)
    before = kernel.launches
    args = (q, k, v, ks, vs, layer, lengths, starts, int8_scores)
    got = decode_attention_stream(*args, pos_major=True)
    ref = decode_attention_stream_plain(*args, pos_major=True)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    if fill == "empty":
        # the row with no key gives 0 (the plain version, one softmax over
        # the -1e30 masked scores, averages v there); the others as below
        assert torch.count_nonzero(got[2]).item() == 0
        got, ref = got[:2], ref[:2]
    err = (got.float() - ref.float()).abs().max().item()
    if cache == "int8":
        # outputs of magnitude <= ~1; p * v_scale is rounded to bf16 at the
        # kernel's running maxima and at the plain version's exact maximum:
        # a few bf16 ulps (2^-7 each)
        assert err < 1.5e-2
    else:
        # p rounded to bf16 likewise: 2 bf16 ulps of the largest output
        top = ref.float().abs().max().item()
        assert err <= 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


# (b, S, Hkv, write_pos) with a row's chunks on CTAs of their own: batch 1
# at S = 2048 (16 chunks of 128) and batch 40 with 2 kv heads at S = 384
# (3 chunks); write_pos in the first, a middle and the last chunk
FOLD_SPLITS = {"1-first": (1, 2048, 8, 10), "1-middle": (1, 2048, 8, 1000),
               "1-last": (1, 2048, 8, 2047), "40-first": (40, 384, 2, 100),
               "40-middle": (40, 384, 2, 200), "40-last": (40, 384, 2, 300)}


@pytest.mark.parametrize("case", list(FOLD_SPLITS))
def test_decode_attention_stream_fold_splits(dev, case):
    """The fold with a chunk a CTA equals _write_cache + decode_attention_
    stream bit for bit: output, int8 rows and scales."""
    b, s, hkv, wpos = FOLD_SPLITS[case]
    n_split, _ = ta.head_split(s)
    whole, _ = ta.cta_plan(n_split, b, hkv, 4, _cuda.sm_count(dev.index or 0))
    assert n_split > 1 and not whole
    g = _gen(dev, 43 + wpos)
    L, grp, d, layer = 2, 4, 128, 0
    k8 = torch.randint(-127, 128, (L, s, b, hkv, d), generator=g, device=dev,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, s, b, hkv, d), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand((L, b, s * hkv), generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand((L, b, s * hkv), generator=g, device=dev) * 0.02 + 1e-3
    q = torch.randn((b, hkv, grp, d), generator=g,
                    device=dev).to(torch.bfloat16)
    nk = torch.randn((b, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    nv = torch.randn((b, hkv, d), generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.full((b,), wpos + 1, dtype=torch.int32, device=dev)
    starts = torch.randint(0, wpos // 2 + 1, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    starts[0] = 0
    two = KVCache(k8.clone(), v8.clone(), ks.clone(), vs.clone(),
                  pos_major=True)
    _write_cache(two, layer, wpos, nk[:, None], nv[:, None])
    ref = decode_attention_stream(q, two.k, two.v, two.ks, two.vs, layer,
                                  lengths, starts, pos_major=True)
    before = ta.FOLD_KERNEL.launches
    got = decode_attention_stream_fold(q, k8, v8, ks, vs, layer, lengths,
                                       starts, nk, nv, wpos)
    torch.cuda.synchronize()
    assert ta.FOLD_KERNEL.launches == before + 1
    for a, r in ((got, ref), (k8, two.k), (v8, two.v), (ks, two.ks),
                 (vs, two.vs)):
        assert torch.equal(a, r)


# C2: the layouts and kernels whose row must not depend on the batch: #1
# position-major on the int8 cache (int8 scores) and on the bf16 cache, #5
# (the fold, with its write), #1 head-major on the int8 cache (int8 scores)
# and on the bf16 cache, and #6 (blocks) on the int8 cache
BATCH_INVARIANT = ["pos-int8", "pos-bf16", "fold", "head-int8", "head-bf16",
                   "blocks-int8"]


def _invariant_call(layout, cache, rows, q, lengths, starts, new):
    """One call of `layout` on the first `rows` rows of the B = 256 cache
    (copied, so that the fold's write lands in the copy)."""
    kv_axis = 2 if layout in ("pos-int8", "pos-bf16", "fold") else 1
    k, v, ks, vs = (None if t is None else
                    t.narrow(axis, 0, rows).contiguous()
                    for t, axis in zip(cache, (kv_axis, kv_axis, 1, 1)))
    args = (q[:rows], k, v, ks, vs, 0, lengths[:rows], starts[:rows])
    if layout == "fold":
        out = decode_attention_stream_fold(*args, new[0][:rows],
                                           new[1][:rows], 1500)
        return out, (k, v, ks, vs)
    if layout.startswith("pos"):
        return decode_attention_stream(*args, pos_major=True), None
    if layout == "blocks-int8":
        return ta.decode_attention_blocks(*args, int8_scores=True), None
    return decode_attention_stream(*args, layout == "head-int8",
                                   pos_major=False), None


@pytest.mark.parametrize("fill", ["full", "ragged"])
@pytest.mark.parametrize("layout", BATCH_INVARIANT)
def test_decode_attention_batch_invariant(dev, layout, fill):
    """C2: row 0 at B = 1, and the same row at the same cache columns
    inside B = 4 and B = 256, give the same bits. The three batches take
    three CTA plans at S = 2048 (head groups, a chunk a CTA, whole rows),
    and the chunks of 128 keys fix the sums. Row 0 is the whole cache or
    keys 37-1500 (chunks cut at both ends); the fold writes position 1500
    and its written rows and scales agree too."""
    g = _gen(dev, 77)
    n_sm = _cuda.sm_count(dev.index or 0)
    L, B, hkv, grp, d, s = 1, 256, 8, 4, 128, 2048
    pos = layout in ("pos-int8", "pos-bf16", "fold")
    shape = (L, s, B, hkv, d) if pos else (L, B, hkv, s, d)
    if layout.endswith("bf16"):
        k = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        ks = vs = None
    else:
        k = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        sshape = (L, B, s * hkv) if pos else (L, B, hkv, s)
        ks = torch.rand(sshape, generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand(sshape, generator=g, device=dev) * 0.02 + 1e-3
    q = torch.randn((B, hkv, grp, d), generator=g,
                    device=dev).to(torch.bfloat16)
    new = [torch.randn((B, hkv, d), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    lengths = torch.randint(1024, s + 1, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    starts = torch.randint(0, 512, (B,), generator=g, device=dev,
                           dtype=torch.int32)
    if fill == "full":
        lengths[0], starts[0] = s, 0
    else:
        lengths[0], starts[0] = 1501, 37
    plans = [ta.cta_plan(ta.head_split(s)[0], rows, hkv, grp, n_sm)
             for rows in (1, 4, B)]
    assert [whole for whole, _ in plans] == [False, False, True]
    outs, written = [], []
    for rows in (1, 4, B):
        out, cache = _invariant_call(layout, (k, v, ks, vs), rows, q,
                                     lengths, starts, new)
        outs.append(out[0])
        if cache is not None:
            written.append([t[:, 1500, 0] if t.dim() == 5 else
                            t[:, 0, 1500 * hkv:1501 * hkv] for t in cache])
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0].float()).all()
    for other in outs[1:]:
        assert torch.equal(outs[0], other)
    for other in written[1:]:
        for a, r in zip(written[0], other):
            assert torch.equal(a, r)


@pytest.mark.parametrize("dim", [2560, 1024, 128])
def test_rms_norm_batch_invariant(dev, dim):
    """The slow stack's and the fast head's RMSNorm (models/dual_ar.py): a
    row's output is the same bits alone and inside batches of 4, 40 and
    256. Its mean of squares is summed in float64: torch's f32 mean orders
    its sum by the tensor's shape, which moved a row's last bit with the
    batch on the card and parted a request alone from the same request in
    a batch."""
    from fish_speech_tpu_torch.models.dual_ar import rms_norm

    g = _gen(dev, 91)
    w = (1 + 0.1 * torch.randn(dim, generator=g, device=dev)).to(
        torch.bfloat16)
    for _ in range(50):
        x = (torch.randn((256, dim), generator=g, device=dev) * 3).to(
            torch.bfloat16)
        one = rms_norm(x[:1], w, 1e-6)
        for b in (4, 40, 256):
            assert torch.equal(rms_norm(x[:b], w, 1e-6)[:1], one)


# (entry, cache, int8_scores) of the head-major kernels
HEAD_CASES = [
    ("stream", "int8", True), ("stream", "int8", False),
    ("stream", "bf16", False),
    ("blocks", "int8", True), ("blocks", "int8", False),
    ("blocks", "bf16", False),
    ("stacked_rows", "int8", False), ("stacked_rows", "bf16", False),
    ("stacked", "int8", False), ("stacked", "bf16", False),
    ("dense", "bf16", False), ("dense", "f32", False),
    ("chunked", "bf16", False), ("chunked", "f32", False),
]


KERNEL_OF = {"stream": ta.STREAM_HEAD_KERNEL, "blocks": ta.BLOCKS_KERNEL,
             "stacked_rows": ta.ROWS_KERNEL, "stacked": ta.STACKED_KERNEL,
             "dense": ta.DENSE_KERNEL, "chunked": ta.CHUNKED_KERNEL}


def _head_call(entry, plain, q, k, v, ks, vs, layer, lengths, starts,
               int8_scores):
    sfx = "_plain" if plain else ""
    stacked = (q, k, v, ks, vs, layer, lengths, starts)
    if entry == "stream":
        return getattr(ta, "decode_attention_stream" + sfx)(
            *stacked, int8_scores, pos_major=False)
    if entry == "blocks":
        return getattr(ta, "decode_attention_blocks" + sfx)(
            *stacked, int8_scores=int8_scores)
    if entry in ("stacked_rows", "stacked"):
        return getattr(ta, f"decode_attention_{entry}{sfx}")(*stacked)
    name = "decode_attention" if entry == "dense" else \
        "decode_attention_chunked"
    return getattr(ta, name + sfx)(q, k[layer].contiguous(),
                                   v[layer].contiguous(), lengths, starts)


# (b, S, rows) of the head-major cases: batch 1 over the full cache and
# batch 40 over ragged rows at S = 384; batch 1 at the engine's S = 2048,
# where the kernel splits each row's keys over CTAs, over the full cache
# and early in a request (keys 0-255: most splits hold none); batch 3 with
# a row whose start is past its length
HEAD_ROWS = {1: (1, 384, "full"), 40: (40, 384, "ragged"),
             "1-s2048": (1, 2048, "full"), "1-s2048-len256": (1, 2048, 256),
             "3-empty-row": (3, 384, "empty")}


@pytest.mark.parametrize("b", list(HEAD_ROWS))
@pytest.mark.parametrize("entry,cache,int8_scores", HEAD_CASES,
                         ids=[f"{e}-{c}{'-i8' if i else ''}"
                              for e, c, i in HEAD_CASES])
def test_decode_attention_head_major(dev, entry, cache, int8_scores, b):
    """The head-major kernels (csrc/decode_attention_head.cu) against their
    plain twins, with one launch count per call; an empty row gives 0."""
    b, s, rows = HEAD_ROWS[b]
    g = _gen(dev, 21 + b)
    L, hkv, grp, d, layer = 2, 8, 4, 128, 1
    shape = (L, b, hkv, s, d)
    if cache == "int8":
        k = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand(shape[:-1], generator=g, device=dev) * 0.02 + 1e-3
    else:
        dt = torch.float32 if cache == "f32" else torch.bfloat16
        k = torch.randn(shape, generator=g, device=dev).to(dt)
        v = torch.randn(shape, generator=g, device=dev).to(dt)
        ks = vs = None
    q = torch.randn((b, hkv, grp, d), generator=g, device=dev).to(
        torch.float32 if cache == "f32" else torch.bfloat16)
    starts = torch.zeros((b,), dtype=torch.int32, device=dev)
    if rows == "ragged":
        lengths = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                                dtype=torch.int32)
        starts = (torch.rand((b,), generator=g, device=dev)
                  * lengths.float()).int()            # start < length
    elif rows == "empty":
        lengths = torch.tensor([s, 300, 50], dtype=torch.int32, device=dev)
        starts = torch.tensor([0, 7, 60], dtype=torch.int32, device=dev)
    else:
        lengths = torch.full((b,), s if rows == "full" else rows,
                             dtype=torch.int32, device=dev)
    kernel = KERNEL_OF[entry]
    before = kernel.launches
    args = (q, k, v, ks, vs, layer, lengths, starts, int8_scores)
    got = _head_call(entry, False, *args)
    ref = _head_call(entry, True, *args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    if rows == "empty":
        # the row with no key gives 0 (the plain version, one softmax over
        # the -1e30 masked scores, averages v there); the others as below
        assert torch.count_nonzero(got[2]).item() == 0
        got, ref = got[:2], ref[:2]
    err = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    if cache == "f32":
        # f32 throughout; online against exact softmax, sums in another order
        assert err <= 1e-5 * max(top, 1.0)
    else:
        # bf16 outputs; the value weights are rounded to bf16 at the
        # kernel's running maxima and at the plain version's exact one:
        # 2 bf16 ulps of the largest output (ulp = 2^-7 of its binade)
        assert err <= 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.parametrize("b", [1, 40])
def test_decode_attention_stream_bf16(dev, b):
    """#1 on a position-major bf16 cache: batch 1 over the full cache,
    batch 40 over ragged rows."""
    g = _gen(dev, 31 + b)
    L, hkv, grp, d, s, layer = 2, 8, 4, 128, 384, 1
    k = torch.randn((L, s, b, hkv, d), generator=g, device=dev).to(
        torch.bfloat16)
    v = torch.randn((L, s, b, hkv, d), generator=g, device=dev).to(
        torch.bfloat16)
    q = torch.randn((b, hkv, grp, d), generator=g,
                    device=dev).to(torch.bfloat16)
    if b == 1:
        lengths = torch.full((1,), s, dtype=torch.int32, device=dev)
        starts = torch.zeros((1,), dtype=torch.int32, device=dev)
    else:
        lengths = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                                dtype=torch.int32)
        starts = (torch.rand((b,), generator=g, device=dev)
                  * lengths.float()).int()
    before = ta.BF16_KERNEL.launches
    got = decode_attention_stream(q, k, v, None, None, layer, lengths, starts,
                                  pos_major=True)
    ref = decode_attention_stream_plain(q, k, v, None, None, layer, lengths,
                                        starts, pos_major=True)
    torch.cuda.synchronize()
    assert ta.BF16_KERNEL.launches == before + 1
    err = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    # p rounded to bf16 at the kernel's running maxima and at the plain
    # version's exact one: 2 bf16 ulps of the largest output
    assert err <= 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


# (N, K) of the S2-Pro slow stack's products: wqkv, wo, w1 and w3, w2
S2_PRO_PRODUCTS = {"wqkv": (6144, 2560), "wo": (2560, 4096),
                   "w1": (9728, 2560), "w2": (2560, 9728)}


def _w4a8_case(dev, m, n, k, gsz, kernel):
    g = _gen(dev, 11)
    qw = quantize_weight_int4_packed(
        torch.randn((n, k), generator=g, device=dev) * 0.02, gsz)
    x8 = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    fn, plain = ((tw.w4a8_matmul, tw.w4a8_matmul_plain) if kernel == "grouped"
                 else (tw.w4a8_matmul_pc, tw.w4a8_matmul_pc_plain))
    got = fn(x8, qw["q4"], qw["gs"])
    ref = plain(x8, qw["q4"], qw["gs"])
    torch.cuda.synchronize()
    # exact int32 dots, the same f32 steps in the same order (-fmad=false)
    assert torch.equal(got, ref)
    return tw.w4a8_plan(m, n, k, k // gsz, _cuda.sm_count(dev.index or 0),
                        kernel == "pc")


# M = 1, 2, 3 and 8 take the kernels' weight stream (a cluster of K parts
# a 32-column tile); 9 (the first tiled M), 40, 100 (a partial row tile)
# and 256 (a prefill) their int8 tensor-core tiles
@pytest.mark.parametrize("kernel", ["grouped", "pc"])
@pytest.mark.parametrize("product", list(S2_PRO_PRODUCTS))
@pytest.mark.parametrize("m", [1, 2, 3, 8, 9, 40, 100, 256])
def test_w4a8(dev, m, product, kernel):
    n, k = S2_PRO_PRODUCTS[product]
    tile, n_split, _ = _w4a8_case(dev, m, n, k, 128, kernel)
    assert (tile == 0) == (m <= 8)
    if kernel == "grouped" and tile:
        assert n_split == 1


# N = 200 and 136: a partial column tile; K = 384 at group size 64: a
# packed K (192 bytes) that is not a whole number of the grouped tiles'
# 128-byte steps, nor of the stream's 256-byte stages; group size 256:
# split parts of whole groups; K = 20480 at group size 128: 160 groups,
# the most the kernels take, in the stream's largest cluster. The tiles'
# per-channel product splits K in every case here (few column tiles), and
# so does every stream
@pytest.mark.parametrize("kernel", ["grouped", "pc"])
@pytest.mark.parametrize("n,k,gsz", [(200, 512, 128), (200, 384, 64),
                                     (136, 2048, 256), (136, 20480, 128)])
@pytest.mark.parametrize("m", [1, 8, 9, 100])
def test_w4a8_tails(dev, m, n, k, gsz, kernel):
    tile, n_split, _ = _w4a8_case(dev, m, n, k, gsz, kernel)
    assert (tile == 0) == (m <= 8)
    if tile:
        assert n_split == 1 if kernel == "grouped" else n_split > 1
    else:
        assert 1 < n_split <= tw.MAX_CLUSTER


# One M = 1 product of each kernel (the stream, one device kernel a call)
# captured in a CUDA graph and replayed equals the eager call bit for bit
@pytest.mark.parametrize("kernel", ["grouped", "pc"])
def test_w4a8_graph(dev, kernel):
    g = _gen(dev, 12)
    n, k = S2_PRO_PRODUCTS["w2"]
    qw = quantize_weight_int4_packed(
        torch.randn((n, k), generator=g, device=dev) * 0.02, 128)
    x8 = torch.randint(-127, 128, (1, k), generator=g, device=dev,
                       dtype=torch.int8)
    fn = tw.w4a8_matmul if kernel == "grouped" else tw.w4a8_matmul_pc
    eager = fn(x8, qw["q4"], qw["gs"])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x8, qw["q4"], qw["gs"])
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


# The tiles' dynamic shared-memory limit holds per card: set on card 0 by
# the first call, it must be set again for a call on card 1
@pytest.mark.parametrize("kernel", ["grouped", "pc"])
def test_w4a8_second_card(kernel):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    n, k = S2_PRO_PRODUCTS["w1"]
    for i in (0, 1):
        with torch.cuda.device(i):
            tile, _, _ = _w4a8_case(torch.device("cuda", i), 256, n, k, 128,
                                    kernel)
        assert tile in (1, 2)


# (dim, heads) of the sweep cases: a small width, and the S2-Pro fast head's
SWEEP_WIDTHS = {"small": (256, 4), "s2pro": (1024, 16)}
# batches up to 8 take the kernel's weight stream (one warp a column), 9 and
# up its int8 tensor-core tiles (40: one partial row tile; 256: four)
SWEEP_CASES = ([("small", b, pos) for b in (1, 3, 8, 9, 40, 256)
                for pos in (0, 3)]
               + [("s2pro", b, 3) for b in (1, 256)])


def _sweep_setup(dev, width, b, pos, n_layer=2, n_pos=4):
    """Two random int8 layers at `width`, the inputs of n_pos positions,
    and a cache whose positions before `pos` the plain sweep filled."""
    g = _gen(dev, 7)
    dim, n_head = SWEEP_WIDTHS[width]

    def w(*shape):
        return torch.randn(shape, generator=g, device=dev) * 0.02

    layers = {
        "attention": {"wqkv": quantize_weight(w(n_layer, 3 * dim, dim)),
                      "wo": quantize_weight(w(n_layer, dim, dim))},
        "feed_forward": {"w1": quantize_weight(w(n_layer, 3 * dim, dim)),
                         "w2": quantize_weight(w(n_layer, dim, 3 * dim)),
                         "w3": quantize_weight(w(n_layer, 3 * dim, dim))},
        "attention_norm": 1 + w(n_layer, dim),
        "ffn_norm": 1 + w(n_layer, dim),
    }
    packed = pack_fast_stack(layers)
    freqs = precompute_freqs_cis(n_pos, dim // n_head, 10000.0, dev)
    xs = torch.randn((n_pos, b, dim), generator=g,
                     device=dev).to(torch.bfloat16)
    cache = FusedFastCache.create(n_layer, n_pos, b, dim, dev)
    kw = dict(n_head=n_head, eps=1e-6)
    for p in range(pos):
        fused_fast_sweep_plain(packed, xs[p], cache, freqs, pos=p, **kw)
    return packed, freqs, xs[pos], cache, kw


def _clone(cache, n_layer=None):
    return FusedFastCache(*(t[:n_layer].clone() for t in (
        cache.k, cache.v, cache.ks, cache.vs)))


@pytest.mark.parametrize("width,b,pos", SWEEP_CASES)
def test_fast_sweep(dev, width, b, pos):
    packed, freqs, x, cache, kw = _sweep_setup(dev, width, b, pos)
    # one layer: the same inputs, the same rounding points and exact int32
    # products on both sides: bit-equal, output and cache row
    layer0 = {k: v[:1].contiguous() for k, v in packed.items()}
    c1, p1 = _clone(cache, 1), _clone(cache, 1)
    before = ff.KERNEL.launches
    got1 = fused_fast_sweep(layer0, x, c1, freqs, pos=pos, **kw)
    ref1 = fused_fast_sweep_plain(layer0, x, p1, freqs, pos=pos, **kw)
    torch.cuda.synchronize()
    assert ff.KERNEL.launches == before + 1
    assert torch.equal(got1, ref1)
    for a, r in zip((c1.k, c1.v, c1.ks, c1.vs), (p1.k, p1.v, p1.ks, p1.vs)):
        assert torch.equal(a[:, pos], r[:, pos])
    ck = _clone(cache)
    got = fused_fast_sweep(packed, x, ck, freqs, pos=pos, **kw)
    ref = fused_fast_sweep_plain(packed, x, cache, freqs, pos=pos, **kw)
    torch.cuda.synchronize()
    # the second layer takes the first one's output from each side; f32
    # sums in another order (RMSNorm, the head sums) may move one bf16
    # rounding and then one int8 step: 2^-5 of the output's scale
    scale = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2 ** -5 * scale
    k_diff = (ck.k[:, pos].int() - cache.k[:, pos].int()).abs()
    assert k_diff.max().item() <= 1
    assert torch.allclose(ck.ks[:, pos].float(), cache.ks[:, pos].float(),
                          rtol=2 ** -7)


def test_fast_sweep_threads_match_twin(dev):
    """The plain twin sums in the order of the kernel's CTA: its THREADS
    must be the built kernel's."""
    assert _cuda.lib("fast_sweep").fast_sweep_threads() == ff.THREADS
    assert ff.THREADS == 32 * ff.WARPS


# the sum-order witness: S2-Pro fast-head width, one layer, pos 9
WITNESS_SEEDS = range(8)


@pytest.mark.parametrize("b", [1, 3, 8, 40, 256])
def test_fast_sweep_order_witness(dev, b):
    """One S2-Pro layer at pos 9 over 8 seeds. The kernel must equal the
    twin (sums in the kernel's order) bit for bit. At each of the layer's
    reductions, on the twin's own inputs, the kernel's order, torch's and
    a float64 sum are compared: both f32 orders must lie within one bf16
    ulp of the f64 value. Logged per seed (one JSON line): the reductions'
    elements, those where torch's order differs from the kernel's, how
    many of those the kernel's value is farther from f64 than torch's is
    (and ties), the largest error of each order in bf16 ulps of the f64
    value, and the one-layer output elements where the twin in torch's
    order (the twin before) differs from the kernel."""
    import json

    dim, n_head, pos, n_pos = 1024, 16, 9, 10
    for seed in WITNESS_SEEDS:
        g = _gen(dev, 100 + seed)

        def w(*shape):
            return torch.randn(shape, generator=g, device=dev) * 0.02

        packed = pack_fast_stack({
            "attention": {"wqkv": quantize_weight(w(1, 3 * dim, dim)),
                          "wo": quantize_weight(w(1, dim, dim))},
            "feed_forward": {"w1": quantize_weight(w(1, 3 * dim, dim)),
                             "w2": quantize_weight(w(1, dim, 3 * dim)),
                             "w3": quantize_weight(w(1, 3 * dim, dim))},
            "attention_norm": 1 + w(1, dim), "ffn_norm": 1 + w(1, dim)})
        freqs = precompute_freqs_cis(n_pos, dim // n_head, 10000.0, dev)
        xs = torch.randn((n_pos, b, dim), generator=g,
                         device=dev).to(torch.bfloat16)
        cache = FusedFastCache.create(1, n_pos, b, dim, dev)
        kw = dict(n_head=n_head, eps=1e-6)
        for p in range(pos):
            fused_fast_sweep_plain(packed, xs[p], cache, freqs, pos=p, **kw)
        ck, cp, ct = _clone(cache), _clone(cache), _clone(cache)
        got = fused_fast_sweep(packed, xs[pos], ck, freqs, pos=pos, **kw)
        sums = []
        ref = fused_fast_sweep_plain(packed, xs[pos], cp, freqs, pos=pos,
                                     sums=sums, **kw)
        old = fused_fast_sweep_plain(packed, xs[pos], ct, freqs, pos=pos,
                                     order="torch", **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), seed
        for a, r in zip((ck.k, ck.v, ck.ks, ck.vs), (cp.k, cp.v, cp.ks,
                                                     cp.vs)):
            assert torch.equal(a[:, pos], r[:, pos]), seed
        n = differ = farther = ties = 0
        worst = {"kernel": 0.0, "torch": 0.0}
        for _, v in sums:
            f = v["f64"]
            ulp = 2.0 ** (torch.floor(torch.log2(f.abs().clamp_min(
                2.0 ** -100))) - 7)
            err = {o: (v[o].double() - f).abs() for o in worst}
            for o in worst:
                worst[o] = max(worst[o], (err[o] / ulp).max().item())
            d = v["kernel"] != v["torch"]
            n += f.numel()
            differ += int(d.sum())
            farther += int((d & (err["kernel"] > err["torch"])).sum())
            ties += int((d & (err["kernel"] == err["torch"])).sum())
        print(json.dumps({
            "witness": "fast_sweep sum order", "b": b, "seed": seed,
            "reduced": n, "torch_differs": differ,
            "kernel_farther": farther, "ties": ties,
            "kernel_err_bf16_ulps": worst["kernel"],
            "torch_err_bf16_ulps": worst["torch"],
            "old_twin_output_differs": int((old != got).sum())}))
        assert worst["kernel"] <= 1 and worst["torch"] <= 1


@pytest.mark.parametrize("b", [1, 40])
def test_fast_sweep_graph(dev, b):
    """One sweep captured in a CUDA graph and replayed equals the eager
    sweep bit for bit (output and cache row)."""
    pos = 3
    packed, freqs, x, cache, kw = _sweep_setup(dev, "small", b, pos)
    eager_cache, graph_cache = _clone(cache), _clone(cache)
    eager = fused_fast_sweep(packed, x, eager_cache, freqs, pos=pos, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_fast_sweep(packed, x, graph_cache, freqs, pos=pos, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    for a, r in zip((graph_cache.k, graph_cache.v, graph_cache.ks,
                     graph_cache.vs), (eager_cache.k, eager_cache.v,
                                       eager_cache.ks, eager_cache.vs)):
        assert torch.equal(a, r)


def _units(c, n, seed, dev, quant=False):
    g = np.random.default_rng(seed)
    units = []
    for _ in range(n):
        units.append({
            "conv1_w": torch.from_numpy(g.normal(0, 0.03, (7, c, c))),
            "conv1_b": torch.from_numpy(g.normal(0, 0.1, c)),
            "conv2_w": torch.from_numpy(g.normal(0, 0.1, (1, c, c))),
            "conv2_b": torch.from_numpy(g.normal(0, 0.1, c)),
            "snake1_alpha": torch.from_numpy(g.uniform(0.5, 2.0, c)),
            "snake2_alpha": torch.from_numpy(g.uniform(0.5, 2.0, c)),
        })
    return {k: v.to(dev)
            for k, v in tv.pack_res_stack(units, quant=quant).items()}


def _tail(c, seed, dev):
    a = np.random.default_rng(seed).uniform(0.5, 2.0, c)
    return torch.from_numpy(np.stack([a / np.pi, 1.0 / (a + 1e-9)])).to(
        dev, torch.float32).contiguous()


@pytest.mark.parametrize("d,tail", [(1, False), (9, True)])
def test_res_stack(dev, d, tail):
    c = 64
    packed = _units(c, 1, 12 + d, dev)
    tv_ = _tail(c, 14, dev) if tail else None
    x = torch.randn(2, 200, c, device=dev).to(torch.bfloat16)
    got = tv.fused_res_stack(x, packed, dilations=(d,), tail_vec=tv_)
    ref = tv.fused_res_stack_plain(x, packed, dilations=(d,), tail_vec=tv_)
    torch.cuda.synchronize()
    # bf16 state, f32 sums in another order: a few bf16 ulps of the scale
    scale = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2 ** -5 * scale


@pytest.mark.parametrize("short", [False, True], ids=["batch2", "t32"])
@pytest.mark.parametrize("d", [1, 3, 9])
def test_res_stack_s2pro(dev, d, short):
    """The bf16 residual-unit kernel (three device kernels: the entry snake,
    the k7 and 1x1 passes) at block 0's S2-Pro width, C = 768, with
    non-zero conv biases, the tail snake on d = 9 as block 0's last unit
    takes it: batch 2 over a T that is not a whole number of the plan's
    row tiles, and batch 1 over T = 32 rows, fewer than the 6d of left
    context at d = 9. One launch count a call; the pack with the K-major
    weights ("w7t", "w1t", as pack_decoder keeps them) and without (then
    transposed per call) give the same bits; against the plain twin 2^-5
    of the output's scale (bf16 state, f32 sums in another order)."""
    c = 768
    b, t = (1, 32) if short else (2, 1000)
    packed = _units(c, 1, 40 + d, dev)
    tv_ = _tail(c, 44, dev) if d == 9 else None
    plan = tv.voc_res_plan(b, t, c, d, _cuda.sm_count(dev.index or 0))
    assert any(t % q["bm"] for q in plan["passes"])
    x = torch.from_numpy(np.random.default_rng(45 + d).standard_normal(
        (b, t, c))).to(dev, torch.bfloat16)
    before = tv.RES_STACK.launches
    got = tv.fused_res_stack(x, packed, dilations=(d,), tail_vec=tv_)
    assert tv.RES_STACK.launches == before + 1
    ref = tv.fused_res_stack_plain(x, packed, dilations=(d,), tail_vec=tv_)
    w7t, w1t = tv.res_weights_t(packed)
    again = tv.fused_res_stack(x, {**packed, "w7t": w7t, "w1t": w1t},
                               dilations=(d,), tail_vec=tv_)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    scale = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2 ** -5 * scale


@pytest.mark.parametrize("stride,final", [(4, False), (2, True)])
def test_block(dev, stride, final):
    c, c_in = 64, 128
    g = np.random.default_rng(13)
    packed = _units(c, 3, 12, dev)
    pw = g.normal(0, 0.05, (2, c_in, stride * c))
    packed["tconv_pw"] = torch.from_numpy(pw).to(dev, torch.bfloat16)
    packed["tconv_pb"] = torch.from_numpy(
        np.tile(g.normal(0, 0.1, c), stride)).to(dev, torch.float32)
    fw = None
    if final:
        fwn = g.normal(0, 0.1, (8, c))
        fwn[7] = 0.0
        fwn[7, 0] = 0.03
        fw = torch.from_numpy(fwn).to(dev, torch.float32)
    kw = dict(stride=stride, tail_vec=_tail(c, 14, dev), final_w=fw)
    x = torch.randn(2, 300, c_in, device=dev).to(torch.bfloat16)
    got = tv.fused_block(x, packed, **kw)
    ref = tv.fused_block_plain(x, packed, **kw)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    scale = 1.0 if final else ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2 ** -5 * scale


# the S2-Pro decoder's blocks 1-3 (C_in, C, stride, final), each at batch 2
# over T_in rows (a T that is not a whole number of the plan's row tiles)
# and at batch 1 over 4 rows (fewer output rows than the left context)
S2_PRO_BLOCKS = {1: (768, 384, 8, False, 100), 2: (384, 192, 4, False, 333),
                 3: (192, 96, 2, True, 1001)}


@pytest.mark.parametrize("short", [False, True], ids=["batch2", "t_in4"])
@pytest.mark.parametrize("block", list(S2_PRO_BLOCKS))
def test_block_s2pro(dev, block, short):
    """The bf16 block kernel (whole-sequence passes) against the plain twin
    at S2-Pro widths, one launch count a call: the twin's state is bf16
    with f32 sums in another order, and a bf16 step that moves one ulp
    compounds over the units: 2^-5 of the output's scale (absolute on the
    waveform). The final conv's weights have the fan-in scale 1/sqrt(7C):
    at 0.1 (2.6x that) its 672 products turn one-ulp steps of the state
    into up to 0.068 of the waveform near tanh's zero crossing, and a
    float32 emulation of the passes on the CPU, in a third sum order,
    already moves it by 0.020 there. On the final block the state before
    the final conv (the block run without it) is held to 2^-5 of its
    scale as well."""
    c_in, c, stride, final, t_in = S2_PRO_BLOCKS[block]
    b = 1 if short else 2
    if short:
        t_in = 4
    g = np.random.default_rng(30 + block)
    packed = _units(c, 3, 31 + block, dev)
    pw = g.normal(0, 0.05, (2, c_in, stride * c))
    packed["tconv_pw"] = torch.from_numpy(pw).to(dev, torch.bfloat16)
    packed["tconv_pb"] = torch.from_numpy(
        np.tile(g.normal(0, 0.1, c), stride)).to(dev, torch.float32)
    fw = None
    if final:
        fwn = g.normal(0, 1 / np.sqrt(7 * c), (8, c))
        fwn[7] = 0.0
        fwn[7, 0] = 0.03
        fw = torch.from_numpy(fwn).to(dev, torch.float32)
    plan = tv.voc_block_plan(b, t_in, c_in, c, stride, final=final,
                             n_sm=_cuda.sm_count(dev.index or 0))
    assert any((q["m_hi"] - q["m_lo"]) % q["bm"] for q in plan["passes"])
    kw = dict(stride=stride, tail_vec=_tail(c, 32 + block, dev), final_w=fw)
    x = torch.from_numpy(g.standard_normal((b, t_in, c_in))).to(
        dev, torch.bfloat16)
    before = tv.BLOCK.launches
    got = tv.fused_block(x, packed, **kw)
    ref = tv.fused_block_plain(x, packed, **kw)
    torch.cuda.synchronize()
    assert tv.BLOCK.launches == before + 1
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.isfinite(got.float()).all()
    scale = 1.0 if final else ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2 ** -5 * scale
    if final:
        kw["final_w"] = None
        got = tv.fused_block(x, packed, **kw)
        ref = tv.fused_block_plain(x, packed, **kw)
        torch.cuda.synchronize()
        scale = ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= \
            2 ** -5 * scale


def _block_case(i, b, dev):
    """Block i of the S2-Pro decoder (seeded random weights; block 3 with
    the final conv at the fan-in scale), its keyword arguments and a seeded
    (b, T_in, C_in) input of 512, 4096 or 16384 rows: a row's input is the
    same at every b."""
    c_in, c, stride, final, _ = S2_PRO_BLOCKS[i]
    t_in = 64 * 8 * {1: 1, 2: 8, 3: 32}[i]
    g = np.random.default_rng(60 + i)
    packed = _units(c, 3, 61 + i, dev)
    packed["tconv_pw"] = torch.from_numpy(g.normal(
        0, 0.05, (2, c_in, stride * c))).to(dev, torch.bfloat16)
    packed["tconv_pb"] = torch.from_numpy(
        np.tile(g.normal(0, 0.1, c), stride)).to(dev, torch.float32)
    fw = None
    if final:
        fwn = g.normal(0, 1 / np.sqrt(7 * c), (8, c))
        fwn[7] = 0.0
        fwn[7, 0] = 0.03
        fw = torch.from_numpy(fwn).to(dev, torch.float32)
    kw = dict(stride=stride, tail_vec=_tail(c, 62 + i, dev), final_w=fw)
    x = torch.from_numpy(g.standard_normal((b, t_in, c_in))).to(
        dev, torch.bfloat16)
    return x, packed, kw


# the bf16 decoder's kernels at batches 4 and 8, as decode_codes_batch
# launches them (8 is its micro-batch and warmup_vocoder's default bucket;
# #4: block 0's residual units over 512 rows; #3: blocks 1-3 over inputs
# of 512, 4096 and 16384 rows): each against its plain twin with the
# tolerance it has at batch 1 and 2
@pytest.mark.parametrize("b", [4, 8])
@pytest.mark.parametrize("part", ["res-1", "res-3", "res-9", "block-1",
                                  "block-2", "block-3"])
def test_vocoder_s2pro_batch4(dev, part, b):
    kind, i = part.split("-")
    i = int(i)
    if kind == "res":
        c = 768
        packed = _units(c, 1, 40 + i, dev)
        tail = _tail(c, 44, dev) if i == 9 else None
        x = torch.from_numpy(np.random.default_rng(46 + i).standard_normal(
            (b, 64 * 8, c))).to(dev, torch.bfloat16)
        before = tv.RES_STACK.launches
        got = tv.fused_res_stack(x, packed, dilations=(i,), tail_vec=tail)
        ref = tv.fused_res_stack_plain(x, packed, dilations=(i,),
                                       tail_vec=tail)
        torch.cuda.synchronize()
        assert tv.RES_STACK.launches == before + 1
        final = False
    else:
        final = S2_PRO_BLOCKS[i][3]
        x, packed, kw = _block_case(i, b, dev)
        before = tv.BLOCK.launches
        got = tv.fused_block(x, packed, **kw)
        ref = tv.fused_block_plain(x, packed, **kw)
        torch.cuda.synchronize()
        assert tv.BLOCK.launches == before + 1
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.isfinite(got.float()).all()
    # test_res_stack_s2pro's and test_block_s2pro's bound
    scale = 1.0 if final else ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 2 ** -5 * scale


def test_final_block_rows_batch_invariant(dev):
    """#3 on the final block at batch 8: each row of the kernel's waveform,
    and of the twin's, equals that row decoded alone, bit for bit (the
    block's tiles do not depend on the batch), so a row's distance from
    the twin is the same at every batch it runs in."""
    x, packed, kw = _block_case(3, 8, dev)
    got = tv.fused_block(x, packed, **kw)
    ref = tv.fused_block_plain(x, packed, **kw)
    for r in range(x.shape[0]):
        assert torch.equal(got[r:r + 1], tv.fused_block(x[r:r + 1], packed,
                                                        **kw))
        assert torch.equal(ref[r:r + 1], tv.fused_block_plain(
            x[r:r + 1], packed, **kw))


# the int8 packs (VOC_QUANT): the same codes and exact int32 sums on both
# sides, and the f32 steps round alike (-fmad=false), so they agree bit for
# bit unless a sum order moves the final conv's f32 sum; the bound is one
# int8 step, 2^-7 of the output's scale. Several tiles each, batch 1 and 2.


def _close_i8(got, ref, scale=None):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale = ref.float().abs().max().item() if scale is None else scale
    assert (got.float() - ref.float()).abs().max().item() <= 2 ** -7 * scale


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("d,tail", [(1, False), (3, False), (9, True)])
def test_res_stack_i8(dev, d, tail, b):
    c, tt = 64, 64
    packed = _units(c, 1, 22 + d, dev, quant=True)
    tv_ = _tail(c, 24, dev) if tail else None
    x = torch.randn(b, 3 * tt, c, device=dev).to(torch.bfloat16)
    before = tv.RES_STACK_I8.launches
    got = tv.fused_res_stack(x, packed, dilations=(d,), tail_vec=tv_, tt=tt)
    ref = tv.fused_res_stack_plain(x, packed, dilations=(d,), tail_vec=tv_,
                                   tt=tt)
    torch.cuda.synchronize()
    assert tv.RES_STACK_I8.launches == before + 1
    _close_i8(got, ref)


def _block_i8_pack(c_in, c, stride, final, seed, dev):
    """Three int8 units and an int8 tconv pack (phase scales per output
    column), and with `final` the final conv's (8, c) taps and bias."""
    g = np.random.default_rng(seed)
    packed = _units(c, 3, seed + 2, dev, quant=True)
    pwf = torch.from_numpy(g.normal(0, 0.05, (2, c_in, stride * c))).float()
    ps = pwf.abs().amax(dim=(0, 1)).clamp_min(1e-12)
    packed["tconv_pw"] = torch.round(pwf / ps * 127.0).to(dev, torch.int8)
    bias = torch.from_numpy(np.tile(g.normal(0, 0.1, c), stride)).float()
    packed["tconv_pb"] = torch.stack([bias, ps / 127.0]).to(dev)
    fw = None
    if final:
        fwn = g.normal(0, 0.1, (8, c))
        fwn[7] = 0.0
        fwn[7, 0] = 0.03
        fw = torch.from_numpy(fwn).to(dev, torch.float32)
    return packed, fw


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("stride,final,tt", [(8, False, 64), (4, False, 32),
                                             (2, True, 128)])
def test_block_i8(dev, stride, final, tt, b):
    c, c_in = 64, 128
    packed, fw = _block_i8_pack(c_in, c, stride, final, 23, dev)
    kw = dict(stride=stride, tail_vec=_tail(c, 26, dev), final_w=fw, tt=tt)
    x = torch.randn(b, 3 * tt // stride, c_in, device=dev).to(torch.bfloat16)
    before = tv.BLOCK_I8.launches
    got = tv.fused_block(x, packed, **kw)
    ref = tv.fused_block_plain(x, packed, **kw)
    torch.cuda.synchronize()
    assert tv.BLOCK_I8.launches == before + 1
    _close_i8(got, ref, 1.0 if final else None)


# the int8 passes at S2-Pro's widths: C = 96 (32-byte K steps), 384 and
# 768 (128-byte), a tile shorter than its halo, batches of 1-8 rows (8:
# decode_codes_batch's micro-batch); bit for bit
# where no final conv is fused (its f32 sum over 7 x C may take another
# order: one int8 step, 2^-7, there)


@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("c,d,tt", [(96, 1, 64), (384, 3, 64),
                                    (768, 9, 32),    # halo 64 > tt
                                    (768, 1, 256)])
def test_res_stack_i8_widths(dev, c, d, tt, b):
    packed = _units(c, 1, 40 + d, dev, quant=True)
    tail = _tail(c, 41, dev) if d == 9 else None
    x = torch.randn(b, 4 * tt, c, device=dev).to(torch.bfloat16)
    before = tv.RES_STACK_I8.launches
    got = tv.fused_res_stack(x, packed, dilations=(d,), tail_vec=tail, tt=tt)
    ref = tv.fused_res_stack_plain(x, packed, dilations=(d,), tail_vec=tail,
                                   tt=tt)
    torch.cuda.synchronize()
    assert tv.RES_STACK_I8.launches == before + 1
    assert got.shape == ref.shape and torch.equal(got, ref)


@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("c_in,c,stride,tt,final", [
    (768, 384, 8, 64, False), (384, 192, 4, 32, False),
    (192, 96, 2, 64, False), (192, 96, 2, 128, True)])
def test_block_i8_widths(dev, c_in, c, stride, tt, final, b):
    packed, fw = _block_i8_pack(c_in, c, stride, final, 50 + stride, dev)
    kw = dict(stride=stride, tail_vec=_tail(c, 51, dev), final_w=fw, tt=tt)
    x = torch.randn(b, 3 * tt // stride, c_in, device=dev).to(torch.bfloat16)
    before = tv.BLOCK_I8.launches
    got = tv.fused_block(x, packed, **kw)
    ref = tv.fused_block_plain(x, packed, **kw)
    torch.cuda.synchronize()
    assert tv.BLOCK_I8.launches == before + 1
    if final:
        _close_i8(got, ref, 1.0)
    else:
        assert got.shape == ref.shape and torch.equal(got, ref)


# --- the continuous-batching path (per-row write positions) ----------------


@pytest.mark.parametrize("t", [1, 3])
def test_scatter_write_pos_int8(dev, t):
    """Each row's k/v at its own columns of the position-major int8 cache
    (one indexed write per tensor) equals writing each row alone through
    its slot's view at a host-int position: bit for bit, scales too."""
    from fish_speech_tpu_torch.engine.scheduler import slice_slot_cache

    g = _gen(dev, 21)
    n_layer, s, b, hkv, d = 2, 256, 4, 8, 128
    cache = KVCache.create(n_layer, b, s, hkv, d, dtype=torch.int8,
                           pos_major=True, device=dev)
    for a in (cache.k, cache.v):
        a.copy_(torch.randint(-127, 128, a.shape, generator=g, device=dev))
    for a in (cache.ks, cache.vs):
        a.copy_(torch.rand(a.shape, generator=g, device=dev) * 0.02)
    rowwise = KVCache(*(a.clone() for a in (cache.k, cache.v, cache.ks,
                                           cache.vs)), pos_major=True)
    k = torch.randn((b, t, hkv, d), generator=g,
                    device=dev).to(torch.bfloat16)
    v = torch.randn((b, t, hkv, d), generator=g,
                    device=dev).to(torch.bfloat16)
    pos = torch.tensor([5, 100, s - t, 17], dtype=torch.int32, device=dev)
    _write_cache(cache, 1, pos, k, v)
    for r in range(b):
        _write_cache(slice_slot_cache(rowwise, r), 1, int(pos[r]),
                     k[r:r + 1], v[r:r + 1])
    torch.cuda.synchronize()
    for name in ("k", "v", "ks", "vs"):
        assert torch.equal(getattr(cache, name), getattr(rowwise, name)), name


def _tick_model(dev):
    """A one-layer int8 serving model whose slow attention fits the decode
    kernel (head_dim 128, 2 query heads a kv head) and whose one-layer fast
    stack fits the sweep kernel (dim 256, 4 heads)."""
    from fish_speech_tpu_torch.engine.generate import serving_config
    from fish_speech_tpu_torch.models.config import DualARConfig
    from fish_speech_tpu_torch.models.init import init_dual_ar_params
    from fish_speech_tpu_torch.ops.quant import quantize_lm_params

    cfg = serving_config(DualARConfig(
        vocab_size=160, n_layer=1, n_head=4, n_local_heads=2, dim=256,
        head_dim=128, intermediate_size=512, max_seq_len=256,
        rope_base=10000.0, codebook_size=32, num_codebooks=4,
        n_fast_layer=1, fast_dim=256, fast_n_head=4, fast_n_local_heads=4,
        fast_head_dim=64, fast_intermediate_size=768, semantic_begin_id=64,
        semantic_end_id=95))
    params = init_dual_ar_params(_gen(dev, 3), cfg, dtype=torch.bfloat16,
                                 device=dev)
    return cfg, ff.enable_fused_fast_head(quantize_lm_params(params))


def test_scheduler_tick_pos_int8(dev, monkeypatch):
    """A 4-slot tick on the card through #1 and #2 (three active rows at
    different offsets, one left-padded, one prefix-cached with start 0, and
    one free slot writing at row cache_len - 1), against the same tick with
    both kernels' plain twins run on the card: the same int8 cache rows and
    scales bit for bit (the one-layer stack writes them before any
    attention), the same slot state; the attention kernel at the tick's
    per-row bounds within its stated tolerance."""
    from fish_speech_tpu_torch.engine.scheduler import (
        ContinuousBatcher,
        SlotRequest,
    )
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.ops.sampling import semantic_logit_bias

    cfg, params = _tick_model(dev)
    rng = np.random.default_rng(8)

    def prompt(t):
        p = rng.integers(0, 64, (cfg.num_codebooks + 1, t)).astype(np.int32)
        p[0, t // 2:] = rng.integers(64, 96, t - t // 2)
        p[1:, :t // 2] = 0
        p[1:] %= cfg.codebook_size
        return p

    prefix = prompt(11)
    prompts = [prompt(9), np.concatenate([prefix, prompt(6)], axis=1),
               prompt(21)]

    def batcher():
        b = ContinuousBatcher(
            params, cfg, num_slots=4, cache_len=256, im_end_id=4,
            bias=semantic_logit_bias(cfg.vocab_size, 64, 95, 4, device=dev),
            greedy=True, prompt_bucket=16, device=dev)
        for i, p in enumerate(prompts):
            b._assign(SlotRequest(request_id=i, prompt=p, max_new_tokens=8,
                                  prefix_id="p" if i == 1 else None,
                                  prefix_len=11 if i == 1 else 0), i)
        return b

    kern = batcher()
    n1, n2 = ta.KERNEL.launches, ff.KERNEL.launches
    kern.step()
    torch.cuda.synchronize()
    assert ta.KERNEL.launches - n1 == cfg.n_layer
    assert ff.KERNEL.launches - n2 == cfg.num_codebooks
    with monkeypatch.context() as m:
        m.setattr(dual_ar, "decode_attention_stream",
                  ta.decode_attention_stream_plain)
        m.setattr(ff, "fused_fast_sweep", ff.fused_fast_sweep_plain)
        plain = batcher()
        n1, n2 = ta.KERNEL.launches, ff.KERNEL.launches
        plain.step()
        torch.cuda.synchronize()
        assert (ta.KERNEL.launches, ff.KERNEL.launches) == (n1, n2)
    assert kern.start.tolist() == [7, 0, 11, 0]
    for name in ("pos", "start", "active"):
        assert torch.equal(getattr(kern, name), getattr(plain, name)), name
    assert kern.pos.tolist()[:3] == [17, 18, 33]
    for name in ("k", "v", "ks", "vs"):
        assert torch.equal(getattr(kern.cache, name),
                           getattr(plain.cache, name)), name
    # the free slot wrote its row at cache_len - 1, the active ones at pos
    assert kern.cache.k[0, 255, 3].abs().sum().item() > 0
    assert kern.cache.k[0, 16, 0].abs().sum().item() > 0
    # the attention kernel over the tick's bounds (lengths up to the cache
    # for the free slot, start 0 for the prefix-cached one) vs its twin
    write = torch.where(kern.active, kern.pos - 1,
                        torch.full_like(kern.pos, 255))
    lengths, starts = (write + 1).int(), kern.start
    q = torch.randn((4, 2, 2, 128), generator=_gen(dev, 4),
                    device=dev).to(torch.bfloat16)
    c = kern.cache
    got = decode_attention_stream(q, c.k, c.v, c.ks, c.vs, 0, lengths,
                                  starts, cfg.slow_attn.pallas_int8_scores,
                                  pos_major=True)
    ref = decode_attention_stream_plain(q, c.k, c.v, c.ks, c.vs, 0, lengths,
                                        starts,
                                        cfg.slow_attn.pallas_int8_scores,
                                        pos_major=True)
    torch.cuda.synchronize()
    # as test_decode_attention_stream: a few bf16 ulps
    assert (got.float() - ref.float()).abs().max().item() < 1.5e-2


def test_per_row_step_matches_rowwise(dev):
    """One decode step of four rows at per-row positions (#1 at B = 4 over
    the per-row bounds) against each row stepped alone at batch 1 with a
    host-int position (#1 at B = 1, another split of the keys): the same
    int8 cache rows and scales bit for bit (written before any attention),
    and the logits within the attention kernel's bf16 rounding."""
    from fish_speech_tpu_torch.engine.scheduler import slice_slot_cache
    from fish_speech_tpu_torch.models.dual_ar import forward_generate

    cfg, params = _tick_model(dev)
    g = _gen(dev, 9)
    b, s = 4, 256
    cache = KVCache.create(cfg.n_layer, b, s, cfg.n_local_heads,
                           cfg.head_dim, dtype=torch.int8, pos_major=True,
                           device=dev)
    for a in (cache.k, cache.v):
        a.copy_(torch.randint(-127, 128, a.shape, generator=g, device=dev))
    for a in (cache.ks, cache.vs):
        a.copy_(torch.rand(a.shape, generator=g, device=dev) * 0.02 + 1e-3)
    rowwise = KVCache(*(a.clone() for a in (cache.k, cache.v, cache.ks,
                                           cache.vs)), pos_major=True)
    pos = torch.tensor([16, 200, 255, 37], dtype=torch.int32, device=dev)
    starts = torch.tensor([7, 0, 0, 11], dtype=torch.int32, device=dev)
    x = torch.randint(64, 96, (b, cfg.num_codebooks + 1, 1), generator=g,
                      device=dev, dtype=torch.int32)
    x[:, 1:] %= cfg.codebook_size
    table = precompute_freqs_cis(s, cfg.head_dim, cfg.rope_base, dev)
    support = (64, 95, 4)
    out = forward_generate(params, cfg, x, cache, pos, table,
                           rope_positions=(pos - starts)[:, None],
                           key_valid_from=starts, logit_support=support)
    for r in range(b):
        # the kernels read a contiguous cache: the row's rows copied out,
        # stepped, and copied back into its slot
        view = slice_slot_cache(rowwise, r)
        parts = ("k", "v", "ks", "vs")
        alone = KVCache(*(getattr(view, n).contiguous() for n in parts),
                        pos_major=True)
        one = forward_generate(
            params, cfg, x[r:r + 1], alone, int(pos[r]), table,
            rope_positions=(pos - starts)[r:r + 1, None],
            key_valid_from=starts[r:r + 1].contiguous(),
            logit_support=support)
        for n in parts:
            getattr(view, n).copy_(getattr(alone, n))
        ref = one.logits.float()
        err = (out.logits[r:r + 1].float() - ref).abs().max().item()
        # bf16 activations after one attention whose kernels split the keys
        # differently at B = 4 and B = 1: the ports' serving tolerance
        assert err <= 2e-2 + 2e-2 * ref.abs().max().item(), (r, err)
    torch.cuda.synchronize()
    for name in ("k", "v", "ks", "vs"):
        assert torch.equal(getattr(cache, name), getattr(rowwise, name)), name


# --- tensor parallelism: the kernels on a rank's shard ---------------------

# (route, cache) of the TP path's attention: #1 position-major and
# head-major, #6 (blocks); int8 caches with int8 scores
TP_ATTENTION = [("pos", "int8"), ("pos", "bf16"), ("head", "int8"),
                ("head", "bf16"), ("blocks", "int8"), ("blocks", "bf16")]


@pytest.mark.parametrize("half", [0, 1])
@pytest.mark.parametrize("route,cache", TP_ATTENTION,
                         ids=[f"{r}-{c}" for r, c in TP_ATTENTION])
def test_attention_head_slice(dev, route, cache, half):
    """TP = 2 at S2-Pro's Hkv = 8: a rank's launch on its 4 heads (q's and
    the cache's head slice; position-major int8 scales as the rank's own
    flat (L, B, S*4)) == those heads of the full-width launch, bit for bit.
    B = 1, S = 2048, keys 37-1500 of layer 1."""
    g = _gen(dev, 90 + half)
    L, b, hkv, grp, d, s = 2, 1, 8, 4, 128, 2048
    pos = route == "pos"
    shape = (L, s, b, hkv, d) if pos else (L, b, hkv, s, d)
    if cache == "int8":
        k = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device=dev,
                          dtype=torch.int8)
        sshape = (L, b, s * hkv) if pos else (L, b, hkv, s)
        ks = torch.rand(sshape, generator=g, device=dev) * 0.02 + 1e-3
        vs = torch.rand(sshape, generator=g, device=dev) * 0.02 + 1e-3
    else:
        k = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        ks = vs = None
    q = torch.randn((b, hkv, grp, d), generator=g,
                    device=dev).to(torch.bfloat16)
    lengths = torch.full((b,), 1501, dtype=torch.int32, device=dev)
    starts = torch.full((b,), 37, dtype=torch.int32, device=dev)
    h0, h1 = half * hkv // 2, (half + 1) * hkv // 2

    def heads(t, axis):
        return t.narrow(axis, h0, h1 - h0).contiguous()

    def flat_heads(t):
        return t.reshape(L, b, s, hkv)[..., h0:h1].reshape(L, b, -1) \
            .contiguous()

    local_kv = [heads(t, 3 if pos else 2) for t in (k, v)]
    local_sc = [None if t is None else
                (flat_heads(t) if pos else heads(t, 2)) for t in (ks, vs)]
    kernel = {"pos": ta.KERNEL if cache == "int8" else ta.BF16_KERNEL,
              "head": ta.STREAM_HEAD_KERNEL,
              "blocks": ta.BLOCKS_KERNEL}[route]

    def call(q_, k_, v_, ks_, vs_):
        args = (q_, k_, v_, ks_, vs_, 1, lengths, starts)
        if route == "blocks":
            return ta.decode_attention_blocks(*args,
                                              int8_scores=cache == "int8")
        return decode_attention_stream(*args, cache == "int8",
                                       pos_major=pos)

    before = kernel.launches
    full = call(q, k, v, ks, vs)
    got = call(heads(q, 1), *local_kv, *local_sc)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, full[:, h0:h1])


@pytest.mark.parametrize("half", [0, 1])
def test_fast_sweep_batch_half(dev, half):
    """TP = 2 splits the fused sweep's batch over the model group: a
    rank's row of a B = 2 batch, swept alone at B = 1 (the kernel's own
    instance and plan there), == that row of the B = 2 launch, output and
    written cache row, bit for bit; S2-Pro's fast stack width over its 28
    layers, codebook position 3."""
    pos = 3
    packed, freqs, x, cache, kw = _sweep_setup(dev, "s2pro", 2, pos,
                                               n_layer=28)
    mine = FusedFastCache(*(t.narrow(2, half, 1).contiguous() for t in (
        cache.k, cache.v, cache.ks, cache.vs)))
    before = ff.KERNEL.launches
    full = fused_fast_sweep(packed, x, cache, freqs, pos=pos, **kw)
    got = fused_fast_sweep(packed, x[half:half + 1].contiguous(), mine,
                           freqs, pos=pos, **kw)
    torch.cuda.synchronize()
    assert ff.KERNEL.launches == before + 2
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, full[half:half + 1])
    for a, r in zip((mine.k, mine.v, mine.ks, mine.vs),
                    (cache.k, cache.v, cache.ks, cache.vs)):
        assert torch.equal(a[:, pos], r[:, pos, half:half + 1])
