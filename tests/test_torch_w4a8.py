"""Port's packed-int4 quantization and W4A8 products (plain versions) vs the
JAX package: ops/quant.py int4 packing and leaf selection, and the Pallas
W4A8 kernels in interpret mode on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.models.init import init_dual_ar_params
from fish_speech_tpu.ops import quant as jq
from fish_speech_tpu.ops.w4a8 import w4a8_matmul as jw4a8
from fish_speech_tpu.ops.w4a8 import w4a8_matmul_pc as jw4a8_pc
from fish_speech_tpu_torch.models.init import lm_params_from_jax
from fish_speech_tpu_torch.ops import quant as tq
from fish_speech_tpu_torch.ops import w4a8 as tw

from test_torch_lm import serving_cfg_jax


def _leaves(tree, prefix=()):
    if isinstance(tree, dict) and not tq.is_quantized(tree):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("shape,gsz", [((48, 256), 32), ((2, 64, 512), 128)])
def test_int4_packing_matches_jax(shape, gsz):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = jq.quantize_weight_int4_packed(jnp.asarray(w), gsz)
    if len(shape) == 3:      # the port's layer-at-a-time path
        got = tq._int4_by_layer(torch.from_numpy(w), gsz)
    else:
        got = tq.quantize_weight_int4_packed(torch.from_numpy(w), gsz)
    # same f32 steps, same round-half-even: bit-equal
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(ref["q4"]))
    np.testing.assert_array_equal(got["gs"].numpy(), np.asarray(ref["gs"]))
    np.testing.assert_array_equal(tq.unpack_int4(got["q4"]).numpy(),
                                  np.asarray(jq.unpack_int4(ref["q4"])))


def test_pack_int4_params_matches_jax():
    w = np.random.default_rng(2).standard_normal((2, 32, 128)).astype(
        np.float32)
    native = jq.quantize_weight_int4(jnp.asarray(w), 32)
    ref = jq.pack_int4_params({"w": native})["w"]
    got = tq.pack_int4_params({"w": {
        "q": torch.from_numpy(np.asarray(native["q"]).astype(np.int8)),
        "gs": torch.from_numpy(np.array(native["gs"]))}})["w"]
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(ref["q4"]))


def test_quantize_lm_params_w4a8_matches_jax():
    cfg = serving_cfg_jax()
    params = init_dual_ar_params(jax.random.key(5), cfg, dtype=jnp.bfloat16)
    ref = jq.quantize_lm_params(params, mode="w4a8", groupsize=32)
    port = lm_params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    got = dict(_leaves(tq.quantize_lm_params(port, mode="w4a8",
                                             groupsize=32)))
    want = dict(_leaves(jax.tree.map(np.asarray, ref)))
    assert got.keys() == want.keys()
    n_int4 = 0
    for path, a in want.items():
        t = got[path]
        if not isinstance(a, dict):
            assert str(t.dtype).endswith(str(a.dtype)), path
            np.testing.assert_array_equal(t.float().numpy(),
                                          a.astype(np.float32), str(path))
            continue
        assert t.keys() == a.keys(), path
        for k in a:
            assert tuple(t[k].shape) == a[k].shape, (path, k)
            assert str(t[k].dtype).endswith(str(a[k].dtype)), (path, k)
        n_int4 += "q4" in a
        # dequantized values within one quantization step (the JAX suite's
        # bound between two quantizations of one tree, tests/test_quant.py)
        step = float(np.asarray(a.get("s", a.get("gs"))).max())
        da = np.asarray(jq.as_weight(jax.tree.map(jnp.asarray, a),
                                     jnp.float32))
        np.testing.assert_allclose(tq.as_weight(t, torch.float32).numpy(),
                                   da, atol=1.01 * step, rtol=0)
    # int4 on exactly the slow stack's five matrices
    assert n_int4 == 5
    assert all("q4" in want[("layers", *k)] for k in (
        ("attention", "wqkv"), ("attention", "wo"), ("feed_forward", "w1"),
        ("feed_forward", "w2"), ("feed_forward", "w3")))


def _w4a8_inputs(m=32, n=256, k=512, gsz=64, seed=3):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    x8 = rng.integers(-127, 128, (m, k)).astype(np.int8)
    return w, x8, gsz


# (m, n, k, gsz): a small case, and S2-Pro's group count (K 2560 in groups
# of 128) at a prefill's 256 rows
@pytest.mark.parametrize("kernel", ["grouped", "pc"])
@pytest.mark.parametrize("shape", [(32, 256, 512, 64), (256, 256, 2560, 128)],
                         ids=["small", "s2pro_groups"])
def test_plain_matches_pallas(kernel, shape):
    m, n, k, gsz = shape
    w, x8, gsz = _w4a8_inputs(m, n, k, gsz)
    qj = jq.quantize_weight_int4_packed(jnp.asarray(w), gsz)
    jfn, tfn = ((jw4a8, tw.w4a8_matmul_plain) if kernel == "grouped"
                else (jw4a8_pc, tw.w4a8_matmul_pc_plain))
    ref = np.asarray(jfn(jnp.asarray(x8), qj["q4"], qj["gs"], gsz=gsz,
                         n_tile=128, interpret=True))
    got = tfn(torch.from_numpy(x8), torch.from_numpy(np.array(qj["q4"])),
              torch.from_numpy(np.array(qj["gs"]))).numpy()
    # the integer dots are exact; only the f32 rounding of the group sum
    # may differ (XLA may contract the interpreter's multiply-add): 1e-5 of
    # the output's scale
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


# (N, K) of the S2-Pro slow stack's five products
S2_PRO_PRODUCTS = {"wqkv": (6144, 2560), "wo": (2560, 4096),
                   "w1": (9728, 2560), "w3": (9728, 2560),
                   "w2": (2560, 9728)}


@pytest.mark.parametrize("n_sm", [108, 132])
@pytest.mark.parametrize("m", [1, 8, 9, 40, 256])
@pytest.mark.parametrize("product", list(S2_PRO_PRODUCTS))
def test_plan(product, m, n_sm):
    """The kernel's plan (what the wrapper passes to csrc/w4a8.cu) at the
    S2-Pro products: the weight stream up to 8 rows, else a tile; K parts
    are whole groups and cover the packed K once. The stream: a cluster
    of at most 8 parts a 32-column tile, a grid that gives every SM a CTA
    and fits on the card at once. The tiles: #11 never splits K (its
    groups add in order); no split takes more CTAs than the SMs hold."""
    n, k = S2_PRO_PRODUCTS[product]
    gsz, kh = 128, k // 2
    for pc in (False, True):
        tile, n_split, part = tw.w4a8_plan(m, n, k, k // gsz, n_sm, pc)
        assert (tile == 0) == (m <= 8)
        assert part % gsz == 0 or (n_split == 1 and part == kh)
        assert (n_split - 1) * part < kh <= n_split * part
        if tile == 0:
            assert part % gsz == 0 and 1 <= n_split <= tw.MAX_CLUSTER
            ctas = -(-n // tw.STREAM_BN) * n_split
            smem = tw.stream_smem(m, k // gsz, gsz, part, n_split, pc)
            assert ctas >= n_sm
            assert ctas <= n_sm * (tw.SM_SMEM // (smem + 1024))
            assert smem <= tw.STREAM_SMEM_MAX
            continue
        if not pc:
            assert (n_split, part) == (1, kh)
        bm, bn = tw.TILES[tile]
        rows, cols = -(-m // bm), -(-n // bn)
        assert rows * bm >= m > (rows - 1) * bm
        assert cols * bn >= n > (cols - 1) * bn
        ctas, per_sm = rows * cols, 2 if tile == 1 else 1
        assert n_split == 1 or ctas * n_split <= per_sm * n_sm


# (n, k, gsz, m): the kernels' envelope, the most groups (160) and the
# largest groups (512), at the stream's widest rows
@pytest.mark.parametrize("shape", [(200, 20480, 128, 8), (136, 81920, 512, 8),
                                   (40, 384, 64, 1)])
@pytest.mark.parametrize("pc", [False, True])
def test_stream_plan_fits(shape, pc):
    n, k, gsz, m = shape
    g = k // gsz
    tile, n_split, part = tw.w4a8_plan(m, n, k, g, 132, pc)
    assert tile == 0 and 1 <= n_split <= tw.MAX_CLUSTER
    assert part % gsz == 0 and (n_split - 1) * part < k // 2 <= n_split * part
    assert tw.stream_smem(m, g, gsz, part, n_split, pc) <= tw.STREAM_SMEM_MAX


def _grouped_split(x8, q4, gs, plan):
    """#11 as the stream kernel computes it under a cluster's K split: per
    K part (packed bytes [z * part, z * part + part)), the exact int32 dot
    of each of its groups, low (k = j) and high (k = K/2 + j); then the
    finishing CTA's f32 sum of float(dot) * gs[n, g] in group order g = 0
    .. G - 1, reading the parts' dots."""
    _, n_split, part = plan
    k, (n, kh), g = x8.shape[1], q4.shape, gs.shape[1]
    gsz = k // g
    unp = tq.unpack_int4(q4)
    dots = {}
    for z in range(n_split):
        for j in range(z * part, min(z * part + part, kh), gsz):
            for half in (0, 1):
                cols = slice(half * kh + j, half * kh + j + gsz)
                dots[half * (g // 2) + j // gsz] = tq.int8_matmul_t(
                    x8[:, cols].contiguous(), unp[:, cols].contiguous())
    # the parts cover every group once
    assert sorted(dots) == list(range(g))
    acc = torch.zeros((x8.shape[0], n), dtype=torch.float32)
    for gi in range(g):
        acc = acc + dots[gi].float() * gs[:, gi]
    return acc


def _pc_split(x8, q4, gs, plan):
    """#12 as the tiled kernel and the stream compute it under a K split:
    per K part, per step of 64 packed bytes, one exact int32 product of
    both nibble halves (x columns j.. and K/2 + j..), the parts' int32 sums
    added, then float(sum) * cs * 8/127."""
    _, n_split, part = plan
    w8, s8 = tw.pc_weights(q4, gs)
    kh = q4.shape[1]
    acc = torch.zeros((x8.shape[0], q4.shape[0]), dtype=torch.int32)
    for z in range(n_split):
        partial = torch.zeros_like(acc)
        for j in range(z * part, min(z * part + part, kh), 64):
            cols = torch.cat([torch.arange(j, j + 64),
                              torch.arange(kh + j, kh + j + 64)])
            partial += tq.int8_matmul_t(x8[:, cols].contiguous(),
                                        w8[:, cols].contiguous())
        acc += partial
    return acc.float() * s8


@pytest.mark.parametrize("n_sm", [108, 132])
def test_pc_split_matches_pallas(n_sm):
    m, n, k, gsz = 32, 256, 2560, 128
    w, x8, gsz = _w4a8_inputs(m, n, k, gsz, seed=7)
    plan = tw.w4a8_plan(m, n, k, k // gsz, n_sm, True)
    assert plan[1] > 1          # these shapes split K
    qj = jq.quantize_weight_int4_packed(jnp.asarray(w), gsz)
    q4, gs = (torch.from_numpy(np.array(qj["q4"])),
              torch.from_numpy(np.array(qj["gs"])))
    got = _pc_split(torch.from_numpy(x8), q4, gs, plan)
    # exact int32 sums in any order, the same f32 epilogue: bit-equal
    assert torch.equal(got, tw.w4a8_matmul_pc_plain(torch.from_numpy(x8),
                                                    q4, gs))
    ref = np.asarray(jw4a8_pc(jnp.asarray(x8), qj["q4"], qj["gs"], gsz=gsz,
                              n_tile=128, interpret=True))
    # as test_plain_matches_pallas
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


# S2-Pro's group counts (K 2560 and 9728 in groups of 128) on 256 columns:
# the stream's cluster splits K into 5 and 8 parts
@pytest.mark.parametrize("kernel", ["grouped", "pc"])
@pytest.mark.parametrize("k", [2560, 9728])
@pytest.mark.parametrize("m", [1, 8])
def test_stream_split_matches_pallas(kernel, k, m):
    n, gsz = 256, 128
    w, x8, gsz = _w4a8_inputs(m, n, k, gsz, seed=11)
    plan = tw.w4a8_plan(m, n, k, k // gsz, 132, kernel == "pc")
    assert plan[0] == 0 and plan[1] > 1       # a cluster's split
    qj = jq.quantize_weight_int4_packed(jnp.asarray(w), gsz)
    q4, gs = (torch.from_numpy(np.array(qj["q4"])),
              torch.from_numpy(np.array(qj["gs"])))
    x8t = torch.from_numpy(x8)
    model, plain, jfn = ((_grouped_split, tw.w4a8_matmul_plain, jw4a8)
                         if kernel == "grouped" else
                         (_pc_split, tw.w4a8_matmul_pc_plain, jw4a8_pc))
    got = model(x8t, q4, gs, plan)
    # exact int32 dots; the same f32 steps in the same order: bit-equal
    assert torch.equal(got, plain(x8t, q4, gs))
    # JAX takes rows in multiples of 32: x8 padded, its first m rows
    x8p = np.concatenate([x8, np.zeros((32 - m, k), np.int8)])
    ref = np.asarray(jfn(jnp.asarray(x8p), qj["q4"], qj["gs"], gsz=gsz,
                         n_tile=128, interpret=True))[:m]
    # as test_plain_matches_pallas
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("m", [1, 8, 64])
def test_matmul_t_matches_jax(m):
    w, _, gsz = _w4a8_inputs()
    x = np.random.default_rng(m).standard_normal((m, w.shape[1])).astype(
        np.float32)
    qj = jq.quantize_weight_int4_packed(jnp.asarray(w), gsz)
    qt = tq.quantize_weight_int4_packed(torch.from_numpy(w), gsz)
    # JAX takes its XLA grouped formulation off the TPU
    ref = np.asarray(jq.matmul_t(jnp.asarray(x), qj, w8a8=True))
    got = tq.matmul_t(torch.from_numpy(x), qt, w8a8=True).numpy()
    # same int8 activations and exact int32 group dots; the f32 sum over
    # groups is taken in another order (XLA reduce vs group order)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    # and it is the product it stands for: int4 rounding of gaussian
    # weights (step max/7 per group) leaves ~10% rms error per output
    exact = x @ w.T
    assert np.corrcoef(got.ravel(), exact.ravel())[0, 1] > 0.98


def test_wrappers_take_plain_path_on_cpu(monkeypatch):
    w, x8, gsz = _w4a8_inputs(m=5)
    qt = tq.quantize_weight_int4_packed(torch.from_numpy(w), gsz)
    x8 = torch.from_numpy(x8)
    before = (tw.KERNEL.launches, tw.KERNEL_PC.launches)
    assert torch.equal(tw.w4a8_matmul(x8, qt["q4"], qt["gs"]),
                       tw.w4a8_matmul_plain(x8, qt["q4"], qt["gs"]))
    assert torch.equal(tw.w4a8_matmul_pc(x8, qt["q4"], qt["gs"]),
                       tw.w4a8_matmul_pc_plain(x8, qt["q4"], qt["gs"]))
    # W4A8_KERNEL=pc routes matmul_t to the per-channel product
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, w.shape[1])).astype(np.float32))
    x8r, xs = tq.int8_rows(x)
    monkeypatch.setenv("W4A8_KERNEL", "pc")
    assert torch.equal(tq.matmul_t(x, qt, w8a8=True),
                       tw.w4a8_matmul_pc_plain(x8r, qt["q4"], qt["gs"]) * xs)
    monkeypatch.delenv("W4A8_KERNEL")
    assert torch.equal(tq.matmul_t(x, qt, w8a8=True),
                       tw.w4a8_matmul_plain(x8r, qt["q4"], qt["gs"]) * xs)
    # a CPU call is not a kernel launch
    assert (tw.KERNEL.launches, tw.KERNEL_PC.launches) == before
