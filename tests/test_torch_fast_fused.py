"""Port's fused fast-head sweep (plain version) vs the JAX Pallas sweep
(interpret mode on the CPU) at every codebook position."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.models.dual_ar import precompute_freqs_cis
from fish_speech_tpu.models.init import init_dual_ar_params
from fish_speech_tpu.ops.fast_fused import (
    FusedFastCache,
    fused_fast_sweep,
    pack_fast_stack,
)
from fish_speech_tpu.ops.quant import quantize_lm_params
from fish_speech_tpu_torch.models.dual_ar import (
    precompute_freqs_cis as precompute_freqs_cis_t,
)
from fish_speech_tpu_torch.models.init import lm_params_from_jax
from fish_speech_tpu_torch.ops import fast_fused as ff

from test_fast_fused import family_cfg


@pytest.fixture(scope="module")
def setup():
    cfg = family_cfg()
    params = quantize_lm_params(
        init_dual_ar_params(jax.random.key(0), cfg, dtype=jnp.bfloat16))
    packed = pack_fast_stack(params["fast_layers"])
    tree = jax.tree.map(np.asarray, {"fast_layers": params["fast_layers"],
                                     "fast_packed": packed})
    return cfg, packed, lm_params_from_jax(tree, device="cpu")


def test_pack_and_carry_agree(setup):
    _, _, port = setup
    mine = ff.pack_fast_stack(port["fast_layers"])
    for k in ("w", "s", "norms"):
        assert torch.equal(mine[k], port["fast_packed"][k]), k


def test_plain_sweep_matches_pallas_every_position(setup):
    _match_pallas(setup, 4, layer0_exact=True)


def test_plain_sweep_matches_pallas_batch_40(setup):
    """B = 40: the batches above 8 where the twin's sums in torch's order
    broke the one-layer bit-equality with the CUDA kernel (the twin now
    sums in the kernel's order). JAX's sweep is the witness at the
    tolerances of B = 4, but for layer 0's cache rows: XLA takes RMSNorm's
    and the head sums in an order of its own, so a last f32 bit moves one
    bf16 rounding and one int8 step in a few of layer 0's values (measured:
    26 of 5120 k values, by 1); at most one step in 2% of them."""
    _match_pallas(setup, 40, layer0_exact=False)


def _match_pallas(setup, b, layer0_exact):
    cfg, packed, port = setup
    K, dim = cfg.num_codebooks, cfg.fast_dim
    table = precompute_freqs_cis(K, cfg.fast_head_dim, cfg.rope_base)
    table_t = precompute_freqs_cis_t(K, cfg.fast_head_dim, cfg.rope_base)
    assert np.array_equal(np.asarray(table, np.float32),
                          table_t.float().numpy())
    rng = np.random.default_rng(0)
    cache = FusedFastCache.create(cfg.n_fast_layer, K, b, dim)
    cache_t = ff.FusedFastCache.create(cfg.n_fast_layer, K, b, dim, "cpu")
    for pos in range(K):
        x = (rng.standard_normal((b, dim)) * 0.5).astype(np.float32)
        xo, cache = fused_fast_sweep(packed, jnp.asarray(x, jnp.bfloat16),
                                     cache, table, pos=pos,
                                     n_head=cfg.fast_n_head, eps=cfg.norm_eps)
        xo_t = ff.fused_fast_sweep(port["fast_packed"],
                                   torch.from_numpy(x).to(torch.bfloat16),
                                   cache_t, table_t, pos=pos,
                                   n_head=cfg.fast_n_head, eps=cfg.norm_eps)
        ref = np.asarray(xo, np.float32)
        got = xo_t.float().numpy()
        # same roundings in the same order; only the f32 summation order
        # (head segment sums, int32 -> f32 partials) and exp/sigmoid differ
        # by an f32 ulp, which can flip one bf16 rounding: the bf16 residual
        # stream (|x| < 2) agrees to 2 bf16 ulps (measured: 1)
        np.testing.assert_allclose(got, ref, atol=2 ** -6, rtol=2 ** -7)
        for name in ("k", "v"):
            a = np.asarray(getattr(cache, name)[:, pos], np.int32)
            c = getattr(cache_t, name)[:, pos].int().numpy()
            if layer0_exact:
                # layer 0's rows see identical inputs: bit-equal
                np.testing.assert_array_equal(c[0], a[0])
            else:
                d0 = np.abs(a[0] - c[0])
                assert d0.max() <= 1 and (d0 > 0).mean() <= 0.02, name
            # deeper layers inherit the one-ulp differences, which move
            # values near a rounding boundary by one int8 step (measured:
            # at most 2 steps, ~10% of values, mean |d| ~0.1 step)
            d = np.abs(a[1:] - c[1:])
            assert d.max() <= 2 and d.mean() < 0.25, (name, d.max(), d.mean())
            sa = np.asarray(getattr(cache, name + "s")[:, pos, :, 0],
                            np.float32)
            sc = getattr(cache_t, name + "s")[:, pos].float().numpy()
            if layer0_exact:
                np.testing.assert_array_equal(sc[0], sa[0])
            np.testing.assert_allclose(sc, sa, rtol=2 ** -6)


# --- the CUDA sweep's host side (runs without a card) ----------------------

S2_PRO_FAST = (1024, 16)    # fast head width, heads (of 64)


@pytest.mark.parametrize("n_sm", [132, 114, 8])
@pytest.mark.parametrize("b", [1, 3, 8, 9, 40, 256])
def test_sweep_plan_fits_the_kernel(b, n_sm):
    """What the plan hands the kernel: the grid, the barriers a sweep (the
    trace's rows: the kernel's phases a layer), and the K parts a segment
    of wo and w2, which the C entry takes only if each part is whole
    16-byte loads and there are at most WARPS: the most parts (a power of
    2) whose items a CTA's warps hold in one pass."""
    dim = S2_PRO_FAST[0]
    for per_sm in (1, 2, 4):
        plan = ff.sweep_plan(b, dim, 28, n_sm, per_sm)
        grid = n_sm * per_sm
        assert plan["grid"] == grid and plan["small"] == (b <= ff.SMALL_B)
        per_layer = 4 if b == 1 else 5 if b <= ff.SMALL_B else 8
        assert plan["phases"] == per_layer
        assert plan["barriers"] == per_layer * 28 - 1
        cols = -(-dim // grid)          # wo / w2 columns of CTA 0
        for ks, nseg in ((plan["ks_wo"], 1), (plan["ks_w2"], 3)):
            if not plan["small"]:
                assert ks == 1
                continue
            assert 1 <= ks <= ff.WARPS and ks & (ks - 1) == 0
            assert dim % (16 * ks) == 0
            assert ks == 1 or cols * nseg * ks <= ff.WARPS
            assert (cols * nseg * 2 * ks > ff.WARPS
                    or dim % (32 * ks) != 0), (b, grid, ks)


def _sweep_args(n_layer=2, dim=128, n_pos=4, b=3, tiles=13, head_dim=64):
    packed = {"w": torch.zeros((n_layer, tiles, dim, dim), dtype=torch.int8),
              "s": torch.zeros((n_layer, tiles, dim)),
              "norms": torch.zeros((n_layer, 2, dim), dtype=torch.bfloat16)}
    cache = ff.FusedFastCache.create(n_layer, n_pos, b, dim, "cpu")
    freqs = precompute_freqs_cis_t(n_pos, head_dim, 10000.0)
    return packed, torch.zeros((b, dim), dtype=torch.bfloat16), cache, freqs


BAD_SWEEPS = {
    "dim not a multiple of 64": (dict(dim=96), {}, 0, 2),
    "dim above 1024": (dict(dim=1088), {}, 0, 17),
    "head_dim not a multiple of 32": (dict(dim=128), {}, 0, 8),
    "12 tiles": (dict(tiles=12), {}, 0, 2),
    "pos past the cache": (dict(n_pos=4), {}, 4, 2),
    "pos past 16": (dict(n_pos=20), {}, 16, 2),
    "negative pos": ({}, {}, -1, 2),
    "x of another width": ({}, {"x": (3, 64)}, 0, 2),
    "cache of another batch": ({}, {"cache_b": 5}, 0, 2),
    "freqs_table in f32": ({}, {"freqs_dtype": torch.float32}, 0, 2),
    "freqs_table of another head_dim": (dict(head_dim=32), {}, 0, 2),
    "freqs_table without row pos": ({}, {"freqs_rows": 3}, 3, 2),
}


@pytest.mark.parametrize("case", list(BAD_SWEEPS))
def test_sweep_refuses_bad_shapes(case):
    kw, change, pos, n_head = BAD_SWEEPS[case]
    packed, x, cache, freqs = _sweep_args(**kw)
    if "x" in change:
        x = torch.zeros(change["x"], dtype=torch.bfloat16)
    if "cache_b" in change:
        cache = ff.FusedFastCache.create(2, 4, change["cache_b"], 128, "cpu")
    if "freqs_dtype" in change:
        freqs = freqs.to(change["freqs_dtype"])
    if "freqs_rows" in change:
        freqs = freqs[:change["freqs_rows"]]
    with pytest.raises(ValueError):
        ff.check_sweep_args(packed, x, cache, freqs, pos=pos, n_head=n_head)


def test_sweep_takes_good_shapes_and_refuses_no_grid():
    packed, x, cache, freqs = _sweep_args()
    assert cache.scratch is None        # a cache on the card holds scratch
    ff.check_sweep_args(packed, x, cache, freqs, pos=3, n_head=2)
    with pytest.raises(ValueError):
        ff.sweep_plan(1, 128, 2, 0, 2)
    with pytest.raises(ValueError):
        ff.sweep_plan(1, 128, 2, 132, 0)


# --- the twin's sum order (runs without a card) ----------------------------


def _kernel_sum(vals: np.ndarray, threads: int) -> np.float32:
    """csrc/fast_sweep.cu's CTA sum, lane by lane in float32: thread t adds
    vals[t + threads*c] in order of c, each warp's 32 lanes fold by an xor
    butterfly (every lane updated at each step), then the warps' totals
    in order."""
    n = -(-len(vals) // threads) * threads
    v = np.zeros(n, np.float32)
    v[:len(vals)] = vals
    part = v[:threads].copy()
    for c in range(1, n // threads):
        part = (part + v[c * threads:(c + 1) * threads]).astype(np.float32)
    lanes = part.reshape(-1, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[:, np.arange(32) ^ o]).astype(np.float32)
    t = np.float32(0)
    for w in lanes[:, 0]:
        t = np.float32(t + w)
    return t


@pytest.mark.parametrize("dim", [96, 256, 1024, 1120])
def test_twin_sums_in_the_kernels_order(dim):
    """The twin's RMSNorm mean of squares and head sums equal the kernel's
    reduction tree, emulated lane by lane, bit for bit; the torch and f64
    orders stay within a few f32 ulps of them."""
    rng = np.random.default_rng(dim)
    x = torch.from_numpy(rng.standard_normal((5, dim)).astype(np.float32)
                         ).to(torch.bfloat16).float()
    got = ff._mean_sq(x, "kernel")[:, 0].numpy()
    for r in range(5):
        sq = (x[r].numpy() ** 2).astype(np.float32)
        want = np.float32(_kernel_sum(sq, ff.THREADS) / np.float32(dim))
        assert got[r] == want, r
    for order in ("torch", "f64"):
        other = ff._mean_sq(x, order)[:, 0].double().numpy()
        np.testing.assert_allclose(other, got, rtol=2 ** -20)
    # heads of 1, 4, 2 and 5 32-lane groups
    n_head = {96: 3, 256: 2, 1024: 16, 1120: 7}[dim]
    prod = torch.from_numpy(rng.standard_normal((3, dim)).astype(np.float32))
    heads = ff._head_sums(prod, n_head, "kernel").numpy()
    hd = dim // n_head
    for r in range(3):
        for h in range(n_head):
            groups = prod[r, h * hd:(h + 1) * hd].numpy().reshape(-1, 32)
            want = np.float32(0)
            for g in groups:              # one warp's butterfly a group
                want = np.float32(want + _kernel_sum(g, 32))
            assert heads[r, h] == want, (r, h)
    np.testing.assert_allclose(
        ff._head_sums(prod, n_head, "f64").numpy(), heads, rtol=2 ** -18,
        atol=2 ** -18)
