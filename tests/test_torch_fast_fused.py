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
    cfg, packed, port = setup
    b, K, dim = 4, cfg.num_codebooks, cfg.fast_dim
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
            # layer 0's rows see identical inputs: bit-equal
            np.testing.assert_array_equal(c[0], a[0])
            # deeper layers inherit the one-ulp differences, which move
            # values near a rounding boundary by one int8 step (measured:
            # at most 2 steps, ~10% of values, mean |d| ~0.1 step)
            d = np.abs(a[1:] - c[1:])
            assert d.max() <= 2 and d.mean() < 0.25, (name, d.max(), d.mean())
            sa = np.asarray(getattr(cache, name + "s")[:, pos, :, 0],
                            np.float32)
            sc = getattr(cache_t, name + "s")[:, pos].float().numpy()
            np.testing.assert_array_equal(sc[0], sa[0])
            np.testing.assert_allclose(sc, sa, rtol=2 ** -6)
