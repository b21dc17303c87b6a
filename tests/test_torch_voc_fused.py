"""Port's fused vocoder kernels (plain versions) vs the JAX Pallas kernels
(interpret mode on the CPU): fused_res_stack and fused_block, with the tail
snake and the final conv + tanh."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.codec.init import _Rng, _res_unit_p
from fish_speech_tpu.ops import voc_fused as jv
from fish_speech_tpu_torch.ops import voc_fused as tv

DIL = (1, 3, 9)


def _units(c, n, seed, bias=True):
    """Random units; nonzero biases and alphas so the left-context
    semantics (state before the sequence start) are exercised."""
    rng = _Rng(jax.random.key(seed))
    units = [_res_unit_p(rng, c) for _ in range(n)]
    g = np.random.default_rng(seed)
    for u in units:
        for k in ("snake1_alpha", "snake2_alpha"):
            u[k] = jnp.asarray(g.uniform(0.5, 2.0, c), jnp.float32)
        if bias:
            for k in ("conv1_b", "conv2_b"):
                u[k] = jnp.asarray(g.normal(0, 0.1, c), jnp.float32)
    return units


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                        tree)


def _tail(c, seed):
    a = np.random.default_rng(seed).uniform(0.5, 2.0, c).astype(np.float32)
    return np.stack([a / np.pi, 1.0 / (a + 1e-9)]).astype(np.float32)


@pytest.mark.parametrize("dilations,tail", [((3,), False), ((9,), True),
                                            (DIL, True)])
def test_res_stack_matches_pallas(dilations, tail):
    c, t, b = 16, 96, 2
    units = _units(c, len(dilations), 0)
    x = np.random.default_rng(1).standard_normal((b, t, c)).astype(np.float32)
    tv_np = _tail(c, 2) if tail else None
    ref = jv.fused_res_stack(
        jnp.asarray(x), jv.pack_res_stack(units, dtype=jnp.float32), tt=32,
        dilations=dilations,
        tail_vec=None if tv_np is None else jnp.asarray(tv_np))
    packed = tv.pack_res_stack(_t(units), dtype=torch.float32)
    got = tv.fused_res_stack(torch.from_numpy(x), packed, dilations=dilations,
                             tail_vec=None if tv_np is None
                             else torch.from_numpy(tv_np))
    # f32 state, f32 products: only summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_res_stack_bf16_state():
    """bf16 state and weights, as on the serving path."""
    c, t = 32, 64
    units = _units(c, 1, 3)
    x = np.random.default_rng(4).standard_normal((1, t, c)).astype(np.float32)
    ref = jv.fused_res_stack(
        jnp.asarray(x, jnp.bfloat16),
        jv.pack_res_stack(units, dtype=jnp.bfloat16), tt=32, dilations=(9,))
    got = tv.fused_res_stack(torch.from_numpy(x).to(torch.bfloat16),
                             tv.pack_res_stack(_t(units)), dilations=(9,))
    # bf16 state: one bf16 ulp at |x| < 4 (f32 accumulation order differs)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=2 ** -6,
                               rtol=2 ** -7)


def _block_inputs(c_in, c, stride, seed):
    g = np.random.default_rng(seed)
    tw = g.normal(0, 0.1, (2 * stride, c_in, c)).astype(np.float32)
    tb = g.normal(0, 0.1, c).astype(np.float32)
    k_t = 2 * stride
    phases = [np.flip(tw[k_t - (j + 1) * stride:k_t - j * stride], 0)
              .transpose(1, 0, 2).reshape(c_in, stride * c) for j in range(2)]
    return np.stack(phases).astype(np.float32), np.tile(tb, stride)


@pytest.mark.parametrize("stride,final", [(2, False), (4, False), (2, True)])
def test_block_matches_pallas(stride, final):
    c_in, c, b = 32, 16, 2
    t_in = 256 // stride
    units = _units(c, 3, 7 + stride)
    pw, pb = _block_inputs(c_in, c, stride, 8)
    x = np.random.default_rng(9).standard_normal((b, t_in, c_in)).astype(
        np.float32)
    tail = _tail(c, 10)
    packed_j = jv.pack_res_stack(units, dtype=jnp.float32)
    packed_j["tconv_pw"] = jnp.asarray(pw)
    packed_j["tconv_pb"] = jnp.asarray(pb)[None]
    fw = None
    if final:
        fw = np.random.default_rng(11).normal(0, 0.1, (8, c)).astype(
            np.float32)
        fw[7] = 0.0
        fw[7, 0] = 0.03
    ref = jv.fused_block(jnp.asarray(x), packed_j, stride=stride, tt=128,
                         tail_vec=jnp.asarray(tail),
                         final_w=None if fw is None else jnp.asarray(fw))
    packed_t = tv.pack_res_stack(_t(units), dtype=torch.float32)
    packed_t["tconv_pw"] = torch.from_numpy(pw)
    packed_t["tconv_pb"] = torch.from_numpy(pb)
    got = tv.fused_block(torch.from_numpy(x), packed_t, stride=stride,
                         tail_vec=torch.from_numpy(tail),
                         final_w=None if fw is None else torch.from_numpy(fw))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_snake_poly_matches_pallas_snake():
    x = np.linspace(-50, 50, 20001).astype(np.float32)
    for a in (0.05, 1.0, 30.0):
        ref = jv._snake(jnp.asarray(x), jnp.float32(a / np.pi),
                        jnp.float32(1.0 / (a + 1e-9)))
        got = tv.snake_poly(torch.from_numpy(x), a / np.pi, 1.0 / (a + 1e-9))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)



# --- the bf16 block kernel's plan (runs without a card) --------------------

# (C_in, C, stride, final) of the S2-Pro decoder's blocks 1-3, and the
# block's input rows a codec frame
S2_PRO_BLOCKS = {1: (768, 384, 8, False, 32), 2: (384, 192, 4, False, 256),
                 3: (192, 96, 2, True, 1024)}


@pytest.mark.parametrize("frames", [1, 16, 128])
@pytest.mark.parametrize("block", list(S2_PRO_BLOCKS))
@pytest.mark.parametrize("b", [1, 2])
def test_voc_block_plan_covers_once(block, frames, b):
    """Every pass's tiles cover its rows and columns once (the grid's last
    row tile reaches past the rows by less than a tile, BN divides the
    columns), the tiles fit the kernel's shared memory, and the units'
    rows start where each unit's valid rows do."""
    c_in, c, stride, final, per_frame = S2_PRO_BLOCKS[block]
    t_in = per_frame * frames
    plan = tv.voc_block_plan(b, t_in, c_in, c, stride, DIL, final, 132)
    halo = 6 * sum(DIL) + (6 if final else 0)
    assert plan["halo"] == halo and plan["rows"] == halo + t_in * stride
    assert plan["tiles"] == [q["tile"] for q in plan["passes"]]
    assert plan["device_kernels"] == 2 + 7 + int(final)
    lo = [0]
    for d in DIL:
        lo.append(lo[-1] + 6 * d)
    want = [(0, t_in, stride * c, 2, c_in)] + [
        (lo[u + 1], halo + t_in * stride, c, taps, c) for u in range(3)
        for taps in (7, 1)]
    for q, w in zip(plan["passes"], want, strict=True):
        m_lo, m_hi, n, _, k = w
        assert (q["m_lo"], q["m_hi"], q["n"], q["taps"], q["k"]) == w
        assert (q["bm"], q["bn"]) == tv.TILE_SHAPES[q["tile"]]
        rows = -(-(m_hi - m_lo) // q["bm"])
        assert (rows - 1) * q["bm"] < m_hi - m_lo <= rows * q["bm"]
        assert n % q["bn"] == 0 and k % tv.GEMM_K == 0
        assert q["ctas"] == rows * (n // q["bn"]) * b
        assert q["smem"] == tv.tile_smem(q["bm"], q["bn"], k) \
            <= tv.SMEM_LIMIT


@pytest.mark.parametrize("block", list(S2_PRO_BLOCKS))
def test_voc_block_plan_fills_132_sms_at_16_frames(block):
    """At F = 16, batch 1 (a streaming vocoder's request), every pass of
    every block has at least one CTA for each of the H100's 132 SMs; at
    F = 128 every pass takes the largest tile that does."""
    c_in, c, stride, final, per_frame = S2_PRO_BLOCKS[block]
    for frames in (16, 128):
        plan = tv.voc_block_plan(1, per_frame * frames, c_in, c, stride,
                                 DIL, final, 132)
        for q in plan["passes"]:
            assert q["ctas"] >= 132, (frames, q)
            bigger = [i for i, (bm, bn) in enumerate(tv.TILE_SHAPES)
                      if q["n"] % bn == 0 and bm * bn > q["bm"] * q["bn"]]
            for i in bigger:
                bm, bn = tv.TILE_SHAPES[i]
                assert -(-(q["m_hi"] - q["m_lo"]) // bm) * (q["n"] // bn) \
                    < 132, (frames, q, i)


def test_voc_block_plan_small_input_takes_most_ctas():
    """Too few rows for a full wave: the tile with the most CTAs, and of
    those the one with fewer rows."""
    plan = tv.voc_block_plan(1, 4, 768, 384, 8, DIL, False, 132)
    tconv = plan["passes"][0]
    assert (tconv["bm"], tconv["bn"]) == (64, 32)
    assert tconv["ctas"] == 3072 // 32


@pytest.mark.parametrize("c,c_in,dil", [(48, 64, DIL), (64, 80, DIL),
                                        (64, 64, (1, 3))])
def test_voc_block_plan_refuses(c, c_in, dil):
    with pytest.raises(ValueError):
        tv.voc_block_plan(1, 16, c_in, c, 2, dil, False, 132)


# --- the bf16 residual-unit kernel's plan (runs without a card) ------------

# block 0 of the S2-Pro decoder: 768 channels, 32 rows a codec frame
S2_PRO_BLOCK0 = (768, 32)


@pytest.mark.parametrize("frames", [1, 16, 128])
@pytest.mark.parametrize("b", [1, 2])
def test_voc_res_plan_covers_once(frames, b):
    """Both passes of a unit cover output rows [0, T) and all C columns
    once (the grid's last row tile reaches past T by less than a tile, BN
    divides C), with the k7 conv's 7 taps and the 1x1's one, each of K = C,
    in tiles that fit the kernel's shared memory; one call runs three
    device kernels (the entry snake, the two passes)."""
    c, per_frame = S2_PRO_BLOCK0
    t = per_frame * frames
    for d in DIL:
        plan = tv.voc_res_plan(b, t, c, d, 132)
        assert plan["tiles"] == [q["tile"] for q in plan["passes"]]
        assert plan["device_kernels"] == 3
        assert [q["taps"] for q in plan["passes"]] == [7, 1]
        for q in plan["passes"]:
            assert (q["m_lo"], q["m_hi"], q["n"], q["k"]) == (0, t, c, c)
            assert (q["bm"], q["bn"]) == tv.TILE_SHAPES[q["tile"]]
            rows = -(-t // q["bm"])
            assert (rows - 1) * q["bm"] < t <= rows * q["bm"]
            assert c % q["bn"] == 0
            assert q["ctas"] == rows * (c // q["bn"]) * b
            assert q["smem"] == tv.tile_smem(q["bm"], q["bn"], c) \
                <= tv.SMEM_LIMIT


@pytest.mark.parametrize("frames,tile", [(16, (64, 32)), (128, (128, 128))])
def test_voc_res_plan_tiles_block0(frames, tile):
    """Batch 1 on the H100's 132 SMs: at F = 128 the 128 x 128 tile fills
    the card (192 CTAs); at F = 16 it would give 24, and the largest tile
    with at least 132 CTAs is 64 x 32 (192). The rule is voc_block_plan's:
    no larger tile reaches 132 CTAs."""
    c, per_frame = S2_PRO_BLOCK0
    plan = tv.voc_res_plan(1, per_frame * frames, c, 9, 132)
    for q in plan["passes"]:
        assert (q["bm"], q["bn"]) == tile and q["ctas"] >= 132
        for bm, bn in tv.TILE_SHAPES:
            if bm * bn > q["bm"] * q["bn"]:
                assert -(-q["m_hi"] // bm) * (c // bn) < 132, (bm, bn)


def test_voc_res_plan_small_input_takes_most_ctas():
    """T = 32 (one frame): the tile with the most CTAs, and of those the
    one with fewer rows."""
    plan = tv.voc_res_plan(1, 32, 768, 9, 132)
    for q in plan["passes"]:
        assert (q["bm"], q["bn"]) == (64, 32) and q["ctas"] == 24


@pytest.mark.parametrize("c", [48, 80, 784])
def test_voc_res_plan_refuses(c):
    with pytest.raises(ValueError):
        tv.voc_res_plan(1, 64, c, 1, 132)


def test_pack_decoder_keeps_unit_weights_t(monkeypatch):
    """A bf16 block run as per-unit calls keeps its units' weights K-major
    ("w7t", "w1t": the transposes of w7 and w1); fused blocks do not (they
    keep "wt"), and an int8 pack's per-unit blocks keep int8 ones;
    decoder_fused hands them to each unit's call, and the result is the
    pack's without them."""
    from fish_speech_tpu_torch.codec import config as tcfg
    from fish_speech_tpu_torch.codec import fastpath as tfast
    from fish_speech_tpu_torch.codec.init import init_dac_params as init_t

    cfg = tcfg.tiny_codec_config()
    params = init_t(torch.Generator().manual_seed(0), cfg, device="cpu")
    # block 0 (64 channels) as per-unit calls, as S2-Pro's 768-wide one
    monkeypatch.setattr(tfast, "FUSED_BLOCK_MAX_C", 32)
    packed = tfast.pack_decoder(params["decoder"], cfg, dtype=torch.bfloat16,
                                quant=False)
    res = packed["blocks"][0]["res"]
    assert "tconv_pw" not in res
    assert torch.equal(res["w7t"], res["w7"].transpose(2, 3))
    assert torch.equal(res["w1t"], res["w1"].transpose(1, 2))
    assert res["w7t"].is_contiguous() and res["w1t"].is_contiguous()
    assert tv.res_weights_t(res) == (res["w7t"], res["w1t"])
    bare = {k: v for k, v in res.items() if k not in ("w7t", "w1t")}
    for a, b in zip(tv.res_weights_t(bare), tv.res_weights_t(res)):
        assert torch.equal(a, b) and a.is_contiguous()
    for blk in packed["blocks"][1:]:
        assert "w7t" not in blk["res"] and "wt" in blk["res"]
    quant = tfast.pack_decoder(params["decoder"], cfg, quant=True)
    assert quant["blocks"][0]["res"]["w7t"].dtype == torch.int8
    assert all(blk["res"]["wt"][1].dtype == torch.int8
               for blk in quant["blocks"][1:])
    z = torch.randn((1, 3, cfg.resolved_latent_dim),
                    generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    got = tfast.decoder_fused(params["decoder"], cfg, z, packed=packed)
    packed["blocks"][0]["res"] = bare
    ref = tfast.decoder_fused(params["decoder"], cfg, z, packed=packed)
    assert torch.isfinite(got.float()).all() and torch.equal(got, ref)
