"""The port's int8 vocoder (VOC_QUANT) vs the JAX package's: the int8 packs,
the per-tile activation quantization, the tile-aware plain versions of the
fused kernels against the Pallas kernels in interpret mode (inputs spanning
at least three tiles), and the whole decoder."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.codec import init_dac_params, tiny_codec_config
from fish_speech_tpu.codec import fastpath as jfast
from fish_speech_tpu.codec.config import DACConfig, RVQConfig
from fish_speech_tpu.codec.init import _Rng, _res_unit_p
from fish_speech_tpu.ops import voc_fused as jv
from fish_speech_tpu_torch.codec import config as tcfg
from fish_speech_tpu_torch.codec import fastpath as tfast
from fish_speech_tpu_torch.codec.init import codec_params_from_jax
from fish_speech_tpu_torch.ops import voc_fused as tv

DIL = (1, 3, 9)


def _units(c, n, seed):
    """Random units with nonzero biases and alphas."""
    rng = _Rng(jax.random.key(seed))
    units = [_res_unit_p(rng, c) for _ in range(n)]
    g = np.random.default_rng(seed)
    for u in units:
        for k in ("snake1_alpha", "snake2_alpha"):
            u[k] = jnp.asarray(g.uniform(0.5, 2.0, c), jnp.float32)
        for k in ("conv1_b", "conv2_b"):
            u[k] = jnp.asarray(g.normal(0, 0.1, c), jnp.float32)
    return units


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                        tree)


def _tail(c, seed):
    a = np.random.default_rng(seed).uniform(0.5, 2.0, c).astype(np.float32)
    return np.stack([a / np.pi, 1.0 / (a + 1e-9)]).astype(np.float32)


def _close_to_int8_step(got, ref):
    """Exact where the two agree bit for bit; otherwise within one int8 step
    of the output (2^-7 of its largest magnitude): XLA on the CPU may fuse
    a product and a sum into one rounding where PyTorch rounds twice, and
    such an ulp can move one activation code by one step."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    tol = 2.0 ** -7 * np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= tol, (err, tol)
    return err


# --- the packs --------------------------------------------------------------


def test_pack_res_stack_quant_matches_jax():
    units = _units(48, 3, 1)
    ref = jv.pack_res_stack(units, quant=True)
    got = tv.pack_res_stack(_t(units), quant=True)
    assert got["w7"].dtype == got["w1"].dtype == torch.int8
    for k in ("w7", "w1", "vec"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def _port_cfg(cfg):
    t = cfg.rvq.pre_post_transformer
    rvq = tcfg.RVQConfig(**{**dataclasses.asdict(cfg.rvq),
                            "pre_post_transformer":
                                tcfg.CodecTransformerConfig(
                                    **dataclasses.asdict(t))})
    return tcfg.DACConfig(**{**dataclasses.asdict(cfg), "rvq": rvq})


def _s2pro_strides_cfg():
    """The real S2-Pro strides (8, 8, 4, 2) with shrunken channels."""
    tp = dataclasses.replace(tiny_codec_config().rvq.pre_post_transformer,
                             dim=16, intermediate_size=32, n_head=2,
                             head_dim=8, n_local_heads=-1)
    return DACConfig(
        encoder_dim=4, encoder_rates=(2, 4, 8, 8), decoder_dim=128,
        decoder_rates=(8, 8, 4, 2), encoder_transformer_layers=(0, 0, 0, 0),
        latent_dim=16,
        rvq=RVQConfig(input_dim=16, n_codebooks=2, codebook_size=32,
                      codebook_dim=4, semantic_codebook_size=64,
                      downsample_factor=(2, 2), pre_post_transformer=tp))


def _biased_params(cfg, seed):
    """Codec params with nonzero decoder biases (left-context handling)."""
    params = init_dac_params(jax.random.key(seed), cfg)
    g = np.random.default_rng(seed)
    for blk in params["decoder"]["blocks"]:
        blk["conv_b"] = jnp.asarray(g.normal(0, 0.05, blk["conv_b"].shape),
                                    jnp.float32)
        for u in blk["res_units"]:
            for k in ("conv1_b", "conv2_b"):
                u[k] = jnp.asarray(g.normal(0, 0.05, u[k].shape), jnp.float32)
    return params


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_pack_decoder_quant_matches_jax(dtype):
    """The int8 tconv phases and scales and the units' int8 weights equal
    JAX's pack (which pads channels to 128 lanes: compared unpadded)."""
    cfg = tiny_codec_config()
    params = _biased_params(cfg, 2)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    ref = jfast.pack_decoder(params["decoder"], cfg, dtype=jdt, quant=True)
    port = codec_params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    got = tfast.pack_decoder(port["decoder"], _port_cfg(cfg), dtype=tdt,
                             quant=True)
    for rb, gb, stride in zip(ref["blocks"], got["blocks"],
                              cfg.decoder_rates):
        r, g = rb["res"], gb["res"]
        c = g["w1"].shape[-1]
        c_in = g["tconv_pw"].shape[1]
        np.testing.assert_array_equal(g["w7"].numpy(),
                                      np.asarray(r["w7"])[:, :, :c, :c])
        np.testing.assert_array_equal(g["w1"].numpy(),
                                      np.asarray(r["w1"])[:, :c, :c])
        np.testing.assert_array_equal(g["vec"].numpy(),
                                      np.asarray(r["vec"])[:, :, :c])
        pw = np.asarray(r["tconv_pw"])
        cp = pw.shape[2] // stride
        pw = pw[:, :c_in].reshape(2, c_in, stride, cp)[..., :c]
        assert g["tconv_pw"].dtype == torch.int8
        np.testing.assert_array_equal(g["tconv_pw"].numpy(),
                                      pw.reshape(2, c_in, stride * c))
        pb = np.asarray(r["tconv_pb"]).reshape(2, stride, cp)[..., :c]
        np.testing.assert_array_equal(g["tconv_pb"].numpy(),
                                      pb.reshape(2, stride * c))


def test_pack_decoder_reads_voc_quant(monkeypatch):
    cfg = tcfg.tiny_codec_config()
    port = codec_params_from_jax(
        jax.tree.map(np.asarray, init_dac_params(jax.random.key(0),
                                                 tiny_codec_config())),
        device="cpu")
    monkeypatch.setenv("VOC_QUANT", "1")
    assert tfast.pack_decoder(port["decoder"], cfg)["blocks"][0]["res"][
        "w7"].dtype == torch.int8
    monkeypatch.setenv("VOC_QUANT", "0")
    assert tfast.pack_decoder(port["decoder"], cfg)["blocks"][0]["res"][
        "w7"].dtype == torch.bfloat16
    monkeypatch.delenv("VOC_QUANT")
    packed = tfast.pack_decoder(port["decoder"], cfg, quant=True)
    assert packed["blocks"][0]["res"]["tconv_pb"].shape[0] == 2


# --- the per-tile quantization --------------------------------------------


def test_quantize_tile_matches_jax():
    rng = np.random.default_rng(3)
    tiles = [rng.standard_normal((40, 24)).astype(np.float32) * 3,
             rng.uniform(0, 1e-3, (16, 8)).astype(np.float32),
             np.zeros((4, 8), np.float32)]
    # values exactly at half steps: m = 127 makes the step 1, and the codes
    # round half away from zero (not to even)
    half = np.asarray([127.0, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 126.5,
                       -126.5, 0.0, -0.0, 3.0], np.float32)
    tiles.append(half.reshape(3, 4))
    for s in tiles:
        q_ref, m_ref = jv._quantize_tile(jnp.asarray(s))
        q, m = tv.quantize_tile(torch.from_numpy(s)[None])
        np.testing.assert_array_equal(q[0].numpy(), np.asarray(q_ref))
        assert m.item() == float(m_ref)
    q, _ = tv.quantize_tile(torch.from_numpy(half)[None, None])
    assert q.flatten().tolist() == [127, 1, -1, 2, -2, 3, -3, 127, -127, 0,
                                    0, 3]


# --- the kernels' plain versions vs the Pallas kernels ----------------------


@pytest.mark.parametrize("dilations,tail,dtype", [
    ((1,), False, "f32"), ((3,), False, "f32"), ((9,), True, "f32"),
    ((9,), True, "bf16"), (DIL, True, "f32")])
def test_res_stack_quant_matches_pallas(dilations, tail, dtype):
    """Block 0's per-unit calls (dilation 1, 3, 9; tail on the last) and a
    three-unit stack, over 3 tiles of 32 rows."""
    c, b, tt = 32, 2, 32
    t = 3 * tt
    units = _units(c, len(dilations), 5)
    x = np.random.default_rng(6).standard_normal((b, t, c)).astype(
        np.float32)
    tl = _tail(c, 7) if tail else None
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    ref = jv.fused_res_stack(
        jnp.asarray(x, jdt), jv.pack_res_stack(units, quant=True), tt=tt,
        dilations=dilations, tail_vec=None if tl is None else jnp.asarray(tl))
    got = tv.fused_res_stack(torch.from_numpy(x).to(tdt),
                             tv.pack_res_stack(_t(units), quant=True),
                             dilations=dilations,
                             tail_vec=None if tl is None
                             else torch.from_numpy(tl), tt=tt)
    assert got.dtype == tdt
    _close_to_int8_step(got.float().numpy(), np.asarray(ref, np.float32))


def _block_pack(c_in, c, stride, seed):
    """A block's int8 pack through the JAX packer's rule (phase scales per
    output column, rounded half to even), in both frameworks' forms."""
    g = np.random.default_rng(seed)
    tw = g.normal(0, 0.1, (2 * stride, c_in, c)).astype(np.float32)
    tb = g.normal(0, 0.1, c).astype(np.float32)
    units = _units(c, 3, seed + 1)
    k_t = 2 * stride
    pwf = np.stack([np.flip(tw[k_t - (j + 1) * stride:k_t - j * stride], 0)
                    .transpose(1, 0, 2).reshape(c_in, stride * c)
                    for j in range(2)])
    ps = np.maximum(np.abs(pwf).max(axis=(0, 1)), np.float32(1e-12))
    pw = np.round(pwf / ps * np.float32(127)).astype(np.int8)
    pb = np.stack([np.tile(tb, stride), ps / np.float32(127)])
    packed_j = jv.pack_res_stack(units, quant=True)
    packed_j.update(tconv_pw=jnp.asarray(pw), tconv_pb=jnp.asarray(pb))
    packed_t = tv.pack_res_stack(_t(units), quant=True)
    packed_t.update(tconv_pw=torch.from_numpy(pw),
                    tconv_pb=torch.from_numpy(pb))
    return packed_j, packed_t


@pytest.mark.parametrize("stride,final,tt", [(2, False, 32), (4, False, 64),
                                             (2, True, 128), (4, True, 128)])
def test_block_quant_matches_pallas(stride, final, tt):
    """fused_block with int8 packs over 3 tiles: the transposed conv's slab
    quantized per tile, the units, the tail, and the final conv + tanh."""
    c_in, c, b = 64, 32, 2
    t = 3 * tt
    packed_j, packed_t = _block_pack(c_in, c, stride, 8 + stride)
    x = np.random.default_rng(9).standard_normal((b, t // stride, c_in))
    x = x.astype(np.float32)
    tl = _tail(c, 10)
    fw = None
    if final:
        fw = np.random.default_rng(11).normal(0, 0.1, (8, c)).astype(
            np.float32)
        fw[7] = 0.0
        fw[7, 0] = 0.03
    ref = jv.fused_block(jnp.asarray(x), packed_j, stride=stride, tt=tt,
                         tail_vec=jnp.asarray(tl),
                         final_w=None if fw is None else jnp.asarray(fw))
    got = tv.fused_block(torch.from_numpy(x), packed_t, stride=stride,
                         tail_vec=torch.from_numpy(tl),
                         final_w=None if fw is None else torch.from_numpy(fw),
                         tt=tt)
    _close_to_int8_step(got.numpy(), ref)


def test_int8_twins_need_the_tile():
    packed_j, packed_t = _block_pack(32, 32, 2, 1)
    x = torch.zeros((1, 64, 32))
    with pytest.raises(ValueError, match="tile"):
        tv.fused_block(x, packed_t, stride=2)
    with pytest.raises(ValueError, match="tile"):
        tv.fused_res_stack(torch.zeros((1, 96, 32)), {
            k: packed_t[k][:1] for k in ("w7", "w1", "vec")}, dilations=(1,),
            tt=40)


# --- the whole decoder -----------------------------------------------------


@pytest.mark.parametrize("which", ["tiny", "s2pro_strides"])
def test_quant_decoder_matches_jax_pallas(which):
    """The port's VOC_QUANT decoder vs JAX's, with nonzero biases. 17 tiny
    frames give the last block a 1088-row tile, not a multiple of 128: the
    final conv then runs after the block, as JAX runs it; the S2-Pro
    strides' last block fuses it."""
    cfg = tiny_codec_config() if which == "tiny" else _s2pro_strides_cfg()
    params = _biased_params(cfg, 5)
    frames = 17 if which == "tiny" else 1
    codes = jax.random.randint(jax.random.key(6),
                               (1, cfg.rvq.total_codebooks, frames), 0, 32,
                               dtype=jnp.int32)
    pk = jfast.pack_decoder(params["decoder"], cfg, dtype=jnp.float32,
                            quant=True)
    ref = np.asarray(jfast.dac_from_indices_pallas(params, cfg, codes,
                                                   packed=pk))
    port = codec_params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    cfg_t = _port_cfg(cfg)
    packed = tfast.pack_decoder(port["decoder"], cfg_t, dtype=torch.float32,
                                quant=True)
    got = tfast.dac_from_indices_fused(port, cfg_t,
                                       torch.from_numpy(np.array(codes)),
                                       packed=packed, device="cpu").numpy()
    assert got.shape == ref.shape == (1, frames * cfg.frame_length)
    _close_to_int8_step(got, ref)


def test_quant_decoder_close_to_bf16_path():
    """JAX's own criteria for its VOC_QUANT decoder against the bf16 conv
    path (tests/test_codec_fastpath.py, same weights and codes), on the
    port's int8 decoder."""
    cfg = tiny_codec_config()
    params = init_dac_params(jax.random.key(7), cfg)
    codes = jax.random.randint(jax.random.key(8),
                               (2, cfg.rvq.total_codebooks, 16), 0, 32,
                               dtype=jnp.int32)
    ref = np.asarray(jfast.dac_from_indices_mm(params, cfg, codes),
                     np.float32)
    port = codec_params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    cfg_t = _port_cfg(cfg)
    packed = tfast.pack_decoder(port["decoder"], cfg_t, quant=True)
    got = tfast.dac_from_indices_fused(port, cfg_t,
                                       torch.from_numpy(np.array(codes)),
                                       packed=packed,
                                       device="cpu").float().numpy()
    scale = max(np.abs(ref).max(), 1e-9)
    assert np.abs(got - ref).max() / scale < 0.05
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.995
