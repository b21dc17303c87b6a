"""Port's codec decode vs the reference goldens and the JAX fused decoder."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.codec import (
    convert_dac_state_dict,
    init_dac_params,
    tiny_codec_config,
)
from fish_speech_tpu.codec import fastpath as jfast
from fish_speech_tpu.codec.config import DACConfig, RVQConfig
from fish_speech_tpu_torch.codec import config as tcfg
from fish_speech_tpu_torch.codec import fastpath as tfast
from fish_speech_tpu_torch.codec.init import (
    codec_params_from_jax,
    init_dac_params as init_t,
)
from fish_speech_tpu_torch.codec.model import dac_from_indices
from fish_speech_tpu_torch.codec.rvq import rvq_decode

GOLDEN = Path(__file__).parent / "goldens" / "codec_tiny.npz"


def _port(cfg):
    """The same config as the port's dataclasses."""
    t = cfg.rvq.pre_post_transformer
    rvq = tcfg.RVQConfig(**{**dataclasses.asdict(cfg.rvq),
                            "pre_post_transformer":
                                tcfg.CodecTransformerConfig(
                                    **dataclasses.asdict(t))})
    return tcfg.DACConfig(**{**dataclasses.asdict(cfg), "rvq": rvq})


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def golden_params(golden):
    cfg = tiny_codec_config()
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("sd:")}
    tree = jax.tree.map(np.asarray, convert_dac_state_dict(sd, cfg))
    return codec_params_from_jax(tree, device="cpu")


def test_config_copy_matches():
    assert _port(tiny_codec_config()) == tcfg.tiny_codec_config()
    assert _port(DACConfig()) == tcfg.s2_pro_codec_config()


def test_from_indices_matches_golden(golden, golden_params):
    cfg = tcfg.tiny_codec_config()
    codes = torch.from_numpy(golden["codes1"])
    ours = dac_from_indices(golden_params, cfg, codes).numpy()
    assert ours.shape == (codes.shape[0], codes.shape[2] * cfg.frame_length)
    # the JAX codec parity test's tolerance (f32)
    np.testing.assert_allclose(ours, golden["golden_audio"][:, 0, :],
                               atol=2e-4, rtol=1e-3)


def test_rvq_decode_matches_golden(golden, golden_params):
    cfg = tcfg.tiny_codec_config()
    z = rvq_decode(golden_params["quantizer"], cfg.rvq,
                   torch.from_numpy(golden["codes2"])).numpy()
    np.testing.assert_allclose(z.transpose(0, 2, 1), golden["golden_z"],
                               atol=1e-4, rtol=1e-3)


def _s2pro_strides_cfg():
    """The real S2-Pro strides (8, 8, 4, 2) with shrunken channels, as in
    tests/test_codec_fastpath.py."""
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


@pytest.mark.parametrize("which", ["tiny", "s2pro_strides"])
def test_fused_decoder_matches_jax_pallas(which):
    cfg = tiny_codec_config() if which == "tiny" else _s2pro_strides_cfg()
    params = init_dac_params(jax.random.key(5), cfg)
    g = np.random.default_rng(6)
    # nonzero biases: the fused kernels' left-context handling must agree
    for blk in params["decoder"]["blocks"]:
        blk["conv_b"] = jnp.asarray(g.normal(0, 0.05, blk["conv_b"].shape),
                                    jnp.float32)
        for u in blk["res_units"]:
            u["conv1_b"] = jnp.asarray(g.normal(0, 0.05, u["conv1_b"].shape),
                                       jnp.float32)
    frames = 2 if which == "tiny" else 1
    codes = jax.random.randint(jax.random.key(6),
                               (1, cfg.rvq.total_codebooks, frames), 0, 32,
                               dtype=jnp.int32)
    ref = np.asarray(jfast.dac_from_indices_pallas(params, cfg, codes))
    port = codec_params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    cfg_t = _port(cfg)
    packed = tfast.pack_decoder(port["decoder"], cfg_t, dtype=torch.float32)
    got = tfast.dac_from_indices_fused(port, cfg_t,
                                       torch.from_numpy(np.array(codes)),
                                       packed=packed, device="cpu").numpy()
    assert got.shape == ref.shape == (1, frames * cfg.frame_length)
    # f32 end to end; the codec fastpath tests' tolerance
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_fused_matches_plain_path_on_port_init():
    cfg = tcfg.tiny_codec_config()
    params = init_t(torch.Generator().manual_seed(0), cfg, device="cpu")
    codes = torch.randint(0, 32, (2, cfg.rvq.total_codebooks, 5),
                          generator=torch.Generator().manual_seed(1))
    ref = dac_from_indices(params, cfg, codes)
    got = tfast.dac_from_indices_fused(
        params, cfg, codes, packed=tfast.pack_decoder(params["decoder"], cfg,
                                                      dtype=torch.float32),
        device="cpu")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_tiles_follow_jax():
    """The fused kernels' time tiles and tile caps are JAX's (the int8
    vocoder's result depends on them)."""
    for t in (16, 24, 48, 96, 100, 256, 384, 640, 2048, 2176, 4096, 6144,
              65536, 262144):
        for cap in (256, 512, 1024, 2048):
            assert tfast._tile_for(t, cap) == jfast._tile_for(t, cap), (t,
                                                                       cap)
    for c in (8, 64, 96, 128, 192, 256, 384, 512, 768):
        cp = jfast._lane_pad(c)
        assert tfast._tile_cap(c) == (2048 if cp <= 128 else
                                      (1024 if cp <= 256 else 512))


@pytest.mark.parametrize("which", ["tiny", "s2pro_strides"])
def test_mm_decoder_matches_jax(which):
    """The `--vocoder-impl mm` decoder (dac_from_indices_mm) against the
    JAX package's, f32 end to end."""
    cfg = tiny_codec_config() if which == "tiny" else _s2pro_strides_cfg()
    params = init_dac_params(jax.random.key(7), cfg)
    codes = jax.random.randint(jax.random.key(8),
                               (2, cfg.rvq.total_codebooks, 3), 0, 32,
                               dtype=jnp.int32)
    ref = np.asarray(jfast.dac_from_indices_mm(params, cfg, codes))
    port = codec_params_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    got = tfast.dac_from_indices_mm(port, _port(cfg),
                                    torch.from_numpy(np.array(codes))).numpy()
    assert got.shape == ref.shape == (2, 3 * cfg.frame_length)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
