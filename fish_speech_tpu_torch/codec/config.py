"""Codec configuration dataclasses.

A copy of `fish_speech_tpu/codec/config.py` (the port imports nothing of the
JAX package). Mirrors the semantics of the upstream modded-DAC codec
(fish_speech/models/dac/modded_dac.py:804-861 and
fish_speech/configs/modded_dac_vq.yaml) as frozen, hashable dataclasses.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def find_multiple(n: int, k: int) -> int:
    if n % k == 0:
        return n
    return n + k - (n % k)


@dataclass(frozen=True)
class CodecTransformerConfig:
    """Window-limited causal transformer used pre/post quantizer and inside
    encoder blocks (ref: modded_dac.py:35-62, ModelArgs)."""

    n_layer: int = 8
    n_head: int = 16
    dim: int = 1024
    intermediate_size: int = 3072
    n_local_heads: int = -1
    head_dim: int = 64
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    window_size: int | None = 128

    def __post_init__(self):
        if self.n_local_heads == -1:
            object.__setattr__(self, "n_local_heads", self.n_head)


@dataclass(frozen=True)
class RVQConfig:
    """Downsampling residual vector quantizer (ref: rvq.py:204-291)."""

    input_dim: int = 1024
    n_codebooks: int = 9  # residual codebooks; +1 semantic
    codebook_size: int = 1024
    codebook_dim: int = 8
    semantic_codebook_size: int = 4096
    downsample_factor: tuple[int, ...] = (2, 2)
    # pre/post module transformer config (ref yaml: window 128, 8 layers, 1024d)
    pre_post_transformer: CodecTransformerConfig = dataclasses.field(
        default_factory=CodecTransformerConfig
    )

    @property
    def total_codebooks(self) -> int:
        return self.n_codebooks + 1

    @property
    def downsample_total(self) -> int:
        t = 1
        for f in self.downsample_factor:
            t *= f
        return t


@dataclass(frozen=True)
class DACConfig:
    """Top-level codec config (ref: modded_dac.py:804-861 + modded_dac_vq.yaml)."""

    sample_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: tuple[int, ...] = (2, 4, 8, 8)
    decoder_dim: int = 1536
    decoder_rates: tuple[int, ...] = (8, 8, 4, 2)
    encoder_transformer_layers: tuple[int, ...] = (0, 0, 0, 4)
    decoder_transformer_layers: tuple[int, ...] = (4, 0, 0, 0)
    latent_dim: int | None = None
    causal: bool = True
    rvq: RVQConfig = dataclasses.field(default_factory=RVQConfig)
    # general transformer defaults applied to encoder in-block transformers
    # (ref yaml transformer_general_config; window_size falls back to 512 for
    # encoder blocks, see modded_dac.py:641)
    encoder_transformer_window: int = 512

    @property
    def resolved_latent_dim(self) -> int:
        if self.latent_dim is not None:
            return self.latent_dim
        return self.encoder_dim * (2 ** len(self.encoder_rates))

    @property
    def hop_length(self) -> int:
        t = 1
        for r in self.encoder_rates:
            t *= r
        return t

    @property
    def frame_length(self) -> int:
        # hop * downsample_total (=4): one RVQ frame per 2048 samples @44.1kHz
        return self.hop_length * self.rvq.downsample_total

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.frame_length

    def encoder_block_transformer(self, dim: int, n_layer: int) -> CodecTransformerConfig:
        # ref: modded_dac.py:638-649 — in-block transformer built from the
        # general config partial with n_head=dim//64, intermediate=3*dim
        return CodecTransformerConfig(
            n_layer=n_layer,
            n_head=dim // 64,
            dim=dim,
            intermediate_size=dim * 3,
            head_dim=64,
            window_size=self.encoder_transformer_window,
        )


def s2_pro_codec_config() -> DACConfig:
    """The shipping S2-Pro codec layout (ref: configs/modded_dac_vq.yaml)."""
    return DACConfig()


def tiny_codec_config() -> DACConfig:
    """Small config for fast tests; same topology, fewer channels/layers."""
    t = CodecTransformerConfig(n_layer=2, n_head=2, dim=64, intermediate_size=128,
                               head_dim=32, window_size=16)
    return DACConfig(
        encoder_dim=8,
        encoder_rates=(2, 4, 4),
        decoder_dim=128,
        decoder_rates=(4, 4, 2),
        encoder_transformer_layers=(0, 0, 2),
        decoder_transformer_layers=(0, 0, 0),
        rvq=RVQConfig(
            input_dim=64,
            n_codebooks=3,
            codebook_size=32,
            codebook_dim=4,
            semantic_codebook_size=64,
            downsample_factor=(2, 2),
            pre_post_transformer=t,
        ),
        # the reference's encoder-block window always falls back to 512
        # (modded_dac.py:641 getattr on a functools.partial) — keep parity
        encoder_transformer_window=512,
    )
