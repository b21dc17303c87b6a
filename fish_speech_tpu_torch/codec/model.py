"""Modded-DAC codec: encoder, decoder (vocoder), the plain reference path.

Counterpart of `fish_speech_tpu/codec/model.py`. Decode: codes
(B, K+1, Tq) -> latents -> a transposed-conv upsampling pyramid -> a
44.1 kHz waveform (B, Tq * frame_length); the serving path is the fused
one in codec/fastpath.py. Encode: a waveform (B, T) -> strided conv blocks
(the last with a window-limited transformer) -> latents -> RVQ codes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .config import DACConfig
from .nn import (
    causal_conv1d,
    causal_conv_transpose1d,
    codec_transformer,
    residual_unit,
    snake,
)
from .rvq import rvq_decode, rvq_encode

DILATIONS = (1, 3, 9)


def encoder_block(params: dict, cfg: DACConfig, x: torch.Tensor,
                  stride: int, n_t_layer: int, dim: int) -> torch.Tensor:
    """Residual units (1, 3, 9) -> snake -> strided causal conv -> the
    block's transformer (window `encoder_transformer_window`) if it has
    layers."""
    for unit, dilation in zip(params["res_units"], DILATIONS):
        x = residual_unit(unit, x, dilation)
    x = snake(x, params["snake_alpha"])
    x = causal_conv1d(x, params["conv_w"], params["conv_b"], stride=stride)
    if n_t_layer > 0:
        x = codec_transformer(params["transformer"],
                              cfg.encoder_block_transformer(dim, n_t_layer),
                              x)
    return x


def encoder(params: dict, cfg: DACConfig, x: torch.Tensor) -> torch.Tensor:
    """Waveform (B, T, 1) -> latents (B, T / hop, latent_dim)."""
    x = causal_conv1d(x, params["conv_in_w"], params["conv_in_b"])
    dim = cfg.encoder_dim
    for block, stride, n_t in zip(params["blocks"], cfg.encoder_rates,
                                  cfg.encoder_transformer_layers):
        dim *= 2
        x = encoder_block(block, cfg, x, stride, n_t, dim)
    x = snake(x, params["snake_alpha"])
    return causal_conv1d(x, params["conv_out_w"], params["conv_out_b"])


def decoder_block(params: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Snake -> transposed conv (k = 2*stride) -> residual units (1, 3, 9)."""
    x = snake(x, params["snake_alpha"])
    x = causal_conv_transpose1d(x, params["conv_w"], params["conv_b"],
                                stride=stride)
    for unit, dilation in zip(params["res_units"], DILATIONS):
        x = residual_unit(unit, x, dilation)
    return x


def decoder(params: dict, cfg: DACConfig, z: torch.Tensor) -> torch.Tensor:
    """Latents (B, Tz, latent_dim) -> waveform (B, Tz*hop, 1)."""
    x = causal_conv1d(z, params["conv_in_w"], params["conv_in_b"])
    for block, stride in zip(params["blocks"], cfg.decoder_rates):
        x = decoder_block(block, x, stride)
    x = snake(x, params["snake_alpha"])
    x = causal_conv1d(x, params["conv_out_w"], params["conv_out_b"])
    return torch.tanh(x)


def dac_from_indices(params: dict, cfg: DACConfig,
                     indices: torch.Tensor) -> torch.Tensor:
    """RVQ codes (B, K+1, Tq) -> waveform (B, Tq*frame_length)."""
    z = rvq_decode(params["quantizer"], cfg.rvq, indices)
    return decoder(params["decoder"], cfg, z)[..., 0]


class EncodeResult(NamedTuple):
    codes: torch.Tensor          # (B, K+1, Tq)
    code_lengths: torch.Tensor   # (B,) valid frames of each row


def dac_encode(params: dict, cfg: DACConfig, audio: torch.Tensor,
               audio_lengths: torch.Tensor | None = None,
               device=None) -> EncodeResult:
    """Audio (B, T) or (B, T, 1) f32 -> RVQ codes, on `device` (CUDA
    unless the caller names another). The audio is right-padded with zeros
    to a whole number of frames; code_lengths = ceil(audio_lengths /
    frame_length) (every row full without audio_lengths)."""
    device = resolve_device(device)
    audio = audio.to(device)
    if audio.dim() == 2:
        audio = audio[..., None]
    length = audio.shape[1]
    right_pad = math.ceil(length / cfg.frame_length) * cfg.frame_length \
        - length
    audio = F.pad(audio, (0, 0, 0, right_pad))
    if audio_lengths is None:
        audio_lengths = torch.full((audio.shape[0],), length + right_pad,
                                   dtype=torch.int32, device=device)
    z = encoder(params["encoder"], cfg, audio)
    codes = rvq_encode(params["quantizer"], cfg.rvq, z).codes
    code_lengths = torch.ceil(audio_lengths.to(device) / cfg.frame_length)
    return EncodeResult(codes=codes, code_lengths=code_lengths.to(torch.int32))


def dac_decode_latents(params: dict, cfg: DACConfig,
                       z: torch.Tensor) -> torch.Tensor:
    """Latents (B, Tz, D) -> waveform (B, Tz * hop)."""
    return decoder(params["decoder"], cfg, z)[..., 0]
