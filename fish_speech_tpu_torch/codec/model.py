"""Modded-DAC decoder (vocoder): the plain reference path.

Counterpart of `fish_speech_tpu/codec/model.py` (decode side): codes
(B, K+1, Tq) -> latents -> a transposed-conv upsampling pyramid -> a
44.1 kHz waveform (B, Tq * frame_length). The serving path is the fused
one in codec/fastpath.py.
"""

from __future__ import annotations

import torch

from .config import DACConfig
from .nn import causal_conv1d, causal_conv_transpose1d, residual_unit, snake
from .rvq import rvq_decode

DILATIONS = (1, 3, 9)


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
