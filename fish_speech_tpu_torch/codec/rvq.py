"""Residual vector quantizer, decode side.

Counterpart of `fish_speech_tpu/codec/rvq.py`: one semantic codebook plus
N residual codebooks, looked up and summed through their output
projections, then the post-module transformer and the transposed-conv
upsample. Activations are channels-last (B, T, C).
"""

from __future__ import annotations

import torch

from .config import RVQConfig
from .nn import causal_conv_transpose1d, codec_transformer, convnext_block


def _vq_lookup_sum(codes: torch.Tensor, codebooks: torch.Tensor,
                   out_w: torch.Tensor, out_b: torch.Tensor) -> torch.Tensor:
    """sum_i out_proj_i(codebook_i[codes_i]). codes (B, K, T); codebooks
    (K, V, d); out_w (K, d, D); out_b (K, D)."""
    k_idx = torch.arange(codebooks.shape[0], device=codes.device)
    gathered = codebooks[k_idx[None, :, None], codes.long()]   # (B, K, T, d)
    z = torch.einsum("bktd,kdD->btD", gathered, out_w)
    return z + out_b.sum(dim=0)[None, None, :]


def rvq_upsample(params: dict, x: torch.Tensor, cfg: RVQConfig) -> torch.Tensor:
    for stage, factor in zip(params["upsample"],
                             reversed(cfg.downsample_factor)):
        x = causal_conv_transpose1d(x, stage["conv_w"], stage["conv_b"],
                                    stride=factor)
        x = convnext_block(stage["convnext"], x)
    return x


def rvq_decode(params: dict, cfg: RVQConfig,
               indices: torch.Tensor) -> torch.Tensor:
    """codes (B, K+1, Tq) -> latents (B, Tq*downsample, D)."""
    semantic = indices[:, :1].clamp(0, cfg.semantic_codebook_size - 1)
    residual = indices[:, 1:].clamp(0, cfg.codebook_size - 1)
    z = (_vq_lookup_sum(semantic, params["semantic_codebooks"],
                        params["semantic_out_w"], params["semantic_out_b"])
         + _vq_lookup_sum(residual, params["residual_codebooks"],
                          params["residual_out_w"], params["residual_out_b"]))
    z = codec_transformer(params["post_module"], cfg.pre_post_transformer, z)
    return rvq_upsample(params, z, cfg)
