"""Residual vector quantizer.

Counterpart of `fish_speech_tpu/codec/rvq.py`: one semantic codebook plus
N residual codebooks. Decode looks the codes up and sums them through their
output projections, then runs the post-module transformer and the
transposed-conv upsample. Encode downsamples, runs the pre-module
transformer and picks each codebook's nearest entry to the residual.
Activations are channels-last (B, T, C).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import RVQConfig
from .nn import (
    causal_conv1d,
    causal_conv_transpose1d,
    codec_transformer,
    convnext_block,
)


class VQEncodeResult(NamedTuple):
    z: torch.Tensor        # (B, T, D) the quantized latents, upsampled
    codes: torch.Tensor    # (B, K+1, Tq) codebook indices


def _vq_lookup_sum(codes: torch.Tensor, codebooks: torch.Tensor,
                   out_w: torch.Tensor, out_b: torch.Tensor) -> torch.Tensor:
    """sum_i out_proj_i(codebook_i[codes_i]). codes (B, K, T); codebooks
    (K, V, d); out_w (K, d, D); out_b (K, D)."""
    k_idx = torch.arange(codebooks.shape[0], device=codes.device)
    gathered = codebooks[k_idx[None, :, None], codes.long()]   # (B, K, T, d)
    z = torch.einsum("bktd,kdD->btD", gathered, out_w)
    return z + out_b.sum(dim=0)[None, None, :]


def _normalized(x: torch.Tensor, dim: int = -1,
                eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), JAX's formula (not F.normalize's, which clamps
    the norm inside a division of its own)."""
    norm = torch.sqrt((x * x).sum(dim=dim, keepdim=True))
    return x / torch.clamp_min(norm, eps)


def _vq_encode_stage(z: torch.Tensor, codebooks: torch.Tensor,
                     in_w: torch.Tensor, in_b: torch.Tensor,
                     out_w: torch.Tensor, out_b: torch.Tensor):
    """Residual VQ over stacked codebooks: per codebook, project the
    residual to the codebook's width, L2-normalize both sides, take the
    nearest entry by JAX's squared distance |e|^2 - 2 e.c + |c|^2 (argmin:
    the first of equal distances), reconstruct through the output
    projection and subtract. z (B, T, D) -> (the reconstructions' sum,
    codes (B, K, T))."""
    z_q_sum = torch.zeros_like(z)
    residual = z
    codes = []
    for i in range(codebooks.shape[0]):
        enc = _normalized(residual @ in_w[i] + in_b[i])          # (B, T, d)
        cb = _normalized(codebooks[i])                            # (V, d)
        dist = ((enc * enc).sum(-1, keepdim=True) - 2.0 * (enc @ cb.T)
                + (cb * cb).sum(-1)[None, None, :])
        idx = torch.argmin(dist, dim=-1)                          # (B, T)
        z_q_i = codebooks[i][idx] @ out_w[i] + out_b[i]           # (B, T, D)
        z_q_sum = z_q_sum + z_q_i
        residual = residual - z_q_i
        codes.append(idx)
    return z_q_sum, torch.stack(codes, dim=1)


def rvq_downsample(params: dict, x: torch.Tensor,
                   cfg: RVQConfig) -> torch.Tensor:
    for stage, factor in zip(params["downsample"], cfg.downsample_factor):
        x = causal_conv1d(x, stage["conv_w"], stage["conv_b"], stride=factor)
        x = convnext_block(stage["convnext"], x)
    return x


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


def rvq_encode(params: dict, cfg: RVQConfig,
               z: torch.Tensor) -> VQEncodeResult:
    """Latents (B, T, D) -> codes (B, K+1, T / downsample) and the
    quantized latents, decoded back to (B, T, D): padded or cropped on the
    left to T."""
    original_t = z.shape[1]
    z = rvq_downsample(params, z, cfg)
    z = codec_transformer(params["pre_module"], cfg.pre_post_transformer, z)
    z_sem, sem_codes = _vq_encode_stage(
        z, params["semantic_codebooks"], params["semantic_in_w"],
        params["semantic_in_b"], params["semantic_out_w"],
        params["semantic_out_b"])
    z_res, res_codes = _vq_encode_stage(
        z - z_sem, params["residual_codebooks"], params["residual_in_w"],
        params["residual_in_b"], params["residual_out_w"],
        params["residual_out_b"])
    codes = torch.cat([sem_codes, res_codes], dim=1)
    zq = codec_transformer(params["post_module"], cfg.pre_post_transformer,
                           z_sem + z_res)
    zq = rvq_upsample(params, zq, cfg)
    diff = original_t - zq.shape[1]
    if diff > 0:
        zq = torch.nn.functional.pad(zq, (0, 0, diff, 0))
    elif diff < 0:
        zq = zq[:, -diff:, :]
    return VQEncodeResult(z=zq, codes=codes)
