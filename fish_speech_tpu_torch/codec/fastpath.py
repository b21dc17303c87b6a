"""The serving vocoder: codes -> waveform through the fused kernels.

Counterpart of `fish_speech_tpu/codec/fastpath.py`. Stride-1 causal convs
are k shifted matmuls, a k = 2*stride transposed conv is two phase-expanded
matmuls:

  conv (stride 1):  y[t] = sum_i  x[t - (eff_k-1) + i*dil] @ W[i]
  tconv (k = 2s):   y[t*s + p] = x[t] @ W[2s-1-p] + x[t-1] @ W[s-1-p]

`decoder_fused` runs decoder blocks with at most 512 channels whole in
ops/voc_fused.fused_block (blocks 1-3 of S2-Pro, the last one with the
final conv and tanh), and a wider block (block 0, 768 channels) as a
transposed conv in torch.matmul followed by ops/voc_fused.fused_res_stack,
one unit per call. The convs the JAX package leaves outside its kernels
(conv_in, block 0's transposed conv, the quantizer's) stay matmuls here.
Channels are not padded to 128 (only the TPU compiler needed that), but
the time tiles are the JAX package's, chosen by the padded width: the int8
vocoder (`pack_decoder(quant=True)`, VOC_QUANT=1) takes one activation
scale per tile, so its result depends on them.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.quant import div_exact
from ..ops.voc_fused import (DILATIONS, block_weights_t, fused_block,
                              fused_res_stack, pack_res_stack, res_weights_t)
from .config import DACConfig, RVQConfig
from .nn import codec_transformer, layer_norm, snake
from .rvq import _vq_lookup_sum

FUSED_BLOCK_MAX_C = 512
RES_STACK_TILE_CAP = 256     # block 0's per-unit calls


def _tile_for(t: int, cap: int = 512) -> int:
    """Largest tile <= cap that divides t and is a multiple of 16 (the JAX
    package's rule; 16, or t itself, when none is larger)."""
    tt = min(cap, t)
    while t % tt or tt % 16:
        tt -= 16 if tt % 16 == 0 else tt % 16
        if tt <= 16:
            return 16 if t % 16 == 0 else t
    return tt


def _tile_cap(c: int) -> int:
    """The fused kernels' tile cap by the channel count padded to 128 lanes,
    as the JAX package pads it: small-C stages take larger tiles."""
    cp = -(-c // 128) * 128
    return 2048 if cp <= 128 else (1024 if cp <= 256 else 512)


def conv1d_mm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
              dilation: int = 1) -> torch.Tensor:
    """Stride-1 causal conv as k shifted matmuls. x (B, T, C_in), w (k,
    C_in, C_out); the output has the input's length."""
    k = w.shape[0]
    if k == 1:
        y = x @ w[0].to(x.dtype)
    else:
        eff = (k - 1) * dilation + 1
        xp = F.pad(x, (0, 0, eff - 1, 0))
        t = x.shape[1]
        y = xp[:, :t] @ w[0].to(x.dtype)
        for i in range(1, k):
            y = y + xp[:, i * dilation:i * dilation + t] @ w[i].to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)[None, None, :]
    return y


def tconv_phases(w: torch.Tensor, stride: int) -> list[torch.Tensor]:
    """Per-lag phase matrices (C_in, stride*C_out) of a (k, C_in, C_out)
    transposed-conv kernel, k a multiple of stride."""
    k, cin, cout = w.shape
    out = []
    for j in range(k // stride):
        wj = w[k - (j + 1) * stride:k - j * stride].flip(0)
        out.append(wj.transpose(0, 1).reshape(cin, stride * cout))
    return out


def conv_transpose1d_phases(x: torch.Tensor, phases: list,
                            b: torch.Tensor | None, *,
                            stride: int) -> torch.Tensor:
    """Transposed conv from its phase matrices: (B, T, C_in) ->
    (B, T*stride, C_out)."""
    bsz, t = x.shape[:2]
    cout = phases[0].shape[1] // stride
    y = None
    x_lag = x
    for j, wj in enumerate(phases):
        term = x_lag @ wj.to(x.dtype)
        y = term if y is None else y + term
        if j + 1 < len(phases):
            x_lag = F.pad(x_lag, (0, 0, 1, 0))[:, :-1]
    y = y.reshape(bsz, t * stride, cout)
    if b is not None:
        y = y + b.to(y.dtype)[None, None, :]
    return y


def conv_transpose1d_mm(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor | None, *, stride: int):
    return conv_transpose1d_phases(x, tconv_phases(w.to(x.dtype), stride), b,
                                   stride=stride)


def convnext_block_mm(params: dict, x: torch.Tensor) -> torch.Tensor:
    """ConvNeXt block with the depthwise conv as shifted multiplies."""
    inp = x
    w = params["dwconv_w"]                               # (k, 1, C)
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    t = x.shape[1]
    y = xp[:, :t] * w[0, 0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i:i + t] * w[i, 0].to(x.dtype)
    y = y + params["dwconv_b"].to(y.dtype)
    y = layer_norm(y, params["norm_w"], params["norm_b"], 1e-6)
    y = y @ params["pw1_w"] + params["pw1_b"]
    y = F.gelu(y)
    y = y @ params["pw2_w"] + params["pw2_b"]
    if "gamma" in params:
        y = params["gamma"] * y
    return inp + y


def rvq_upsample_mm(params: dict, x: torch.Tensor,
                    cfg: RVQConfig) -> torch.Tensor:
    for stage, factor in zip(params["upsample"],
                             reversed(cfg.downsample_factor)):
        x = conv_transpose1d_mm(x, stage["conv_w"], stage["conv_b"],
                                stride=factor)
        x = convnext_block_mm(stage["convnext"], x)
    return x


def rvq_decode_mm(params: dict, cfg: RVQConfig,
                  indices: torch.Tensor) -> torch.Tensor:
    semantic = indices[:, :1].clamp(0, cfg.semantic_codebook_size - 1)
    residual = indices[:, 1:].clamp(0, cfg.codebook_size - 1)
    z = (_vq_lookup_sum(semantic, params["semantic_codebooks"],
                        params["semantic_out_w"], params["semantic_out_b"])
         + _vq_lookup_sum(residual, params["residual_codebooks"],
                          params["residual_out_w"], params["residual_out_b"]))
    z = codec_transformer(params["post_module"], cfg.pre_post_transformer, z)
    return rvq_upsample_mm(params, z, cfg)


def _tail(alpha: torch.Tensor) -> torch.Tensor:
    """(2, C) f32 snake constants [alpha/pi, 1/(alpha+eps)]."""
    a = alpha.float()
    return torch.stack([a * (1.0 / math.pi), 1.0 / (a + 1e-9)]).contiguous()


def pack_decoder(params: dict, cfg: DACConfig, dtype=torch.bfloat16,
                 quant: bool | None = None) -> dict:
    """Pre-pack the decoder for `decoder_fused`: per block the residual
    units (ops/voc_fused.pack_res_stack), the transposed conv as phase
    matrices (stacked for the fused block), and the next snake as the
    block's tail; the final conv as an (8, C) f32 block (7 taps + a bias
    row) for the last block's kernel. Packs also keep the weights the
    kernels' passes read, transposed (K-major, in the pack's dtype): a
    fused block's as "wt", the units' of a block run one unit a call as
    "w7t" and "w1t".

    quant=True (None: the VOC_QUANT environment variable, "1") packs the
    fused kernels' convolutions as int8: the units per pack_res_stack, and
    the fused block's stacked phases per output column (of the phases in
    `dtype`), with a second tconv_pb row of the scales / 127."""
    if quant is None:
        quant = os.environ.get("VOC_QUANT", "0") == "1"
    out = {"conv_in_w": params["conv_in_w"].to(dtype),
           "conv_in_b": params["conv_in_b"].to(dtype), "blocks": []}
    blocks = params["blocks"]
    for i, (block, stride) in enumerate(zip(blocks, cfg.decoder_rates)):
        phases = [p.to(dtype) for p in tconv_phases(block["conv_w"], stride)]
        dim = block["conv_w"].shape[2]
        res = pack_res_stack(block["res_units"], dtype=dtype, quant=quant)
        if dim <= FUSED_BLOCK_MAX_C and len(phases) == 2:
            pw = torch.stack(phases)
            pb = block["conv_b"].float().repeat(stride)
            if quant:
                pwf = pw.float()
                ps = pwf.abs().amax(dim=(0, 1)).clamp_min(1e-12)
                pw = torch.round(pwf / ps * 127.0).to(torch.int8)
                pb = torch.stack([pb, div_exact(ps, 127.0)])
            res["tconv_pw"] = pw.contiguous()
            res["tconv_pb"] = pb.contiguous()
            res["wt"] = block_weights_t(res)
        else:
            res["w7t"], res["w1t"] = res_weights_t(res)
        nxt = (blocks[i + 1]["snake_alpha"] if i + 1 < len(blocks)
               else params["snake_alpha"])
        out["blocks"].append({
            "snake_alpha": block["snake_alpha"].float(),
            "tconv_phases": phases,
            "tconv_b": block["conv_b"].to(dtype),
            "res": res,
            "tail_vec": _tail(nxt),
        })
    out["conv_out_w"] = params["conv_out_w"].to(dtype)
    out["conv_out_b"] = params["conv_out_b"].to(dtype)
    if "tconv_pw" in out["blocks"][-1]["res"]:
        fw = params["conv_out_w"][:, :, 0].float()                # (7, C)
        bias_row = torch.zeros_like(fw[:1])
        bias_row[0, 0] = params["conv_out_b"][0]
        out["final_fw"] = torch.cat([fw, bias_row]).contiguous()
    return out


def decoder_fused(params: dict, cfg: DACConfig, z: torch.Tensor,
                  packed: dict | None = None) -> torch.Tensor:
    """model.decoder on the fused kernels. z: latents (B, Tz, latent_dim);
    the decoder runs in the packed dtype. Returns (B, Tz*hop, 1). The time
    tiles, and whether the last block fuses the final conv (only when its
    tile is a multiple of 128), are the JAX decoder's."""
    if packed is None:
        packed = pack_decoder(params, cfg, dtype=z.dtype)
    x = conv1d_mm(z.to(packed["conv_in_w"].dtype), packed["conv_in_w"],
                  packed["conv_in_b"])
    # block 0's entry snake has no preceding kernel to ride in: exact sin
    x = snake(x.float(), packed["blocks"][0]["snake_alpha"]).to(x.dtype)
    n_blocks = len(packed["blocks"])
    for bi, (pb, stride) in enumerate(zip(packed["blocks"],
                                          cfg.decoder_rates)):
        res = pb["res"]
        if "tconv_pw" in res:
            tt = _tile_for(x.shape[1] * stride, _tile_cap(res["w1"].shape[-1]))
            if bi == n_blocks - 1 and "final_fw" in packed and tt % 128 == 0:
                wave = fused_block(x, res, stride=stride, dilations=DILATIONS,
                                   tail_vec=pb["tail_vec"],
                                   final_w=packed["final_fw"], tt=tt)
                return wave[..., None]
            x = fused_block(x, res, stride=stride, dilations=DILATIONS,
                            tail_vec=pb["tail_vec"], tt=tt)
            continue
        x = conv_transpose1d_phases(x, pb["tconv_phases"], pb["tconv_b"],
                                    stride=stride)
        tt = _tile_for(x.shape[1], RES_STACK_TILE_CAP)
        for u, d in enumerate(DILATIONS):
            sub = {k: v[u:u + 1] for k, v in res.items()}
            last = u == len(DILATIONS) - 1
            x = fused_res_stack(x, sub, dilations=(d,),
                                tail_vec=pb["tail_vec"] if last else None,
                                tt=tt)
    x = conv1d_mm(x, packed["conv_out_w"], packed["conv_out_b"])
    return torch.tanh(x)


def dac_from_indices_fused(params: dict, cfg: DACConfig,
                           indices: torch.Tensor,
                           packed: dict | None = None,
                           device=None) -> torch.Tensor:
    """RVQ codes (B, K+1, Tq) -> waveform (B, Tq*frame_length) through the
    fused decoder. Runs on `device` (CUDA by default); the codes are moved
    there."""
    device = resolve_device(device)
    z = rvq_decode_mm(params["quantizer"], cfg.rvq, indices.to(device))
    return decoder_fused(params["decoder"], cfg, z, packed=packed)[..., 0]
