"""Building blocks of the codec, channels-last (B, T, C).

Counterpart of `fish_speech_tpu/codec/nn.py` (decode side). Convolution
weights keep the JAX package's (k, in, out) layout, and a transposed conv's
kernel is stored spatially flipped relative to torch's ConvTranspose1d (the
JAX package expresses it as an input-dilated convolution).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .config import CodecTransformerConfig


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation: x + sin(alpha x)^2 / (alpha + 1e-9). alpha: (C,)."""
    a = alpha[None, None, :]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return normed.to(x.dtype) * weight + bias


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
           stride: int = 1, dilation: int = 1, groups: int = 1,
           padding: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Plain 1-D conv on (B, T, C_in). w: (k, in/groups, out)."""
    xt = F.pad(x.transpose(1, 2), padding)
    y = F.conv1d(xt, w.to(x.dtype).permute(2, 1, 0), stride=stride,
                 dilation=dilation, groups=groups).transpose(1, 2)
    if b is not None:
        y = y + b.to(x.dtype)[None, None, :]
    return y


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
                  stride: int = 1, dilation: int = 1,
                  groups: int = 1) -> torch.Tensor:
    """Left-padded so the output depends only on the past; an extra right
    pad aligns the length to the stride."""
    k = w.shape[0]
    eff_k = (k - 1) * dilation + 1
    pad = eff_k - stride
    length = x.shape[1]
    n_frames = (length - eff_k + pad) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (eff_k - pad)
    extra = ideal_length - length
    return conv1d(x, w, b, stride=stride, dilation=dilation, groups=groups,
                  padding=(pad, extra))


def causal_conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor | None, *,
                            stride: int) -> torch.Tensor:
    """Transposed conv, trimmed by (k - stride) on the right. w: (k, in,
    out), spatially flipped relative to torch's layout."""
    k = w.shape[0]
    wt = w.to(x.dtype).flip(0).permute(1, 2, 0)          # (in, out, k)
    y = F.conv_transpose1d(x.transpose(1, 2), wt, stride=stride)
    y = y.transpose(1, 2)
    if b is not None:
        y = y + b.to(x.dtype)[None, None, :]
    trim = k - stride
    return y[:, :-trim, :] if trim > 0 else y


def convnext_block(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv -> LN -> pointwise MLP (gelu) -> gamma ->
    residual."""
    inp = x
    x = causal_conv1d(x, params["dwconv_w"], params["dwconv_b"],
                      groups=x.shape[-1])
    x = layer_norm(x, params["norm_w"], params["norm_b"], 1e-6)
    x = x @ params["pw1_w"] + params["pw1_b"]
    x = F.gelu(x)
    x = x @ params["pw2_w"] + params["pw2_b"]
    if "gamma" in params:
        x = params["gamma"] * x
    return inp + x


def precompute_freqs_cis(seq_len: int, n_elem: int, base: float = 10000.0,
                         device=None) -> torch.Tensor:
    freqs = 1.0 / (base ** (np.arange(0, n_elem, 2)[: n_elem // 2]
                            .astype(np.float32) / n_elem))
    t = np.arange(seq_len, dtype=np.float32)
    angles = np.outer(t, freqs)
    cache = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    return torch.from_numpy(cache).to(device=device, dtype=torch.bfloat16)


def apply_rotary_emb(x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, D); freqs_cis: (T, D//2, 2)."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    fc = freqs_cis.float()[None, :, None]
    real = xf[..., 0] * fc[..., 0] - xf[..., 1] * fc[..., 1]
    imag = xf[..., 1] * fc[..., 0] + xf[..., 0] * fc[..., 1]
    return torch.stack([real, imag], dim=-1).reshape(x.shape).to(x.dtype)


def window_causal_mask(q_len: int, kv_len: int,
                       window_size: int | None) -> np.ndarray:
    """Banded lower-triangular mask."""
    rows = np.arange(q_len)[:, None]
    cols = np.arange(kv_len)[None, :]
    mask = cols <= rows
    if window_size is not None:
        mask &= cols >= np.maximum(rows - window_size + 1, 0)
    return mask


def mha(q, k, v, mask: torch.Tensor) -> torch.Tensor:
    """Masked multi-head attention. q, k, v: (B, T, H, D); mask (Tq, Tk)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(-torch.inf, device=q.device))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attention(params: dict, cfg: CodecTransformerConfig, x, freqs_cis, mask):
    b, t, _ = x.shape
    h, d = cfg.n_head, cfg.head_dim
    q, k, v = torch.chunk(x @ params["wqkv"].T, 3, dim=-1)
    q = apply_rotary_emb(q.reshape(b, t, h, d), freqs_cis)
    k = apply_rotary_emb(k.reshape(b, t, h, d), freqs_cis)
    y = mha(q, k, v.reshape(b, t, h, d), mask)
    return y.reshape(b, t, h * d) @ params["wo"].T


def _ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["w1"].T) * (x @ params["w3"].T)) @ params["w2"].T


def codec_transformer(params: dict, cfg: CodecTransformerConfig,
                      x: torch.Tensor) -> torch.Tensor:
    """Window-limited causal transformer, channels-last."""
    t = x.shape[1]
    if "input_proj_w" in params:
        x = x @ params["input_proj_w"].T + params["input_proj_b"]
    freqs_cis = precompute_freqs_cis(t, cfg.head_dim, cfg.rope_base, x.device)
    mask = torch.from_numpy(window_causal_mask(t, t, cfg.window_size)).to(
        x.device)
    for layer in params["layers"]:
        a = _attention(layer["attention"], cfg,
                       rms_norm(x, layer["attention_norm"], cfg.norm_eps),
                       freqs_cis, mask)
        x = x + layer["attention_ls"] * a
        f = _ffn(layer["feed_forward"],
                 rms_norm(x, layer["ffn_norm"], cfg.norm_eps))
        x = x + layer["ffn_ls"] * f
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    if "output_proj_w" in params:
        x = x @ params["output_proj_w"].T + params["output_proj_b"]
    return x


def residual_unit(params: dict, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """Snake -> causal conv k7 (dilated) -> Snake -> conv k1, residual."""
    y = snake(x, params["snake1_alpha"])
    y = causal_conv1d(y, params["conv1_w"], params["conv1_b"],
                      dilation=dilation)
    y = snake(y, params["snake2_alpha"])
    y = causal_conv1d(y, params["conv2_w"], params["conv2_b"])
    pad = x.shape[1] - y.shape[1]
    if pad > 0:
        x = x[:, :-pad, :]
    return x + y
