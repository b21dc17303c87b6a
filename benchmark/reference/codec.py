"""Plain float32 reference of the S2-Pro codec's decoder (modded DAC).

A frozen copy written for the benchmark: it imports nothing of the
program. Codes (K, n) -> the 44.1 kHz waveform (n * 2048,): the semantic
and residual codebooks looked up and summed through their projections, a
window-limited causal transformer, two transposed-conv upsampling stages
with ConvNeXt blocks, then the decoder: a k7 conv, four blocks (snake, a
causal transposed conv, three residual units of dilations 1, 3, 9), snake,
a k7 conv and tanh. Every conv is causal. Channels-last (T, C); conv
weights (k, in, out), a transposed conv's kernel spatially flipped against
torch's layout. TF32 is off.

`decode_stream` gives the same waveform chunk by chunk, each chunk the
tail of a decode of the whole prefix: equal to `decode` because every
layer is causal.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DILATIONS = (1, 3, 9)


def snake(x, alpha):
    return x + torch.sin(alpha * x) ** 2 / (alpha + 1e-9)


def conv(x, w, b, *, dilation: int = 1, groups: int = 1):
    """Causal stride-1 conv of (T, C_in) with w (k, in/groups, out)."""
    k = w.shape[0]
    pad = (k - 1) * dilation
    y = F.conv1d(F.pad(x.T[None], (pad, 0)), w.permute(2, 1, 0),
                 dilation=dilation, groups=groups)[0].T
    return y + b


def tconv(x, w, b, stride: int):
    """Causal transposed conv, the (k - stride) overhang cut on the right."""
    k = w.shape[0]
    y = F.conv_transpose1d(x.T[None], w.flip(0).permute(1, 2, 0),
                           stride=stride)[0].T + b
    return y[:y.shape[0] - (k - stride)]


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def transformer(p: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal transformer with attention limited to the last `window`
    positions, LayerScale on both branches."""
    t = x.shape[0]
    h, d = cfg["n_head"], cfg["head_dim"]
    freqs = 1.0 / (cfg["rope_base"] ** (torch.arange(0, d, 2, dtype=torch.float64,
                                                     device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = (ang.cos().to(x.dtype)[:, None], ang.sin().to(x.dtype)[:, None])

    def rope(v):
        vp = v.reshape(t, h, -1, 2)
        return torch.stack([vp[..., 0] * cos - vp[..., 1] * sin,
                            vp[..., 1] * cos + vp[..., 0] * sin],
                           dim=-1).reshape(t, h, d)

    i = torch.arange(t, device=x.device)
    mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - cfg["window"])
    for layer in p["layers"]:
        a = layer["attention"]
        q, k, v = (_rms(x, layer["attention_norm"], cfg["norm_eps"])
                   @ a["wqkv"].T).chunk(3, dim=-1)
        q, k, v = rope(q.reshape(t, h, d)), rope(k.reshape(t, h, d)), \
            v.reshape(t, h, d)
        s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(d)
        s = s.masked_fill(~mask, float("-inf")).softmax(-1)
        y = torch.einsum("hts,shd->thd", s, v).reshape(t, h * d)
        x = x + layer["attention_ls"] * (y @ a["wo"].T)
        f = layer["feed_forward"]
        hn = _rms(x, layer["ffn_norm"], cfg["norm_eps"])
        x = x + layer["ffn_ls"] * ((F.silu(hn @ f["w1"].T) * (hn @ f["w3"].T))
                                   @ f["w2"].T)
    return _rms(x, p["norm"], cfg["norm_eps"])


def convnext(p, x):
    y = conv(x, p["dwconv_w"], p["dwconv_b"], groups=x.shape[-1])
    y = F.layer_norm(y, y.shape[-1:], p["norm_w"], p["norm_b"], 1e-6)
    y = F.gelu(y @ p["pw1_w"] + p["pw1_b"]) @ p["pw2_w"] + p["pw2_b"]
    return x + p["gamma"] * y


def residual_unit(p, x, dilation):
    y = conv(snake(x, p["snake1_alpha"]), p["conv1_w"], p["conv1_b"],
             dilation=dilation)
    return x + conv(snake(y, p["snake2_alpha"]), p["conv2_w"], p["conv2_b"])


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


@torch.no_grad()
def decode(params: dict, cfg: dict, codes: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """codes (K, n) int -> waveform (n * frame_length,) float32, computed
    in `dtype` (float32; a lower one for a control)."""
    if dtype != torch.float32:
        params = _cast(params, dtype)
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _decode(params, cfg, codes).float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _decode(params, cfg, codes):
    q, dec = params["quantizer"], params["decoder"]
    codes = codes.long().to(q["semantic_codebooks"].device)
    sem = codes[0].clamp(0, cfg["semantic_codebook_size"] - 1)
    res = codes[1:].clamp(0, cfg["codebook_size"] - 1)
    z = q["semantic_codebooks"][0][sem] @ q["semantic_out_w"][0] \
        + q["semantic_out_b"][0]
    for i in range(res.shape[0]):
        z = z + q["residual_codebooks"][i][res[i]] @ q["residual_out_w"][i] \
            + q["residual_out_b"][i]
    z = transformer(q["post_module"], cfg["post_transformer"], z)
    for stage, factor in zip(q["upsample"], reversed(cfg["downsample"])):
        z = convnext(stage["convnext"], tconv(z, stage["conv_w"],
                                              stage["conv_b"], factor))
    x = conv(z, dec["conv_in_w"], dec["conv_in_b"])
    for block, stride in zip(dec["blocks"], cfg["decoder_rates"]):
        x = tconv(snake(x, block["snake_alpha"]), block["conv_w"],
                  block["conv_b"], stride)
        for unit, dilation in zip(block["res_units"], DILATIONS):
            x = residual_unit(unit, x, dilation)
    x = conv(snake(x, dec["snake_alpha"]), dec["conv_out_w"],
             dec["conv_out_b"])
    return torch.tanh(x[:, 0])


def decode_stream(params: dict, cfg: dict, codes: torch.Tensor,
                  chunk: int, first: int | None = None):
    """The waveform of `codes` (K, n) as chunks of `chunk` frames (the
    first of `first`), each cut from a decode of the whole prefix."""
    n, fl = codes.shape[1], cfg["frame_length"]
    start, width = 0, first or chunk
    while start < n:
        end = min(n, start + width)
        yield decode(params, cfg, codes[:, :end])[start * fl:end * fl]
        start, width = end, chunk
