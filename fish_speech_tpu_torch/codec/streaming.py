"""Streaming vocoder: codes to waveform chunk by chunk, equal to a full
decode.

Counterpart of `fish_speech_tpu/codec/streaming.py`. The codec's decode
path is causal with a bounded look-back: the only attention is the
post-quantizer transformer, limited to a window of frames, and the conv
stacks add a few frames more. Two ways to stream it:

- `StatefulVocoder` carries state: every stride-1 causal conv keeps its
  left context (its causal pad is zeros, so a zero context is exact from
  the first chunk), every transposed conv keeps its (k - stride)-sample
  overlap-add tail without the bias, and each window-limited attention
  layer keeps a rolling cache of its last `window` keys and values with
  absolute RoPE positions. Each frame is vocoded once.
- `StreamingVocoder` recomputes: it decodes the exact prefix while the
  stream is short, then a fixed window of history + chunk frames, and
  keeps the new tail (the history covers the attention window and the
  convs' reach).

Both run the plain f32 decoder of codec/model.py and codec/nn.py
(`F.conv1d`, `F.conv_transpose1d`, matmul), as the JAX package runs them
outside any Pallas kernel; the state is f32 too.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils.profiling import span
from .config import DACConfig, RVQConfig
from .model import DILATIONS, dac_from_indices
from .nn import (
    _ffn,
    apply_rotary_emb,
    conv1d,
    layer_norm,
    precompute_freqs_cis,
    rms_norm,
    snake,
)
from .rvq import _vq_lookup_sum

# attention window (128) + the upsample and conv stacks' reach, in frames
DEFAULT_HISTORY = 160


# ---------------------------------------------------------------------------
# Stateful primitives: (params, state, x) -> (y, state')
# ---------------------------------------------------------------------------


def _stream_conv(st, x, w, b, *, dilation: int = 1, groups: int = 1):
    """Stride-1 causal conv with its carried left context st (B, eff_k - 1,
    C_in), or None for k = 1."""
    k = w.shape[0]
    eff = (k - 1) * dilation + 1
    if eff == 1:
        return conv1d(x, w, b, groups=groups), st
    xin = torch.cat([st, x], dim=1)
    y = conv1d(xin, w, b, dilation=dilation, groups=groups)
    return y, xin[:, -(eff - 1):]


def _ctx(batch: int, length: int, channels: int, dtype, device):
    return torch.zeros((batch, length, channels), dtype=dtype, device=device)


def _stream_conv_transpose(st, x, w, b, *, stride: int):
    """Causal transposed conv with its carried overlap-add tail st
    (B, k - stride, C_out), kept without the bias: frame i reaches outputs
    [i * stride, i * stride + k), and the bias is added once, on emit. w
    (k, in, out) is JAX's correlation layout, flipped for
    `F.conv_transpose1d` as `nn.causal_conv_transpose1d` does."""
    k = w.shape[0]
    wt = w.to(x.dtype).flip(0).permute(1, 2, 0)          # (in, out, k)
    y = F.conv_transpose1d(x.transpose(1, 2), wt, stride=stride)
    y = y.transpose(1, 2)                        # (B, T*s + (k - s), C_out)
    t_out = x.shape[1] * stride
    tail = k - stride
    if tail > 0:
        y = torch.cat([y[:, :tail] + st.to(y.dtype), y[:, tail:]], dim=1)
        new_st = y[:, t_out:]
        y = y[:, :t_out]
    else:
        new_st = st
    if b is not None:
        y = y + b.to(y.dtype)[None, None, :]
    return y, new_st


def _freq_rows(freqs_table: torch.Tensor, pos, t: int) -> torch.Tensor:
    """Rows pos .. pos + t - 1 of the RoPE table; pos a host int or a 0-d
    tensor on the table's device (then no host sync)."""
    if isinstance(pos, torch.Tensor):
        return freqs_table[pos + torch.arange(t, device=pos.device)]
    return freqs_table[pos:pos + t]


def _stream_attention(p, cfg, st, x, pos, freqs_table, window: int):
    """One window-limited attention layer over its rolling last-`window`
    KV cache: absolute RoPE rows from the table, a key counts where
    key_abs >= 0 (the cache's zero slots do not), key_abs <= q_abs and
    key_abs > q_abs - window; the softmax in f32."""
    b, t, _ = x.shape
    h, d = cfg.n_head, cfg.head_dim
    q, k, v = torch.chunk(x @ p["wqkv"].T, 3, dim=-1)
    fc = _freq_rows(freqs_table, pos, t)
    q = apply_rotary_emb(q.reshape(b, t, h, d), fc)
    k = apply_rotary_emb(k.reshape(b, t, h, d), fc)
    v = v.reshape(b, t, h, d)
    k_all = torch.cat([st["k"], k], dim=1)           # (B, W + t, H, D)
    v_all = torch.cat([st["v"], v], dim=1)
    new_st = {"k": k_all[:, -window:], "v": v_all[:, -window:]}
    dev = x.device
    q_abs = pos + torch.arange(t, device=dev)
    key_abs = pos - window + torch.arange(window + t, device=dev)
    valid = ((key_abs[None, :] >= 0)
             & (key_abs[None, :] <= q_abs[:, None])
             & (key_abs[None, :] > q_abs[:, None] - window))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_all) / math.sqrt(d)
    scores = torch.where(valid[None, None], scores,
                         torch.full((), -torch.inf, device=dev))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    y = torch.einsum("bhqk,bkhd->bqhd", probs, v_all).reshape(b, t, h * d)
    return y @ p["wo"].T, new_st


def _stream_transformer(params, cfg, st, x, pos, freqs_table):
    """`nn.codec_transformer` with carried per-layer KV caches at absolute
    positions."""
    if "input_proj_w" in params:
        x = x @ params["input_proj_w"].T + params["input_proj_b"]
    new_layers = []
    for layer, lst in zip(params["layers"], st["layers"]):
        a, nls = _stream_attention(
            layer["attention"], cfg, lst,
            rms_norm(x, layer["attention_norm"], cfg.norm_eps), pos,
            freqs_table, cfg.window_size)
        x = x + layer["attention_ls"] * a
        f = _ffn(layer["feed_forward"],
                 rms_norm(x, layer["ffn_norm"], cfg.norm_eps))
        x = x + layer["ffn_ls"] * f
        new_layers.append(nls)
    x = rms_norm(x, params["norm"], cfg.norm_eps)
    if "output_proj_w" in params:
        x = x @ params["output_proj_w"].T + params["output_proj_b"]
    return x, {"layers": new_layers}


def _stream_convnext(p, st, x):
    y, nst = _stream_conv(st, x, p["dwconv_w"], p["dwconv_b"],
                          groups=x.shape[-1])
    y = layer_norm(y, p["norm_w"], p["norm_b"], 1e-6)
    y = F.gelu(y @ p["pw1_w"] + p["pw1_b"])
    y = y @ p["pw2_w"] + p["pw2_b"]
    if "gamma" in p:
        y = p["gamma"] * y
    return x + y, nst


def _stream_residual_unit(p, st, x, dilation: int):
    y = snake(x, p["snake1_alpha"])
    y, c1 = _stream_conv(st["c1"], y, p["conv1_w"], p["conv1_b"],
                         dilation=dilation)
    y = snake(y, p["snake2_alpha"])
    y, c2 = _stream_conv(st["c2"], y, p["conv2_w"], p["conv2_b"])
    return x + y, {"c1": c1, "c2": c2}


def _stream_decoder_block(p, st, x, stride: int):
    x = snake(x, p["snake_alpha"])
    x, tail = _stream_conv_transpose(st["tail"], x, p["conv_w"], p["conv_b"],
                                     stride=stride)
    units = []
    for unit, ust, dilation in zip(p["res_units"], st["res_units"],
                                   DILATIONS):
        x, nust = _stream_residual_unit(unit, ust, x, dilation)
        units.append(nust)
    return x, {"tail": tail, "res_units": units}


def vocoder_stream_step(params: dict, cfg: DACConfig, state: dict,
                        codes: torch.Tensor, freqs_table: torch.Tensor):
    """One streaming step: codes (B, K+1, t) -> (waveform (B, t *
    frame_length), state'). The continuation of `dac_from_indices` over
    the frames the state has seen."""
    rvq: RVQConfig = cfg.rvq
    q = params["quantizer"]
    semantic = codes[:, :1].clamp(0, rvq.semantic_codebook_size - 1)
    residual = codes[:, 1:].clamp(0, rvq.codebook_size - 1)
    z = (_vq_lookup_sum(semantic, q["semantic_codebooks"],
                        q["semantic_out_w"], q["semantic_out_b"])
         + _vq_lookup_sum(residual, q["residual_codebooks"],
                          q["residual_out_w"], q["residual_out_b"]))
    z, post_st = _stream_transformer(q["post_module"],
                                     rvq.pre_post_transformer,
                                     state["post_module"], z, state["pos"],
                                     freqs_table)
    up_st = []
    for stage, sst, factor in zip(q["upsample"], state["upsample"],
                                  reversed(rvq.downsample_factor)):
        z, tail = _stream_conv_transpose(sst["tail"], z, stage["conv_w"],
                                         stage["conv_b"], stride=factor)
        z, cst = _stream_convnext(stage["convnext"], sst["convnext"], z)
        up_st.append({"tail": tail, "convnext": cst})
    dec = params["decoder"]
    x, ci = _stream_conv(state["decoder"]["conv_in"], z, dec["conv_in_w"],
                         dec["conv_in_b"])
    blocks = []
    for block, bst, stride in zip(dec["blocks"], state["decoder"]["blocks"],
                                  cfg.decoder_rates):
        x, nbst = _stream_decoder_block(block, bst, x, stride)
        blocks.append(nbst)
    x = snake(x, dec["snake_alpha"])
    x, co = _stream_conv(state["decoder"]["conv_out"], x, dec["conv_out_w"],
                         dec["conv_out_b"])
    new_state = {
        "pos": state["pos"] + codes.shape[-1],
        "post_module": post_st,
        "upsample": up_st,
        "decoder": {"conv_in": ci, "blocks": blocks, "conv_out": co},
    }
    return torch.tanh(x)[..., 0], new_state


def init_vocoder_state(params: dict, cfg: DACConfig, batch: int = 1,
                       dtype=torch.float32, device=None) -> dict:
    """Zero streaming state shaped from the parameter tree, on `device`
    (the parameters' by default); "pos" is the host int 0."""
    rvq: RVQConfig = cfg.rvq
    q = params["quantizer"]
    dec = params["decoder"]
    if device is None:
        device = dec["conv_in_w"].device

    def conv_ctx(w, dilation: int = 1, width: int | None = None):
        eff = (w.shape[0] - 1) * dilation + 1
        if eff == 1:
            return None
        return _ctx(batch, eff - 1, w.shape[1] if width is None else width,
                    dtype, device)

    def tconv_tail(w, stride: int):
        return _ctx(batch, w.shape[0] - stride, w.shape[2], dtype, device)

    tcfg = rvq.pre_post_transformer
    if tcfg.window_size is None:
        raise ValueError("stateful streaming needs a window-limited post "
                         "transformer (window_size set)")
    kv = (batch, tcfg.window_size, tcfg.n_head, tcfg.head_dim)
    post = {"layers": [{"k": torch.zeros(kv, dtype=dtype, device=device),
                        "v": torch.zeros(kv, dtype=dtype, device=device)}
                       for _ in q["post_module"]["layers"]]}
    upsample = [{
        "tail": tconv_tail(stage["conv_w"], factor),
        # depthwise: the context's width is the stage's channel count
        "convnext": conv_ctx(stage["convnext"]["dwconv_w"],
                             width=stage["conv_w"].shape[2]),
    } for stage, factor in zip(q["upsample"],
                               reversed(rvq.downsample_factor))]
    blocks = [{
        "tail": tconv_tail(block["conv_w"], stride),
        "res_units": [{"c1": conv_ctx(unit["conv1_w"], dilation),
                       "c2": conv_ctx(unit["conv2_w"])}
                      for unit, dilation in zip(block["res_units"],
                                                DILATIONS)],
    } for block, stride in zip(dec["blocks"], cfg.decoder_rates)]
    return {
        "pos": 0,
        "post_module": post,
        "upsample": upsample,
        "decoder": {"conv_in": conv_ctx(dec["conv_in_w"]), "blocks": blocks,
                    "conv_out": conv_ctx(dec["conv_out_w"])},
    }


class StatefulVocoder:
    """codes -> audio with carried conv and attention state: each frame is
    vocoded once. Feed (K+1, t) codes as they come; the yielded chunks
    concatenate to the full decode of everything fed. Runs on `device`
    (CUDA unless the caller names another)."""

    def __init__(self, params: dict, cfg: DACConfig, chunk_frames: int = 64,
                 max_frames: int = 16384, batch: int = 1, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.chunk = chunk_frames
        self.batch = batch
        self.max_frames = max_frames
        tcfg = cfg.rvq.pre_post_transformer
        self._freqs = precompute_freqs_cis(max_frames, tcfg.head_dim,
                                           tcfg.rope_base, self.device)
        self.reset()

    def step(self, state: dict, codes: torch.Tensor):
        """One `vocoder_stream_step` of (B, K+1, t) codes from `state`:
        (waveform, state')."""
        with span("stream.vocoder", frames=codes.shape[-1]):
            return vocoder_stream_step(self.params, self.cfg, state,
                                       codes.to(self.device), self._freqs)

    def feed(self, codes: np.ndarray | None = None,
             final: bool = False) -> Iterator[np.ndarray]:
        """Append (K+1, t) codes (or None); yield the ready audio chunks
        (1-D f32 arrays of chunk * frame_length samples; the last, with
        final=True, may be shorter)."""
        if self._finished:
            raise RuntimeError(
                "StatefulVocoder was flushed with final=True (its state "
                "has advanced through the tail padding); call reset() "
                "before feeding a new stream.")
        if codes is not None and codes.shape[1] > 0:
            self._fed_frames += codes.shape[1]
            if self._fed_frames > self.max_frames:
                # the RoPE table holds max_frames rows
                raise ValueError(
                    f"stream exceeds max_frames={self.max_frames} "
                    f"(~{self.max_frames / self.cfg.frame_rate:.0f}s of "
                    "audio); construct StatefulVocoder with a larger "
                    "max_frames or reset() between utterances.")
            codes = np.asarray(codes, dtype=np.int64)
            self._pending = (codes if self._pending is None else
                             np.concatenate([self._pending, codes], axis=1))
        while self._pending is not None and (
                self._pending.shape[1] >= self.chunk
                or (final and self._pending.shape[1] > 0)):
            take = min(self.chunk, self._pending.shape[1])
            block = self._pending[:, :take]
            self._pending = (self._pending[:, take:]
                             if take < self._pending.shape[1] else None)
            if take < self.chunk:
                # the ragged last chunk: zero codes to the chunk's width
                # (causal: the pad changes no earlier sample), the waveform
                # trimmed; the state has passed the pad, so the stream ends
                block = np.concatenate(
                    [block, np.zeros((block.shape[0], self.chunk - take),
                                     np.int64)], axis=1)
                self._finished = True
            wav, self.state = self.step(self.state,
                                        torch.from_numpy(block)[None])
            yield wav[0, :take * self.cfg.frame_length].float().cpu().numpy()

    def reset(self) -> None:
        self.state = init_vocoder_state(self.params, self.cfg,
                                        batch=self.batch, device=self.device)
        self._pending: np.ndarray | None = None
        self._fed_frames = 0
        self._finished = False


class StreamingVocoder:
    """codes -> audio by recomputing a window (the fallback to
    StatefulVocoder): while the stream is shorter than history + chunk it
    decodes the exact prefix, right-padded with zero codes to a whole
    number of chunks; then a window of history + chunk frames, keeping the
    new tail. The yielded chunks concatenate to the full decode. Runs on
    `device` (CUDA unless the caller names another)."""

    def __init__(self, params: dict, cfg: DACConfig, chunk_frames: int = 64,
                 history_frames: int = DEFAULT_HISTORY, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.chunk = chunk_frames
        # history rounded up to whole chunks, so the phases align
        self.history = -(-history_frames // chunk_frames) * chunk_frames
        self._window_len = self.history + chunk_frames
        self.reset()

    def _run(self, codes: np.ndarray) -> np.ndarray:
        wav = dac_from_indices(self.params, self.cfg,
                               torch.from_numpy(codes)[None].to(self.device))
        return wav[0].float().cpu().numpy()

    def feed(self, codes: np.ndarray | None = None,
             final: bool = False) -> Iterator[np.ndarray]:
        """Append (K+1, t) codes (or None); yield the ready audio chunks."""
        if codes is not None and codes.shape[1] > 0:
            codes = np.asarray(codes, dtype=np.int64)
            self._codes = (codes if self._codes is None else
                           np.concatenate([self._codes, codes], axis=1))
        if self._codes is None:
            return
        fl = self.cfg.frame_length
        total = self._codes.shape[1]
        while (total - self._emitted >= self.chunk
               or (final and total > self._emitted)):
            end = min(self._emitted + self.chunk, total)
            if end <= self._window_len:
                target = -(-end // self.chunk) * self.chunk
                window = np.zeros((self._codes.shape[0], target), np.int64)
                window[:, :end] = self._codes[:, :end]
                yield self._run(window)[self._emitted * fl:end * fl]
            else:
                window = self._codes[:, end - self._window_len:end]
                wav = self._run(window)
                yield wav[(self._window_len - (end - self._emitted)) * fl:]
            self._emitted = end

    def reset(self) -> None:
        self._codes: np.ndarray | None = None
        self._emitted = 0
