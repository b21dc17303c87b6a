"""Random codec parameters, and the weight carry from the JAX package.

Counterpart of `fish_speech_tpu/codec/init.py::init_dac_params`. Layouts
match the JAX package's tree. The draws run in another order than JAX's:
first what decoding reads (the quantizer's decode side, then the decoder),
then the encoder and the quantizer's encode side, so that a seed gives the
decode parameters it gave before the encoder was ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .config import CodecTransformerConfig, DACConfig, RVQConfig

_STD = 0.02


class _Init:
    def __init__(self, gen: torch.Generator, device):
        self.gen, self.device = gen, device

    def w(self, shape, std=_STD) -> torch.Tensor:
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=self.gen)
        return t * std

    def full(self, shape, value) -> torch.Tensor:
        return torch.full(shape, float(value), dtype=torch.float32,
                          device=self.device)


def _convnext_p(r: _Init, dim: int, mlp_ratio: float = 4.0, kernel: int = 7):
    hidden = int(mlp_ratio * dim)
    return {
        "dwconv_w": r.w((kernel, 1, dim)), "dwconv_b": r.full((dim,), 0),
        "norm_w": r.full((dim,), 1), "norm_b": r.full((dim,), 0),
        "pw1_w": r.w((dim, hidden)), "pw1_b": r.full((hidden,), 0),
        "pw2_w": r.w((hidden, dim)), "pw2_b": r.full((dim,), 0),
        "gamma": r.full((dim,), 1e-6),
    }


def _transformer_p(r: _Init, cfg: CodecTransformerConfig,
                   input_dim: int | None = None) -> dict:
    qkv_dim = 3 * cfg.n_head * cfg.head_dim
    layers = [{
        "attention": {"wqkv": r.w((qkv_dim, cfg.dim)),
                      "wo": r.w((cfg.dim, cfg.n_head * cfg.head_dim))},
        "feed_forward": {"w1": r.w((cfg.intermediate_size, cfg.dim)),
                         "w2": r.w((cfg.dim, cfg.intermediate_size)),
                         "w3": r.w((cfg.intermediate_size, cfg.dim))},
        "attention_norm": r.full((cfg.dim,), 1),
        "ffn_norm": r.full((cfg.dim,), 1),
        "attention_ls": r.full((cfg.dim,), 1e-2),
        "ffn_ls": r.full((cfg.dim,), 1e-2),
    } for _ in range(cfg.n_layer)]
    p = {"layers": layers, "norm": r.full((cfg.dim,), 1)}
    if input_dim is not None and input_dim != cfg.dim:
        p["input_proj_w"] = r.w((cfg.dim, input_dim))
        p["input_proj_b"] = r.full((cfg.dim,), 0)
        p["output_proj_w"] = r.w((input_dim, cfg.dim))
        p["output_proj_b"] = r.full((input_dim,), 0)
    return p


def _res_unit_p(r: _Init, dim: int) -> dict:
    return {
        "snake1_alpha": r.full((dim,), 1),
        "conv1_w": r.w((7, dim, dim)), "conv1_b": r.full((dim,), 0),
        "snake2_alpha": r.full((dim,), 1),
        "conv2_w": r.w((1, dim, dim)), "conv2_b": r.full((dim,), 0),
    }


def init_quantizer(r: _Init, cfg: RVQConfig) -> dict:
    d, cd = cfg.input_dim, cfg.codebook_dim
    params = {
        "semantic_codebooks": r.w((1, cfg.semantic_codebook_size, cd), 1.0),
        "semantic_out_w": r.w((1, cd, d)),
        "semantic_out_b": r.full((1, d), 0),
        "residual_codebooks": r.w((cfg.n_codebooks, cfg.codebook_size, cd),
                                  1.0),
        "residual_out_w": r.w((cfg.n_codebooks, cd, d)),
        "residual_out_b": r.full((cfg.n_codebooks, d), 0),
        "upsample": [],
    }
    for factor in cfg.downsample_factor:
        params["upsample"].append({"conv_w": r.w((factor, d, d)),
                                   "conv_b": r.full((d,), 0),
                                   "convnext": _convnext_p(r, d)})
    params["post_module"] = _transformer_p(r, cfg.pre_post_transformer,
                                           cfg.input_dim)
    return params


def init_quantizer_encode(r: _Init, cfg: RVQConfig) -> dict:
    """The quantizer's encode side: the codebooks' input projections, the
    downsample stages and the pre-module transformer."""
    d, cd = cfg.input_dim, cfg.codebook_dim
    return {
        "semantic_in_w": r.w((1, d, cd)),
        "semantic_in_b": r.full((1, cd), 0),
        "residual_in_w": r.w((cfg.n_codebooks, d, cd)),
        "residual_in_b": r.full((cfg.n_codebooks, cd), 0),
        "downsample": [{"conv_w": r.w((factor, d, d)),
                        "conv_b": r.full((d,), 0),
                        "convnext": _convnext_p(r, d)}
                       for factor in cfg.downsample_factor],
        "pre_module": _transformer_p(r, cfg.pre_post_transformer,
                                     cfg.input_dim),
    }


def init_encoder(r: _Init, cfg: DACConfig) -> dict:
    params = {"conv_in_w": r.w((7, 1, cfg.encoder_dim)),
              "conv_in_b": r.full((cfg.encoder_dim,), 0), "blocks": []}
    dim = cfg.encoder_dim
    for stride, n_t in zip(cfg.encoder_rates, cfg.encoder_transformer_layers):
        dim *= 2
        block = {
            "res_units": [_res_unit_p(r, dim // 2) for _ in range(3)],
            "snake_alpha": r.full((dim // 2,), 1),
            "conv_w": r.w((2 * stride, dim // 2, dim)),
            "conv_b": r.full((dim,), 0),
        }
        if n_t > 0:
            block["transformer"] = _transformer_p(
                r, cfg.encoder_block_transformer(dim, n_t))
        params["blocks"].append(block)
    params["snake_alpha"] = r.full((dim,), 1)
    params["conv_out_w"] = r.w((3, dim, cfg.resolved_latent_dim))
    params["conv_out_b"] = r.full((cfg.resolved_latent_dim,), 0)
    return params


def init_decoder(r: _Init, cfg: DACConfig) -> dict:
    params = {"conv_in_w": r.w((7, cfg.resolved_latent_dim, cfg.decoder_dim)),
              "conv_in_b": r.full((cfg.decoder_dim,), 0), "blocks": []}
    dim = cfg.decoder_dim
    for i, stride in enumerate(cfg.decoder_rates):
        in_dim = cfg.decoder_dim // (2 ** i)
        out_dim = cfg.decoder_dim // (2 ** (i + 1))
        params["blocks"].append({
            "snake_alpha": r.full((in_dim,), 1),
            "conv_w": r.w((2 * stride, in_dim, out_dim)),
            "conv_b": r.full((out_dim,), 0),
            "res_units": [_res_unit_p(r, out_dim) for _ in range(3)],
        })
        dim = out_dim
    params["snake_alpha"] = r.full((dim,), 1)
    params["conv_out_w"] = r.w((7, dim, 1))
    params["conv_out_b"] = r.full((1,), 0)
    return params


def init_dac_params(gen: torch.Generator, cfg: DACConfig,
                    device=None) -> dict:
    """Truncated-normal random codec parameters (f32), drawn from `gen` on
    `device` (CUDA by default): the decode side first, then the encoder and
    the quantizer's encode side."""
    r = _Init(gen, resolve_device(device))
    quantizer = init_quantizer(r, cfg.rvq)
    decoder = init_decoder(r, cfg)
    encoder = init_encoder(r, cfg)
    quantizer.update(init_quantizer_encode(r, cfg.rvq))
    return {"encoder": encoder, "quantizer": quantizer, "decoder": decoder}


def codec_params_from_jax(tree, device=None):
    """The JAX codec parameter tree with numpy leaves
    (`jax.tree.map(np.asarray, params)`) as the port's tree."""
    device = resolve_device(device)

    def visit(x):
        if isinstance(x, dict):
            return {k: visit(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [visit(v) for v in x]
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return visit(tree)
