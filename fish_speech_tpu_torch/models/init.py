"""Random init for the Dual-AR transformer, the conversion of a reference
(torch) state dict, and the weight carry from the JAX package's parameter
tree.

Counterpart of `fish_speech_tpu/models/init.py`. Parameters are nested dicts
of tensors with the same keys and layouts as the JAX pytree: per-layer
tensors are stacked along a leading depth axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant import pack_int4_params
from ..utils.checkpoint import sd_tensor
from .config import AttnDims, DualARConfig


def _normal(gen: torch.Generator, shape, std: float, dtype,
            device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def _init_stack(gen, ad: AttnDims, n_layer: int, inter: int, std: float,
                dtype, device) -> dict:
    qkv_dim = (ad.n_head + 2 * ad.n_local_heads) * ad.head_dim

    def w(shape):
        return _normal(gen, (n_layer, *shape), std, dtype, device)

    def full(shape, value):
        return torch.full((n_layer, *shape), value, dtype=dtype, device=device)

    layers = {
        "attention": {
            "wqkv": w((qkv_dim, ad.dim)),
            "wo": w((ad.dim, ad.n_head * ad.head_dim)),
        },
        "feed_forward": {
            "w1": w((inter, ad.dim)),
            "w2": w((ad.dim, inter)),
            "w3": w((inter, ad.dim)),
        },
        "attention_norm": full((ad.dim,), 1.0),
        "ffn_norm": full((ad.dim,), 1.0),
    }
    if ad.qkv_bias:
        layers["attention"]["wqkv_b"] = full((qkv_dim,), 0.0)
    if ad.o_bias:
        layers["attention"]["wo_b"] = full((ad.dim,), 0.0)
    if ad.qk_norm:
        layers["attention"]["q_norm"] = full((ad.head_dim,), 1.0)
        layers["attention"]["k_norm"] = full((ad.head_dim,), 1.0)
    return layers


def init_dual_ar_params(gen: torch.Generator, cfg: DualARConfig,
                        dtype=torch.float32, device=None) -> dict:
    """Truncated-normal (std = cfg.initializer_range) random parameters,
    drawn from `gen` directly on `device` (CUDA by default)."""
    device = resolve_device(device)
    std = cfg.initializer_range

    def w(shape):
        return _normal(gen, shape, std, dtype, device)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    params = {
        "embeddings": w((cfg.vocab_size, cfg.dim)),
        "codebook_embeddings": w((cfg.codebook_size * cfg.num_codebooks,
                                  cfg.dim)),
        "layers": _init_stack(gen, cfg.slow_attn, cfg.n_layer,
                              cfg.intermediate_size, std, dtype, device),
        "norm": ones(cfg.dim),
    }
    if cfg.is_naive:
        # the parallel codebook head: all K codebooks from the slow stack
        params["codebook_norm"] = ones(cfg.dim)
        params["codebook_output"] = w((cfg.codebook_size * cfg.num_codebooks,
                                       cfg.dim))
    else:
        params.update({
            "fast_embeddings": w((cfg.codebook_size, cfg.fast_dim)),
            "fast_layers": _init_stack(gen, cfg.fast_attn, cfg.n_fast_layer,
                                       cfg.fast_intermediate_size, std,
                                       dtype, device),
            "fast_norm": ones(cfg.fast_dim),
            "fast_output": w((cfg.codebook_size, cfg.fast_dim)),
        })
    if not cfg.tie_word_embeddings:
        params["output"] = w((cfg.vocab_size, cfg.dim))
    if cfg.fast_dim != cfg.dim and not cfg.is_naive:
        params["fast_project_in"] = {
            "w": w((cfg.fast_dim, cfg.dim)),
            "b": torch.zeros(cfg.fast_dim, dtype=dtype, device=device),
        }
    return params


def _convert_stack(sd: dict, prefix: str, n_layer: int, ad: AttnDims, dtype,
                   device) -> dict:
    """Per-layer tensors `prefix.{i}.*` stacked on a leading depth axis.
    Each stack is allocated on `device` and filled a layer at a time, so a
    layer is read from its (mapped) file once, straight into its slot."""
    def stack(fmt):
        first = sd[fmt.format(i=0)]
        out = torch.empty((n_layer, *first.shape), dtype=dtype, device=device)
        for i in range(n_layer):
            out[i].copy_(sd_tensor(sd[fmt.format(i=i)]))
        return out

    layers = {
        "attention": {
            "wqkv": stack(prefix + ".{i}.attention.wqkv.weight"),
            "wo": stack(prefix + ".{i}.attention.wo.weight"),
        },
        "feed_forward": {
            "w1": stack(prefix + ".{i}.feed_forward.w1.weight"),
            "w2": stack(prefix + ".{i}.feed_forward.w2.weight"),
            "w3": stack(prefix + ".{i}.feed_forward.w3.weight"),
        },
        "attention_norm": stack(prefix + ".{i}.attention_norm.weight"),
        "ffn_norm": stack(prefix + ".{i}.ffn_norm.weight"),
    }
    if ad.qkv_bias:
        layers["attention"]["wqkv_b"] = stack(prefix + ".{i}.attention.wqkv.bias")
    if ad.o_bias:
        layers["attention"]["wo_b"] = stack(prefix + ".{i}.attention.wo.bias")
    if ad.qk_norm:
        layers["attention"]["q_norm"] = stack(
            prefix + ".{i}.attention.q_norm.weight")
        layers["attention"]["k_norm"] = stack(
            prefix + ".{i}.attention.k_norm.weight")
    return layers


def convert_dual_ar_state_dict(sd: dict, cfg: DualARConfig,
                               dtype=torch.float32, device=None) -> dict:
    """{reference name: tensor or numpy array} -> the port's parameter tree
    in `dtype` on `device` (CUDA unless named): the keys and layouts of
    `init_dual_ar_params`, layers stacked, the optional q/k norms, biases,
    `fast_project_in` and untied output as the state dict has them, and
    the naive head's `codebook_norm` / `codebook_output` for
    `model_type="naive"`.
    Counterpart of the JAX `convert_dual_ar_state_dict`."""
    device = resolve_device(device)

    def one(name):
        return sd_tensor(sd[name]).to(device=device, dtype=dtype)

    params = {
        "embeddings": one("embeddings.weight"),
        "codebook_embeddings": one("codebook_embeddings.weight"),
        "layers": _convert_stack(sd, "layers", cfg.n_layer, cfg.slow_attn,
                                 dtype, device),
        "norm": one("norm.weight"),
    }
    if cfg.is_naive:
        params["codebook_norm"] = one("codebook_norm.weight")
        params["codebook_output"] = one("codebook_output.weight")
    else:
        params.update({
            "fast_embeddings": one("fast_embeddings.weight"),
            "fast_layers": _convert_stack(sd, "fast_layers", cfg.n_fast_layer,
                                          cfg.fast_attn, dtype, device),
            "fast_norm": one("fast_norm.weight"),
            "fast_output": one("fast_output.weight"),
        })
    if not cfg.tie_word_embeddings:
        params["output"] = one("output.weight")
    if "fast_project_in.weight" in sd:
        params["fast_project_in"] = {"w": one("fast_project_in.weight"),
                                     "b": one("fast_project_in.bias")}
    return params


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "int4":
        a = a.astype(np.int8)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16: carry the bit pattern through int16
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def lm_params_from_jax(tree: dict, device=None) -> dict:
    """The JAX Dual-AR parameter tree, with every leaf already a numpy
    array (`jax.tree.map(np.asarray, params)`), as the port's tree: float
    (the naive head's leaves too),
    int8-quantized ({"q", "s"}), packed int4 ({"q4", "gs"}, carried as it
    is) or with the packed fast stack ("fast_packed", see
    ops/fast_fused.py). Layouts are kept, except the packed stack's
    Mosaic-only padding tile and lane-padded scale axis. Native int4
    leaves ({"q" int4, "gs"}, the JAX checkpoint form) are packed on the
    way in, as the JAX `pack_int4_params` does."""
    device = resolve_device(device)

    def visit(keys: tuple, x):
        if isinstance(x, dict):
            if keys == ("fast_packed",):
                return {
                    "w": _to_torch(np.asarray(x["w"])[:, :13], device),
                    "s": _to_torch(np.asarray(x["s"])[:, :13, 0], device),
                    "norms": _to_torch(x["norms"], device),
                }
            return {k: visit(keys + (k,), v) for k, v in x.items()}
        return _to_torch(x, device)

    return pack_int4_params({k: visit((k,), v) for k, v in tree.items()})
