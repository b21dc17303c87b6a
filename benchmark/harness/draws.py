"""The benchmark's own seeded weights, drawn on the device.

A normal draw on a generator seeded from `--seed`, in calls of 2^30
elements, fills a flat buffer for the language model (bf16, the type it is served from before the
program quantizes it) and one for the codec's decode side (float32), and
every leaf is a view of its buffer: the same seed gives the same weights
on every run, in a second of device time. Matrices are N(0, 0.02^2),
embedding codebooks N(0, 1), norm weights and snake slopes 1 + N(0, 0.1^2),
biases N(0, 0.02^2), LayerScale factors constant. The layouts are the
parameter trees the program reads (layers stacked on a leading axis).
"""

from __future__ import annotations

import torch

STD = 0.02

# elements a normal draw fills at once (the LM's ~4.5e9 in five calls)
CHUNK = 2 ** 30

# leaf kinds: "w" N(0, STD), "unit" 1 + N(0, 0.1), "bias" N(0, STD),
# "code" N(0, 1), ("const", v)
_SCALE = {"w": STD, "unit": 0.1, "bias": STD, "code": 1.0}


def lm_shapes(s: dict) -> dict:
    """{leaf: (shape, kind)} of the Dual-AR tree for the sizes `s`."""
    def stack(n, dim, heads, kv, hd, inter, qk_norm):
        att = {"wqkv": ((n, (heads + 2 * kv) * hd, dim), "w"),
               "wo": ((n, dim, heads * hd), "w")}
        if qk_norm:
            att["q_norm"] = ((n, hd), "unit")
            att["k_norm"] = ((n, hd), "unit")
        return {"attention": att,
                "feed_forward": {"w1": ((n, inter, dim), "w"),
                                 "w2": ((n, dim, inter), "w"),
                                 "w3": ((n, inter, dim), "w")},
                "attention_norm": ((n, dim), "unit"),
                "ffn_norm": ((n, dim), "unit")}

    d, fd, cb = s["dim"], s["fast_dim"], s["codebook_size"]
    return {
        "embeddings": ((s["vocab_size"], d), "w"),
        "codebook_embeddings": ((cb * s["num_codebooks"], d), "w"),
        "layers": stack(s["n_layer"], d, s["n_head"], s["n_local_heads"],
                        s["head_dim"], s["intermediate_size"],
                        s["attention_qk_norm"]),
        "norm": ((d,), "unit"),
        "fast_embeddings": ((cb, fd), "w"),
        "fast_layers": stack(s["n_fast_layer"], fd, s["fast_n_head"],
                             s["fast_n_local_heads"], s["fast_head_dim"],
                             s["fast_intermediate_size"], False),
        "fast_norm": ((fd,), "unit"),
        "fast_output": ((cb, fd), "w"),
        "fast_project_in": {"w": ((fd, d), "w"), "b": ((fd,), "bias")},
    }


def codec_shapes(c: dict) -> dict:
    """{leaf: (shape, kind)} of the codec's decode side (the quantizer's
    lookup, post transformer and upsampling; the decoder)."""
    d, cd = c["input_dim"], c["codebook_dim"]
    t = c["post_transformer"]

    def convnext(dim):
        return {"dwconv_w": ((7, 1, dim), "w"), "dwconv_b": ((dim,), "bias"),
                "norm_w": ((dim,), "unit"), "norm_b": ((dim,), "bias"),
                "pw1_w": ((dim, 4 * dim), "w"), "pw1_b": ((4 * dim,), "bias"),
                "pw2_w": ((4 * dim, dim), "w"), "pw2_b": ((dim,), "bias"),
                "gamma": ((dim,), ("const", 1e-6))}

    tdim, hq = t["dim"], t["n_head"] * t["head_dim"]
    post = {"layers": [{
        "attention": {"wqkv": ((3 * hq, tdim), "w"), "wo": ((tdim, hq), "w")},
        "feed_forward": {"w1": ((t["intermediate_size"], tdim), "w"),
                         "w2": ((tdim, t["intermediate_size"]), "w"),
                         "w3": ((t["intermediate_size"], tdim), "w")},
        "attention_norm": ((tdim,), "unit"), "ffn_norm": ((tdim,), "unit"),
        "attention_ls": ((tdim,), ("const", 1e-2)),
        "ffn_ls": ((tdim,), ("const", 1e-2)),
    } for _ in range(t["n_layer"])], "norm": ((tdim,), "unit")}
    n_res = c["n_codebooks"]
    quantizer = {
        "semantic_codebooks": ((1, c["semantic_codebook_size"], cd), "code"),
        "semantic_out_w": ((1, cd, d), "w"),
        "semantic_out_b": ((1, d), "bias"),
        "residual_codebooks": ((n_res, c["codebook_size"], cd), "code"),
        "residual_out_w": ((n_res, cd, d), "w"),
        "residual_out_b": ((n_res, d), "bias"),
        "upsample": [{"conv_w": ((f, d, d), "w"), "conv_b": ((d,), "bias"),
                      "convnext": convnext(d)}
                     for f in c["downsample"]],
        "post_module": post,
    }
    blocks = []
    dim = c["decoder_dim"]
    for stride in c["decoder_rates"]:
        out = dim // 2
        unit = {"snake1_alpha": ((out,), "unit"),
                "conv1_w": ((7, out, out), "w"), "conv1_b": ((out,), "bias"),
                "snake2_alpha": ((out,), "unit"),
                "conv2_w": ((1, out, out), "w"), "conv2_b": ((out,), "bias")}
        blocks.append({"snake_alpha": ((dim,), "unit"),
                       "conv_w": ((2 * stride, dim, out), "w"),
                       "conv_b": ((out,), "bias"),
                       "res_units": [dict(unit) for _ in range(3)]})
        dim = out
    decoder = {"conv_in_w": ((7, c["latent_dim"], c["decoder_dim"]), "w"),
               "conv_in_b": ((c["decoder_dim"],), "bias"), "blocks": blocks,
               "snake_alpha": ((dim,), "unit"),
               "conv_out_w": ((7, dim, 1), "w"), "conv_out_b": ((1,), "bias")}
    return {"quantizer": quantizer, "decoder": decoder}


def _leaves(tree, out: list):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _numel(shape) -> int:
    n = 1
    for x in shape:
        n *= x
    return n


def fill(shapes, gen: torch.Generator, dtype, device):
    """The tree of `shapes` with every random leaf a view of one flat
    normal draw."""
    total = sum(_numel(sh) for sh, kind in _leaves(shapes, [])
                if not isinstance(kind, tuple))
    flat = torch.empty(total, dtype=dtype, device=device)
    for a in range(0, total, CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    at = 0

    def build(tree):
        nonlocal at
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v) for v in tree]
        shape, kind = tree
        if isinstance(kind, tuple):
            return torch.full(shape, kind[1], dtype=dtype, device=device)
        n = _numel(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        leaf.mul_(_SCALE[kind])
        if kind == "unit":
            leaf.add_(1.0)
        return leaf

    return build(shapes)


def draw(seed: int, lm: dict, codec: dict, device):
    """(Dual-AR bf16 tree, codec decode-side f32 tree) from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = fill(lm_shapes(lm), gen, torch.bfloat16, device)
    codec_params = fill(codec_shapes(codec), gen, torch.float32, device)
    return params, codec_params
