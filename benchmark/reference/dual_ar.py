"""Plain float32 reference of the S2-Pro Dual-AR decoder, without a cache.

A frozen copy written for the benchmark: it imports nothing of the program.
The text-to-codes model of Fish Audio's S2-Pro (a Qwen3-4B-shaped slow
stack over the prompt and the emitted frames, then a small "fast" stack
that emits the frame's residual codebooks one after another), computed in
float32 with TF32 off, over the whole sequence at once with a causal mask.

It takes the benchmark's own bf16 draws (the parameter tree's keys and
layouts: layers stacked on a leading axis) and quantizes them itself, as
the configuration states (`Precision`): the slow stack's products with
int8 per-channel or int4 groupwise weights and per-row int8 activations,
the fast stack's and the codebook head's int8 per channel with int8
activations, the embedding tables int8 per row (a weight-only product for
the token logits), both stacks' keys and values rounded through an int8
cache row. Departures from the serving program, all toward exactness: no
bf16 activations, an f32 RoPE table, and the decode step's queries are not
quantized for the score product.

`forward` gives, for each served frame of each sequence, the slow stack's
logits over the semantic support and the fast head's logits for
codebooks 1..K-1, teacher-forced on the served frames.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import quant


@dataclass(frozen=True)
class Precision:
    """The slow stack's products; the fast stack, the heads and the
    embeddings are int8, and both caches int8 rows, in every
    configuration."""
    slow_weights: str = "int8"    # "int8" or "int4_g<group>"
    slow_act_bits: int = 8        # per-row activation bits

    def replace(self, **kw) -> "Precision":
        return Precision(**{**self.__dict__, **kw})


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) \
        * w.float()


def rope_table(n_pos: int, dim: int, base: float, device) -> torch.Tensor:
    """(n_pos, dim/2, 2) (cos, sin), angles in float64."""
    freqs = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                         device=device) / dim))
    ang = torch.arange(n_pos, dtype=torch.float64, device=device)[:, None] \
        * freqs[None]
    return torch.stack([ang.cos(), ang.sin()], dim=-1).float()


def rope(x: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """x (..., T, H, D) on interleaved (real, imag) pairs; tab (T, D/2, 2)."""
    xp = x.reshape(*x.shape[:-1], -1, 2)
    c, s = tab[:, None, :, 0], tab[:, None, :, 1]
    re = xp[..., 0] * c - xp[..., 1] * s
    im = xp[..., 1] * c + xp[..., 0] * s
    return torch.stack([re, im], dim=-1).reshape(x.shape)


def _attention(q, k, v, mask):
    """q (B, T, H, D), k/v (B, S, Hkv, D), mask (T, S) -> (B, T, H*D)."""
    b, t, h, d = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(d)
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhts,bshd->bthd", s.softmax(-1), v).reshape(b, t,
                                                                     h * d)


def _layer(p: dict, x: torch.Tensor, dims: dict, tab: torch.Tensor,
           mask: torch.Tensor, wkind: str, abits: int,
           kv_bf16_scale: bool, eps: float) -> torch.Tensor:
    """One pre-norm transformer layer of either stack. x (B, T, D)."""
    b, t, _ = x.shape
    h, hkv, hd = dims["n_head"], dims["n_kv"], dims["head_dim"]
    a, f = p["attention"], p["feed_forward"]

    def mm(inp, wt):
        return quant.rows(inp, abits) @ quant.weight(wt, wkind).T

    qkv = mm(rms(x, p["attention_norm"], eps), a["wqkv"])
    q, k, v = qkv.split([h * hd, hkv * hd, hkv * hd], dim=-1)
    q, k, v = (q.reshape(b, t, h, hd), k.reshape(b, t, hkv, hd),
               v.reshape(b, t, hkv, hd))
    if "q_norm" in a:
        q = rms(q, a["q_norm"], 1e-5)
        k = rms(k, a["k_norm"], 1e-5)
    q, k = rope(q, tab), rope(k, tab)
    if kv_bf16_scale:    # one scale a row over all heads
        k = quant.cache_rows(k.reshape(b, t, -1), True).reshape(k.shape)
        v = quant.cache_rows(v.reshape(b, t, -1), True).reshape(v.shape)
    else:                # one scale a row and head
        k, v = quant.cache_rows(k), quant.cache_rows(v)
    x = x + mm(_attention(q, k, v, mask), a["wo"])
    hn = rms(x, p["ffn_norm"], eps)
    gate = torch.nn.functional.silu(mm(hn, f["w1"])) * mm(hn, f["w3"])
    return x + mm(gate, f["w2"])


def _layers(tree: dict, i: int) -> dict:
    return {k: (_layers(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def embed(w: dict, shape: dict, cols: torch.Tensor) -> torch.Tensor:
    """(K+1, T) token columns -> (T, D): the token's embedding plus, on a
    semantic token, its codebooks' embeddings, scaled by 1/sqrt(K+1)."""
    k, cb = shape["num_codebooks"], shape["codebook_size"]
    tok = cols[0].long()
    codes = cols[1:].long() + cb * torch.arange(k, device=cols.device)[:, None]
    emb = quant.weight_int8(w["embeddings"][tok])
    vq = quant.weight_int8(w["codebook_embeddings"][codes.reshape(-1)]
                           ).reshape(k, -1, emb.shape[-1]).sum(0)
    sem = ((tok >= shape["semantic_begin_id"])
           & (tok <= shape["semantic_end_id"]))[:, None]
    x = emb + torch.where(sem, vq, torch.zeros_like(vq))
    return torch.where(sem, x / math.sqrt(k + 1), x)


@torch.no_grad()
def forward(w: dict, shape: dict, seqs: list[tuple[torch.Tensor, int]],
            prec: Precision = Precision()):
    """seqs: (columns (K+1, T_p + n) int: the prompt then the n served
    frames, T_p). Returns per sequence (slow (n, n_sem + 1) logits over the
    semantic ids and im_end, fast (n, K-1, codebook_size) logits of
    codebooks 1..K-1), each frame teacher-forced on the served ones."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(w, shape, seqs, prec)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _forward(w, shape, seqs, prec):
    dev = w["norm"].device
    eps = shape["norm_eps"]
    k = shape["num_codebooks"]
    slow_dims = dict(n_head=shape["n_head"], n_kv=shape["n_local_heads"],
                     head_dim=shape["head_dim"])
    fast_dims = dict(n_head=shape["fast_n_head"],
                     n_kv=shape["fast_n_local_heads"],
                     head_dim=shape["fast_head_dim"])
    xs, tabs, masks = [], [], []
    for cols, t_p in seqs:
        inp = cols[:, :-1].to(dev)             # the last frame is no input
        t = inp.shape[1]
        xs.append(embed(w, shape, inp)[None])
        tabs.append(rope_table(t, shape["head_dim"], shape["rope_base"], dev))
        masks.append(torch.ones(t, t, dtype=torch.bool, device=dev).tril())
    for i in range(shape["n_layer"]):
        p = _layers(w["layers"], i)
        xs = [_layer(p, x, slow_dims, tab, m, prec.slow_weights,
                     prec.slow_act_bits, False, eps)
              for x, tab, m in zip(xs, tabs, masks)]
    sb, se = shape["semantic_begin_id"], shape["semantic_end_id"]
    support = torch.cat([torch.arange(sb, se + 1, device=dev),
                         torch.tensor([shape["im_end_id"]], device=dev)])
    head = quant.weight_int8(w["embeddings"][support])
    fe = quant.weight_int8(w["fast_embeddings"])
    out_w = quant.weight_int8(w["fast_output"])
    pin = w["fast_project_in"]
    ftab = rope_table(k, shape["fast_head_dim"], shape["rope_base"], dev)
    fmask = torch.ones(k, k, dtype=torch.bool, device=dev).tril()
    fins, slows = [], []
    for x, (cols, t_p) in zip(xs, seqs):
        h = rms(x[0, t_p - 1:], w["norm"], eps)            # (n, D)
        slows.append(h @ head.T)
        served = cols[1:, t_p:].long().to(dev)             # (K, n) codes
        first = h @ pin["w"].float().T + pin["b"].float()
        fins.append(torch.cat([first[:, None], fe[served[:-1].T]], dim=1))
    lens = [f.shape[0] for f in fins]
    fx = torch.cat(fins)                                   # (sum n, K, Df)
    for i in range(shape["n_fast_layer"]):
        fx = _layer(_layers(w["fast_layers"], i), fx, fast_dims, ftab, fmask,
                    "int8", 8, True, eps)
    fx = quant.rows(rms(fx[:, 1:], w["fast_norm"], eps))
    fast = (fx @ out_w.T).split(lens)
    return list(zip(slows, fast))


def served_gaps(logits, cols: torch.Tensor, t_p: int,
                shape: dict) -> torch.Tensor:
    """(n, K) gaps by which each served token's logit lies below the best
    one: column 0 the slow stack's token (over the semantic ids and
    im_end), 1..K-1 the fast head's codes."""
    slow, fast = logits
    served = cols[:, t_p:].long().to(slow.device)          # (K+1, n)
    tok = served[0]
    sb, se = shape["semantic_begin_id"], shape["semantic_end_id"]
    idx = torch.where(tok == shape["im_end_id"], se - sb + 1, tok - sb)
    g0 = slow.amax(-1) - slow.gather(1, idx[:, None])[:, 0]
    codes = served[2:].T                                   # (n, K-1)
    gf = fast.amax(-1) - fast.gather(2, codes[..., None])[..., 0]
    return torch.cat([g0[:, None], gf], dim=1)


def argmax_gaps(logits, control) -> torch.Tensor:
    """(n, K) gaps, in `logits`, of the tokens that `control` (another
    precision's logits at the same positions) puts first."""
    slow, fast = logits
    cs, cf = control
    g0 = slow.amax(-1) - slow.gather(1, cs.argmax(-1)[:, None])[:, 0]
    gf = fast.amax(-1) - fast.gather(2, cf.argmax(-1)[..., None])[..., 0]
    return torch.cat([g0[:, None], gf], dim=1)
