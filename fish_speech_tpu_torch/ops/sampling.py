"""Top-k / top-p / temperature sampling and RAS (repetition-aware sampling).

Counterpart of `fish_speech_tpu/ops/sampling.py`: one logsumexp over the
support gives the full-softmax denominator, `topk` extracts the only
candidates the joint top-p/top-k mask can keep, and a Gumbel-max draw
(argmax of probs / -log u) picks among them.

JAX draws its uniforms from `jax.random`; here they come from a
`torch.Generator`, or the caller passes them in (`u`), so a test can feed
both sides the same numbers.
"""

from __future__ import annotations

import torch

RAS_WIN_SIZE = 10
RAS_HIGH_TEMP = 1.0
RAS_HIGH_TOP_P = 0.9

_TINY = torch.finfo(torch.float32).tiny


def _on_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """x as a tensor on `device`. A Python number becomes a fill there: a
    copy from the host's pageable memory would wait for the stream, the
    host idle until the device has run all it was given."""
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def _per_row(x, ref: torch.Tensor) -> torch.Tensor:
    """A sampling parameter (scalar or per-row (B,)) broadcastable over
    (B, k)."""
    x = _on_device(x, torch.float32, ref.device)
    return x[:, None] if x.ndim == 1 else x


def uniforms(gen: torch.Generator | None, shape, device) -> torch.Tensor:
    """U(tiny, 1) draws, the range `jax.random.uniform` samples here."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u.clamp_min(_TINY)


def _mask_topk_rows(vals: torch.Tensor, top_k_row) -> torch.Tensor:
    """Per-row top-k inside a static roof: `vals` is the (B, roof)
    descending candidate matrix; candidates at positions >= k_row become
    -inf, which is what extracting topk(logits, k_row) would have kept
    (later candidates never reach the kept prefix's cumsum). top_k_row:
    None (no-op), a scalar or a (B,) int."""
    if top_k_row is None:
        return vals
    k = _on_device(top_k_row, torch.int32, vals.device)
    pos = torch.arange(vals.shape[-1], dtype=torch.int32, device=vals.device)
    keep = pos[None, :] < (k[:, None] if k.ndim == 1 else k)
    return torch.where(keep, vals, _on_device(-torch.inf, torch.float32,
                                              vals.device))


def _candidates(logits: torch.Tensor, top_k: int, top_k_row=None):
    logits = logits.float()
    z = torch.logsumexp(logits, dim=-1, keepdim=True)
    vals, idx = torch.topk(logits, top_k, dim=-1)
    vals = _mask_topk_rows(vals, top_k_row)
    return vals, idx, torch.cumsum(torch.exp(vals - z), dim=-1)


def _draw(vals, idx, cum, temperature, top_p, u) -> torch.Tensor:
    remove = cum > _per_row(top_p, vals)
    remove[:, 0] = False                                   # keep the top-1
    cand = torch.where(remove, _on_device(-torch.inf, torch.float32,
                                          vals.device), vals)
    cand = cand / _per_row(temperature, vals).clamp_min(1e-5)
    probs = torch.softmax(cand, dim=-1)
    choice = torch.argmax(probs / -torch.log(u), dim=-1)
    return torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)


def sample_one(logits: torch.Tensor, temperature, top_p, top_k: int,
               top_k_row=None, *, gen: torch.Generator | None = None,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """One token per row. logits (B, V); temperature/top_p scalar or (B,);
    top_k: the static candidate roof, top_k_row: None or each row's k
    within it (scalar or (B,)). u: optional (B, top_k) uniforms; drawn from
    `gen` otherwise."""
    vals, idx, cum = _candidates(logits, top_k, top_k_row)
    if u is None:
        u = uniforms(gen, vals.shape, vals.device)
    return _draw(vals, idx, cum, temperature, top_p, u)


def greedy_one(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_main_and_high(logits: torch.Tensor, temperature, top_p,
                         top_k: int, top_k_row=None, *,
                         gen: torch.Generator | None = None,
                         u: torch.Tensor | None = None):
    """The normal-parameter draw and the RAS high-temperature fallback from
    ONE candidate pass (top_k_row as in `sample_one`). u: optional (2, B,
    top_k) uniforms (normal, high)."""
    vals, idx, cum = _candidates(logits, top_k, top_k_row)
    if u is None:
        u = uniforms(gen, (2, *vals.shape), vals.device)
    return (_draw(vals, idx, cum, temperature, top_p, u[0]),
            _draw(vals, idx, cum, RAS_HIGH_TEMP, RAS_HIGH_TOP_P, u[1]))


def sampling_probs(logits: torch.Tensor, temperature, top_p,
                   top_k: int) -> torch.Tensor:
    """(B, V) probabilities this sampler draws from: the candidates'
    probabilities scattered back over the vocabulary, zero elsewhere."""
    vals, idx, cum = _candidates(logits, top_k)
    remove = cum > _per_row(top_p, vals)
    remove[:, 0] = False
    cand = torch.where(remove, _on_device(-torch.inf, torch.float32,
                                          vals.device), vals)
    probs = torch.softmax(cand / _per_row(temperature, vals).clamp_min(1e-5),
                          dim=-1)
    return torch.zeros_like(logits, dtype=torch.float32).scatter(1, idx,
                                                                 probs)


def sample_token(logits: torch.Tensor, temperature, top_p, top_k: int = 30,
                 greedy: bool = False, *, gen: torch.Generator | None = None,
                 u: torch.Tensor | None = None) -> torch.Tensor:
    if greedy:
        return greedy_one(logits)
    return sample_one(logits, temperature, top_p, top_k, gen=gen, u=u)


def ras_select(token_normal: torch.Tensor, token_high: torch.Tensor,
               prev_window: torch.Tensor, semantic_begin: int,
               semantic_end: int) -> torch.Tensor:
    """Use the high-temperature draw iff the normal one is a semantic token
    already in the window of recent tokens. Branch-free, on the device."""
    in_window = (prev_window == token_normal[:, None]).any(dim=-1)
    is_sem = (token_normal >= semantic_begin) & (token_normal <= semantic_end)
    return torch.where(in_window & is_sem, token_high, token_normal)


def push_window(prev_window: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Roll the RAS window left and insert `token` at the end."""
    return torch.cat([prev_window[:, 1:], token[:, None].to(prev_window.dtype)],
                     dim=-1)


def semantic_logit_bias(vocab_size: int, semantic_begin: int,
                        semantic_end: int, im_end_id: int,
                        device=None) -> torch.Tensor:
    """(V,) additive bias: 0 inside the semantic range and at im_end, -inf
    elsewhere (constrained decoding)."""
    bias = torch.full((vocab_size,), -torch.inf, dtype=torch.float32)
    bias[semantic_begin:semantic_end + 1] = 0.0
    bias[im_end_id] = 0.0
    return bias.to(device)
