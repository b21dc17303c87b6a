"""Fused fast-head sweep: the whole fast stack at one codebook position.

Counterpart of `fish_speech_tpu/ops/fast_fused.py::fused_fast_sweep`. For
each layer: RMSNorm, per-row int8 quantization, W8A8 q/k/v products, RoPE,
per-(position, row) int8 quantization of k and v written at `pos` into the
(L, K, B, dim) cache, attention over positions [0, pos], W8A8 wo and
residual, RMSNorm, W8A8 w1/w3 with SiLU gating, W8A8 w2 and residual.

Layout differences from the TPU kernel (only Mosaic needed them): the cache
scales are (L, K, B) bf16 instead of broadcast across 128 lanes, the packed
weights hold the 13 real (dim, dim) tiles without the padding tile, and the
batch is not padded to 8. The scales are still rounded to bf16 after the
int8 quantization with the f32 scale, as the TPU kernel does.

`fused_fast_sweep` launches the CUDA sweep (csrc/fast_sweep.cu, one
cooperative launch a sweep) for CUDA tensors and runs
`fused_fast_sweep_plain` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from . import _cuda
from .quant import div_exact, int8_matmul_t, int8_rows

KERNEL = _cuda.Kernel("fast_sweep")
N_TILES = 13     # q, k, v, wo, w1 x3, w3 x3, w2 x3 (column tiles)


@dataclass
class FusedFastCache:
    """Position-major int8 fast KV cache, written in place.

    A cache on the card also holds the CUDA sweep's scratch, made with it:
    the buffers that a sweep, or a CUDA-graph replay of one, writes live as
    long as the cache and serve it alone. As for the cache itself, one
    sweep on it runs at a time."""
    k: torch.Tensor    # (L, K, B, dim) int8
    v: torch.Tensor    # (L, K, B, dim) int8
    ks: torch.Tensor   # (L, K, B) bf16 per-(position, row) scales
    vs: torch.Tensor   # (L, K, B) bf16
    # (x8 (B, 3*dim) int8, xs (B,) f32, buf (B, 3*dim) bf16, hmax (B,) f32)
    scratch: tuple | None = field(init=False, default=None, repr=False,
                                  compare=False)

    def __post_init__(self):
        if self.k.is_cuda:
            _, _, b, dim = self.k.shape
            dev = self.k.device
            self.scratch = (
                torch.empty((b, 3 * dim), dtype=torch.int8, device=dev),
                torch.empty((b,), dtype=torch.float32, device=dev),
                torch.empty((b, 3 * dim), dtype=torch.bfloat16, device=dev),
                torch.empty((b,), dtype=torch.float32, device=dev))

    @staticmethod
    def create(n_layer: int, n_pos: int, batch: int, dim: int,
               device=None) -> "FusedFastCache":
        z = torch.zeros((n_layer, n_pos, batch, dim), dtype=torch.int8,
                        device=device)
        s = torch.zeros((n_layer, n_pos, batch), dtype=torch.bfloat16,
                        device=device)
        return FusedFastCache(z, z.clone(), s, s.clone())


def pack_fast_stack(fast_layers: dict) -> dict:
    """Int8-quantized fast-layer weights as the sweep's tiles:
    {"w": (L, 13, dim, dim) int8, "s": (L, 13, dim) f32,
     "norms": (L, 2, dim) bf16}. Needs the "3x" layer family
    (n_head * head_dim == dim, intermediate == 3 * dim)."""
    att, ffn = fast_layers["attention"], fast_layers["feed_forward"]
    wqkv, wo = att["wqkv"], att["wo"]
    w1, w2, w3 = ffn["w1"], ffn["w2"], ffn["w3"]
    n_layer, qkv_rows, dim = wqkv["q"].shape
    if qkv_rows != 3 * dim or w1["q"].shape[1] != 3 * dim:
        raise ValueError("fused fast head needs the 3x layer family")

    def rows3(wq):
        return wq.reshape(n_layer, 3, dim, dim)

    w = torch.cat([
        rows3(wqkv["q"]), wo["q"][:, None], rows3(w1["q"]), rows3(w3["q"]),
        w2["q"].reshape(n_layer, dim, 3, dim).transpose(1, 2),  # column tiles
    ], dim=1).contiguous()
    s = torch.cat([
        wqkv["s"].reshape(n_layer, 3, dim), wo["s"][:, None],
        w1["s"].reshape(n_layer, 3, dim), w3["s"].reshape(n_layer, 3, dim),
        w2["s"][:, None].expand(n_layer, 3, dim),
    ], dim=1).float().contiguous()
    norms = torch.stack([fast_layers["attention_norm"],
                         fast_layers["ffn_norm"]], dim=1).to(torch.bfloat16)
    return {"w": w, "s": s, "norms": norms.contiguous()}


def enable_fused_fast_head(params: dict) -> dict:
    """Serving transform: replace `fast_layers` by the packed sweep form.
    Needs int8-quantized parameters (quantize_lm_params)."""
    out = dict(params)
    out["fast_packed"] = pack_fast_stack(out.pop("fast_layers"))
    return out


def rope_rows(freqs_table: torch.Tensor, pos: int, n_head: int):
    """Full-width (cos, sin) f32 rows for RoPE on a flat (B, dim) row:
    pair i's values on lanes 2i and 2i+1, tiled across heads."""
    cs = freqs_table[pos].float()                       # (D/2, 2)
    cos = cs[:, 0].repeat_interleave(2).repeat(n_head)
    sin = cs[:, 1].repeat_interleave(2).repeat(n_head)
    return cos, sin


# --- the CUDA sweep's grid ------------------------------------------------
# One cooperative launch: a grid of every co-resident CTA (the SM count x
# CTAs an SM) walks the layers, with grid-wide barriers between phases.

SMALL_B = 8   # batches up to this stream the weights one warp a column
# warps of a CTA: 256 threads. They also fix the plain twin's sum order
# (`_mean_sq`, `_head_sums`); `fast_sweep_threads` reads the built kernel's
# count, and a card test holds the two equal
WARPS = 8
THREADS = 32 * WARPS
TILE = 64     # above SMALL_B: the tensor-core tile (rows, columns, K bytes)


def k_split(n_cols: int, nseg: int, kseg: int, grid: int) -> int:
    """K parts a segment for a product at B <= SMALL_B whose n_cols columns
    are dealt to the CTAs (column n to CTA n % grid) and whose (column,
    segment, part) items go to a CTA's warps: the most parts (a power of
    2) whose items still fit the CTA's warps, each part whole 16-byte
    loads."""
    cols = -(-n_cols // grid)
    ks = 1
    while cols * nseg * ks * 2 <= WARPS and kseg % (16 * ks * 2) == 0:
        ks *= 2
    return ks


def sweep_plan(b: int, dim: int, n_layer: int, n_sm: int,
               ctas_per_sm: int) -> dict:
    """The kernel's grid, its phases and barriers, and the K splits of wo
    and w2 at batch b on a card of n_sm SMs holding ctas_per_sm of the
    kernel's CTAs each."""
    if n_sm < 1 or ctas_per_sm < 1:
        raise ValueError(f"the fast sweep needs a co-resident grid (got "
                         f"{n_sm} SMs x {ctas_per_sm} CTAs)")
    grid = n_sm * ctas_per_sm
    small = b <= SMALL_B
    # phases a layer: four at B = 1, five up to SMALL_B (the rows'
    # attention is spread over CTAs), eight above; no barrier after the
    # last
    phases = 4 if b == 1 else 5 if small else 8
    return {"grid": grid, "ctas_per_sm": ctas_per_sm, "small": small,
            "ks_wo": k_split(dim, 1, dim, grid) if small else 1,
            "ks_w2": k_split(dim, 3, dim, grid) if small else 1,
            "phases": phases, "barriers": phases * n_layer - 1}


_GRID: dict = {}      # device index -> (SMs, co-resident CTAs an SM)


def sweep_grid(dev: torch.device) -> tuple[int, int]:
    """(SM count, co-resident sweep CTAs an SM) of the card, asked once."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _GRID:
        n_sm, per_sm = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(idx):
            err = _cuda.lib("fast_sweep").fast_sweep_grid(
                ctypes.byref(n_sm), ctypes.byref(per_sm))
        if err:
            raise RuntimeError(f"fast sweep: no cooperative grid on {dev}: "
                               f"cudaError {err}")
        _GRID[idx] = (n_sm.value, per_sm.value)
    return _GRID[idx]


# The twin's reductions. order="kernel" (the twin's own): the sums of
# csrc/fast_sweep.cu. RMSNorm's sum of squares: thread t of the THREADS
# adds x[t + THREADS*c]^2 for c = 0, 1, ..., each warp folds its 32
# lanes by an xor butterfly (lane i + lane i^16, then ^8, ^4, ^2, ^1), and
# the WARPS totals are added in warp order; the kernel then takes
# 1 / sqrtf(ss / dim + eps), two correctly rounded steps, not an rsqrt. A
# head's score: each 32-lane group of the head folds bf16(q * k) by the
# same butterfly and the head's groups are added in order. torch's own
# reductions order their sums by the tensor's shape, so an order of their
# own moves the last f32 bit for some rows, and then a bf16 rounding (the
# one-layer check failed at B > 8 on some inputs). order="torch" keeps
# those reductions (torch.mean, rsqrt, sum) and order="f64" takes the
# sums in float64, rounded to f32 once: the two witnesses that the card
# test holds the kernel's order against.
ORDERS = ("kernel", "torch", "f64")


def _butterfly(x: torch.Tensor) -> torch.Tensor:
    """A warp's xor butterfly over the last dim (32 lanes): lane 0's
    value, (..., 1). Lane i then holds x_i + x_{i^o} for o = 16, ..., 1,
    the same in every lane, so halving the vector gives the same sums."""
    o = x.shape[-1] // 2
    while o:
        x = x[..., :o] + x[..., o:2 * o]
        o //= 2
    return x


def _in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, left to right: (..., 1)."""
    t = x[..., :1]
    for i in range(1, x.shape[-1]):
        t = t + x[..., i:i + 1]
    return t


def _mean_sq(xf: torch.Tensor, order: str) -> torch.Tensor:
    """Mean of squares over the last dim, (..., 1), in `order` (f64: the
    float64 value)."""
    dim = xf.shape[-1]
    if order == "torch":
        return xf.pow(2).mean(dim=-1, keepdim=True)
    if order == "f64":
        return xf.double().pow(2).sum(-1, keepdim=True) / dim
    sq = xf.pow(2)                      # bf16 values: exact squares
    pad = -dim % THREADS
    if pad:
        sq = torch.cat([sq, sq.new_zeros(*sq.shape[:-1], pad)], -1)
    sq = sq.reshape(*sq.shape[:-1], -1, THREADS)
    part = sq[..., 0, :]
    for c in range(1, sq.shape[-2]):
        part = part + sq[..., c, :]
    part = _butterfly(part.reshape(*part.shape[:-1], WARPS, 32))
    return div_exact(_in_order(part[..., 0]), float(dim))


def _head_sums(prod: torch.Tensor, n_head: int, order: str) -> torch.Tensor:
    """prod (B, dim) f32 -> per-head sums (B, n_head) in `order` (f64:
    the float64 value)."""
    b, dim = prod.shape
    if order == "torch":
        return prod.reshape(b, n_head, -1).sum(-1)
    if order == "f64":
        return prod.double().reshape(b, n_head, -1).sum(-1)
    return _in_order(_butterfly(prod.reshape(b, n_head, -1, 32))[..., 0])[
        ..., 0]


def _reduce(fn, x, order: str, sums: list | None, name: str, *args):
    """fn(x, *args, order) rounded to f32; with `sums`, also appends (name,
    {order: value before that rounding}) of all three orders on x."""
    if sums is not None:
        sums.append((name, {o: fn(x, *args, o) for o in ORDERS}))
    return fn(x, *args, order).float()


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float, order: str = "kernel",
         sums: list | None = None) -> torch.Tensor:
    xf = x.float()
    m = _reduce(_mean_sq, xf, order, sums, "mean_sq")
    if order == "torch":
        r = torch.rsqrt(m + eps)
    else:
        r = torch.reciprocal(torch.sqrt(m + eps))
    return (xf * r).to(torch.bfloat16) * w


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    xf = x.float()
    pairs = xf.reshape(*xf.shape[:-1], -1, 2)
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(xf.shape)
    return (xf * cos + rot * sin).to(torch.bfloat16)


def _quant_cache(x: torch.Tensor):
    xf = x.float()
    sc = div_exact(xf.abs().amax(dim=-1, keepdim=True), 127.0).clamp_min(
        1e-8)
    return torch.round(xf / sc).to(torch.int8), sc[..., 0].to(torch.bfloat16)


def fused_fast_sweep_plain(packed: dict, x: torch.Tensor,
                           cache: FusedFastCache, freqs_table: torch.Tensor,
                           *, pos: int, n_head: int, eps: float,
                           order: str = "kernel",
                           sums: list | None = None) -> torch.Tensor:
    """Plain PyTorch version: it rounds where the TPU kernel rounds, and
    takes RMSNorm's sum of squares and the attention's head sums in the
    CUDA kernel's order (see `_butterfly`), so that one layer equals the
    kernel bit for bit: the other sums are exact (int32 products, maxima)
    or run in the same order on both sides. x: (B, dim). Returns x_out (B,
    dim) bf16; writes position `pos` of the cache in place.

    order: "kernel", or the witnesses "torch" (torch's own reductions, the
    twin before) and "f64" (float64 sums rounded to f32 once); `sums`: a
    list that gets, for each of those reductions in the order taken, (name,
    {order: value}) of all three orders on the same input, before their
    rounding to f32."""
    if order not in ORDERS:
        raise ValueError(f"unknown sum order {order!r}")
    w, s, norms = packed["w"], packed["s"], packed["norms"]
    n_layer, _, dim, _ = w.shape
    hd = dim // n_head
    # the kernel's 1.f / sqrtf(hd), an f32 value
    scale = torch.reciprocal(torch.sqrt(torch.tensor(float(hd)))).item()
    cos, sin = rope_rows(freqs_table, pos, n_head)
    xs = x.to(torch.bfloat16)
    b = xs.shape[0]
    for l in range(n_layer):
        def w8a8(x8, xsc, j):
            return int8_matmul_t(x8, w[l, j]).float() * xsc * s[l, j]

        x8, xsc = int8_rows(
            _rms(xs, norms[l, 0], eps, order, sums).float())
        q = _rope(w8a8(x8, xsc, 0).to(torch.bfloat16), cos, sin)
        k = _rope(w8a8(x8, xsc, 1).to(torch.bfloat16), cos, sin)
        v = w8a8(x8, xsc, 2).to(torch.bfloat16)
        cache.k[l, pos], cache.ks[l, pos] = _quant_cache(k)
        cache.v[l, pos], cache.vs[l, pos] = _quant_cache(v)

        sc = [_reduce(_head_sums,
                      (q * cache.k[l, p].to(torch.bfloat16)).float(), order,
                      sums, f"head_sums p{p}", n_head)
              * cache.ks[l, p].float()[:, None] * scale
              for p in range(pos + 1)]                  # (B, H) each
        m = sc[0]
        for t in sc[1:]:
            m = torch.maximum(m, t)
        es = [torch.exp(t - m) for t in sc]
        den = es[0]
        for e in es[1:]:
            den = den + e
        inv = 1.0 / den
        out = torch.zeros(b, dim, dtype=torch.float32, device=x.device)
        for p in range(pos + 1):
            wt = (es[p] * inv * cache.vs[l, p].float()[:, None]
                  ).to(torch.bfloat16).repeat_interleave(hd, dim=-1)
            out = out + (wt * cache.v[l, p].to(torch.bfloat16)).float()
        a8, asc = int8_rows(out.to(torch.bfloat16).float())
        xs = xs + w8a8(a8, asc, 3).to(torch.bfloat16)

        x8, xsc = int8_rows(
            _rms(xs, norms[l, 1], eps, order, sums).float())
        g = torch.cat([w8a8(x8, xsc, j) for j in (4, 5, 6)], dim=-1)
        g = g.to(torch.bfloat16).float()
        u = torch.cat([w8a8(x8, xsc, j) for j in (7, 8, 9)], dim=-1)
        h2 = (g * torch.sigmoid(g)).to(torch.bfloat16) * u.to(torch.bfloat16)
        h8, hsc = int8_rows(h2.float())
        acc = int8_matmul_t(h8[:, :dim].contiguous(), w[l, 10]).float()
        for c in (1, 2):
            acc = acc + int8_matmul_t(h8[:, c * dim:(c + 1) * dim]
                                      .contiguous(), w[l, 10 + c]).float()
        xs = xs + (acc * hsc * s[l, 10]).to(torch.bfloat16)
    return xs


def fused_fast_sweep(packed: dict, x: torch.Tensor, cache: FusedFastCache,
                     freqs_table: torch.Tensor, *, pos: int, n_head: int,
                     eps: float, trace: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """One fast-stack sweep at codebook position `pos`: (B, dim) -> (B, dim)
    bf16, with the cache's position `pos` written in place. On CUDA: one
    cooperative launch of the sweep kernel (raises if it cannot launch),
    which reads RoPE's row `pos` from freqs_table ((>= pos + 1, head_dim /
    2, 2) bf16, as `precompute_freqs_cis` makes it) and works in the
    cache's scratch.

    trace: None, or an int64 (barriers + 1, 2, grid) CUDA tensor (the
    plan's) that the kernel fills with the global timer (ns) at its start,
    at each CTA's arrival at and exit from every grid barrier, and at its
    end (`sweep_phase_times` reads it)."""
    if not x.is_cuda:
        return fused_fast_sweep_plain(packed, x, cache, freqs_table, pos=pos,
                                      n_head=n_head, eps=eps)
    check_sweep_args(packed, x, cache, freqs_table, pos=pos, n_head=n_head)
    w, s, norms = packed["w"], packed["s"], packed["norms"]
    n_layer, _, dim, _ = w.shape
    n_pos, b = cache.k.shape[1], x.shape[0]
    dev = x.device
    _cuda.check(w, "w", torch.int8, None, dev)
    _cuda.check(s, "s", torch.float32, None, dev)
    _cuda.check(norms, "norms", torch.bfloat16, None, dev)
    for name, t in (("cache.k", cache.k), ("cache.v", cache.v)):
        _cuda.check(t, name, torch.int8, None, dev)
    for name, t in (("cache.ks", cache.ks), ("cache.vs", cache.vs)):
        _cuda.check(t, name, torch.bfloat16, None, dev)
    # the kernel reads the table's row `pos` 16 bytes a load
    _cuda.check(freqs_table, "freqs_table", torch.bfloat16, None, dev)
    if freqs_table.data_ptr() % 16:
        raise ValueError("freqs_table must be 16-byte aligned")
    plan = sweep_plan(b, dim, n_layer, *sweep_grid(dev))
    x8, xsc, buf, hmax = cache.scratch
    if trace is not None:
        _cuda.check(trace, "trace", torch.int64,
                    (plan["barriers"] + 1, 2, plan["grid"]), dev)
    xin = x.to(torch.bfloat16).contiguous()
    if xin.data_ptr() % 16:           # the kernel reads rows 16 bytes a load
        xin = xin.clone()
    xo = torch.empty_like(xin)
    KERNEL(xin.data_ptr(), xo.data_ptr(), w.data_ptr(), s.data_ptr(),
           norms.data_ptr(), freqs_table.data_ptr(), cache.k.data_ptr(),
           cache.v.data_ptr(), cache.ks.data_ptr(), cache.vs.data_ptr(),
           x8.data_ptr(), xsc.data_ptr(), buf.data_ptr(), hmax.data_ptr(),
           _cuda.ptr(trace), b, dim, n_layer, n_pos, pos, n_head,
           plan["grid"], plan["ks_wo"], plan["ks_w2"], float(eps))
    return xo


def sweep_phase_times(trace: torch.Tensor, per_layer: int) -> dict:
    """Microseconds a sweep spends per phase, from a filled trace. Phase i
    runs on each CTA from trace[i, 0] (the start, or its exit from barrier
    i - 1) to trace[i, 1] (its arrival at barrier i, or the end). For each
    of a layer's `per_layer` phases, the mean over layers of: the mean and
    the slowest CTA's work, and the barrier after it (the last arrival to
    the first exit); and the sweep's span."""
    t = trace.double().cpu()                  # (phases, 2, grid)
    leave, arrive = t[:, 0], t[:, 1]
    work = arrive - leave
    wait = torch.cat([leave[1:].amin(dim=1) - arrive[:-1].amax(dim=1),
                      torch.zeros(1, dtype=t.dtype)])
    out = {}
    for i in range(per_layer):
        out[f"p{i}_work_mean_us"] = float(work[i::per_layer].mean()) / 1e3
        out[f"p{i}_work_max_us"] = float(
            work[i::per_layer].amax(dim=1).mean()) / 1e3
        out[f"p{i}_barrier_us"] = float(wait[i::per_layer].mean()) / 1e3
    out["span_us"] = float(arrive.amax() - leave.amin()) / 1e3
    return out


def check_sweep_args(packed: dict, x: torch.Tensor, cache: FusedFastCache,
                     freqs_table: torch.Tensor, *, pos: int,
                     n_head: int) -> None:
    """The shapes the sweep kernel takes; raises ValueError otherwise."""
    w, s, norms = packed["w"], packed["s"], packed["norms"]
    if w.dim() != 4:
        raise ValueError(f"w must be (L, 13, dim, dim), got {tuple(w.shape)}")
    n_layer, n_tiles, dim, _ = w.shape
    if (n_tiles != N_TILES or dim % 64 or dim > 1024 or n_head < 1
            or dim % n_head or (dim // n_head) % 32):
        raise ValueError(f"fast sweep kernel takes 13 tiles, dim a multiple "
                         f"of 64 up to 1024 and head_dim a multiple of 32 "
                         f"(got {n_tiles}, {dim}, {n_head} heads)")
    if x.dim() != 2 or x.shape[1] != dim or x.shape[0] < 1:
        raise ValueError(f"x must be (B, {dim}), got {tuple(x.shape)}")
    b, n_pos = x.shape[0], cache.k.shape[1]
    if not 0 <= pos < min(n_pos, 16):
        raise ValueError(f"pos {pos} out of range")
    want = {"w": (w, (n_layer, N_TILES, dim, dim)),
            "s": (s, (n_layer, N_TILES, dim)),
            "norms": (norms, (n_layer, 2, dim)),
            "cache.k": (cache.k, (n_layer, n_pos, b, dim)),
            "cache.v": (cache.v, (n_layer, n_pos, b, dim)),
            "cache.ks": (cache.ks, (n_layer, n_pos, b)),
            "cache.vs": (cache.vs, (n_layer, n_pos, b)),
            "freqs_table": (freqs_table, (max(freqs_table.shape[0], pos + 1),
                                          dim // n_head // 2, 2))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if freqs_table.dtype != torch.bfloat16:
        raise ValueError(f"freqs_table must be bfloat16, got "
                         f"{freqs_table.dtype}")
