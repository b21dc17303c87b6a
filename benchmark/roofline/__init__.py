"""Operations and bytes of the kernels and of a decode step, from shapes,
and the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit).

A kernel's bound is the least time the card could take: its bytes over
the memory rate, or its operations over the peak rate of their type,
whichever is larger. Each input byte is counted read once and each output
byte written once. The arithmetic is the one the port's kernel checks use
(`chip_smoke.bound` and its callers, `kernel_bench.py`), copied here.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def bound_s(n_bytes: float, ops: dict) -> float:
    """Least seconds for `n_bytes` moved and `ops` {type: operations}."""
    t_ops = sum(n / PEAK_OPS_PER_S[ty] for ty, n in ops.items())
    return max(n_bytes / HBM_BYTES_PER_S, t_ops)


# --- #2, the fused fast-head sweep (ops/fast_fused.py, csrc/fast_sweep.cu)

def sweep_bound_s(b: int, pos: int, dim: int, n_layer: int) -> float:
    """One sweep of `n_layer` fast layers at codebook position `pos` for
    `b` rows: the packed int8 weights (13 (dim, dim) tiles a layer), their
    f32 scales and bf16 norms, the row in and out (bf16), the int8 cache
    read at positions < pos and written at pos (a bf16 scale a row)."""
    w = n_layer * 13 * dim * dim
    scales = n_layer * 13 * dim * 4
    norms = n_layer * 2 * dim * 2
    rows = 2 * b * dim * 2
    cache = n_layer * (pos + 1) * b * (2 * dim + 2 * 2)
    return bound_s(w + scales + norms + rows + cache,
                   {"int8": 2 * b * 13 * dim * dim * n_layer,
                    "bf16": 4 * (pos + 1) * b * dim * n_layer})


# --- #11 / #12, the W4A8 products (ops/w4a8.py, csrc/w4a8.cu)

def w4a8_bound_s(m: int, n: int, k: int, group: int = 128) -> float:
    """x8 (m, k) int8 @ unpack(q4 (n, k/2)).T with f32 scales (n, k/group)
    -> f32 (m, n)."""
    return bound_s(m * k + n * k // 2 + 4 * n * (k // group) + 4 * m * n,
                   {"int8": 2 * m * n * k})


def slow_products(s: dict) -> list[tuple[str, int, int]]:
    """(name, N, K) of a slow layer's five products, in launch order."""
    qkv = (s["n_head"] + 2 * s["n_local_heads"]) * s["head_dim"]
    d, i = s["dim"], s["intermediate_size"]
    return [("wqkv", qkv, d), ("wo", d, s["n_head"] * s["head_dim"]),
            ("w1", i, d), ("w3", i, d), ("w2", d, i)]


# --- #1, decode attention over the position-major int8 cache

def attn_int8_bound_s(b: int, filled: int, hkv: int, g: int, d: int) -> float:
    """One layer at `filled` keys summed over the rows: int8 k and v with
    f32 scales a (position, head), the bf16 query and output."""
    row_bytes = hkv * d * 2 + hkv * 4 * 2
    q_bytes = b * hkv * g * d * 2
    return bound_s(filled * row_bytes + 2 * q_bytes + 2 * 4 * b,
                   {"int8": 2 * filled * hkv * g * d,
                    "bf16": 2 * filled * hkv * g * d})


# --- #3 / #4, the fused bf16 vocoder (ops/voc_fused.py, csrc/voc_fused.cu)

def unit_flops(t: int, c: int, n_units: int) -> int:
    """A k7 and a 1x1 conv of `n_units` residual units over t rows."""
    return n_units * t * 2 * 8 * c * c


def vocoder_ops(frames: int, c: dict) -> dict:
    """bf16 operations of #4 (block 0's three residual units) and #3
    (blocks 1..: the transposed conv, three units, and the final k7 conv
    on the last) for `frames` code frames."""
    t = frames * 4                      # the quantizer's upsampling
    dim = c["decoder_dim"]
    ops4 = ops3 = 0
    for bi, stride in enumerate(c["decoder_rates"]):
        c_in, c_out = dim, dim // 2
        t_out = t * stride
        if bi == 0:
            ops4 = unit_flops(t_out, c_out, 3)
        else:
            ops3 += (2 * t * c_in * 2 * stride * c_out
                     + unit_flops(t_out, c_out, 3)
                     + (2 * 7 * c_out * t_out
                        if bi == len(c["decoder_rates"]) - 1 else 0))
        t, dim = t_out, c_out
    return {"res_stack": ops4, "block": ops3}


# --- the decode step: one frame of the Dual-AR model

def frame_ops(s: dict, length: int) -> int:
    """Operations of one decoded frame at a sequence of `length`: the slow
    stack's products and attention over `length` keys, the token logits
    over the semantic ids and im_end, the projection into the fast head,
    ten fast sweeps (products and attention over positions 0..p), and the
    nine codebook logits."""
    slow = sum(n * k for _, n, k in slow_products(s)) * 2 * s["n_layer"]
    slow += 4 * length * s["n_head"] * s["head_dim"] * s["n_layer"]
    head = 2 * (s["codebook_size"] + 1) * s["dim"]
    proj = 2 * s["fast_dim"] * s["dim"]
    fd, fl, k = s["fast_dim"], s["n_fast_layer"], s["num_codebooks"]
    fq = (s["fast_n_head"] + 2 * s["fast_n_local_heads"]) * s["fast_head_dim"]
    fast_w = fq * fd + fd * s["fast_n_head"] * s["fast_head_dim"] \
        + 3 * s["fast_intermediate_size"] * fd
    fast = k * 2 * fast_w * fl
    fast += sum(4 * (p + 1) * s["fast_n_head"] * s["fast_head_dim"] * fl
                for p in range(k))
    out = (k - 1) * 2 * s["codebook_size"] * fd
    return slow + head + proj + fast + out
