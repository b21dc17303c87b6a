#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fish_speech_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile N]

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi); CUDA must be available;
  2. build the hand-written CUDA kernels (nvcc, in parallel);
  3. each kernel against its plain PyTorch version on the same inputs at the
     serving path's shapes, with the tolerance stated, timed with CUDA
     events; the kernels' weights are those of the engine built for phase 4;
  4. the serving main path: build_engine(serving=True) at full S2-Pro width
     with seeded random weights drawn on the card, then three `tts`
     requests. Each must give codes in range and a finite waveform in
     [-1, 1] of frames x 2048 samples, and must launch all four kernels.

Output: one JSON line per request, then the `{"kernels": [...]}` line, the
card's name and power limit, and last the `{"ok": true, ...}` line.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

# bytes/s and operations/s of one H100 SXM (dense, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}

SEED = 0
MAX_NEW_TOKENS = 96   # frames per request, at most (~4.5 s of audio)
FRAMES = 128          # codec frames for the vocoder kernel checks
TEXTS = (
    "Hello there. This is the first request to the serving path.",
    "<|speaker:0|>A second request, spoken by one tagged speaker.",
    "The third request is a little longer: it checks that a sentence with "
    "punctuation, numbers like 42, and a few more words goes through.",
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes: float, ops: dict) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[ty] for ty, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


class Checks:
    """Collects kernel cases; a case outside its tolerance fails the run."""

    def __init__(self):
        self.failed: list[str] = []

    def case(self, kernel: str, label: str, err: float, tol: float,
             **extra) -> dict:
        ok = err <= tol and math.isfinite(err)
        log(f"  {kernel} [{label}] max_abs_err={err:.3e} tol={tol:.3e} "
            f"{'ok' if ok else 'FAIL'} " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in extra.items()))
        if not ok:
            self.failed.append(f"{kernel} [{label}]")
        return {"case": label, "max_abs_err": err, "tol": tol, **extra}


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_attention(chk: Checks, cfg, dev, gen) -> list[dict]:
    """#1 at the bench shape (B=256, S=384, ragged rows) and at the main
    path's (B=1, S=2048, full). Timing walks the 36 layers, as a decode step
    does, so every launch reads its layer from device memory."""
    from fish_speech_tpu_torch.ops.attention import (
        decode_attention_stream, decode_attention_stream_plain)

    n_layer, hkv, d = cfg.n_layer, cfg.n_local_heads, cfg.head_dim
    g = cfg.n_head // hkv
    cases = []
    for b, s, ragged in ((256, 384, True), (1, 2048, False)):
        k = torch.randint(-127, 128, (n_layer, s, b, hkv, d), generator=gen,
                          device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (n_layer, s, b, hkv, d), generator=gen,
                          device=dev, dtype=torch.int8)
        ks = torch.rand((n_layer, b, s * hkv), generator=gen, device=dev)
        ks = ks * 0.02 + 1e-3
        vs = torch.rand((n_layer, b, s * hkv), generator=gen, device=dev)
        vs = vs * 0.02 + 1e-3
        q = torch.randn((b, hkv, g, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        if ragged:
            lengths = torch.randint(s // 2, s + 1, (b,), generator=gen,
                                    device=dev, dtype=torch.int32)
            starts = torch.randint(0, s // 8, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
        else:
            lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
            starts = torch.zeros((b,), dtype=torch.int32, device=dev)
        layer = n_layer - 1
        got = decode_attention_stream(q, k, v, ks, vs, layer, lengths, starts)
        ref = decode_attention_stream_plain(q, k, v, ks, vs, layer, lengths,
                                            starts)
        torch.cuda.synchronize()
        it = iter(range(10 ** 9))
        ms = time_ms(lambda: decode_attention_stream(
            q, k, v, ks, vs, next(it) % n_layer, lengths, starts), n_layer)
        plain_ms = time_ms(lambda: decode_attention_stream_plain(
            q, k, v, ks, vs, next(it) % n_layer, lengths, starts), 6, 1)
        filled = int((lengths - starts).clamp_min(0).sum())
        row_bytes = hkv * d * 2 + hkv * 4 * 2        # int8 k+v, f32 scales
        b_ms, b_by = bound(filled * row_bytes + nbytes(q, q, lengths, starts),
                           {"int8": 2 * filled * hkv * g * d,
                            "bf16": 2 * filled * hkv * g * d})
        # outputs have magnitude <= ~1: the kernel and the plain version
        # round p * v_scale to bf16 at different running maxima and the
        # result is bf16, so they agree to a few bf16 ulps (2^-7 each)
        cases.append(chk.case("decode_attention_stream", f"B={b} S={s}",
                              max_err(got, ref), 1.5e-2, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              filled_positions=filled))
        del k, v, ks, vs
        torch.cuda.empty_cache()
    return cases


def _clone_cache(c, n_layer=None):
    from fish_speech_tpu_torch.ops.fast_fused import FusedFastCache

    return FusedFastCache(*(t[:n_layer].clone() for t in (c.k, c.v, c.ks,
                                                          c.vs)))


def check_fast_sweep(chk: Checks, cfg, packed: dict, dev, gen) -> list[dict]:
    """#2 on the engine's packed fast stack at B=256 and B=1, at pos 0 and
    pos 9; positions before `pos` are filled by plain sweeps first.

    Tolerance. Both sides round at the same points (bf16 where the TPU
    kernel rounds, int8 activations and cache), but take f32 sums in
    another order, so a bf16 rounding can move by one ulp; the int8
    quantizations that follow turn such a step into a whole int8 step, and
    28 random-weight layers amplify it. So the check is two-fold: after one
    layer the outputs must agree to 2^-6 of their scale (two bf16 ulps),
    and after all layers the kernel must stay within twice the plain
    version's own spread: its change when 1% of the inputs move by one bf16
    ulp (measured here, on the same inputs)."""
    from fish_speech_tpu_torch.models.dual_ar import precompute_freqs_cis
    from fish_speech_tpu_torch.ops.fast_fused import (
        FusedFastCache, fused_fast_sweep, fused_fast_sweep_plain)

    n_layer, dim, n_pos = cfg.n_fast_layer, cfg.fast_dim, cfg.num_codebooks
    freqs = precompute_freqs_cis(n_pos, cfg.fast_head_dim, cfg.rope_base, dev)
    kw = dict(n_head=cfg.fast_n_head, eps=cfg.norm_eps)
    layer0 = {k: v[:1].contiguous() for k, v in packed.items()}
    cases = []
    for b in (256, 1):
        xs = torch.randn((n_pos, b, dim), generator=gen,
                         device=dev).to(torch.bfloat16)
        base = FusedFastCache.create(n_layer, n_pos, b, dim, dev)
        for pos in range(n_pos):
            if pos in (0, n_pos - 1):
                x = xs[pos]
                got1 = fused_fast_sweep(layer0, x, _clone_cache(base, 1),
                                        freqs, pos=pos, **kw)
                ref1 = fused_fast_sweep_plain(layer0, x, _clone_cache(base, 1),
                                              freqs, pos=pos, **kw)
                err1 = max_err(got1, ref1)
                tol1 = 2 ** -6 * ref1.float().abs().max().item()
                nudge = torch.rand(x.shape, generator=gen, device=dev) < 0.01
                xn = torch.where(nudge, (x.float() * (1 + 2 ** -8)).to(
                    torch.bfloat16), x)
                spread = max_err(
                    fused_fast_sweep_plain(packed, xn, _clone_cache(base),
                                           freqs, pos=pos, **kw),
                    fused_fast_sweep_plain(packed, x, _clone_cache(base),
                                           freqs, pos=pos, **kw))
                ck, cp = _clone_cache(base), _clone_cache(base)
                got = fused_fast_sweep(packed, x, ck, freqs, pos=pos, **kw)
                ref = fused_fast_sweep_plain(packed, x, cp, freqs, pos=pos,
                                             **kw)
                torch.cuda.synchronize()
                ms = time_ms(lambda: fused_fast_sweep(
                    packed, xs[pos], ck, freqs, pos=pos, **kw), 10)
                plain_ms = time_ms(lambda: fused_fast_sweep_plain(
                    packed, xs[pos], cp, freqs, pos=pos, **kw), 3, 1)
                kv_mismatch = float(
                    ((ck.k[:, pos] != cp.k[:, pos]).float().mean()
                     + (ck.v[:, pos] != cp.v[:, pos]).float().mean()) / 2)
                w = packed["w"]
                read_cache = n_layer * pos * b * (2 * dim + 2 * 2)
                wrote_cache = n_layer * b * (2 * dim + 2 * 2)
                b_ms, b_by = bound(
                    nbytes(w, packed["s"], packed["norms"], xs[pos], got)
                    + read_cache + wrote_cache,
                    {"int8": 2 * b * w[0].numel() * n_layer,
                     "bf16": 4 * (pos + 1) * b * dim * n_layer})
                if err1 > tol1:
                    chk.failed.append(f"fast_sweep [B={b} pos={pos}] one "
                                      f"layer: {err1:.3e} > {tol1:.3e}")
                cases.append(chk.case(
                    "fast_sweep", f"B={b} pos={pos}", max_err(got, ref),
                    2 * spread, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, plain_spread=spread,
                    one_layer_err=err1, one_layer_tol=tol1,
                    cache_int8_mismatch=kv_mismatch))
            fused_fast_sweep_plain(packed, xs[pos], base, freqs, pos=pos,
                                   **kw)
    return cases


def vocoder_inputs(engine, frames: int, dev, gen):
    """The decoder's activations for `frames` random codes, through the
    plain path: block 0's residual-stack input, then each fused block's."""
    from fish_speech_tpu_torch.codec.fastpath import (
        conv1d_mm, conv_transpose1d_phases, rvq_decode_mm)
    from fish_speech_tpu_torch.codec.nn import snake

    ccfg, packed = engine.codec_cfg, engine.packed_decoder
    codes = torch.randint(0, ccfg.rvq.codebook_size,
                          (1, ccfg.rvq.n_codebooks + 1, frames),
                          generator=gen, device=dev)
    z = rvq_decode_mm(engine.codec_params["quantizer"], ccfg.rvq, codes)
    x = conv1d_mm(z.to(torch.bfloat16), packed["conv_in_w"],
                  packed["conv_in_b"])
    pb0 = packed["blocks"][0]
    x = snake(x.float(), pb0["snake_alpha"]).to(torch.bfloat16)
    return conv_transpose1d_phases(x, pb0["tconv_phases"], pb0["tconv_b"],
                                   stride=ccfg.decoder_rates[0])


def res_stack_block0(x, pb, fn):
    """Block 0's residual units, one call per unit as decoder_fused runs
    them; fn is fused_res_stack or its plain version."""
    from fish_speech_tpu_torch.ops.voc_fused import DILATIONS

    for u, d in enumerate(DILATIONS):
        sub = {k: pb["res"][k][u:u + 1] for k in ("w7", "w1", "vec")}
        last = u == len(DILATIONS) - 1
        x = fn(x, sub, dilations=(d,), tail_vec=pb["tail_vec"] if last
               else None)
    return x


def unit_flops(t: int, c: int, n_units: int) -> int:
    """k7 conv + 1x1 conv of `n_units` residual units over t rows."""
    return n_units * t * 2 * 8 * c * c


def check_vocoder(chk: Checks, engine, frames: int, dev,
                  gen) -> tuple[list[dict], list[dict]]:
    """#4 (block 0's residual stack, 3 launches) and #3 (blocks 1-3, the
    last with the final conv and tanh) on the engine's packed decoder."""
    from fish_speech_tpu_torch.ops.voc_fused import (
        DILATIONS, fused_block, fused_block_plain, fused_res_stack,
        fused_res_stack_plain)

    packed, ccfg = engine.packed_decoder, engine.codec_cfg
    blocks = packed["blocks"]
    x = vocoder_inputs(engine, frames, dev, gen)
    # both sides keep the state between units in bf16 with f32 sums; sums
    # in another order move a bf16 rounding by one ulp (2^-8 relative), and
    # such steps compound over the units: 2^-5 of the output's scale
    res_cases, block_cases = [], []
    pb = blocks[0]
    got = res_stack_block0(x, pb, fused_res_stack)
    ref = res_stack_block0(x, pb, fused_res_stack_plain)
    torch.cuda.synchronize()
    ms = time_ms(lambda: res_stack_block0(x, pb, fused_res_stack), 3, 1)
    plain_ms = time_ms(lambda: res_stack_block0(x, pb, fused_res_stack_plain),
                       2, 1)
    t, c = x.shape[1], x.shape[2]
    b_ms, b_by = bound(3 * nbytes(x, got) + nbytes(*(pb["res"][k] for k in (
        "w7", "w1", "vec"))), {"bf16": unit_flops(t, c, 3)})
    res_cases.append(chk.case(
        "voc_res_stack", f"block 0 F={frames} T={t} C={c}", max_err(got, ref),
        2 ** -5 * ref.float().abs().max().item(), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by))
    x = ref
    for bi in range(1, len(blocks)):
        pb, stride = blocks[bi], ccfg.decoder_rates[bi]
        final = bi == len(blocks) - 1
        kw = dict(stride=stride, dilations=DILATIONS, tail_vec=pb["tail_vec"],
                  final_w=packed["final_fw"] if final else None)
        got = fused_block(x, pb["res"], **kw)
        ref = fused_block_plain(x, pb["res"], **kw)
        torch.cuda.synchronize()
        ms = time_ms(lambda: fused_block(x, pb["res"], **kw), 3, 1)
        plain_ms = time_ms(lambda: fused_block_plain(x, pb["res"], **kw), 2,
                           1)
        t_in, c_in = x.shape[1], x.shape[2]
        c = pb["res"]["w1"].shape[-1]
        t = t_in * stride
        flops = 2 * t_in * c_in * 2 * stride * c + unit_flops(t, c, 3)
        if final:
            flops += 2 * 7 * c * t
        wts = [pb["res"][k] for k in ("tconv_pw", "tconv_pb", "w7", "w1",
                                      "vec")]
        b_ms, b_by = bound(nbytes(x, got, *wts), {"bf16": flops})
        # the waveform is tanh'd into [-1, 1]: 2^-5 absolute there
        scale = 1.0 if final else ref.float().abs().max().item()
        block_cases.append(chk.case(
            "voc_block", f"block {bi} F={frames} T={t} C={c_in}->{c}",
            max_err(got, ref), 2 ** -5 * scale, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by))
        x = ref
    return res_cases, block_cases


# ---------------------------------------------------------------------------
# Phase 4: the serving main path
# ---------------------------------------------------------------------------


def run_main_path(engine, kernels: dict, chk: Checks) -> None:
    from fish_speech_tpu_torch.engine.generate import GenerateLongRequest

    cfg = engine.cfg
    fl = engine.codec_cfg.frame_length
    for k in kernels.values():
        k.launches = 0
    for i, text in enumerate(TEXTS):
        before = {n: k.launches for n, k in kernels.items()}
        req = GenerateLongRequest(text=text, max_new_tokens=MAX_NEW_TOKENS,
                                  seed=SEED + i)
        t0 = time.perf_counter()
        wav, codes, lm_s = engine.tts_with_codes(req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        frames = codes.shape[1]
        rose = {n: kernels[n].launches - before[n] for n in kernels}
        problems = []
        if frames < 1:
            problems.append("no frames")
        if codes.shape[0] != cfg.num_codebooks or codes.min() < 0 \
                or codes.max() >= cfg.codebook_size:
            problems.append(f"codes out of range: shape {codes.shape}, "
                            f"[{codes.min()}, {codes.max()}]")
        if wav.shape != (frames * fl,):
            problems.append(f"wav shape {wav.shape} != ({frames * fl},)")
        if not (abs(wav) <= 1.0).all():
            problems.append("wav not finite or outside [-1, 1]")
        if min(rose.values()) < 1:
            problems.append(f"kernels not launched: {rose}")
        print(json.dumps({
            "request": i, "frames": frames, "wall_s": wall,
            "lm_s": lm_s, "audio_s": len(wav) / engine.codec_cfg.sample_rate,
            "decode_steps_per_s": frames / lm_s if lm_s > 0 else None,
            "launches": rose}), flush=True)
        if problems:
            chk.failed.append(f"request {i}: " + "; ".join(problems))


def profile_request(engine, n_rows: int) -> None:
    """One more request under torch.profiler: device time by kernel and the
    device's idle share of the request's wall time (to stderr). The request
    is cut to 16 frames: the profiler's own bookkeeping grows with the
    ~10^4 launches of every frame, and it inflates the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from fish_speech_tpu_torch.engine.generate import GenerateLongRequest

    req = GenerateLongRequest(text=TEXTS[0], max_new_tokens=16,
                              seed=SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, codes, lm_s = engine.tts_with_codes(req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile: {codes.shape[1]} frames, wall {wall * 1e3:.1f} ms "
        f"(LM {lm_s * 1e3:.1f} ms), device busy {busy:.1f} ms, idle share "
        f"{1 - busy / (wall * 1e3):.3f}")
    for ms, n, key in rows[:n_rows]:
        log(f"  {ms:10.3f} ms {ms / busy:6.1%} {n:7d}x  {key[:90]}")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the checks, profile one more request and "
                         "list its N costliest device kernels")
    args = ap.parse_args()

    from fish_speech_tpu_torch.engine.generate import build_engine
    from fish_speech_tpu_torch.ops import _cuda
    from fish_speech_tpu_torch.ops import attention, fast_fused, voc_fused

    # phase 1: the card
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script needs a GPU")
        return 2
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # phase 2: build
    t0 = time.perf_counter()
    _cuda.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for src, text in _cuda.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {src}: {line.strip()}")

    t0 = time.perf_counter()
    engine = build_engine(device=dev, serving=True, seed=SEED)
    torch.cuda.synchronize()
    log(f"engine (S2-Pro, random weights on the card): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    # phase 3: kernels against their plain versions
    chk = Checks()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    attn = check_attention(chk, engine.cfg, dev, gen)
    sweep = check_fast_sweep(chk, engine.cfg, engine.params["fast_packed"],
                             dev, gen)
    res, blk = check_vocoder(chk, engine, FRAMES, dev, gen)
    torch.cuda.empty_cache()

    # phase 4: the main path, counts from zero
    kernels = {"decode_attention_stream": attention.KERNEL,
               "fast_sweep": fast_fused.KERNEL,
               "voc_block": voc_fused.BLOCK,
               "voc_res_stack": voc_fused.RES_STACK}
    run_main_path(engine, kernels, chk)
    launches = {n: k.launches for n, k in kernels.items()}
    if args.profile:
        profile_request(engine, args.profile)

    def entry(name, replaces, cases, head, sum_cases=False):
        h = cases[head]
        agg = {key: (sum(c[key] for c in cases) if sum_cases else h[key])
               for key in ("ms", "plain_ms", "bound_ms")}
        return {"name": name, "route": "cuda",
                "source": f"fish_speech_tpu_torch/csrc/{_cuda.SIGNATURES[name][0]}.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                **agg, "bound_by": h["bound_by"], "library_ms": None,
                "cases": cases}

    report = {"kernels": [
        # headline: the main path's own shape (batch 1)
        entry("decode_attention_stream",
              "fish_speech_tpu/ops/attention.py:910", attn, 1),
        entry("fast_sweep", "fish_speech_tpu/ops/fast_fused.py:351", sweep,
              3),
        # headline: the whole decoder's use at F frames
        entry("voc_block", "fish_speech_tpu/ops/voc_fused.py:378", blk, 0,
              sum_cases=True),
        entry("voc_res_stack", "fish_speech_tpu/ops/voc_fused.py:459", res,
              0),
    ]}
    if min(launches.values()) < 1:
        chk.failed.append(f"a kernel of the main path never ran: {launches}")
    print(json.dumps(report), flush=True)
    if chk.failed:
        log("chip_smoke FAILED: " + ", ".join(chk.failed))
        return 1
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
