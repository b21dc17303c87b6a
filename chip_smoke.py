#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fish_speech_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile N]

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi); CUDA must be available;
  2. build the hand-written CUDA kernels (nvcc, in parallel);
  3. each kernel against its plain PyTorch version on the same inputs at the
     serving paths' shapes, with the tolerance stated, timed with CUDA
     events; the vocoder and fast-head kernels' weights are those of the
     engine built for phase 4;
  4. the int8 serving path: build_engine(serving=True) at full S2-Pro width
     with seeded random weights drawn on the card, then three `tts`
     requests;
  4b. the head-major routes: the same engine and weights, its configuration
     replaced by serving_config(kv_layout="head", ...) for each of six
     routes (blocks16, blocks16-bf16, stream16 on the int8 cache; rows on the
     native and the int8 cache; rows with the per-layer "scan" stack on the
     native cache), one `tts` request each;
  4c. the position-major bf16 cache: the same engine, its configuration
     replaced by serving_config(kv_layout="pos", kv_cache="native",
     attn="stream"), one `tts` request;
  4d. the int8 vocoder (VOC_QUANT): the same engine, its packed decoder
     replaced by pack_decoder(quant=True) of the same weights, one `tts`
     request;
  6. the continuous-batching scheduler on the int8 path (run after 4d, on
     phase 4's weights): TTSEngine(scheduler_slots=4, scheduler_chunk=4,
     prefill_chunk=64), its batcher greedy, answers six requests (two sharing a system
     prompt, one prompt longer than the prefill chunk, all of different
     lengths) once one at a time and once from six threads with staggered
     arrival, on two fresh batchers with the same seed; each request's
     codes must be the same in both runs, and so must the prefix hits and
     misses and the chunked prefills; both batchers must have captured
     their tick's slow forward as a CUDA graph, and each request alone in
     a 4-slot batcher that ticks eagerly must give the same greedy codes;
     each request alone in a 1-slot
     batcher must give the same greedy codes as in the 4-slot run (#1 at
     batch 1 takes other CTAs but the same 128-key chunks); one `tts`
     through the scheduler must give a finite waveform. Each request's
     agreement with the non-scheduler path at batch 1 (greedy) is logged,
     not checked, and at the first frame where the two differ, both
     paths' logits there;
  7. the codec's other paths, on the same weights through a phase-6
     scheduler engine: warmup_vocoder(); stream_tts of one request, its
     audio against the plain f32 decode of its codes; encode_reference of a
     seeded 3 s waveform against dac_encode; decode_codes_batch of three
     sequences in one fused call at batch 4 against their single decodes,
     and #3/#4 against their plain twins at batch 4; under 120 s;
  5. the W4A8 serving path: that engine freed, build_engine(serving=True,
     quant="w4a8", kv_fold=True) from the same seed, then three `tts`
     requests, the last with W4A8_KERNEL=pc;
  8. the HTTP server from disk (that engine freed): a full-width S2-Pro LM
     drawn from the seed, written as a sharded bf16 fish_qwen3_omni
     safetensors checkpoint with its index and config.json, and the codec
     as codec.pth with every conv a weight-norm pair; the CLI's own
     parse_args / build_engine load them (--kv-cache int8 --pallas-attn
     stream --kv-layout pos --vocoder-impl pallas, 4 scheduler slots, an
     API key), the loaded LM bit-equal to the drawn one and the codec
     within 1e-6 relative; the CLI's warm-up; create_server on an
     ephemeral port in a thread, driven with urllib: health, 401 without
     the key, a buffered JSON wav, a msgpack pcm, a streamed wav (time to
     its first audio byte), a reference added then used, four requests
     from threads at once, /v1/vqgan/encode (equal to encode_reference)
     and /v1/vqgan/decode of three sequences (equal to decode_codes_batch
     as f16 bytes); every audio body parses and holds frames x 2048
     samples; #1 (pos int8) and #3/#4 launch and nothing else; the
     serving vocoder's three routes (pallas, lax, mm) timed at the
     server's shapes; then both CLIs as subprocesses in demo mode, each
     with --vocoder-impl pallas and held to report it;
  9. training and LoRA (that engine freed): a synthetic corpus (two
     speakers, 16 clips of 10 x 40-200 random codes with transcripts)
     through the port's build_dataset; a full-width S2-Pro drawn from the
     seed in bf16 and written as a native checkpoint; the training CLI's
     `main` (in this process) with --lora, 4 steps at batch 2 and up to
     1024 tokens, checkpoints every 2 (finite losses and gradient norms,
     the base bit-equal after, some b factor non-zero at step 2, the final
     factors read back), then merge_lora's `main` (differs from the base);
     a full finetune with make_train_step (remat), 3 steps at batch 2 x
     1024 (finite; unchanged after step 1 at LR 0, moved after step 2;
     seconds, tokens/s and peak memory a step); one full and one LoRA
     step on a tiny f32 model on the card against the CPU (loss, metrics,
     every gradient leaf); none of the 12 kernels launches;
 10. tensor parallelism (phase 9's engines freed): two ranks of this
     script (--tp-rank) on cuda:0, joined over gloo into one model group
     of TP = 2, each drawing the S2-Pro weights from the seed on the card
     at full width, the slow stack cut to 12 of its 36 layers (int8 and
     W4A8 serving trees, fused fast head) and keeping its slices
     (parallel/mesh.py); rank 0 decodes each case at TP = 1 on the whole
     weights first, then both decode it at TP = 2 under decode_mesh:
     (a) two 32-frame greedy requests at batch 1 and one batch of 2 on
     the int8 path (#1 position-major on the rank's 4 KV heads, #2 on
     its rows of the batch), (b) one 16-frame request on the head-major
     blocks16 route (#6), (c) one on W4A8 (#11 on the local wqkv / w1 /
     w3 slices and the whole wo / w2), (d) four requests through a 4-slot
     ContinuousBatcher; every rank's codes must equal TP = 1's bit for
     bit, and each case must launch its route's kernels on every rank and
     no other; (e) `tools.api_server --multihost` in demo mode as leader
     and follower on cuda:0: one /v1/tts to the leader gives a wav of
     frames x the demo codec's frame length finite samples, the follower
     logs the same codes as the leader, and both exit 0 after the
     leader's SIGINT. Two ranks on one card time-share it: the phase's
     seconds are no measure of TP speed;
 11. the tools at full S2-Pro width (phase 10's ranks gone), weights drawn
     from the seed: (a) a bf16 native checkpoint through tools.quantize
     --mode int8 and w4a8, the loaded leaves bit-equal to
     quantize_lm_params of the drawn tree, the GB before and after; (b)
     tools.quant_drift at its defaults (36 layers, B = 8, prompt 48, 16
     steps, cache 256): the full serving configuration within
     QUANT_DRIFT.md's max and mean |dlogit| go bounds on prefill, decode
     slow and decode fast (its top-1 in the bf16 top-5 logged), the
     other configurations logged; (c)
     tools.latency_bench --full --quant --kv-int8 --w8a8 --pallas-attn
     stream --fused-fast --kv-layout pos --slots 2 --max-new 24: finite
     TTFA and RTF, audio > 0; (d) tools.profile_decode at B = 1 over a
     2048 cache and B = 64 over 384, 8 steps each: #1 and #2 among the
     device kernels, the idle share logged; (e) tools.extract_vq with a
     seeded S2-Pro codec.pth on three seeded 3 s waveforms: the codes
     equal encode_reference's; #1, #2 and #11 launch; under 150 s;
 12. training and the vocoder under the (data, model) mesh (phase 11's
     engines freed): two ranks of this script (--mesh-rank) on cuda:0,
     one gloo world serving a (data 1, model 2) and a (data 2, model 1)
     mesh. (a) A full finetune of S2-Pro at full width and depth in
     bf16, weights drawn from the seed, under (1, 2): rank 0 first takes
     a TP = 1 step on the whole tree with the same batch (LR 0, so the
     tree stays as drawn), then both ranks take two make_train_step steps
     at batch 2 x 512 on their slices; step 1's loss and grad_norm within
     1e-2 and 5e-2 relative of TP = 1's, finite after step 2, the
     replicated leaves bit-equal on both ranks, peak memory and seconds
     a step reported. (b) The training CLI (--lora, 2 steps, checkpoint
     every step, --device cuda:0) on a full-width native checkpoint and
     phase 9's corpus, as one process here and as two ranks under
     torchrun's environment with --data-parallel 2, at the same global
     batch, both steps at LR > 0: losses within 1e-2 and grad_norm (the
     data-summed gradient's norm) within 5e-2 relative a step, each
     final factor within 2^-2 of its L2 norm (Adam's first steps are
     near sign(gradient), so an entry whose gradient nearly cancels
     follows the bf16 sums' last bits; the factors over 2^-5 are
     reported), rank 0 alone logging. (c) The vocoder over (2,
     1): four seeded 64-frame code sequences at S2-Pro codec width, two a
     rank, the gathered waveform within 2^-5 of rank 0's decode of all
     four; #3 and #4 launch on both ranks, and no kernel in (a) or (b).
     Under 240 s. The ranks time-share the card: the phase's seconds are
     no measure of parallel speed.
Each request must give codes in range and a finite waveform in [-1, 1] of
frames x 2048 samples, and must launch the kernels of its route and none of
the other route's. Launch counts are set to 0 just before each path.
Phase 3 also checks the position-major bf16 attention entry and the int8
vocoder entries against their plain versions, and measures the int8
vocoder's waveform against the bf16 one's (not a check).

Output: the `{"voc_quant_vs_bf16": ...}` line, one JSON line per request,
the `{"scheduler": ...}`, `{"codec": ...}`, `{"server": ...}`,
`{"train": ...}`, `{"parallel": ...}`, `{"tools": ...}` and `{"mesh":
...}` lines, then the
`{"kernels": [...]}` line, the card's name and power limit, one compact
`{"phase": ...}` line a phase (ok, seconds, launches, key numbers: the
earlier lines may fall outside a 24 KB tail of the output), and last the
`{"ok": true, ...}` line.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import torch

# bytes/s and operations/s of one H100 SXM (dense, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
SM_CYCLES_PER_S = 2.0e9   # above the H100's 1.98 GHz boost clock

SEED = 0
MAX_NEW_TOKENS = 96   # frames per request, at most (~4.5 s of audio)
W4A8_NEW_TOKENS = 64  # frames per request of the W4A8 path, at most
HEAD_NEW_TOKENS = 32  # frames per request of a head-major route, at most
FRAMES = 128          # codec frames for the vocoder kernel checks
GROUPSIZE = 128       # int4 group size of the W4A8 path
PREFILL_M = 256       # rows of a prefill product (a 256-token prompt bucket)
BATCH_M = 40          # rows of a batched decode product
L2_BYTES = 50e6       # timing loops rotate over more than twice this
SCHED_SLOTS = 4       # phase 6: decode slots,
SCHED_CHUNK = 4       # decode ticks a read-back while no request waits,
PREFILL_CHUNK = 64    # prompt columns a prefill chunk
SCHED_STAGGER_S = 0.4  # between the concurrent requests' arrivals
STREAM_CHUNK = 16     # phase 7: stream_tts's chunk, in frames,
STREAM_FIRST = 4      # its first cut,
# and its audio against the plain f32 full decode: both f32 (no TF32), the
# convs over chunks against over the whole sequence, so the sums run in
# other orders; a wrong context or tail would be off by ~0.1
STREAM_TOL = 1e-3
ENCODE_SECONDS = 3.0  # the encode_reference waveform
BATCH_FRAMES = (37, 52)  # two more sequences of decode_codes_batch
# a batched item against its own decode_codes: bf16 vocoder kernels at
# another batch and frame bucket (other tiles, other sum orders), the bound
# the kernels have against their twins, 2^-5 of the waveform
BATCH_TOL = 2 ** -5
# #3/#4 against their twins at decode_codes_batch's batches: 4 (three
# sequences) and 8 (its micro-batch, warmup_vocoder's default bucket)
BATCH_TWIN_FRAMES = 64
TWIN_BATCHES = (4, 8)
CODEC_PHASE_S = 120.0
SERVER_CACHE_LEN = 2048  # phase 8: the served engine's cache,
SERVER_KEY = "smoke-key"  # its API key,
SERVER_NEW_TOKENS = 16   # the buffered JSON request's frames at most,
SERVER_SHORT_TOKENS = 12  # every other request's
TRAIN_SPEAKERS = 2      # phase 9: the synthetic corpus's speakers,
TRAIN_CLIPS = 8         # clips a speaker,
TRAIN_BATCH = 2         # the training batch,
TRAIN_LEN = 1024        # its tokens a row at most,
LORA_STEPS = 4          # the LoRA CLI's steps,
FULL_STEPS = 3          # the full finetune's
# phase 6's requests: (text, voice reference (its frames) or None, frames
# at most). Without a reference the system prompt is the default one, a
# prefix all of them share (the first misses, the others hit); the two
# references are prefixes of their own. The suffix is the text's bytes + 20
# tokens: only the fourth is longer than PREFILL_CHUNK (prefilled in
# chunks). Every prompt has another length.
SCHED_REQUESTS = (
    ("Hello there, this is request one.", None, 20),
    ("Request two shares the system prompt.", None, 24),
    ("Request three has a voice reference.", 12, 16),
    ("The fourth request is the long one: its prompt does not fit in one "
     "prefill chunk, so it is prefilled in pieces.", None, 22),
    ("Four and a fifth.", 20, 18),
    ("Six: the last one.", None, 20),
)
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
    """Mean device time of fn() over `reps` back-to-back calls. A sleep
    kernel holds the device while the host enqueues the calls, so that the
    events time the device's work, not the host's rate of launching (a
    wrapper's Python takes tens of microseconds, longer than many of these
    kernels run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(1.0, 2 * enqueue_s * reps) * SM_CYCLES_PER_S))
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


def rotation(tensors) -> list:
    """Copies of `tensors`, enough that cycling through them reads more
    than twice the L2 (so a timed call finds its operands in device memory,
    as on the main path, and not in the 50 MB L2)."""
    n = max(1, math.ceil(2 * L2_BYTES / nbytes(*tensors)))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def cycle(items):
    while True:
        yield from items


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


def attn_plan(b: int, s: int, hkv: int, g: int, dev,
              kernel: str = "pos") -> dict:
    """The decode-attention kernel's (`kernel`: "pos" or "head") chunks of
    a row's keys and their CTAs at these shapes (logged with each case):
    n_split chunks of `chunk` keys; whole rows (one CTA a row) or one CTA
    a chunk and a group of g / hs query heads."""
    from fish_speech_tpu_torch.ops import attention as ta
    from fish_speech_tpu_torch.ops._cuda import sm_count

    n_sm = sm_count(dev.index or 0)
    n_split, chunk = ta.head_split(s)
    whole, hs = ta.cta_plan(n_split, b, hkv, g, n_sm, kernel)
    return {"n_split": n_split, "chunk": chunk, "whole_rows": whole,
            "head_groups": hs,
            "ctas": (1 if whole else n_split * hs) * b * hkv,
            "scratch_bytes": 0 if whole else b * hkv * n_split * g * 130 * 4}


def check_attention(chk: Checks, cfg, dev,
                    gen) -> tuple[list[dict], list[dict]]:
    """#1 on the position-major cache at the bench shape (B=256, S=384,
    ragged rows), at the main path's (B=1, S=2048, full) and early in such
    a request (B=1, S=2048, keys 0-255: the kernel's split over CTAs leaves
    most splits empty): the int8 cache (decode_attention_stream) and the
    bf16 cache (decode_attention_stream_bf16). Timing walks the 36 layers,
    as a decode step does, so every launch reads its layer from device
    memory."""
    from fish_speech_tpu_torch.ops.attention import (
        decode_attention_stream, decode_attention_stream_plain)

    n_layer, hkv, d = cfg.n_layer, cfg.n_local_heads, cfg.head_dim
    g = cfg.n_head // hkv
    cases, bf16_cases = [], []
    for b, s, fill in ((256, 384, "ragged"), (1, 2048, "full"),
                       (1, 2048, "early")):
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
        if fill == "ragged":
            lengths = torch.randint(s // 2, s + 1, (b,), generator=gen,
                                    device=dev, dtype=torch.int32)
            starts = torch.randint(0, s // 8, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
        else:
            lengths = torch.full((b,), s if fill == "full" else 256,
                                 dtype=torch.int32, device=dev)
            starts = torch.zeros((b,), dtype=torch.int32, device=dev)
        layer = n_layer - 1
        got = decode_attention_stream(q, k, v, ks, vs, layer, lengths, starts,
                                      pos_major=True)
        ref = decode_attention_stream_plain(q, k, v, ks, vs, layer, lengths,
                                            starts, pos_major=True)
        torch.cuda.synchronize()
        it = iter(range(10 ** 9))
        ms = time_ms(lambda: decode_attention_stream(
            q, k, v, ks, vs, next(it) % n_layer, lengths, starts,
            pos_major=True), n_layer)
        plain_ms = time_ms(lambda: decode_attention_stream_plain(
            q, k, v, ks, vs, next(it) % n_layer, lengths, starts,
            pos_major=True), 6, 1)
        filled = int((lengths - starts).clamp_min(0).sum())
        row_bytes = hkv * d * 2 + hkv * 4 * 2        # int8 k+v, f32 scales
        b_ms, b_by = bound(filled * row_bytes + nbytes(q, q, lengths, starts),
                           {"int8": 2 * filled * hkv * g * d,
                            "bf16": 2 * filled * hkv * g * d})
        # outputs have magnitude <= ~1: the kernel and the plain version
        # round p * v_scale to bf16 at different running maxima and the
        # result is bf16, so they agree to a few bf16 ulps (2^-7 each)
        cases.append(chk.case("decode_attention_stream",
                              f"B={b} S={s} {fill}", max_err(got, ref),
                              1.5e-2, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, filled_positions=filled,
                              fill=fill, **attn_plan(b, s, hkv, g, dev)))
        del k, v, ks, vs
        torch.cuda.empty_cache()
        bf16_cases.append(check_attention_pos_bf16(
            chk, q, lengths, starts, n_layer, s, fill, dev, gen))
    return cases, bf16_cases


def check_attention_pos_bf16(chk: Checks, q, lengths, starts, n_layer: int,
                             s: int, fill: str, dev, gen) -> dict:
    """#1 on a position-major bf16 cache (L, S, B, Hkv, D), the same q and
    rows. Library yardstick: one scaled_dot_product_attention (GQA, boolean
    mask) on the layer's (B, Hkv, S, D) views of k and v."""
    from fish_speech_tpu_torch.ops.attention import (
        decode_attention_stream, decode_attention_stream_plain)

    b, hkv, g, d = q.shape
    shape = (n_layer, s, b, hkv, d)
    k = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    v = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    for li in range(n_layer):
        k[li] = torch.randn(shape[1:], generator=gen, device=dev)
        v[li] = torch.randn(shape[1:], generator=gen, device=dev)
    pos = torch.arange(s, device=dev)
    mask = ((pos[None] >= starts[:, None])
            & (pos[None] < lengths[:, None]))[:, None, None, :]
    layer = n_layer - 1
    got = decode_attention_stream(q, k, v, None, None, layer, lengths, starts,
                                  pos_major=True)
    ref = decode_attention_stream_plain(q, k, v, None, None, layer, lengths,
                                        starts, pos_major=True)
    torch.cuda.synchronize()
    it = iter(range(10 ** 9))
    ms = time_ms(lambda: decode_attention_stream(
        q, k, v, None, None, next(it) % n_layer, lengths, starts,
        pos_major=True), n_layer)
    plain_ms = time_ms(lambda: decode_attention_stream_plain(
        q, k, v, None, None, next(it) % n_layer, lengths, starts,
        pos_major=True), 4, 1)
    qh = q.reshape(b, hkv * g, 1, d)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(li):
        return sdpa(qh, k[li].permute(1, 2, 0, 3), v[li].permute(1, 2, 0, 3),
                    attn_mask=mask, enable_gqa=True)
    try:
        library_ms = time_ms(lambda: library(next(it) % n_layer), n_layer)
    except TypeError as e:   # a PyTorch without enable_gqa
        log(f"  scaled_dot_product_attention: {e}")
        library_ms = None
    filled = int((lengths - starts).clamp_min(0).sum())
    b_ms, b_by = bound(filled * hkv * 2 * 2 * d
                       + nbytes(q, q, lengths, starts),
                       {"bf16": 4 * filled * hkv * g * d})
    # p is rounded to bf16 at the kernel's running maxima and at the plain
    # version's exact one: 2 bf16 ulps of the largest output
    top = ref.float().abs().max().item()
    tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    case = chk.case("decode_attention_stream_bf16", f"B={b} S={s} {fill}",
                    max_err(got, ref), tol, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                    filled_positions=filled, b=b, fill=fill,
                    **attn_plan(b, s, hkv, g, dev))
    del k, v
    torch.cuda.empty_cache()
    return case


# the head-major entries: (C entry, wrapper, replaces, (cache, int8_scores)
# cases, the headline case at batch 1)
_ATT = "fish_speech_tpu/ops/attention.py"
HEAD_ENTRIES = (
    ("decode_attention_stream_head", "stream", f"{_ATT}:910",
     (("int8", True), ("int8", False), ("bf16", False)), ("int8", True)),
    ("decode_attention_blocks", "blocks", f"{_ATT}:614",
     (("int8", True), ("int8", False), ("bf16", False)), ("int8", True)),
    ("decode_attention_stacked_rows", "stacked_rows", f"{_ATT}:432",
     (("int8", False), ("bf16", False)), ("bf16", False)),
    ("decode_attention_stacked", "stacked", f"{_ATT}:277",
     (("int8", False), ("bf16", False)), ("bf16", False)),
    ("decode_attention", "dense", f"{_ATT}:50", (("bf16", False),),
     ("bf16", False)),
    ("decode_attention_chunked", "chunked", f"{_ATT}:150",
     (("bf16", False),), ("bf16", False)),
)
F32_ENTRIES = ("stacked", "dense", "chunked")


def head_call(entry: str, plain: bool, q, k, v, ks, vs, layer: int,
              lengths, starts, int8_scores: bool):
    """One head-major entry (or its plain version) on layer `layer` of the
    stacked cache; the per-layer entries get that layer's (B, Hkv, S, D)."""
    from fish_speech_tpu_torch.ops import attention as ta

    sfx = "_plain" if plain else ""
    stacked = (q, k, v, ks, vs, layer, lengths, starts)
    if entry == "stream":
        return getattr(ta, "decode_attention_stream" + sfx)(
            *stacked, int8_scores, pos_major=False)
    if entry == "blocks":
        return getattr(ta, "decode_attention_blocks" + sfx)(
            *stacked, int8_scores=int8_scores)
    if entry in ("stacked_rows", "stacked"):
        return getattr(ta, f"decode_attention_{entry}{sfx}")(*stacked)
    name = "decode_attention" if entry == "dense" else \
        "decode_attention_chunked"
    return getattr(ta, name + sfx)(q, k[layer], v[layer], lengths, starts)


def check_attention_head(chk: Checks, cfg, dev, gen) -> dict:
    """#1 head-major and #6-#10 at the main path's shape (B=1, S=2048,
    full), early in such a request (B=1, S=2048, keys 0-255: the kernel's
    split over CTAs leaves most splits empty) and the bench shape (B=256,
    S=384, ragged), on the int8 and the bf16 cache wherever the entry
    takes both, blocks and stream with and without int8 scores. Timing
    walks the 36 layers. Library yardstick for a bf16 cache: one
    scaled_dot_product_attention over the same q, k, v and a boolean mask
    (GQA); none computes the int8 cache's function. Also times the
    per-layer int8 route's eager dequantization of one layer (k and v,
    bf16 products). Returns {C entry: cases}."""
    n_layer, hkv, d = cfg.n_layer, cfg.n_local_heads, cfg.head_dim
    g = cfg.n_head // hkv
    cases = {name: [] for name, *_ in HEAD_ENTRIES}
    dequant = []
    for b, s, fill in ((1, 2048, "full"), (1, 2048, "early"),
                       (256, 384, "ragged")):
        q = torch.randn((b, hkv, g, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        if fill == "ragged":
            lengths = torch.randint(s // 2, s + 1, (b,), generator=gen,
                                    device=dev, dtype=torch.int32)
            starts = torch.randint(0, s // 8, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
        else:
            lengths = torch.full((b,), s if fill == "full" else 256,
                                 dtype=torch.int32, device=dev)
            starts = torch.zeros((b,), dtype=torch.int32, device=dev)
        split = attn_plan(b, s, hkv, g, dev, "head")
        log(f"  head-major B={b} S={s} {fill}: {split}")
        pos = torch.arange(s, device=dev)
        mask = ((pos[None] >= starts[:, None])
                & (pos[None] < lengths[:, None]))[:, None, None, :]
        filled = int((lengths - starts).clamp_min(0).sum())
        shape = (n_layer, b, hkv, s, d)
        for kind in ("int8", "bf16"):
            if kind == "int8":
                k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                                  dtype=torch.int8)
                v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                                  dtype=torch.int8)
                ks = torch.rand(shape[:-1], generator=gen, device=dev)
                ks = ks * 0.02 + 1e-3
                vs = torch.rand(shape[:-1], generator=gen, device=dev)
                vs = vs * 0.02 + 1e-3
                row_bytes = hkv * (2 * d + 2 * 4)   # int8 k+v, f32 scales
                library_ms = None
                it = iter(range(10 ** 9))

                def deq():
                    li = next(it) % n_layer
                    return (k[li].to(torch.bfloat16)
                            * ks[li][..., None].to(torch.bfloat16),
                            v[li].to(torch.bfloat16)
                            * vs[li][..., None].to(torch.bfloat16))
                dequant.append({"b": b, "s": s, "fill": fill,
                                "ms": time_ms(deq, n_layer)})
                log(f"  per-layer int8 dequant (k and v, one layer) B={b} "
                    f"S={s} {fill}: {dequant[-1]['ms']:.4g} ms")
            else:
                k = torch.empty(shape, dtype=torch.bfloat16, device=dev)
                v = torch.empty(shape, dtype=torch.bfloat16, device=dev)
                for li in range(n_layer):
                    k[li] = torch.randn(shape[1:], generator=gen, device=dev)
                    v[li] = torch.randn(shape[1:], generator=gen, device=dev)
                ks = vs = None
                row_bytes = hkv * 2 * 2 * d               # bf16 k+v
                qh = q.reshape(b, hkv * g, 1, d)
                it = iter(range(10 ** 9))
                sdpa = torch.nn.functional.scaled_dot_product_attention

                def library(li):
                    return sdpa(qh, k[li], v[li], attn_mask=mask,
                                enable_gqa=True)
                try:
                    library_ms = time_ms(
                        lambda: library(next(it) % n_layer), n_layer)
                except TypeError as e:   # a PyTorch without enable_gqa
                    log(f"  scaled_dot_product_attention: {e}")
                    library_ms = None
            for name, entry, _, kinds, _ in HEAD_ENTRIES:
                for ck, i8 in kinds:
                    if ck != kind:
                        continue
                    args = (q, k, v, ks, vs)
                    got = head_call(entry, False, *args, n_layer - 1,
                                    lengths, starts, i8)
                    ref = head_call(entry, True, *args, n_layer - 1,
                                    lengths, starts, i8)
                    torch.cuda.synchronize()
                    it = iter(range(10 ** 9))
                    ms = time_ms(lambda: head_call(
                        entry, False, *args, next(it) % n_layer, lengths,
                        starts, i8), n_layer)
                    plain_ms = time_ms(lambda: head_call(
                        entry, True, *args, next(it) % n_layer, lengths,
                        starts, i8), 4, 1)
                    macs = 2 * filled * hkv * g * d    # scores + values
                    if entry in F32_ENTRIES:
                        ops = {"f32": 2 * macs}
                    elif i8:
                        ops = {"int8": macs, "bf16": macs}
                    else:
                        ops = {"bf16": 2 * macs}
                    b_ms, b_by = bound(filled * row_bytes
                                       + nbytes(q, q, lengths, starts), ops)
                    # bf16 outputs: the value weights are rounded to bf16
                    # at the kernel's running maxima and at the plain
                    # version's exact one: 2 bf16 ulps of the largest
                    # output (ulp = 2^-7 of its binade)
                    top = ref.float().abs().max().item()
                    tol = 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
                    label = (f"{kind}{' int8 scores' if i8 else ''} B={b} "
                             f"S={s} {fill}")
                    cases[name].append(chk.case(
                        name, label, max_err(got, ref), tol, ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=library_ms, filled_positions=filled,
                        cache=kind, int8_scores=i8, b=b, fill=fill,
                        **split))
            del k, v, ks, vs
            torch.cuda.empty_cache()
    cases["decode_attention"][0]["int8_scan_dequant"] = dequant
    return cases


def w4a8_case_plan(m: int, n: int, k: int, pc: bool, dev) -> dict:
    """The W4A8 kernel's plan at these shapes (logged with each case): the
    stream's columns a CTA, cluster and part bytes (M <= 8), or the tile
    and its K parts."""
    from fish_speech_tpu_torch.ops._cuda import sm_count
    from fish_speech_tpu_torch.ops.w4a8 import STREAM_BN, TILES, w4a8_plan

    tile, n_split, part = w4a8_plan(m, n, k, k // GROUPSIZE,
                                    sm_count(dev.index or 0), pc)
    if tile == 0:
        return {"tile": "stream", "bn": STREAM_BN, "cluster": n_split,
                "part": part}
    return {"tile": "x".join(map(str, TILES[tile])), "n_split": n_split,
            "part": part}


# CUgraphNodeType of the CUDA driver API (cuda.h)
GRAPH_NODE_KINDS = ("KERNEL", "MEMCPY", "MEMSET", "HOST", "GRAPH", "EMPTY",
                    "WAIT_EVENT", "EVENT_RECORD", "EXT_SEMAS_SIGNAL",
                    "EXT_SEMAS_WAIT", "MEM_ALLOC", "MEM_FREE",
                    "BATCH_MEM_OP", "CONDITIONAL")


def graph_node_kinds(graph) -> list[str]:
    """The kinds of the nodes of a graph captured with keep_graph=True
    (cuGraphGetNodes, cuGraphNodeGetType): every kernel, memset and copy
    the captured work enqueues is one node."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds.append(GRAPH_NODE_KINDS[t.value]
                     if 0 <= t.value < len(GRAPH_NODE_KINDS) else str(t.value))
    return kinds


def w4a8_capture(fn, x8, q4, gs) -> tuple[bool, list[str]]:
    """One call captured in a CUDA graph and replayed against the eager
    call: whether the two are equal bit for bit, and the kinds of the
    graph's nodes (the device work one call enqueues)."""
    eager = fn(x8, q4, gs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn(x8, q4, gs)
    kinds = graph_node_kinds(graph)
    graph.instantiate()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(out, eager)
    del graph, out
    return same, kinds


def check_w4a8(chk: Checks, cfg, dev, gen,
               rows=(1, 8, BATCH_M, PREFILL_M),
               plans: bool = True) -> tuple[list[dict], list[dict]]:
    """#11 and #12 at the slow stack's five products (wqkv, wo, w1, w3,
    w2) at `rows` rows M (decode at 1, the weight stream's widest case at
    8, a batched decode at 40, prefill at 256), on int4 weights quantized
    from random ones; with `plans`, each case logs the kernel's plan (the
    stream's cluster and part bytes, or the tile and its K parts) and, up
    to 8 rows, the work one call enqueues, from the nodes of a CUDA graph
    that captures it, which must be one kernel (the stream: no memset, no
    second kernel), that graph's replay, which must equal the eager call,
    and the device kernels the profiler records for a call, which must be
    one where it keeps a record. Both kernels must equal their plain
    versions bit for bit (exact int32 dots, the same f32 steps). Library
    yardstick: one torch._int_mm of the same M x K by K x N int8 product,
    on the int8 weights #12 reconstructs (for #11, the W8A8 product this
    configuration replaces)."""
    from fish_speech_tpu_torch.ops.quant import quantize_weight_int4_packed
    from fish_speech_tpu_torch.ops.w4a8 import (
        pc_weights, w4a8_matmul, w4a8_matmul_pc, w4a8_matmul_pc_plain,
        w4a8_matmul_plain)

    d, inter = cfg.dim, cfg.intermediate_size
    qkv = (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim
    products = (("wqkv", qkv, d), ("wo", d, cfg.n_head * cfg.head_dim),
                ("w1", inter, d), ("w3", inter, d), ("w2", d, inter))
    grouped, pc = [], []
    for name, n, k in products:
        qw = quantize_weight_int4_packed(
            torch.randn((n, k), generator=gen, device=dev) * 0.02, GROUPSIZE)
        q4, gs = qw["q4"], qw["gs"]
        weights = rotation((q4, gs))
        lib_weights = rotation((pc_weights(q4, gs)[0],))
        for m in rows:
            x8 = torch.randint(-127, 128, (m, k), generator=gen,
                               device=dev, dtype=torch.int8)
            # torch._int_mm takes at least 17 rows: pad, outside the timing
            x8p = torch.cat([x8, x8.new_zeros(max(0, 32 - m), k)])
            it = cycle(lib_weights)
            library_ms = time_ms(
                lambda: torch._int_mm(x8p, next(it)[0].t()),
                2 * len(lib_weights))
            b_ms, b_by = bound(nbytes(x8, q4, gs) + 4 * m * n,
                               {"int8": 2 * m * n * k})
            for fn, plain, out in ((w4a8_matmul, w4a8_matmul_plain, grouped),
                                   (w4a8_matmul_pc, w4a8_matmul_pc_plain,
                                    pc)):
                got = fn(x8, q4, gs)
                ref = plain(x8, q4, gs)
                torch.cuda.synchronize()
                it = cycle(weights)
                ms = time_ms(lambda: fn(x8, *next(it)), 2 * len(weights))
                plain_ms = time_ms(lambda: plain(x8, *next(it)), 3, 1)
                label = f"{name} M={m} N={n} K={k}"
                extra = {}
                if plans:
                    extra["plan"] = w4a8_case_plan(m, n, k,
                                                   fn is w4a8_matmul_pc, dev)
                if plans and m <= 8:
                    same, kinds = w4a8_capture(fn, x8, q4, gs)
                    extra["graph_equal"] = same
                    extra["graph_nodes"] = kinds
                    if not same:
                        chk.failed.append(f"{fn.__name__} [{label}]: the "
                                          f"captured call differs")
                    if kinds != ["KERNEL"]:
                        chk.failed.append(f"{fn.__name__} [{label}]: a call "
                                          f"enqueues {kinds}")
                    # the profiler's record, where it keeps one, must agree
                    names, _ = device_kernels(lambda: fn(x8, q4, gs))
                    extra["device_kernels"] = sorted({s[:40] for s in names})
                    if names and len(names) != 1:
                        chk.failed.append(f"{fn.__name__} [{label}]: "
                                          f"{len(names)} device kernels a "
                                          f"call")
                out.append(chk.case(
                    fn.__name__, label, max_err(got, ref), 0.0, ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=library_ms, m=m, **extra,
                    bit_equal=bool(torch.equal(got, ref))))
        del weights, lib_weights
    torch.cuda.empty_cache()
    return grouped, pc


def check_fold(chk: Checks, cfg, dev, gen) -> list[dict]:
    """#5 at the main path's shape (B=1, S=2048, writing the last slot: the
    last of the kernel's splits), the bench shape (B=256, S=384, mixed
    starts, the last slot; one split), and at B=1, S=2048 early in a
    request (keys 0-255, writing slot 255: a middle split) and at its start
    (keys 0-39: the first split). The keys end at the written slot. It must
    equal writing the rows with the model's _write_cache and then launching
    #1, bit for bit (output, int8 rows, scales); its error against its
    plain version has #1's tolerance. Timing walks the 36 layers, as a
    decode step does."""
    from fish_speech_tpu_torch.models.dual_ar import KVCache, _write_cache
    from fish_speech_tpu_torch.ops.attention import (
        decode_attention_stream, decode_attention_stream_fold,
        decode_attention_stream_fold_plain)

    n_layer, hkv, d = cfg.n_layer, cfg.n_local_heads, cfg.head_dim
    g = cfg.n_head // hkv
    cases = []
    for b, s, fill, wpos in ((1, 2048, "full", 2047),
                             (256, 384, "ragged", 383),
                             (1, 2048, "early", 255), (1, 2048, "first", 39)):
        kv = [torch.randint(-127, 128, (n_layer, s, b, hkv, d), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2)]
        sc = [torch.rand((n_layer, b, s * hkv), generator=gen, device=dev)
              * 0.02 + 1e-3 for _ in range(2)]
        c = KVCache(*kv, *sc, pos_major=True)
        del kv, sc

        def clone():
            return KVCache(c.k.clone(), c.v.clone(), c.ks.clone(),
                           c.vs.clone(), pos_major=True)

        q = torch.randn((b, hkv, g, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        nk = torch.randn((b, hkv, d), generator=gen,
                         device=dev).to(torch.bfloat16)
        nv = torch.randn((b, hkv, d), generator=gen,
                         device=dev).to(torch.bfloat16)
        lengths = torch.full((b,), wpos + 1, dtype=torch.int32, device=dev)
        starts = torch.randint(0, s // 2, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        starts[0] = 0
        args = (n_layer - 1, lengths, starts)
        two = clone()
        _write_cache(two, args[0], wpos, nk[:, None], nv[:, None])
        ref2 = decode_attention_stream(q, two.k, two.v, two.ks, two.vs, *args,
                                       pos_major=True)
        pc = clone()
        ref = decode_attention_stream_fold_plain(
            q, pc.k, pc.v, pc.ks, pc.vs, *args, nk, nv, wpos)
        del pc
        got = decode_attention_stream_fold(q, c.k, c.v, c.ks, c.vs, *args, nk,
                                           nv, wpos)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in (
            (got, ref2), (c.k, two.k), (c.v, two.v), (c.ks, two.ks),
            (c.vs, two.vs)))
        del two
        torch.cuda.empty_cache()
        split = attn_plan(b, s, hkv, g, dev)
        label = f"B={b} S={s} {fill} write_pos={wpos}"
        if not same:
            chk.failed.append(f"decode_attention_stream_fold [{label}]: "
                              f"not bit-equal to _write_cache + #1")
        it = iter(range(10 ** 9))
        ms = time_ms(lambda: decode_attention_stream_fold(
            q, c.k, c.v, c.ks, c.vs, next(it) % n_layer, lengths, starts,
            nk, nv, wpos), n_layer)
        plain_ms = time_ms(lambda: decode_attention_stream_fold_plain(
            q, c.k, c.v, c.ks, c.vs, next(it) % n_layer, lengths, starts,
            nk, nv, wpos), 6, 1)
        filled = int((lengths - starts).clamp_min(0).sum())
        row_bytes = hkv * d * 2 + hkv * 4 * 2        # int8 k+v, f32 scales
        new_rows = b * row_bytes + nbytes(nk, nv)    # written + read
        b_ms, b_by = bound(filled * row_bytes + new_rows
                           + nbytes(q, q, lengths, starts),
                           {"int8": 2 * filled * hkv * g * d,
                            "bf16": 2 * filled * hkv * g * d})
        # #1's tolerance: the plain version takes one exact softmax
        cases.append(chk.case("decode_attention_stream_fold", label,
                              max_err(got, ref), 1.5e-2, ms=ms,
                              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                              filled_positions=filled, fill=fill,
                              write_pos=wpos,
                              write_split=wpos // split["chunk"],
                              two_step_bit_equal=same, **split))
        del c
        torch.cuda.empty_cache()
    return cases


def _clone_cache(c, n_layer=None):
    from fish_speech_tpu_torch.ops.fast_fused import FusedFastCache

    return FusedFastCache(*(t[:n_layer].clone() for t in (c.k, c.v, c.ks,
                                                          c.vs)))


def device_kernels(fn, tries: int = 3,
                   times: list | None = None) -> tuple[list[str], int]:
    """Names of the device kernels (and copies) one call of fn runs, from
    torch.profiler, and the calls made. A profiler session now and then
    records no device event at all (seen once in four on the H100, and
    three sessions in a row once): an empty record is taken again, after a
    pause, up to `tries` sessions in all, each with one call of fn. The
    names are the last session's, so those of one call; they are empty if
    no session kept a record. `times`, where given, receives each of them
    with its device time in us, in launch order."""
    from torch.profiler import ProfilerActivity, profile

    for calls in range(1, tries + 1):
        if calls > 1:
            time.sleep(0.5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    if times is not None:
        times[:] = [(e.name[:40], e.device_time_total) for e in events]
    return [e.name for e in events], calls


def sweep_capture_equal(packed, x, base, freqs, pos: int, kw: dict) -> bool:
    """One sweep captured in a CUDA graph and replayed against the eager
    call on a copy of the same cache: output and cache bit for bit."""
    from fish_speech_tpu_torch.ops.fast_fused import fused_fast_sweep

    eager_cache, graph_cache = _clone_cache(base), _clone_cache(base)
    eager = fused_fast_sweep(packed, x, eager_cache, freqs, pos=pos, **kw)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_fast_sweep(packed, x, graph_cache, freqs, pos=pos, **kw)
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(out, eager) and all(
        torch.equal(getattr(graph_cache, n), getattr(eager_cache, n))
        for n in ("k", "v", "ks", "vs"))
    del graph, out
    return same


def check_fast_sweep(chk: Checks, cfg, packed: dict, dev, gen,
                     batches=(256, 1)) -> list[dict]:
    """#2 on the engine's packed fast stack at `batches`, at pos 0 and
    pos 9; positions before `pos` are filled by plain sweeps first. Each
    case logs the kernel's cooperative grid (CTAs, CTAs an SM), its grid
    barriers a sweep, and the device kernels one call runs (profiler: must
    be one); at pos 9 one sweep is captured in a CUDA graph and replayed,
    and must equal the eager call bit for bit.

    Tolerance. Both sides round at the same points (bf16 where the TPU
    kernel rounds, int8 activations and cache) and the kernel's int32
    products are exact, so after one layer the output must be bit-equal to
    the plain twin's (its error against 2^-6 of the output's scale is
    logged too). Over all layers exp and the SiLU's sigmoid, which the two
    sides take from different math libraries, may move a bf16 rounding by
    one ulp; the
    int8 quantizations that follow turn such a step into a whole int8 step,
    and 28 random-weight layers amplify it. So at full depth the kernel must
    stay within twice the plain version's own spread: its change when 1% of
    the inputs move by one bf16 ulp (measured here, on the same inputs). At
    B=1 the cache row it writes must equal the twin's in every layer."""
    from fish_speech_tpu_torch.models.dual_ar import precompute_freqs_cis
    from fish_speech_tpu_torch.ops.fast_fused import (
        KERNEL, FusedFastCache, fused_fast_sweep, fused_fast_sweep_plain,
        sweep_grid, sweep_phase_times, sweep_plan)

    n_layer, dim, n_pos = cfg.n_fast_layer, cfg.fast_dim, cfg.num_codebooks
    freqs = precompute_freqs_cis(n_pos, cfg.fast_head_dim, cfg.rope_base, dev)
    kw = dict(n_head=cfg.fast_n_head, eps=cfg.norm_eps)
    layer0 = {k: v[:1].contiguous() for k, v in packed.items()}
    cases = []
    for b in batches:
        xs = torch.randn((n_pos, b, dim), generator=gen,
                         device=dev).to(torch.bfloat16)
        base = FusedFastCache.create(n_layer, n_pos, b, dim, dev)
        plan = sweep_plan(b, dim, n_layer, *sweep_grid(dev))
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
                prof_cache = _clone_cache(base)
                before = KERNEL.launches
                sweep_kernels, calls = device_kernels(
                    lambda: fused_fast_sweep(packed, x, prof_cache, freqs,
                                             pos=pos, **kw))
                per_call = (KERNEL.launches - before) / calls
                del prof_cache
                captured = None
                if pos == n_pos - 1:
                    captured = sweep_capture_equal(packed, x, base, freqs,
                                                   pos, kw)
                    log(f"  fast_sweep [B={b} pos={pos}] CUDA graph capture "
                        f"and replay bit-equal to the eager call: {captured}")
                    if not captured:
                        chk.failed.append(f"fast_sweep [B={b} pos={pos}] "
                                          f"captured sweep differs")
                ms = time_ms(lambda: fused_fast_sweep(
                    packed, xs[pos], ck, freqs, pos=pos, **kw), 10)
                plain_ms = time_ms(lambda: fused_fast_sweep_plain(
                    packed, xs[pos], cp, freqs, pos=pos, **kw), 3, 1)
                trace = torch.zeros((plan["barriers"] + 1, 2, plan["grid"]),
                                    dtype=torch.int64, device=dev)
                fused_fast_sweep(packed, x, _clone_cache(base), freqs,
                                 pos=pos, trace=trace, **kw)
                phases = sweep_phase_times(trace, plan["phases"])
                log(f"  fast_sweep [B={b} pos={pos}] a layer's phases (us, "
                    f"work mean / slowest CTA / barrier): " + ", ".join(
                        f"{phases[f'p{i}_work_mean_us']:.2f}/"
                        f"{phases[f'p{i}_work_max_us']:.2f}/"
                        f"{phases[f'p{i}_barrier_us']:.2f}"
                        for i in range(plan["phases"])))
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
                if not torch.equal(got1, ref1):
                    chk.failed.append(f"fast_sweep [B={b} pos={pos}] one "
                                      f"layer not bit-equal: {err1:.3e}")
                if b == 1 and kv_mismatch:
                    chk.failed.append(f"fast_sweep [B=1 pos={pos}] cache "
                                      f"int8 mismatch {kv_mismatch:.3e}")
                # one call: one launch of the C entry (one cudaLaunchKernelEx)
                # and, where the profiler saw the call, one device kernel
                if len(sweep_kernels) > 1 or per_call != 1:
                    chk.failed.append(f"fast_sweep [B={b} pos={pos}]: one "
                                      f"call made {per_call} launches, ran "
                                      f"{sweep_kernels}")
                cases.append(chk.case(
                    "fast_sweep", f"B={b} pos={pos}", max_err(got, ref),
                    2 * spread, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, plain_spread=spread,
                    one_layer_err=err1, one_layer_tol=tol1,
                    one_layer_bit_equal=bool(torch.equal(got1, ref1)),
                    cache_int8_mismatch=kv_mismatch, grid_ctas=plan["grid"],
                    ctas_per_sm=plan["ctas_per_sm"],
                    barriers_per_sweep=plan["barriers"],
                    device_kernels_per_call=len(sweep_kernels),
                    device_kernel=sweep_kernels[0][:40] if sweep_kernels
                    else None, capture_bit_equal=captured))
            fused_fast_sweep_plain(packed, xs[pos], base, freqs, pos=pos,
                                   **kw)
    return cases


def vocoder_inputs(engine, frames: int, dev, gen, batch: int = 1):
    """The decoder's activations for `batch` rows of `frames` random codes,
    through the plain path: block 0's residual-stack input, then each fused
    block's."""
    from fish_speech_tpu_torch.codec.fastpath import (
        conv1d_mm, conv_transpose1d_phases, rvq_decode_mm)
    from fish_speech_tpu_torch.codec.nn import snake

    ccfg, packed = engine.codec_cfg, engine.packed_decoder
    codes = torch.randint(0, ccfg.rvq.codebook_size,
                          (batch, ccfg.rvq.n_codebooks + 1, frames),
                          generator=gen, device=dev)
    z = rvq_decode_mm(engine.codec_params["quantizer"], ccfg.rvq, codes)
    x = conv1d_mm(z.to(torch.bfloat16), packed["conv_in_w"],
                  packed["conv_in_b"])
    pb0 = packed["blocks"][0]
    x = snake(x.float(), pb0["snake_alpha"]).to(torch.bfloat16)
    return conv_transpose1d_phases(x, pb0["tconv_phases"], pb0["tconv_b"],
                                   stride=ccfg.decoder_rates[0])


def res_stack_block0(x, pb, fn, tt=None):
    """Block 0's residual units, one call per unit as decoder_fused runs
    them; fn is fused_res_stack or its plain version (tt: an int8 pack's
    tile)."""
    from fish_speech_tpu_torch.ops.voc_fused import DILATIONS

    for u, d in enumerate(DILATIONS):
        sub = {k: v[u:u + 1] for k, v in pb["res"].items()}
        last = u == len(DILATIONS) - 1
        x = fn(x, sub, dilations=(d,), tail_vec=pb["tail_vec"] if last
               else None, tt=tt)
    return x


def unit_flops(t: int, c: int, n_units: int) -> int:
    """k7 conv + 1x1 conv of `n_units` residual units over t rows."""
    return n_units * t * 2 * 8 * c * c


def pass_plan(plan_name: str, dev, *args) -> dict:
    """A vocoder kernel's plan for this call (logged with its case):
    `voc_block_plan`, `voc_res_plan` or `voc_i8_plan` of ops/voc_fused.py
    at `args` and the card's SM count; each pass's tile and CTAs, and the
    device kernels a call runs; {} for a package without that plan
    (kernel_bench --tree)."""
    from fish_speech_tpu_torch.ops import _cuda, voc_fused

    plan_fn = getattr(voc_fused, plan_name, None)
    if plan_fn is None:
        return {}
    plan = plan_fn(*args, _cuda.sm_count(dev.index or 0))
    return {"plan": [f"{q['name']}: {q['bm']}x{q['bn']} {q['ctas']} CTAs"
                     for q in plan["passes"]],
            "plan_device_kernels": plan["device_kernels"]}


def with_biases(pb: dict, gen) -> dict:
    """A copy of a block's pack whose units' conv biases (rows 4 and 5 of
    each unit's vec) are drawn from `gen`, N(0, 0.1): the random codec
    init leaves them at zero, as JAX's does."""
    vec = pb["res"]["vec"].clone()
    vec[:, 4:6] = 0.1 * torch.randn(vec[:, 4:6].shape, generator=gen,
                                    device=vec.device)
    return {**pb, "res": {**pb["res"], "vec": vec}}


def check_vocoder(chk: Checks, engine, frames: int, dev, gen,
                  batch: int = 1) -> tuple[list[dict], list[dict]]:
    """#4 (block 0's residual stack, 3 calls) and #3 (blocks 1-3, the last
    with the final conv and tanh) on the engine's packed decoder (`engine`
    needs codec_cfg, codec_params and packed_decoder) at `batch` rows of
    `frames` codec frames; #4 with its conv biases drawn from `gen`
    (`with_biases`). Each case logs the kernel's plan and the device
    kernels one call runs (profiler); a call must count one launch."""
    from fish_speech_tpu_torch.ops.voc_fused import (
        BLOCK, DILATIONS, RES_STACK, fused_block, fused_block_plain,
        fused_res_stack, fused_res_stack_plain)

    packed, ccfg = engine.packed_decoder, engine.codec_cfg
    blocks = packed["blocks"]
    x = vocoder_inputs(engine, frames, dev, gen, batch)
    # both sides keep the state between units in bf16 with f32 sums; sums
    # in another order move a bf16 rounding by one ulp (2^-8 relative), and
    # such steps compound over the units: 2^-5 of the output's scale
    res_cases, block_cases = [], []
    pb = with_biases(blocks[0], gen)
    got = res_stack_block0(x, pb, fused_res_stack)
    ref = res_stack_block0(x, pb, fused_res_stack_plain)
    torch.cuda.synchronize()
    ms = time_ms(lambda: res_stack_block0(x, pb, fused_res_stack), 3, 1)
    plain_ms = time_ms(lambda: res_stack_block0(x, pb, fused_res_stack_plain),
                       2, 1)
    t, c = x.shape[1], x.shape[2]
    b_ms, b_by = bound(3 * nbytes(x, got) + nbytes(*(pb["res"][k] for k in (
        "w7", "w1", "vec"))), {"bf16": unit_flops(batch * t, c, 3)})
    before = RES_STACK.launches
    names, calls = device_kernels(lambda: res_stack_block0(
        x, pb, fused_res_stack))
    per_call = (RES_STACK.launches - before) / (3 * calls)
    if per_call != 1:
        chk.failed.append(f"voc_res_stack [block 0]: one call made "
                          f"{per_call} launches")
    res_cases.append(chk.case(
        "voc_res_stack", f"block 0 B={batch} F={frames} T={t} C={c}",
        max_err(got, ref), 2 ** -5 * ref.float().abs().max().item(), ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, block=0,
        frames=frames, batch=batch,
        device_kernels_per_call=len(names) / 3,
        device_kernels=sorted({n[:40] for n in names}),
        **pass_plan("voc_res_plan", dev, *x.shape, DILATIONS[0])))
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
        flops = batch * (2 * t_in * c_in * 2 * stride * c
                         + unit_flops(t, c, 3) + (2 * 7 * c * t if final
                                                  else 0))
        wts = [pb["res"][k] for k in ("tconv_pw", "tconv_pb", "w7", "w1",
                                      "vec")]
        b_ms, b_by = bound(nbytes(x, got, *wts), {"bf16": flops})
        before = BLOCK.launches
        names, calls = device_kernels(lambda: fused_block(x, pb["res"],
                                                          **kw))
        per_call = (BLOCK.launches - before) / calls
        if per_call != 1:
            chk.failed.append(f"voc_block [block {bi}]: one call made "
                              f"{per_call} launches")
        # the waveform is tanh'd into [-1, 1]: 2^-5 absolute there
        scale = 1.0 if final else ref.float().abs().max().item()
        block_cases.append(chk.case(
            "voc_block", f"block {bi} B={batch} F={frames} T={t} "
            f"C={c_in}->{c}", max_err(got, ref), 2 ** -5 * scale, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, block=bi,
            frames=frames, batch=batch,
            device_kernels_per_call=len(names),
            device_kernels=sorted({n[:40] for n in names}),
            **pass_plan("voc_block_plan", dev, *x.shape, c, stride,
                        DILATIONS, final)))
        x = ref
    return res_cases, block_cases


def i8_unit_ops(rows: int, n_tiles: int, c: int, dilations, v: int = 0
                ) -> int:
    """int8 operations of residual units over n_tiles tiles of `rows` rows
    (the valid rows start at v): each unit's k7 and 1x1 convs on the rows it
    keeps, the tile's halo recomputed, as the int8 function defines it."""
    ops = 0
    for d in dilations:
        n = rows - v - 6 * d
        ops += n_tiles * n * 2 * 8 * c * c
        v += 6 * d
    return ops


def i8_launches(chk: Checks, kernel, name: str, label: str, fn,
                n_calls: int) -> dict:
    """The device kernels one call of an int8 vocoder wrapper runs
    (profiler) and their device times, for a case's record; fails the
    case unless each of fn's n_calls calls counted one launch."""
    before = kernel.launches
    times = []
    names, calls = device_kernels(fn, times=times)
    per_call = (kernel.launches - before) / (n_calls * calls)
    if per_call != 1:
        chk.failed.append(f"{name} [{label}]: one call made {per_call} "
                          f"launches")
    return {"device_kernels_per_call": len(names) / n_calls,
            "device_kernels": sorted({n[:40] for n in names}),
            "device_kernels_us": times}


def check_vocoder_i8(chk: Checks, engine, frames: int, dev,
                     gen) -> tuple[list[dict], list[dict]]:
    """#4 and #3 on the int8 pack (VOC_QUANT) of the engine's decoder
    weights: block 0's three calls and blocks 1-3, in the JAX decoder's
    tiles, against the tile-aware plain versions. Both quantize the same
    activations to the same codes and sum them exactly, and the f32 steps
    round alike (-fmad=false): bit-equal is expected; the tolerance is one
    int8 step, 2^-7 of the largest output (2^-7 absolute for the
    waveform). Each case logs the kernel's plan and the device kernels one
    call runs, with their times (profiler); a call must count one
    launch."""
    from fish_speech_tpu_torch.codec.fastpath import (
        RES_STACK_TILE_CAP, _tile_cap, _tile_for, pack_decoder)
    from fish_speech_tpu_torch.ops.voc_fused import (
        BLOCK_I8, DILATIONS, RES_STACK_I8, fused_block, fused_block_plain,
        fused_res_stack, fused_res_stack_plain, halo_for)

    ccfg = engine.codec_cfg
    packed = pack_decoder(engine.codec_params["decoder"], ccfg,
                          dtype=torch.bfloat16, quant=True)
    blocks = packed["blocks"]
    x = vocoder_inputs(engine, frames, dev, gen)
    res_cases, block_cases = [], []
    pb = blocks[0]
    t, c = x.shape[1], x.shape[2]
    tt = _tile_for(t, RES_STACK_TILE_CAP)
    got = res_stack_block0(x, pb, fused_res_stack, tt)
    ref = res_stack_block0(x, pb, fused_res_stack_plain, tt)
    torch.cuda.synchronize()
    ms = time_ms(lambda: res_stack_block0(x, pb, fused_res_stack, tt), 3, 1)
    plain_ms = time_ms(lambda: res_stack_block0(
        x, pb, fused_res_stack_plain, tt), 2, 1)
    ops = sum(i8_unit_ops(halo_for((d,)) + tt, t // tt, c, (d,))
              for d in DILATIONS)
    b_ms, b_by = bound(3 * nbytes(x, got) + nbytes(*(pb["res"][k] for k in (
        "w7", "w1", "vec"))), {"int8": ops})
    label = f"block 0 F={frames} T={t} C={c} tt={tt}"
    plans = [pass_plan("voc_i8_plan", dev, 1, t, c, (d,), tt, None, False)
             for d in DILATIONS]
    plan = {"plan": sum((q["plan"] for q in plans), []),
            "plan_device_kernels": plans[0]["plan_device_kernels"]} \
        if plans[0] else {}
    res_cases.append(chk.case(
        "voc_res_stack_i8", label, max_err(got, ref),
        2 ** -7 * ref.float().abs().max().item(), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, bit_equal=bool(torch.equal(got, ref)),
        block=0, frames=frames, **plan, **i8_launches(
            chk, RES_STACK_I8, "voc_res_stack_i8", label,
            lambda: res_stack_block0(x, pb, fused_res_stack, tt), 3)))
    x = ref
    for bi in range(1, len(blocks)):
        pb, stride = blocks[bi], ccfg.decoder_rates[bi]
        c_in, c = x.shape[2], pb["res"]["w1"].shape[-1]
        t = x.shape[1] * stride
        tt = _tile_for(t, _tile_cap(c))
        final = bi == len(blocks) - 1 and tt % 128 == 0
        kw = dict(stride=stride, dilations=DILATIONS, tail_vec=pb["tail_vec"],
                  final_w=packed["final_fw"] if final else None, tt=tt)
        got = fused_block(x, pb["res"], **kw)
        ref = fused_block_plain(x, pb["res"], **kw)
        torch.cuda.synchronize()
        ms = time_ms(lambda: fused_block(x, pb["res"], **kw), 3, 1)
        plain_ms = time_ms(lambda: fused_block_plain(x, pb["res"], **kw), 2,
                           1)
        rows = halo_for(DILATIONS, 6 if final else 0) + tt
        n_tiles = t // tt
        ops = {"int8": 2 * n_tiles * (rows // stride) * c_in * 2 * stride * c
               + i8_unit_ops(rows, n_tiles, c, DILATIONS)}
        if final:
            ops["f32"] = 2 * 7 * c * t
        wts = [pb["res"][k] for k in ("tconv_pw", "tconv_pb", "w7", "w1",
                                      "vec")]
        b_ms, b_by = bound(nbytes(x, got, *wts), ops)
        scale = 1.0 if final else ref.float().abs().max().item()
        label = (f"block {bi} F={frames} T={t} C={c_in}->{c} tt={tt}"
                 f"{' final' if final else ''}")
        block_cases.append(chk.case(
            "voc_block_i8", label, max_err(got, ref), 2 ** -7 * scale, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bit_equal=bool(torch.equal(got, ref)), block=bi, frames=frames,
            **pass_plan("voc_i8_plan", dev, 1, t, c, DILATIONS, tt,
                        (c_in, stride), final),
            **i8_launches(chk, BLOCK_I8, "voc_block_i8", label,
                          lambda: fused_block(x, pb["res"], **kw), 1)))
        x = ref
    return res_cases, block_cases


def voc_quant_vs_bf16(engine, frames: int, dev, gen) -> dict:
    """The int8 vocoder (VOC_QUANT) against the bf16 one on the engine's
    decoder weights and `frames` random codes, both through the fused
    decoder (`dac_from_indices_fused`): the relative max error (over the
    bf16 waveform's largest value) and the correlation of the two
    waveforms. JAX holds its int8 decoder to under 0.05 and above 0.995
    against its bf16 conv path (tests/test_torch_voc_quant.py); this is a
    measurement of the int8 function, not a check of the kernels."""
    from fish_speech_tpu_torch.codec.fastpath import (dac_from_indices_fused,
                                                      pack_decoder)

    ccfg = engine.codec_cfg
    codes = torch.randint(0, ccfg.rvq.codebook_size,
                          (1, ccfg.rvq.n_codebooks + 1, frames),
                          generator=gen, device=dev)
    i8 = pack_decoder(engine.codec_params["decoder"], ccfg,
                      dtype=torch.bfloat16, quant=True)
    ref = dac_from_indices_fused(engine.codec_params, ccfg, codes,
                                 packed=engine.packed_decoder,
                                 device=dev).float()
    got = dac_from_indices_fused(engine.codec_params, ccfg, codes,
                                 packed=i8, device=dev).float()
    scale = max(ref.abs().max().item(), 1e-9)
    return {"frames": frames, "samples": ref.numel(),
            "rel_max_err": (got - ref).abs().max().item() / scale,
            "corr": torch.corrcoef(torch.stack(
                [got.flatten(), ref.flatten()]))[0, 1].item(),
            "bf16_max_abs": scale, "jax_criteria": "rel < 0.05, corr > 0.995"}


# ---------------------------------------------------------------------------
# Phases 4 and 5: the serving paths
# ---------------------------------------------------------------------------


# (route, attention mode, kv cache, stack mode, the C entry it launches)
HEAD_ROUTES = (
    ("a", "blocks16", "int8", "carry", "decode_attention_blocks"),
    ("b", "blocks16-bf16", "int8", "carry", "decode_attention_blocks"),
    ("c", "stream16", "int8", "carry", "decode_attention_stream_head"),
    ("d", "rows", "native", "carry", "decode_attention_stacked_rows"),
    ("e", "rows", "int8", "carry", "decode_attention_stacked_rows"),
    ("f", "rows", "native", "scan", "decode_attention"),
)


def run_path(engine, path: str, requests: list, kernels: dict,
             chk: Checks) -> dict:
    """Drive `requests` ((text, max_new_tokens, W4A8_KERNEL value or None,
    names of the kernels that route launches)) through engine.tts with
    every count set to 0 first; a request fails unless each kernel of its
    route launched and no other did. Returns the path's launch counts."""
    from fish_speech_tpu_torch.engine.generate import GenerateLongRequest

    cfg = engine.cfg
    fl = engine.codec_cfg.frame_length
    for k in kernels.values():
        k.launches = 0
    for i, (text, max_new, w4a8_kernel, route) in enumerate(requests):
        before = {n: k.launches for n, k in kernels.items()}
        req = GenerateLongRequest(text=text, max_new_tokens=max_new,
                                  seed=SEED + i)
        if w4a8_kernel:
            os.environ["W4A8_KERNEL"] = w4a8_kernel
        t0 = time.perf_counter()
        try:
            wav, codes, lm_s = engine.tts_with_codes(req)
            torch.cuda.synchronize()
        finally:
            os.environ.pop("W4A8_KERNEL", None)
        wall = time.perf_counter() - t0
        frames = codes.shape[1]
        rose = {n: kernels[n].launches - before[n] for n in kernels}
        problems = []
        if frames < 1:
            problems.append("no frames")
        elif codes.shape[0] != cfg.num_codebooks or codes.min() < 0 \
                or codes.max() >= cfg.codebook_size:
            problems.append(f"codes out of range: shape {codes.shape}, "
                            f"[{codes.min()}, {codes.max()}]")
        if wav.shape != (frames * fl,):
            problems.append(f"wav shape {wav.shape} != ({frames * fl},)")
        if not (abs(wav) <= 1.0).all():
            problems.append("wav not finite or outside [-1, 1]")
        missing = [n for n in route if rose[n] < 1]
        stray = [n for n in kernels if n not in route and rose[n] > 0]
        if missing or stray:
            problems.append(f"route {sorted(route)}: not launched {missing}, "
                            f"launched off route {stray}")
        print(json.dumps({
            "path": path, "request": i, "w4a8_kernel": w4a8_kernel,
            "frames": frames, "wall_s": wall, "lm_s": lm_s,
            "audio_s": len(wav) / engine.codec_cfg.sample_rate,
            "decode_steps_per_s": frames / lm_s if lm_s > 0 else None,
            "launches": rose}), flush=True)
        if problems:
            chk.failed.append(f"{path} request {i}: " + "; ".join(problems))
    return {n: k.launches for n, k in kernels.items()}


def profile_request(engine, n_rows: int, path: str) -> None:
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
    log_profile(prof, f"profile {path}: {codes.shape[1]} frames, wall "
                f"{wall * 1e3:.1f} ms (LM {lm_s * 1e3:.1f} ms)", wall, n_rows)


def log_profile(prof, head: str, wall: float, n_rows: int) -> None:
    """The device busy time and idle share of a profiled window of `wall`
    seconds, then its n_rows costliest device kernels (to stderr), by
    utils/profiling.py's accounting."""
    from fish_speech_tpu_torch.utils.profiling import (profile_table,
                                                       table_lines)

    for line in table_lines(profile_table(prof, wall), head, n_rows):
        log(line)


# ---------------------------------------------------------------------------
# Phase 6: the continuous-batching scheduler
# ---------------------------------------------------------------------------


def scheduler_requests(engine) -> list:
    """SCHED_REQUESTS as GenerateLongRequests (random reference codes drawn
    from a seeded numpy generator)."""
    import numpy as np

    from fish_speech_tpu_torch.engine.generate import GenerateLongRequest

    rng = np.random.default_rng(SEED)
    reqs = []
    for i, (text, ref, frames) in enumerate(SCHED_REQUESTS):
        kw = {}
        if ref:
            kw = dict(prompt_text=[f"reference speaker {i}"],
                      prompt_tokens=[rng.integers(
                          0, engine.cfg.codebook_size,
                          (engine.cfg.num_codebooks, ref))])
        reqs.append(GenerateLongRequest(text=text, max_new_tokens=frames,
                                        seed=SEED + i, **kw))
    return reqs


def codes_of(engine, req):
    """The request's (K, n) codes through generate_long (one segment)."""
    import numpy as np

    return np.concatenate([r.codes for r in engine.generate_long(req)
                           if r.action == "sample"], axis=1)


def scheduler_engine(engine):
    """An engine on `engine`'s weights (and codec) that serves through a
    fresh ContinuousBatcher: SCHED_SLOTS slots, greedy, the batcher's
    default seed."""
    from fish_speech_tpu_torch.engine.generate import TTSEngine

    eng = TTSEngine(engine.params, engine.cfg, engine.tokenizer,
                    engine.codec_params, engine.codec_cfg,
                    cache_len=engine.cache_len, device=engine.device,
                    scheduler_slots=SCHED_SLOTS,
                    scheduler_chunk=SCHED_CHUNK,
                    prefill_chunk=PREFILL_CHUNK)
    eng.scheduler.batcher.greedy = True     # before any request is queued
    return eng


def record_segments(eng) -> list:
    """Wrap `eng._generate_codes`: each segment's prompt (padded, start),
    max_new, prefix_id / prefix_len and the (K+1, n) codes it returned, in
    order."""
    segs = []
    inner = eng._generate_codes

    def recorded(padded, start, max_new, req, gen, **kw):
        codes = inner(padded, start, max_new, req, gen, **kw)
        segs.append(dict(padded=padded, start=start, max_new=max_new,
                         codes=codes, **kw))
        return codes

    eng._generate_codes = recorded
    return segs


def batch1_codes(engine, seg: dict, max_new: int):
    """The segment through the engine's non-scheduler path (the decode
    loop at batch 1, `generate`), greedy: (K+1, n) codes."""
    from fish_speech_tpu_torch.models.decode import SamplingConfig, generate

    codes, lengths = generate(
        engine.params, engine.cfg, torch.from_numpy(seg["padded"])[None],
        torch.tensor([seg["start"]], dtype=torch.int32), None,
        SamplingConfig.create(), engine._bias, max_new_tokens=max_new,
        im_end_id=engine.im_end_id, greedy=True, cache_len=engine.cache_len,
        device=engine.device)
    return codes[0, :, :int(lengths[0])].cpu().numpy()


def scheduler_replay(engine, seg: dict, max_new: int,
                     slots: int = SCHED_SLOTS, graph: bool = True):
    """The segment alone through a fresh batcher of `slots` slots, built
    otherwise as phase 6's engine builds it (slot 0, a prefix miss,
    per-step ticks: the same values as a hit and as chunked ticks);
    `graph=False` ticks eagerly, without the captured slow forward:
    (K+1, n) codes."""
    import numpy as np

    from fish_speech_tpu_torch.engine.scheduler import (ContinuousBatcher,
                                                        SlotRequest)

    b = ContinuousBatcher(engine.params, engine.cfg, num_slots=slots,
                          cache_len=engine.cache_len,
                          im_end_id=engine.im_end_id, bias=engine._bias,
                          greedy=True, prefill_chunk=PREFILL_CHUNK,
                          device=engine.device)
    b.graph_tick = b.graph_tick and graph
    req = SlotRequest(request_id=0, prompt=np.ascontiguousarray(
        seg["padded"][:, seg["start"]:]).astype(np.int32),
        max_new_tokens=max_new, prefix_id=seg["prefix_id"],
        prefix_len=seg["prefix_len"])
    return b.run([req])[0]


class LogitRecorder:
    """Within `with`, a copy of the logits of every sampling call of
    models/decode.py (the slow head's, then each fast codebook's), in
    order."""

    def __enter__(self):
        import fish_speech_tpu_torch.models.decode as dec

        self.dec, self.inner, self.calls = dec, dec._sample, []

        def recorded(logits, *args):
            self.calls.append(logits.detach().float().clone())
            return self.inner(logits, *args)

        dec._sample = recorded
        return self

    def __exit__(self, *exc):
        self.dec._sample = self.inner


def split_witness(engine, seg: dict, ref, f: int) -> dict:
    """Frame f is the first where the scheduler's codes (seg) leave the
    batch-1 path's (ref). Replays both up to frame f with their logits
    recorded and returns, for the sampling call of the first differing
    code row, the batch-1 logits' top-two gap beside the largest
    difference between the two paths' logits there, at frame 0's calls
    (the prefills) and at every earlier call. Both replays must reproduce
    their codes (`replay_equal`). A third replay runs the request alone in
    a 1-slot batcher (the same cache layout as the scheduler's, no other
    row): `one_slot`, its largest logit difference from the SCHED_SLOTS
    replay up to the split call and whether its codes equal the
    scheduler's."""
    import numpy as np

    sched = seg["codes"]
    row = int(np.flatnonzero(sched[:, f] != ref[:, f])[0])
    # code row 0 is the slow head's sample, row 1 is derived from it, row
    # j >= 2 is fast codebook call j - 1; a frame has num_codebooks calls
    per_frame = engine.cfg.num_codebooks
    i = f * per_frame + max(row - 1, 0)
    with LogitRecorder() as r1:
        b1 = batch1_codes(engine, seg, f + 1)
    with LogitRecorder() as r2:
        sc = scheduler_replay(engine, seg, f + 1)
    with LogitRecorder() as r3:
        one = scheduler_replay(engine, seg, f + 1, slots=1)
    # row 0 of every call: batch 1, or slot 0 of the replay's ticks
    a, b, c = ([t[0] for t in r.calls] for r in (r1, r2, r3))

    def maxdiff(xs, ys):
        out = 0.0
        for x, y in zip(xs, ys):
            fin = torch.isfinite(x) & torch.isfinite(y)
            out = max(out, float((x[fin] - y[fin]).abs().max()))
        return out

    def against_sched(calls, codes):
        return {"max_logit_diff": maxdiff(calls[:i + 1], b[:i + 1]),
                "codes_equal": bool(np.array_equal(codes,
                                                   sched[:, :f + 1]))}

    top = a[i].topk(2).values
    return {"frame": f, "code_row": row,
            "top2_gap": float(top[0] - top[1]),
            "max_logit_diff": maxdiff(a[i:i + 1], b[i:i + 1]),
            "max_logit_diff_frame0": maxdiff(a[:per_frame], b[:per_frame]),
            "max_logit_diff_before": maxdiff(a[:i], b[:i]),
            "logit_absmax": float(a[i][torch.isfinite(a[i])].abs().max()),
            "argmax_batch1_sched": [int(a[i].argmax()), int(b[i].argmax())],
            "replay_equal": bool(np.array_equal(b1, ref[:, :f + 1])
                                 and np.array_equal(sc, sched[:, :f + 1])),
            "one_slot": against_sched(c, one)}


def batcher_counts(b) -> dict:
    """The batcher's counters, and whether its tick's slow forward was
    captured as a CUDA graph (`graph`)."""
    return {**{k: getattr(b, k) for k in (
        "ticks", "chunked_ticks", "prefix_hits", "prefix_misses",
        "chunked_prefills", "ticks_while_prefilling")},
        "graph": b.slow_graph is not None and b.slow_graph.graph is not None}


def run_scheduler(engine, kernels: dict, chk: Checks, card: str,
                  stagger_s: float = SCHED_STAGGER_S) -> dict:
    """Phase 6 on `engine`'s weights; returns the path's launch counts.
    The concurrent requests arrive `stagger_s` apart."""
    import threading

    import numpy as np

    t_phase = time.perf_counter()
    fl = engine.codec_cfg.frame_length
    for k in kernels.values():
        k.launches = 0
    runs = {}
    # (a) solo: each request submitted once the previous one has finished
    eng = scheduler_engine(engine)
    segs = record_segments(eng)
    try:
        t0 = time.perf_counter()
        solo = [codes_of(eng, r) for r in scheduler_requests(engine)]
        torch.cuda.synchronize()
        runs["solo"] = (time.perf_counter() - t0, solo,
                        batcher_counts(eng.scheduler.batcher))
    finally:
        eng.close()
    # (b) concurrent: six threads, arrivals stagger_s apart
    eng = scheduler_engine(engine)
    try:
        got, errors = {}, {}

        def worker(i, req):
            time.sleep(i * stagger_s)
            try:
                got[i] = codes_of(eng, req)
            except Exception as e:  # noqa: BLE001 - fails the phase below
                errors[i] = repr(e)

        threads = [threading.Thread(target=worker, args=(i, r))
                   for i, r in enumerate(scheduler_requests(engine))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        torch.cuda.synchronize()
        runs["concurrent"] = (time.perf_counter() - t0,
                              [got.get(i) for i in range(len(threads))],
                              batcher_counts(eng.scheduler.batcher))
        # one tts through the scheduler: codes and the vocoder
        text, _, frames = SCHED_REQUESTS[0]
        from fish_speech_tpu_torch.engine.generate import GenerateLongRequest

        wav, tts_codes, _ = eng.tts_with_codes(GenerateLongRequest(
            text=text, max_new_tokens=frames, seed=SEED))
        torch.cuda.synchronize()
    finally:
        eng.close()
    launches = {n: k.launches for n, k in kernels.items()}

    problems = [f"request {i}: {e}" for i, e in sorted(errors.items())]
    solo_codes, conc_codes = runs["solo"][1], runs["concurrent"][1]
    for i, (a, b) in enumerate(zip(solo_codes, conc_codes)):
        if b is None or a.shape[1] < 1:
            problems.append(f"request {i}: no codes")
        elif a.shape != b.shape or not (a == b).all():
            diff = next((j for j in range(min(a.shape[1], b.shape[1]))
                         if not (a[:, j] == b[:, j]).all()),
                        min(a.shape[1], b.shape[1]))
            problems.append(f"request {i}: concurrent codes {b.shape} != "
                            f"solo {a.shape} from frame {diff}")
    c_solo, c_conc = runs["solo"][2], runs["concurrent"][2]
    for k in ("prefix_hits", "prefix_misses", "chunked_prefills"):
        if c_solo[k] != c_conc[k]:
            problems.append(f"{k}: solo {c_solo[k]} != concurrent "
                            f"{c_conc[k]}")
    if c_conc["ticks_while_prefilling"] < 1:
        problems.append("no tick ran while a chunked prefill was in flight")
    if c_conc["prefix_hits"] < 1 or c_conc["chunked_prefills"] < 1:
        problems.append(f"no prefix hit or no chunked prefill: {c_conc}")
    on_card = engine.device.type == "cuda"
    if c_solo["graph"] != on_card or c_conc["graph"] != on_card:
        problems.append(f"the tick's graph captured: solo {c_solo['graph']}"
                        f", concurrent {c_conc['graph']} on "
                        f"{engine.device.type}")
    n = tts_codes.shape[1]
    if n < 1 or wav.shape != (n * fl,) or not np.isfinite(wav).all():
        problems.append(f"tts: {n} frames, waveform {wav.shape}, finite "
                        f"{bool(np.isfinite(wav).all())}")
    route = ("decode_attention_stream", "fast_sweep", "voc_block",
             "voc_res_stack")
    missing = [k for k in route if launches[k] < 1]
    stray = [k for k in launches if k not in route and launches[k] > 0]
    if missing or stray:
        problems.append(f"not launched {missing}, launched off route "
                        f"{stray}")

    # each request alone in a SCHED_SLOTS-slot batcher that ticks eagerly
    # (checked): the captured slow forward makes the eager tick's launches,
    # so the greedy codes must equal the solo run's. Each request alone in
    # a 1-slot batcher (checked): #1 at B = 1 takes
    # other CTAs than at B = SCHED_SLOTS but the same chunks of keys, so
    # the greedy codes must equal the SCHED_SLOTS run's (Queue C2). The
    # non-scheduler path at batch 1 (greedy), logged, not checked: the two
    # paths lay the prompt out at other cache columns. At the first frame
    # where they differ, both paths' logits there (split_witness)
    shared, splits, one_slot_equal, eager_equal = [], [], [], []
    if len(segs) != len(solo_codes):
        problems.append(f"{len(segs)} segments for {len(solo_codes)} "
                        f"requests")
        segs = []

    def first_diff(a, b):
        return next((j for j in range(min(a.shape[1], b.shape[1]))
                     if not (a[:, j] == b[:, j]).all()),
                    min(a.shape[1], b.shape[1]))

    t_eager = time.perf_counter()
    for i, seg in enumerate(segs):
        a = seg["codes"]
        eager = scheduler_replay(engine, seg, seg["max_new"], graph=False)
        eager_equal.append(bool(np.array_equal(eager, a)))
        if not eager_equal[-1]:
            problems.append(f"request {i}: eager-tick codes {eager.shape} "
                            f"!= captured {a.shape} from frame "
                            f"{first_diff(a, eager)}")
    eager_s = time.perf_counter() - t_eager
    for i, seg in enumerate(segs):
        a = seg["codes"]
        one = scheduler_replay(engine, seg, seg["max_new"], slots=1)
        one_slot_equal.append(bool(np.array_equal(one, a)))
        if not one_slot_equal[-1]:
            problems.append(f"request {i}: 1-slot codes {one.shape} != "
                            f"{SCHED_SLOTS}-slot {a.shape} from frame "
                            f"{first_diff(a, one)}")
        ref = batch1_codes(engine, seg, seg["max_new"])
        m = min(a.shape[1], ref.shape[1])
        same = [bool((a[:, j] == ref[:, j]).all()) for j in range(m)]
        shared.append(same.index(False) if False in same else m)
        splits.append(split_witness(engine, seg, ref, shared[-1])
                      if shared[-1] < m else None)

    def rate(run):
        wall, codes, _ = runs[run]
        frames = sum(c.shape[1] for c in codes if c is not None)
        return {"wall_s": wall, "frames": frames,
                "frames_per_s": frames / wall}

    report = {"scheduler": {
        "card": card, "slots": SCHED_SLOTS, "chunk": SCHED_CHUNK,
        "prefill_chunk": PREFILL_CHUNK, "requests": len(SCHED_REQUESTS),
        "frames": [c.shape[1] for c in solo_codes],
        "solo": {**rate("solo"), **c_solo},
        "concurrent": {**rate("concurrent"), **c_conc},
        "tts_frames": n, "launches": launches,
        "eager_tick_codes_equal": eager_equal, "eager_replays_s": eager_s,
        "one_slot_codes_equal": one_slot_equal,
        "frames_shared_with_batch1": shared,
        "first_split": splits,
        "phase_s": time.perf_counter() - t_phase}}
    print(json.dumps(report), flush=True)
    log(f"scheduler ({card}): solo {rate('solo')['frames_per_s']:.2f} "
        f"frames/s, concurrent {rate('concurrent')['frames_per_s']:.2f} "
        f"frames/s at {SCHED_SLOTS} slots; {c_conc}")
    if problems:
        chk.failed.append("scheduler: " + "; ".join(problems))
    return launches


def profile_scheduler(engine, n_rows: int) -> None:
    """SCHED_SLOTS requests of 16 frames at once through the scheduler
    under torch.profiler: device time by kernel and the device's idle
    share of the wall time (to stderr)."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    from fish_speech_tpu_torch.engine.generate import GenerateLongRequest

    eng = scheduler_engine(engine)
    reqs = [GenerateLongRequest(text=t, max_new_tokens=16, seed=SEED)
            for t, ref, _ in SCHED_REQUESTS if ref is None][:SCHED_SLOTS]
    try:
        codes_of(eng, reqs[0])           # the prefix entry, out of the trace
        torch.cuda.synchronize()
        ticks = eng.scheduler.batcher.ticks
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=codes_of, args=(eng, r))
                       for r in reqs]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ticks = eng.scheduler.batcher.ticks - ticks
    finally:
        eng.close()
    log_profile(prof, f"profile scheduler: {len(reqs)} requests x 16 "
                f"frames, {ticks} ticks, wall {wall * 1e3:.1f} ms", wall,
                n_rows)


# ---------------------------------------------------------------------------
# Phase 7: the codec's streaming, batched-decode and encode paths
# ---------------------------------------------------------------------------


def run_codec(engine, kernels: dict, chk: Checks, card: str, dev,
              gen) -> dict:
    """Phase 7 on `engine`'s weights, through a scheduler engine built as
    phase 6 builds it (greedy, SCHED_SLOTS slots); returns the path's
    launch counts. In order: warmup_vocoder(); stream_tts of one request
    (chunks of STREAM_CHUNK frames, the first cut at STREAM_FIRST), whose
    audio must equal the plain f32 dac_from_indices of its codes within
    STREAM_TOL (its error against the bf16 fused decode_codes and the time
    to its first chunk are logged); encode_reference of a seeded
    ENCODE_SECONDS waveform, whose codes must be in range, of shape
    (K+1, ceil(n / frame_length)) and equal to dac_encode of the waveform
    zero-padded as encode_reference pads it; decode_codes_batch of three
    code sequences of different lengths, one fused call at batch 4, each
    within BATCH_TOL of its own decode_codes. The launches are read after
    those, and then #3/#4 are held against their plain twins at batches 4
    and 8 (`check_vocoder`, TWIN_BATCHES). f32 products and convs run
    without TF32 (main sets it off). The phase must take under
    CODEC_PHASE_S."""
    import numpy as np

    from fish_speech_tpu_torch.codec import fastpath
    from fish_speech_tpu_torch.codec.model import dac_encode, dac_from_indices
    from fish_speech_tpu_torch.engine.generate import GenerateLongRequest

    t_phase = time.perf_counter()
    ccfg = engine.codec_cfg
    fl = ccfg.frame_length
    for k in kernels.values():
        k.launches = 0
    problems, report = [], {"card": card}
    eng = scheduler_engine(engine)
    submitted = []
    submit = eng.scheduler.submit

    def recorded(req):
        submitted.append(req)
        return submit(req)

    eng.scheduler.submit = recorded
    try:
        t0 = time.perf_counter()
        eng.warmup_vocoder()
        torch.cuda.synchronize()
        report["warmup_vocoder_s"] = time.perf_counter() - t0

        # (a) stream_tts
        text, _, frames = SCHED_REQUESTS[0]
        chunks, first_s = [], None
        t0 = time.perf_counter()
        for w in eng.stream_tts(GenerateLongRequest(
                text=text, max_new_tokens=frames, seed=SEED),
                chunk_frames=STREAM_CHUNK, first_chunk_frames=STREAM_FIRST):
            if first_s is None:
                first_s = time.perf_counter() - t0
            chunks.append(w)
        stream_s = time.perf_counter() - t0
        codes = np.stack(submitted[-1].result, axis=1)[1:]
        n = codes.shape[1]
        streamed = np.concatenate(chunks) if chunks else np.zeros(0)
        plain = dac_from_indices(engine.codec_params, ccfg, torch.from_numpy(
            codes.astype(np.int64))[None].to(dev))[0].cpu().numpy()
        fused = eng.decode_codes(codes)
        ok = streamed.shape == plain.shape == (n * fl,) and n > 0
        err = float(np.abs(streamed - plain).max()) if ok else float("inf")
        report["stream"] = {
            "frames": n, "chunks": [len(c) // fl for c in chunks],
            "first_chunk_s": first_s, "stream_s": stream_s,
            "max_abs_err_vs_plain_f32": err, "tol": STREAM_TOL,
            "max_abs_err_vs_fused_bf16": float(np.abs(
                streamed - fused).max()) if ok else None}
        if not ok or not err <= STREAM_TOL:
            problems.append(f"stream_tts: {n} frames, audio "
                            f"{streamed.shape} against {plain.shape}, max "
                            f"error {err:.3g} > {STREAM_TOL}")

        # (b) encode_reference
        n_samples = int(ENCODE_SECONDS * ccfg.sample_rate)
        wav = (np.random.default_rng(SEED).standard_normal(n_samples)
               * 0.1).astype(np.float32)
        t0 = time.perf_counter()
        ref_codes = eng.encode_reference(wav)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        n_frames = -(-n_samples // fl)
        bucket = max(32, -(-n_frames // 64) * 64)
        padded = np.zeros((1, bucket * fl), np.float32)
        padded[0, :n_samples] = wav
        direct = dac_encode(engine.codec_params, ccfg,
                            torch.from_numpy(padded), device=dev)
        direct = direct.codes[0, :, :n_frames].cpu().numpy()
        rvq = ccfg.rvq
        in_range = bool((ref_codes >= 0).all()
                        and (ref_codes[0] < rvq.semantic_codebook_size).all()
                        and (ref_codes[1:] < rvq.codebook_size).all())
        report["encode"] = {"samples": n_samples, "frames": n_frames,
                            "bucket_frames": bucket, "s": enc_s,
                            "in_range": in_range,
                            "equal_to_dac_encode": bool(np.array_equal(
                                ref_codes, direct))}
        if ref_codes.shape != (rvq.total_codebooks, n_frames) or \
                not in_range or not np.array_equal(ref_codes, direct):
            problems.append(f"encode_reference: {report['encode']}, shape "
                            f"{ref_codes.shape}")

        # (c) decode_codes_batch: the streamed codes and two seeded ones
        rng = np.random.default_rng(SEED + 7)
        seqs = [codes] + [np.concatenate([
            rng.integers(0, rvq.semantic_codebook_size, (1, t)),
            rng.integers(0, rvq.codebook_size, (rvq.n_codebooks, t))])
            for t in BATCH_FRAMES]
        singles = [eng.decode_codes(c) for c in seqs]
        calls, inner = [], fastpath.dac_from_indices_fused

        def counting(p, cfg, c, **kw):
            calls.append(tuple(c.shape))
            return inner(p, cfg, c, **kw)

        fastpath.dac_from_indices_fused = counting
        try:
            t0 = time.perf_counter()
            wavs = eng.decode_codes_batch(seqs)
            torch.cuda.synchronize()
            batch_s = time.perf_counter() - t0
        finally:
            fastpath.dac_from_indices_fused = inner
        errs = [float(np.abs(a - b).max()) if a.shape == b.shape
                else float("inf") for a, b in zip(wavs, singles)]
        report["decode_batch"] = {"frames": [c.shape[1] for c in seqs],
                                  "calls": calls, "s": batch_s,
                                  "max_abs_err_vs_single": errs,
                                  "tol": BATCH_TOL}
        if len(calls) != 1 or calls[0][0] != 4 or max(errs) > BATCH_TOL:
            problems.append(f"decode_codes_batch: {report['decode_batch']}")
    finally:
        eng.close()
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    route = ("decode_attention_stream", "fast_sweep", "voc_block",
             "voc_res_stack")
    missing = [k for k in route if launches[k] < 1]
    stray = [k for k in launches if k not in route and launches[k] > 0]
    if missing or stray:
        problems.append(f"not launched {missing}, launched off route "
                        f"{stray}")
    # #3/#4 against their plain twins at decode_codes_batch's batches
    for batch in TWIN_BATCHES:
        res, blocks = check_vocoder(chk, engine, BATCH_TWIN_FRAMES, dev,
                                    gen, batch=batch)
        report[f"twins_batch{batch}"] = [
            {k: c[k] for k in ("case", "max_abs_err", "tol", "ms",
                               "plain_ms")}
            for c in res + blocks]
    report["launches"] = launches
    report["phase_s"] = time.perf_counter() - t_phase
    if report["phase_s"] > CODEC_PHASE_S:
        problems.append(f"phase 7 took {report['phase_s']:.1f} s > "
                        f"{CODEC_PHASE_S} s")
    print(json.dumps({"codec": report}), flush=True)
    log(f"codec ({card}): first audio {first_s} s, stream error "
        f"{report['stream']['max_abs_err_vs_plain_f32']:.3g}, encode "
        f"{enc_s:.2f} s, batch errors {errs}, phase "
        f"{report['phase_s']:.1f} s")
    if problems:
        chk.failed.append("codec: " + "; ".join(problems))
    return launches


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 8: the HTTP server from a checkpoint on disk
# ---------------------------------------------------------------------------

# fish_qwen3_omni names of the Dual-AR tree's per-layer leaves
_LAYER_LEAVES = (
    (("attention", "wqkv"), "attention.wqkv.weight"),
    (("attention", "wqkv_b"), "attention.wqkv.bias"),
    (("attention", "wo"), "attention.wo.weight"),
    (("attention", "wo_b"), "attention.wo.bias"),
    (("attention", "q_norm"), "attention.q_norm.weight"),
    (("attention", "k_norm"), "attention.k_norm.weight"),
    (("feed_forward", "w1"), "feed_forward.w1.weight"),
    (("feed_forward", "w2"), "feed_forward.w2.weight"),
    (("feed_forward", "w3"), "feed_forward.w3.weight"),
    (("attention_norm",), "attention_norm.weight"),
    (("ffn_norm",), "ffn_norm.weight"),
)


def lm_reference_names(params: dict) -> dict:
    """The port's Dual-AR tree as {fish_qwen3_omni name: tensor} (layers
    unstacked, views of the tree's leaves): the inverse of
    load_torch_lm_checkpoint's remap and convert_dual_ar_state_dict."""
    out = {"text_model.model.embeddings.weight": params["embeddings"],
           "text_model.model.norm.weight": params["norm"],
           "audio_decoder.codebook_embeddings.weight":
               params["codebook_embeddings"],
           "audio_decoder.embeddings.weight": params["fast_embeddings"],
           "audio_decoder.norm.weight": params["fast_norm"],
           "audio_decoder.output.weight": params["fast_output"]}
    if "output" in params:
        out["text_model.model.output.weight"] = params["output"]
    if "fast_project_in" in params:
        out["audio_decoder.project_in.weight"] = params["fast_project_in"]["w"]
        out["audio_decoder.project_in.bias"] = params["fast_project_in"]["b"]
    for stack, prefix in (("layers", "text_model.model.layers"),
                          ("fast_layers", "audio_decoder.layers")):
        for keys, name in _LAYER_LEAVES:
            leaf = params[stack]
            for k in keys:
                leaf = leaf.get(k) if isinstance(leaf, dict) else None
            if leaf is None:
                continue
            for i in range(leaf.shape[0]):
                out[f"{prefix}.{i}.{name}"] = leaf[i]
    return out


def fish_qwen3_omni_config(cfg, tokenizer) -> dict:
    """The nested config.json that DualARConfig.from_json reads back as
    `cfg` (with the tokenizer's semantic range)."""
    return {
        "model_type": "fish_qwen3_omni",
        "semantic_start_token_id": tokenizer.semantic_begin_id,
        "semantic_end_token_id": tokenizer.semantic_end_id,
        "text_config": {
            "vocab_size": cfg.vocab_size, "n_layer": cfg.n_layer,
            "n_head": cfg.n_head, "n_local_heads": cfg.n_local_heads,
            "head_dim": cfg.head_dim, "dim": cfg.dim,
            "intermediate_size": cfg.intermediate_size,
            "rope_base": cfg.rope_base, "norm_eps": cfg.norm_eps,
            "max_seq_len": cfg.max_seq_len,
            "tie_word_embeddings": cfg.tie_word_embeddings,
            "attention_qkv_bias": cfg.attention_qkv_bias,
            "attention_o_bias": cfg.attention_o_bias,
            "attention_qk_norm": cfg.attention_qk_norm},
        "audio_decoder_config": {
            "vocab_size": cfg.codebook_size,
            "num_codebooks": cfg.num_codebooks, "n_layer": cfg.n_fast_layer,
            "dim": cfg.fast_dim, "n_head": cfg.fast_n_head,
            "n_local_heads": cfg.fast_n_local_heads,
            "head_dim": cfg.fast_head_dim,
            "intermediate_size": cfg.fast_intermediate_size,
            "attention_qkv_bias": cfg.fast_attention_qkv_bias,
            "attention_o_bias": cfg.fast_attention_o_bias,
            "attention_qk_norm": cfg.fast_attention_qk_norm},
    }


def write_lm_checkpoint(d, params: dict, cfg, tokenizer,
                        shard_bytes: float = 4e9) -> dict:
    """`params` as a sharded bf16 safetensors checkpoint in the
    fish_qwen3_omni layout (shards of at most `shard_bytes`, the index,
    the nested config.json). Returns {"shards", "bytes"}."""
    from fish_speech_tpu_torch.utils.safetensors import save_file

    named = lm_reference_names(params)
    shards, cur, size = [], {}, 0
    for name in sorted(named):
        n = nbytes(named[name])
        if cur and size + n > shard_bytes:
            shards.append(cur)
            cur, size = {}, 0
        cur[name] = named[name]
        size += n
    shards.append(cur)
    weight_map = {}
    for i, part in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(part, os.path.join(d, fname))
        weight_map.update({k: fname for k in part})
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": nbytes(*named.values())},
                   "weight_map": weight_map}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(fish_qwen3_omni_config(cfg, tokenizer), f, indent=2)
    return {"shards": len(shards), "bytes": nbytes(*named.values())}


def _wn_pair(sd: dict, prefix: str, w_torch: torch.Tensor, b) -> None:
    """A conv in the torch layout as a weight-norm pair (g = the norm over
    all dims but 0, v = w) and its bias."""
    v = w_torch.float().contiguous()
    g = v.double().square().sum(dim=tuple(range(1, v.ndim)),
                                keepdim=True).sqrt().float()
    sd[f"{prefix}.parametrizations.weight.original0"] = g
    sd[f"{prefix}.parametrizations.weight.original1"] = v
    if b is not None:
        sd[f"{prefix}.bias"] = b


def _put_conv(sd, prefix, w, b):
    """A port conv (k, in/g, out) as a CausalConvNet's weight-norm conv."""
    _wn_pair(sd, f"{prefix}.conv", w.permute(2, 1, 0), b)


def _put_tconv(sd, prefix, w, b):
    """A port transposed conv (k, in, out, flipped) as (in, out, k)."""
    _wn_pair(sd, f"{prefix}.conv", w.flip(0).permute(1, 2, 0), b)


def _put_transformer(sd, prefix, p):
    for i, lp in enumerate(p["layers"]):
        q = f"{prefix}.layers.{i}"
        sd[f"{q}.attention.wqkv.weight"] = lp["attention"]["wqkv"]
        sd[f"{q}.attention.wo.weight"] = lp["attention"]["wo"]
        for w in ("w1", "w2", "w3"):
            sd[f"{q}.feed_forward.{w}.weight"] = lp["feed_forward"][w]
        sd[f"{q}.attention_norm.weight"] = lp["attention_norm"]
        sd[f"{q}.ffn_norm.weight"] = lp["ffn_norm"]
        sd[f"{q}.attention_layer_scale.gamma"] = lp["attention_ls"]
        sd[f"{q}.ffn_layer_scale.gamma"] = lp["ffn_ls"]
    sd[f"{prefix}.norm.weight"] = p["norm"]
    for k in ("input_proj", "output_proj"):
        if f"{k}_w" in p:
            sd[f"{prefix}.{k}.weight"] = p[f"{k}_w"]
            sd[f"{prefix}.{k}.bias"] = p[f"{k}_b"]


def _put_convnext(sd, prefix, p):
    _put_conv(sd, f"{prefix}.dwconv", p["dwconv_w"], p["dwconv_b"])
    sd[f"{prefix}.norm.weight"] = p["norm_w"]
    sd[f"{prefix}.norm.bias"] = p["norm_b"]
    sd[f"{prefix}.pwconv1.weight"] = p["pw1_w"].T
    sd[f"{prefix}.pwconv1.bias"] = p["pw1_b"]
    sd[f"{prefix}.pwconv2.weight"] = p["pw2_w"].T
    sd[f"{prefix}.pwconv2.bias"] = p["pw2_b"]
    if "gamma" in p:
        sd[f"{prefix}.gamma"] = p["gamma"]


def _put_res_unit(sd, prefix, u):
    sd[f"{prefix}.block.0.alpha"] = u["snake1_alpha"].reshape(1, -1, 1)
    _put_conv(sd, f"{prefix}.block.1", u["conv1_w"], u["conv1_b"])
    sd[f"{prefix}.block.2.alpha"] = u["snake2_alpha"].reshape(1, -1, 1)
    _put_conv(sd, f"{prefix}.block.3", u["conv2_w"], u["conv2_b"])


def codec_state_dict(params: dict, cfg) -> dict:
    """The port's codec tree as the reference's state dict, every conv a
    weight-norm pair: the inverse of codec/convert.py."""
    sd: dict = {}
    enc = params["encoder"]
    _put_conv(sd, "encoder.block.0", enc["conv_in_w"], enc["conv_in_b"])
    n = len(cfg.encoder_rates)
    for bi, blk in enumerate(enc["blocks"]):
        bp = f"encoder.block.{bi + 1}.block"
        for u, unit in enumerate(blk["res_units"]):
            _put_res_unit(sd, f"{bp}.{u}", unit)
        sd[f"{bp}.3.alpha"] = blk["snake_alpha"].reshape(1, -1, 1)
        _put_conv(sd, f"{bp}.4", blk["conv_w"], blk["conv_b"])
        if "transformer" in blk:
            _put_transformer(sd, f"{bp}.5", blk["transformer"])
    sd[f"encoder.block.{n + 1}.alpha"] = enc["snake_alpha"].reshape(1, -1, 1)
    _put_conv(sd, f"encoder.block.{n + 2}", enc["conv_out_w"],
              enc["conv_out_b"])

    q = params["quantizer"]
    for name, kind in (("semantic_quantizer", "semantic"),
                       ("quantizer", "residual")):
        for i in range(q[f"{kind}_codebooks"].shape[0]):
            qp = f"quantizer.{name}.quantizers.{i}"
            sd[f"{qp}.codebook.weight"] = q[f"{kind}_codebooks"][i]
            _wn_pair(sd, f"{qp}.in_proj", q[f"{kind}_in_w"][i].T[..., None],
                     q[f"{kind}_in_b"][i])
            _wn_pair(sd, f"{qp}.out_proj",
                     q[f"{kind}_out_w"][i].T[..., None],
                     q[f"{kind}_out_b"][i])
    for i, (down, up) in enumerate(zip(q["downsample"], q["upsample"])):
        _put_conv(sd, f"quantizer.downsample.{i}.0", down["conv_w"],
                  down["conv_b"])
        _put_convnext(sd, f"quantizer.downsample.{i}.1", down["convnext"])
        _put_tconv(sd, f"quantizer.upsample.{i}.0", up["conv_w"],
                   up["conv_b"])
        _put_convnext(sd, f"quantizer.upsample.{i}.1", up["convnext"])
    _put_transformer(sd, "quantizer.pre_module", q["pre_module"])
    _put_transformer(sd, "quantizer.post_module", q["post_module"])

    dec = params["decoder"]
    _put_conv(sd, "decoder.model.0", dec["conv_in_w"], dec["conv_in_b"])
    n = len(cfg.decoder_rates)
    for bi, blk in enumerate(dec["blocks"]):
        bp = f"decoder.model.{bi + 1}.block"
        sd[f"{bp}.0.alpha"] = blk["snake_alpha"].reshape(1, -1, 1)
        _put_tconv(sd, f"{bp}.1", blk["conv_w"], blk["conv_b"])
        for u, unit in zip((2, 3, 4), blk["res_units"]):
            _put_res_unit(sd, f"{bp}.{u}", unit)
    sd[f"decoder.model.{n + 1}.alpha"] = dec["snake_alpha"].reshape(1, -1, 1)
    _put_conv(sd, f"decoder.model.{n + 2}", dec["conv_out_w"],
              dec["conv_out_b"])
    return {"generator." + k: v.detach().float().cpu().contiguous()
            for k, v in sd.items()}


def compare_trees(got: dict, want: dict, rtol: float) -> list[str]:
    """Leaves of `got` that differ from `want` (rtol 0: bit-equal)."""
    from fish_speech_tpu_torch.utils.checkpoint import _flatten

    g, want = _flatten(got), _flatten(want)
    bad = []
    for path, w in want.items():
        x = g.get(path)
        if w is None or x is None:
            if (w is None) != (x is None):
                bad.append(f"{path}: missing")
            continue
        if x.shape != w.shape or x.dtype != w.dtype:
            bad.append(f"{path}: {tuple(x.shape)} {x.dtype} != "
                       f"{tuple(w.shape)} {w.dtype}")
        elif rtol == 0 and not torch.equal(x, w):
            bad.append(f"{path}: not bit-equal")
        elif rtol and not torch.allclose(x, w, rtol=rtol, atol=0):
            rel = ((x - w).abs() / w.abs().clamp_min(1e-30)).max().item()
            bad.append(f"{path}: rel err {rel:.3g}")
    if len(g) != len(want):
        bad.append(f"{len(g)} leaves, want {len(want)}")
    return bad


class Client:
    """urllib against the phase's server, the API key on every call."""

    def __init__(self, port: int, key: str | None):
        self.base = f"http://127.0.0.1:{port}"
        self.key = key

    def call(self, method: str, path: str, body=None, ctype=None,
             auth: bool = True, accept=None):
        """(status, headers, body bytes, seconds); a dict goes as JSON, or
        as msgpack with ctype="application/msgpack"."""
        from fish_speech_tpu_torch.serve import msgpack

        import urllib.error
        import urllib.request

        headers = {}
        if isinstance(body, dict):
            if ctype == "application/msgpack":
                body = msgpack.packb(body)
            else:
                body, ctype = json.dumps(body).encode(), "application/json"
        if ctype:
            headers["Content-Type"] = ctype
        if accept:
            headers["Accept"] = accept
        if auth and self.key:
            headers["Authorization"] = f"Bearer {self.key}"
        req = urllib.request.Request(self.base + path, data=body,
                                     headers=headers, method=method)
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                out = r.status, r.headers, r.read()
        except urllib.error.HTTPError as e:
            out = e.code, e.headers, e.read()
        return (*out, time.perf_counter() - t0)

    def stream(self, body: dict) -> tuple[int, bytes, float, float]:
        """A streamed /v1/tts: (status, body, seconds to the first audio
        byte after the WAV header, seconds in all)."""
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1",
                                          int(self.base.rsplit(":", 1)[1]),
                                          timeout=600)
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/v1/tts", json.dumps(body),
                         {"Content-Type": "application/json",
                          "Authorization": f"Bearer {self.key}"})
            resp = conn.getresponse()
            data, first = b"", None
            while True:
                part = resp.read1(1 << 16)
                if not part:
                    break
                data += part
                if first is None and len(data) > 44:
                    first = time.perf_counter() - t0
            return resp.status, data, first, time.perf_counter() - t0
        finally:
            conn.close()


def audio_frames(body: bytes, fmt: str, fl: int, max_frames: int) -> tuple:
    """(frames, problem or None) of a wav or pcm body: it parses (RIFF, or
    even-length PCM16), its samples are finite, and there are frames x
    `fl` of them, 0 < frames <= max_frames."""
    import io
    import wave

    import numpy as np

    if fmt == "wav":
        if body[:4] != b"RIFF":
            return 0, "no RIFF header"
        try:
            with wave.open(io.BytesIO(body)) as w:
                pcm = w.readframes(w.getnframes())
        except (wave.Error, EOFError) as e:
            return 0, f"wav does not parse: {e}"
        if len(pcm) == 0 and len(body) > 44:    # a streamed header
            pcm = body[44:]
    else:
        pcm = body
    if len(pcm) % 2:
        return 0, f"odd PCM length {len(pcm)}"
    samples = np.frombuffer(pcm, "<i2").astype(np.float32) / 32768.0
    n = samples.size
    if not np.isfinite(samples).all():
        return 0, "samples not finite"
    if n == 0 or n % fl or n // fl > max_frames:
        return n / fl, f"{n} samples: not frames x {fl}, <= {max_frames}"
    return n // fl, None


VOC_IMPL_SHAPES = ((1, 32), (1, 64), (4, 64))  # (batch, frame bucket)


def vocoder_impl_ms(engine, rng) -> list[dict]:
    """The serving vocoder's three routes (`TTSEngine._vocode`: "pallas"
    #3/#4, "lax" the plain f32 decoder, "mm" its matmul form) timed on the
    same seeded codes at the server's shapes: a request's 32-frame bucket,
    the "auto" probe's 64 frames, and /v1/vqgan/decode's batch of 4. Each
    twice: with the codes on the host, as the engine gets them (their copy
    to the card waits for the device, so this is a call's wall time), and
    with the codes already on the card (the device's time)."""
    n_q = engine.codec_cfg.rvq.total_codebooks
    out = []
    for b, frames in VOC_IMPL_SHAPES:
        host = torch.from_numpy(rng.integers(
            0, engine.codec_cfg.rvq.codebook_size, (b, n_q, frames)))
        row = {"batch": b, "frames": frames}
        for where, codes in (("host_codes", host),
                             ("device_codes", host.to(engine.device))):
            row[where] = {
                impl: time_ms(lambda: engine._vocode(codes, impl), reps=5)
                for impl in ("pallas", "lax", "mm")}
            log(f"  vocoder routes at B={b}, {frames} frames, {where}: "
                + ", ".join(f"{i} {t:.3f} ms"
                            for i, t in row[where].items()))
        out.append(row)
    return out


def cli_env() -> dict:
    """The environment of a CLI subprocess: this checkout on its path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__)) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def run_cli(args: list, cwd: str,
            timeout: float) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd,
                          env=cli_env(), capture_output=True, text=True,
                          timeout=timeout)


def demo_server_check(workdir: str, timeout: float = 300) -> dict:
    """The server CLI in demo mode on the card, as a subprocess, serving
    #3/#4 by name: health, one /v1/tts, then SIGTERM. Its first line has to
    come within `timeout` seconds; its stderr goes to a file of the work
    dir. Returns its seconds."""
    import queue
    import re
    import threading

    t0 = time.perf_counter()
    err_path = os.path.join(workdir, "demo_server.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fish_speech_tpu_torch.tools.api_server",
             "--listen", "127.0.0.1:0", "--vocoder-impl", "pallas",
             "--references-dir", os.path.join(workdir, "demo_refs")],
            cwd=workdir, env=cli_env(), stdout=subprocess.PIPE, stderr=err,
            text=True)
    try:
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: lines.put(proc.stdout.readline()),
                         daemon=True).start()
        try:
            line = lines.get(timeout=timeout)
        except queue.Empty:
            line = None
        m = line and re.search(r"http://127\.0\.0\.1:(\d+), vocoder (\w+)$",
                               line.strip())
        if not m or m.group(2) != "pallas":
            proc.kill()
            proc.wait()
            with open(err_path) as f:
                tail = f.read()[-2000:]
            raise RuntimeError(
                f"demo server did not start on #3/#4 within {timeout} s: "
                f"{line!r}; stderr tail: {tail}")
        up_s = time.perf_counter() - t0
        c = Client(int(m.group(1)), None)
        health = c.call("GET", "/v1/health")
        tts = c.call("POST", "/v1/tts", {"text": "demo", "max_new_tokens": 8})
        if health[0] != 200 or tts[0] != 200 or tts[2][:4] != b"RIFF":
            raise RuntimeError(f"demo server answered {health[0]} / "
                               f"{tts[0]}: {tts[2][:200]!r}")
        return {"up_s": up_s, "tts_s": tts[3]}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def run_server(kernels: dict, chk: Checks, card: str, dev,
               profile: int = 0) -> dict:
    """Phase 8: a full-width S2-Pro checkpoint written to disk in the
    reference layout, loaded and served by the port's CLI functions, driven
    over HTTP (see the module docstring); returns the phase's launch
    counts. profile > 0: then one more request of the served engine under
    torch.profiler (`profile_request`)."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    from fish_speech_tpu_torch.codec.config import s2_pro_codec_config
    from fish_speech_tpu_torch.codec.init import init_dac_params
    from fish_speech_tpu_torch.models.config import (DualARConfig,
                                                     s2_pro_lm_config)
    from fish_speech_tpu_torch.models.init import init_dual_ar_params
    from fish_speech_tpu_torch.serve.app import create_server
    from fish_speech_tpu_torch.serve.wav import decode_audio_bytes, encode_wav
    from fish_speech_tpu_torch.text.tokenizer import ByteTokenizer
    from fish_speech_tpu_torch.tools import api_server

    problems: list[str] = []
    report: dict = {"card": card}
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix=".smoke_server_", dir=root)
    report["disk_free_gb"] = shutil.disk_usage(work).free / 1e9
    log(f"phase 8: work dir {work}, {report['disk_free_gb']:.1f} GB free")
    server = engine = None
    try:
        # (a) the checkpoint, drawn from the seed on the card
        tokenizer = ByteTokenizer()
        cfg = s2_pro_lm_config(max_seq_len=SERVER_CACHE_LEN)
        gen = torch.Generator(device=dev).manual_seed(SEED + 8)
        drawn = init_dual_ar_params(gen, cfg, dtype=torch.bfloat16,
                                    device=dev)
        codec_cfg = s2_pro_codec_config()
        drawn_codec = init_dac_params(gen, codec_cfg, device=dev)
        ckpt = os.path.join(work, "lm")
        os.makedirs(ckpt)
        t0 = time.perf_counter()
        written = write_lm_checkpoint(ckpt, drawn, cfg, tokenizer)
        report["write_lm_s"] = time.perf_counter() - t0
        report.update(lm_bytes=written["bytes"], lm_shards=written["shards"])
        codec_path = os.path.join(work, "codec.pth")
        t0 = time.perf_counter()
        torch.save(codec_state_dict(drawn_codec, codec_cfg), codec_path)
        report["write_codec_s"] = time.perf_counter() - t0
        log(f"  wrote {written['bytes'] / 1e9:.2f} GB of LM in "
            f"{written['shards']} shards in {report['write_lm_s']:.1f} s, "
            f"codec.pth in {report['write_codec_s']:.1f} s")
        want_cfg = cfg.with_semantic_range(tokenizer.semantic_begin_id,
                                           tokenizer.semantic_end_id)
        if DualARConfig.from_json(ckpt) != want_cfg:
            problems.append("config.json does not read back as S2-Pro")

        # (b) the engine, through the CLI's own functions
        args = api_server.parse_args([
            "--checkpoint", ckpt, "--codec-checkpoint", codec_path,
            "--kv-cache", "int8", "--pallas-attn", "stream",
            "--kv-layout", "pos", "--vocoder-impl", "pallas",
            "--scheduler-slots", str(SCHED_SLOTS),
            "--cache-len", str(SERVER_CACHE_LEN), "--api-key", SERVER_KEY,
            "--references-dir", os.path.join(work, "refs"),
            "--device", str(dev)])
        t0 = time.perf_counter()
        engine = api_server.build_engine(args)
        torch.cuda.synchronize()
        report["load_s"] = time.perf_counter() - t0
        bad = compare_trees(engine.params, drawn, rtol=0)
        bad += compare_trees(engine.codec_params, drawn_codec, rtol=1e-6)
        if bad:
            problems.append(f"loaded weights differ: {bad[:5]}")
        del drawn, drawn_codec
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  engine from disk in {report['load_s']:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; "
            f"leaves {'equal' if not bad else 'DIFFER'}")
        t0 = time.perf_counter()
        api_server.warm_up(engine)
        torch.cuda.synchronize()
        report["warmup_s"] = time.perf_counter() - t0

        # (c) the server in a thread, on an ephemeral port
        server = create_server(engine, "127.0.0.1", 0,
                               ref_dir=args.references_dir,
                               api_key=args.api_key)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        c = Client(server.server_address[1], SERVER_KEY)
        fl = codec_cfg.frame_length
        requests: list[dict] = []

        def audio_check(label, status, body, fmt, max_new, wall):
            frames, why = ((0, f"status {status}: {body[:200]!r}")
                           if status != 200
                           else audio_frames(body, fmt, fl, max_new))
            requests.append({"request": label, "status": status,
                             "frames": frames, "wall_s": wall})
            if why:
                problems.append(f"{label}: {why}")

        for k in kernels.values():
            k.launches = 0
        st, _, body, wall = c.call("GET", "/v1/health")
        if st != 200 or json.loads(body) != {"status": "ok"}:
            problems.append(f"health: {st} {body[:100]!r}")
        st, _, _, _ = c.call("GET", "/v1/health", auth=False)
        if st != 401:
            problems.append(f"health without the key: {st}, not 401")
        st, _, body, wall = c.call("POST", "/v1/tts", {
            "text": TEXTS[0], "max_new_tokens": SERVER_NEW_TOKENS})
        audio_check("tts_json_wav", st, body, "wav", SERVER_NEW_TOKENS, wall)
        st, _, body, wall = c.call("POST", "/v1/tts", {
            "text": TEXTS[1], "max_new_tokens": SERVER_SHORT_TOKENS,
            "format": "pcm"}, ctype="application/msgpack")
        audio_check("tts_msgpack_pcm", st, body, "pcm", SERVER_SHORT_TOKENS,
                    wall)
        st, body, first_s, wall = c.stream({
            "text": TEXTS[2], "max_new_tokens": SERVER_SHORT_TOKENS,
            "streaming": True})
        audio_check("tts_stream_wav", st, body, "wav", SERVER_SHORT_TOKENS,
                    wall)
        report["stream_first_audio_s"] = first_s
        if first_s is None:
            problems.append("the stream sent no audio")

        rng = np.random.default_rng(SEED + 8)
        sr = codec_cfg.sample_rate
        t = np.arange(int(ENCODE_SECONDS * sr)) / sr
        ref_wav = (0.3 * np.sin(2 * np.pi * 220 * t)
                   + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
        ref_bytes = encode_wav(ref_wav, sr)
        st, _, body, wall = c.call("POST", "/v1/references/add", {
            "id": "smoke", "text": "A seeded reference.",
            "audio": ref_bytes}, ctype="application/msgpack")
        if st != 200:
            problems.append(f"references/add: {st} {body[:200]!r}")
        st, _, body, wall = c.call("POST", "/v1/tts", {
            "text": TEXTS[0], "max_new_tokens": SERVER_SHORT_TOKENS,
            "reference_id": "smoke"})
        audio_check("tts_reference", st, body, "wav", SERVER_SHORT_TOKENS,
                    wall)

        results = [None] * SCHED_SLOTS

        def one(i):
            results[i] = c.call("POST", "/v1/tts", {
                "text": SCHED_REQUESTS[i][0],
                "max_new_tokens": SERVER_SHORT_TOKENS, "seed": i})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(SCHED_SLOTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        report["concurrent_wall_s"] = time.perf_counter() - t0
        for i, r in enumerate(results):
            if r is None:
                problems.append(f"concurrent {i}: no answer")
                continue
            audio_check(f"tts_concurrent_{i}", r[0], r[2], "wav",
                        SERVER_SHORT_TOKENS, r[3])

        st, _, body, wall = c.call("POST", "/v1/vqgan/encode",
                                   {"audios": [ref_bytes]},
                                   ctype="application/msgpack",
                                   accept="application/msgpack")
        from fish_speech_tpu_torch.serve import msgpack

        want = engine.encode_reference(decode_audio_bytes(ref_bytes, sr))
        got = (np.asarray(msgpack.unpackb(body)["tokens"][0])
               if st == 200 else None)
        requests.append({"request": "vqgan_encode", "status": st,
                         "frames": None if got is None else got.shape[1],
                         "wall_s": wall})
        if got is None or got.shape != want.shape or (got != want).any():
            problems.append(f"vqgan/encode: {st}, not encode_reference's "
                            f"codes {want.shape}")

        codes = [rng.integers(0, codec_cfg.rvq.codebook_size,
                              (codec_cfg.rvq.total_codebooks, n))
                 for n in (20, *BATCH_FRAMES)]
        st, _, body, wall = c.call(
            "POST", "/v1/vqgan/decode",
            {"tokens": [x.tolist() for x in codes]},
            ctype="application/msgpack", accept="application/msgpack")
        got = msgpack.unpackb(body)["audios"] if st == 200 else None
        requests.append({"request": "vqgan_decode", "status": st,
                         "frames": [x.shape[1] for x in codes],
                         "wall_s": wall})
        launches = {n: k.launches for n, k in kernels.items()}
        # the engine's own call on the same codes, after the count
        want = [np.asarray(w, np.float16).tobytes()
                for w in engine.decode_codes_batch(codes)]
        if got != want:
            diff = None
            if got is not None and len(got) == len(want):
                diff = max(float(np.abs(
                    np.frombuffer(a, np.float16).astype(np.float32)
                    - np.frombuffer(b, np.float16).astype(np.float32)).max())
                    for a, b in zip(got, want))
            problems.append(f"vqgan/decode: {st}, not decode_codes_batch's "
                            f"f16 bytes (max diff {diff})")
        route = ("decode_attention_stream", "voc_block", "voc_res_stack")
        missing = [n for n in route if launches[n] < 1]
        stray = [n for n in kernels if n not in route and launches[n] > 0]
        if missing or stray:
            problems.append(f"launches: not launched {missing}, launched off "
                            f"the route {stray}")
        report["launches"] = {n: launches[n] for n in route}
        report["requests"] = requests
        report["vocoder_impl_ms"] = vocoder_impl_ms(engine, rng)
        if profile:
            profile_request(engine, profile, "server")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            server.app.close()
        if engine is not None:
            engine.close()
        shutil.rmtree(os.path.join(work, "lm"), ignore_errors=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the CLIs as subprocesses, demo mode, on the card
    try:
        report["demo_server"] = demo_server_check(work)
        out = os.path.join(work, "demo.wav")
        t0 = time.perf_counter()
        r = run_cli(["fish_speech_tpu_torch.tools.tts_cli", "--output", out,
                     "--max-new-tokens", "8", "--vocoder-impl", "pallas",
                     "--output-dir", os.path.join(work, "codes")], work, 300)
        report["demo_tts_cli_s"] = time.perf_counter() - t0
        if r.returncode != 0 or not os.path.exists(out):
            problems.append(f"tts_cli exited {r.returncode}: "
                            f"{r.stderr[-2000:]}")
        elif r.stdout.splitlines()[:1] != ["vocoder pallas"]:
            problems.append(f"tts_cli did not serve #3/#4: "
                            f"{r.stdout[:200]!r}")
        else:
            with open(out, "rb") as f:
                if f.read(4) != b"RIFF":
                    problems.append("tts_cli wrote no wav")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"server": report}), flush=True)
    log(f"phase 8: load {report['load_s']:.1f} s, warm-up "
        f"{report['warmup_s']:.1f} s, first streamed audio "
        f"{report['stream_first_audio_s']} s, launches "
        f"{report['launches']}")
    for p in problems:
        chk.failed.append(f"server: {p}")
    return launches


# ---------------------------------------------------------------------------
# Phase 9: training and LoRA at full S2-Pro width
# ---------------------------------------------------------------------------


def tree_to(tree, device):
    """A detached copy of a parameter tree on `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.detach().to(device, copy=True)


def trees_equal(a: dict, b: dict) -> list[str]:
    """The key paths whose leaves are not bit-equal (or are missing)."""
    from fish_speech_tpu_torch.train.step import tree_leaves

    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    if la.keys() != lb.keys():
        return sorted(map(str, la.keys() ^ lb.keys()))
    return [str(k) for k in la if not torch.equal(la[k], lb[k])]


def write_train_corpus(root: str, rng) -> None:
    """TRAIN_SPEAKERS x TRAIN_CLIPS clips of random codes (10 x 40-200
    frames) as .npy, each with a .lab transcript."""
    import numpy as np

    words = ("the", "card", "trains", "a", "voice", "on", "random", "codes",
             "slowly", "and", "then", "quickly", "again")
    for s in range(TRAIN_SPEAKERS):
        d = os.path.join(root, f"speaker{s}")
        os.makedirs(d)
        for i in range(TRAIN_CLIPS):
            frames = int(rng.integers(40, 201))
            np.save(os.path.join(d, f"clip{i}.npy"),
                    rng.integers(0, 4096, (10, frames)))
            text = " ".join(rng.choice(words, int(rng.integers(5, 14))))
            with open(os.path.join(d, f"clip{i}.lab"), "w") as f:
                f.write(f"Speaker {s}, clip {i}: {text}.")


def card_vs_cpu(dev) -> dict:
    """(d) One full step's and one LoRA step's loss, metrics and gradient
    leaves on the card against the port on the CPU, from the same tiny f32
    weights and batch (TF32 off). Tolerances: a loss, a norm 1e-5
    relative; top-5 accuracy within one flipped entry; a gradient leaf
    1e-4 of its largest entry on the CPU (cuBLAS and the embeddings' index
    accumulation sum in other orders)."""
    import dataclasses

    import numpy as np

    from fish_speech_tpu_torch.models.config import tiny_dual_ar_config
    from fish_speech_tpu_torch.models.init import init_dual_ar_params
    from fish_speech_tpu_torch.train import lora as tl
    from fish_speech_tpu_torch.train import step as ts
    from fish_speech_tpu_torch.train.scheduler import constant_warmup_schedule

    cfg = dataclasses.replace(
        tiny_dual_ar_config(), tie_word_embeddings=False,
        attention_qk_norm=True, scale_codebook_embeddings=True,
        norm_fastlayer_input=True)
    gen = torch.Generator().manual_seed(SEED + 9)
    base = init_dual_ar_params(gen, cfg, device="cpu")
    lcfg = tl.LoraConfig(r=4, lora_alpha=8.0)
    lora = tl.init_lora_params(gen, base, lcfg)
    for v in lora.values():   # b drawn too: with b = 0, a gets no gradient
        v["b"] = 0.02 * torch.randn(v["b"].shape, generator=gen)
    rng = np.random.default_rng(SEED + 9)
    b, t, k = 2, 24, cfg.num_codebooks
    tokens = rng.integers(0, cfg.vocab_size, (b, 1, t))
    tokens[:, 0, t // 2:] = rng.integers(cfg.semantic_begin_id,
                                         cfg.semantic_end_id + 1,
                                         (b, t - t // 2))
    inputs = np.concatenate([tokens, rng.integers(0, cfg.codebook_size,
                                                  (b, k, t))], 1)
    labels = inputs.copy()
    labels[:, :, :4] = -100
    masks = np.zeros((b, t), bool)
    masks[1, -5:] = True
    batch_np = {"inputs": inputs.astype(np.int32),
                "labels": labels.astype(np.int32), "attention_masks": masks}
    sem = ((labels[:, 0] >= cfg.semantic_begin_id)
           & (labels[:, 0] <= cfg.semantic_end_id))[..., None]
    n_acc = int((sem & (labels[:, 1:].transpose(0, 2, 1) > 0)).sum())

    def run(device):
        batch = ts.TrainBatch.from_numpy(batch_np, device)
        params = tree_to(base, device)
        m_full, g_full = ts.dual_ar_grads(params, cfg, batch, remat=True)
        opt = ts.make_optimizer(params, constant_warmup_schedule(1e-3, 0))
        _, _, s_full = ts.make_train_step(cfg, opt)(params, opt.init(params),
                                                    batch)
        frozen, factors = tree_to(base, device), tree_to(lora, device)
        leaves = [x for _, x in ts.tree_leaves(factors)]
        for x in leaves:
            x.requires_grad_(True)
        loss, m_lora = ts.dual_ar_loss(
            tl.merge_lora(frozen, factors, lcfg), cfg, batch, True)
        g_lora = dict(zip((p for p, _ in ts.tree_leaves(factors)),
                          ts.grads_of(loss, leaves)))
        opt = tl.make_lora_optimizer(constant_warmup_schedule(1e-3, 0))
        _, _, s_lora = tl.make_lora_train_step(cfg, frozen, lcfg, opt)(
            factors, opt.init(factors), batch)
        return ({"full": m_full, "full_step": s_full, "lora": m_lora,
                 "lora_step": s_lora},
                {"full": dict(ts.tree_leaves(g_full)), "lora": g_lora})

    m_cpu, g_cpu = run("cpu")
    m_dev, g_dev = run(dev)
    out = {"metrics": {}, "grads": {}, "problems": []}
    for part, ms in m_cpu.items():
        for name, want in ms.items():
            want, got = float(want), float(m_dev[part][name])
            err = abs(got - want)
            tol = (1.0 / max(n_acc, 1) if name == "top_5_accuracy"
                   else 1e-5 * max(abs(want), 1e-30))
            out["metrics"][f"{part}.{name}"] = [want, got]
            if not err <= tol:
                out["problems"].append(f"{part} {name}: card {got} cpu {want}")
    for part, gs in g_cpu.items():
        worst = 0.0
        for path, want in gs.items():
            scale = max(float(want.abs().max()), 1e-30)
            rel = max_err(g_dev[part][path].cpu(), want) / scale
            worst = max(worst, rel)
            if not rel <= 1e-4:
                out["problems"].append(f"{part} grad {path}: {rel:.3g} of "
                                       "its largest entry")
        out["grads"][part] = {"leaves": len(gs), "max_rel_err": worst}
    return out


def run_train(kernels: dict, chk: Checks, card: str, dev) -> dict:
    """Phase 9: training at full S2-Pro width, bf16 weights drawn from the
    seed on the card: (a) a synthetic corpus through the port's
    build_dataset; (b) LoRA through the training CLI's `main` (in this
    process), then merge_lora's `main`; (c) a full finetune with
    make_train_step (remat); (d) the card against the CPU on a tiny f32
    model (`card_vs_cpu`); (e) none of the hand-written kernels launches.
    Returns the phase's launch counts."""
    import shutil
    import tempfile

    import numpy as np

    from fish_speech_tpu_torch.data import (SemanticIterableDataset,
                                            TextDataCollator, data_loader)
    from fish_speech_tpu_torch.models.config import s2_pro_lm_config
    from fish_speech_tpu_torch.models.init import init_dual_ar_params
    from fish_speech_tpu_torch.text.tokenizer import ByteTokenizer
    from fish_speech_tpu_torch.tools import build_dataset, merge_lora, train
    from fish_speech_tpu_torch.train import (TrainBatch,
                                             cosine_warmup_schedule,
                                             make_optimizer, make_train_step)
    from fish_speech_tpu_torch.utils.checkpoint import (load_params,
                                                        save_params)

    t_phase = time.perf_counter()
    problems: list[str] = []
    report: dict = {"card": card}
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix=".smoke_train_", dir=root)
    for k in kernels.values():
        k.launches = 0
    try:
        # (a) the corpus
        rng = np.random.default_rng(SEED + 9)
        corpus, protos = (os.path.join(work, d) for d in ("corpus", "protos"))
        write_train_corpus(corpus, rng)
        n = build_dataset.main(["--input", corpus, "--output", protos])
        if n != TRAIN_SPEAKERS * TRAIN_CLIPS:
            problems.append(f"build_dataset wrote {n} sentences")

        # (b) LoRA through the CLI, on a checkpoint drawn from the seed
        tokenizer = ByteTokenizer()
        cfg = s2_pro_lm_config(max_seq_len=TRAIN_LEN).with_semantic_range(
            tokenizer.semantic_begin_id, tokenizer.semantic_end_id)
        gen = torch.Generator(device=dev).manual_seed(SEED + 9)
        drawn = init_dual_ar_params(gen, cfg, dtype=torch.bfloat16,
                                    device=dev)
        ckpt, out = (os.path.join(work, d) for d in ("base", "lora"))
        t0 = time.perf_counter()
        save_params(ckpt, drawn, cfg)
        report["write_base_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = train.main([
            "--proto-dir", protos, "--output-dir", out, "--checkpoint", ckpt,
            "--lora", "--max-steps", str(LORA_STEPS), "--batch-size",
            str(TRAIN_BATCH), "--max-length", str(TRAIN_LEN),
            "--warmup-steps", "1", "--checkpoint-every", "2",
            "--log-every", "1", "--device", str(dev)])
        torch.cuda.synchronize()
        report["lora_cli_s"] = time.perf_counter() - t0
        hist = r["history"]
        report["lora_history"] = hist
        if [h["step"] for h in hist] != list(range(1, LORA_STEPS + 1)) or \
                not all(math.isfinite(h[m]) for h in hist
                        for m in ("loss", "grad_norm")):
            problems.append(f"LoRA CLI: steps or losses wrong: {hist}")
        bad = trees_equal(r["params"], drawn)
        report["base_frozen"] = not bad
        if bad:
            problems.append(f"LoRA moved the base: {bad[:5]}")
        step2, _ = load_params(os.path.join(out, "step_000000002"),
                               device=dev)
        report["b_nonzero_after_step_2"] = sum(
            int(v["b"].count_nonzero()) for v in step2.values())
        if not report["b_nonzero_after_step_2"]:
            problems.append("every b factor is zero after step 2")
        final, cfg_final = load_params(r["final"], device=dev)
        bad = trees_equal(final, tree_to(r["state"], dev))
        if cfg_final is not None or bad:
            problems.append(f"the final LoRA checkpoint: config "
                            f"{cfg_final is not None}, differs at {bad[:5]}")
        report["lora_factors"] = len(final)
        del r, step2, final
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        diff = merge_lora.main(["--base", ckpt, "--lora",
                                os.path.join(out, f"step_{LORA_STEPS:09d}"
                                                  "_final"),
                                "--output", os.path.join(work, "merged"),
                                "--device", str(dev)])
        report["merge_s"] = time.perf_counter() - t0
        report["merge_l1"] = diff
        if not os.path.exists(os.path.join(work, "merged",
                                           "model.safetensors")):
            problems.append("merge_lora wrote no checkpoint")
        gc.collect()
        torch.cuda.empty_cache()

        # (c) a full finetune with make_train_step, remat on
        ds = SemanticIterableDataset([protos], tokenizer,
                                     max_length=TRAIN_LEN,
                                     num_codebooks=cfg.num_codebooks)
        loader = data_loader(ds, TextDataCollator(tokenizer, TRAIN_LEN),
                             TRAIN_BATCH)
        before = tree_to(drawn, dev)
        opt = make_optimizer(drawn, cosine_warmup_schedule(1e-4, 1,
                                                           FULL_STEPS))
        state = opt.init(drawn)
        step_fn = make_train_step(cfg, opt, remat=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for i in range(FULL_STEPS):
            batch = TrainBatch.from_numpy(next(loader), dev)
            t0 = time.perf_counter()
            _, state, m = step_fn(drawn, state, batch)
            m = {k: float(v) for k, v in m.items()}
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            tokens = batch.inputs.shape[0] * batch.inputs.shape[2]
            steps.append({"step": i + 1, "s": dt, "tokens": tokens,
                          "tokens_per_s": tokens / dt, **m})
            if not (math.isfinite(m["loss"]) and math.isfinite(
                    m["grad_norm"])):
                problems.append(f"full step {i + 1}: {m}")
            moved = trees_equal(drawn, before)
            if i == 0 and moved:
                problems.append(f"LR 0 moved {moved[:5]}")
            if i == 1 and not moved:
                problems.append("step 2 moved no parameter")
        report["full_steps"] = steps
        report["full_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del before, state, opt, step_fn, drawn
        gc.collect()
        torch.cuda.empty_cache()

        # (d) the card against the CPU
        versus = card_vs_cpu(dev)
        problems += versus.pop("problems")
        report["card_vs_cpu"] = versus
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (e) no hand-written kernel on the training path
    launches = {n: k.launches for n, k in kernels.items()}
    if any(launches.values()):
        problems.append(f"kernels launched in training: "
                        f"{ {n: c for n, c in launches.items() if c} }")
    report["launches"] = sum(launches.values())
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"train": report}), flush=True)
    log(f"phase 9: {report['phase_s']:.1f} s; LoRA CLI "
        f"{report['lora_cli_s']:.1f} s; full steps "
        + ", ".join(f"{s['s']:.2f} s ({s['tokens_per_s']:.0f} tok/s)"
                    for s in steps)
        + f"; peak {report['full_peak_gib']:.1f} GiB; card vs cpu "
        f"{versus['grads']}")
    for p in problems:
        chk.failed.append(f"train: {p}")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: tensor parallelism, two ranks on the one card over gloo
# ---------------------------------------------------------------------------

TP = 2               # phase 10: the model group's ranks, all on cuda:0,
TP_LAYERS = 12       # the slow stack's layers (S2-Pro's 36, cut: each
                     # layer's gloo collectives cost the host ~4 ms a frame),
TP_FRAMES = 32       # frames of 10a's requests,
TP_SHORT = 16        # of 10b, 10c and 10d's,
TP_PROMPT = 48       # tokens of a prompt,
TP_CACHE_LEN = 256   # the KV cache's positions,
TP_SLOTS = 4         # 10d's batcher slots,
TP_PHASE_S = 180.0   # the two ranks' time limit,
MULTIHOST_S = 120.0  # 10e's
# each case's route: the kernels that must launch on every rank, all
# others must not
TP_ROUTES = {
    "int8_b1_a": ("decode_attention_stream", "fast_sweep"),
    "int8_b1_b": ("decode_attention_stream", "fast_sweep"),
    "int8_b2": ("decode_attention_stream", "fast_sweep"),
    "blocks16": ("decode_attention_blocks", "fast_sweep"),
    "w4a8": ("decode_attention_stream", "fast_sweep", "w4a8_matmul"),
    "batcher": ("decode_attention_stream", "fast_sweep"),
}


def tp_prompts(cfg, n: int, seed: int):
    """n seeded (K+1, TP_PROMPT) prompts: text tokens, then semantic tokens
    with their codes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = TP_PROMPT
        p = np.zeros((cfg.num_codebooks + 1, t), np.int32)
        p[0] = rng.integers(0, cfg.semantic_begin_id, t)
        p[0, t // 2:] = rng.integers(cfg.semantic_begin_id,
                                     cfg.semantic_end_id + 1, t - t // 2)
        p[1:, t // 2:] = rng.integers(0, cfg.codebook_size,
                                      (cfg.num_codebooks, t - t // 2))
        out.append(p)
    return out


def first_parting(want, got, calls_want, calls_got, k: int) -> dict | None:
    """Where two (B, K+1, T) code arrays first part (batch row, frame, code
    row, in sampling order), with each side's five best logits of the
    sampling call there; None if they agree."""
    import numpy as np

    if want.shape == got.shape and np.array_equal(want, got):
        return None
    if want.shape != got.shape:
        return {"shapes": [list(want.shape), list(got.shape)]}
    b, r, f = min((int(b), int(r), int(f)) for b, r, f in
                  zip(*np.nonzero(want != got)))
    i = f * k + max(r - 1, 0)

    def top(calls):
        if i >= len(calls):
            return None
        v, idx = calls[i][b].topk(5)
        return {"values": v.tolist(), "indices": idx.tolist()}

    return {"row": b, "frame": f, "code_row": r,
            "codes": [int(want[b, r, f]), int(got[b, r, f])],
            "logits_tp1": top(calls_want), "logits_tp": top(calls_got)}


def tp_rank_main(rank: int, addr: str, out_dir: str) -> int:
    """One rank of phase 10 (`--tp-rank`): joins a gloo world of TP ranks
    on cuda:0, draws the S2-Pro weights from the seed, runs each case at
    TP = 1 (rank 0, on the whole weights) and then at TP = 2 on the rank's
    slices under decode_mesh, and writes DIR/rank{R}.json: per case the
    codes, the TP = 1 codes (rank 0), the seconds, the launches and the
    local shapes."""
    from datetime import timedelta

    import numpy as np
    import torch.distributed as dist

    from fish_speech_tpu_torch.engine.generate import serving_config
    from fish_speech_tpu_torch.engine.scheduler import (ContinuousBatcher,
                                                        SlotRequest)
    from fish_speech_tpu_torch.models.config import s2_pro_lm_config
    from fish_speech_tpu_torch.models.decode import SamplingConfig, generate
    from fish_speech_tpu_torch.models.init import init_dual_ar_params
    from fish_speech_tpu_torch.ops import attention, fast_fused, w4a8
    from fish_speech_tpu_torch.ops.fast_fused import enable_fused_fast_head
    from fish_speech_tpu_torch.ops.quant import quantize_lm_params
    from fish_speech_tpu_torch.ops.sampling import semantic_logit_bias
    from fish_speech_tpu_torch.parallel.mesh import (MeshConfig, create_mesh,
                                                     shard_dual_ar_params)
    from fish_speech_tpu_torch.parallel.tp import decode_mesh
    from fish_speech_tpu_torch.text.tokenizer import (IM_END_TOKEN,
                                                      ByteTokenizer)

    t_start = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=TP, rank=rank,
                            timeout=timedelta(seconds=60))
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(MeshConfig(data=1, model=TP), backend="gloo",
                       device=dev)
    kernels = {"decode_attention_stream": attention.KERNEL,
               "decode_attention_stream_bf16": attention.BF16_KERNEL,
               "decode_attention_stream_fold": attention.FOLD_KERNEL,
               "decode_attention_stream_head": attention.STREAM_HEAD_KERNEL,
               "decode_attention_blocks": attention.BLOCKS_KERNEL,
               "decode_attention_stacked_rows": attention.ROWS_KERNEL,
               "decode_attention": attention.DENSE_KERNEL,
               "decode_attention_stacked": attention.STACKED_KERNEL,
               "decode_attention_chunked": attention.CHUNKED_KERNEL,
               "w4a8_matmul": w4a8.KERNEL, "w4a8_matmul_pc": w4a8.KERNEL_PC,
               "fast_sweep": fast_fused.KERNEL}

    tokenizer = ByteTokenizer(n_semantic=4096)
    base = dataclasses.replace(
        s2_pro_lm_config(max_seq_len=TP_CACHE_LEN), n_layer=TP_LAYERS
    ).with_semantic_range(tokenizer.semantic_begin_id,
                          tokenizer.semantic_end_id)
    im_end = tokenizer.get_token_id(IM_END_TOKEN)
    bias = semantic_logit_bias(base.vocab_size, base.semantic_begin_id,
                               base.semantic_end_id, im_end, device=dev)
    # build_engine's LM draw at TP_LAYERS, then both serving quantizations
    gen = torch.Generator(device=dev).manual_seed(SEED)
    drawn = init_dual_ar_params(gen, base, dtype=torch.bfloat16, device=dev)
    whole = {"int8": enable_fused_fast_head(quantize_lm_params(drawn)),
             "w4a8": enable_fused_fast_head(quantize_lm_params(
                 drawn, mode="w4a8", groupsize=GROUPSIZE))}
    del drawn
    local = {q: shard_dual_ar_params(p, mesh) for q, p in whole.items()}
    if rank != 0:
        whole = None        # only rank 0 decodes at TP = 1
    gc.collect()
    torch.cuda.empty_cache()
    prompts = tp_prompts(base, 6, SEED + 10)
    cfg_pos = serving_config(base)
    cfg_blocks = serving_config(base, kv_layout="head", attn="blocks16")
    result = {"rank": rank, "setup_s": time.perf_counter() - t_start,
              "local_shapes": {
                  "wqkv": list(local["int8"]["layers"]["attention"]["wqkv"]
                               ["q"].shape),
                  "wo": list(local["int8"]["layers"]["attention"]["wo"]
                             ["q"].shape),
                  "w1": list(local["int8"]["layers"]["feed_forward"]["w1"]
                             ["q"].shape),
                  "w2": list(local["int8"]["layers"]["feed_forward"]["w2"]
                             ["q"].shape),
                  "w4a8_wqkv": list(local["w4a8"]["layers"]["attention"]
                                    ["wqkv"]["q4"].shape),
                  "w4a8_wo": list(local["w4a8"]["layers"]["attention"]["wo"]
                                  ["q4"].shape),
                  "fast_output": list(local["int8"]["fast_output"]["q"]
                                      .shape),
                  "kv_heads": cfg_pos.n_local_heads // TP},
              "cases": {}}

    def decode(params, cfg, batch, frames):
        prompt = torch.from_numpy(np.stack(batch))
        codes, _ = generate(params, cfg, prompt,
                            torch.zeros(len(batch), dtype=torch.int32), None,
                            SamplingConfig.create(), bias,
                            max_new_tokens=frames, im_end_id=im_end,
                            greedy=True, cache_len=TP_CACHE_LEN, device=dev)
        return codes.cpu().numpy()

    def batcher_codes(params, cfg, batch, frames):
        b = ContinuousBatcher(params, cfg, num_slots=TP_SLOTS,
                              cache_len=TP_CACHE_LEN, im_end_id=im_end,
                              bias=bias, greedy=True, prompt_bucket=64,
                              device=dev)
        out = b.run([SlotRequest(request_id=i, prompt=p,
                                 max_new_tokens=frames)
                     for i, p in enumerate(batch)])
        n = max(v.shape[1] for v in out.values())
        codes = np.full((len(batch), base.num_codebooks + 1, n), -1,
                        np.int32)
        for i, v in out.items():
            codes[i, :, :v.shape[1]] = v
        return codes

    cases = [("int8_b1_a", decode, "int8", cfg_pos, prompts[:1], TP_FRAMES),
             ("int8_b1_b", decode, "int8", cfg_pos, prompts[1:2], TP_FRAMES),
             ("int8_b2", decode, "int8", cfg_pos, prompts[:2], TP_FRAMES),
             ("blocks16", decode, "int8", cfg_blocks, prompts[2:3],
              TP_SHORT),
             ("w4a8", decode, "w4a8", cfg_pos, prompts[3:4], TP_SHORT),
             ("batcher", batcher_codes, "int8", cfg_pos, prompts[2:6],
              TP_SHORT)]
    for name, fn, quant, cfg, batch, frames in cases:
        ref = ref_calls = None
        if rank == 0:
            t0 = time.perf_counter()
            with LogitRecorder() as rec:
                ref = fn(whole[quant], cfg, batch, frames)
            torch.cuda.synchronize()
            tp1_s = time.perf_counter() - t0
            ref_calls = rec.calls
        dist.barrier()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        with decode_mesh(mesh), LogitRecorder() as rec:
            got = fn(local[quant], dataclasses.replace(cfg, tp_shards=TP),
                     batch, frames)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        case = {"codes": got.tolist(), "seconds": seconds,
                "launches": launches, "frames": int(got.shape[2])}
        if rank == 0:
            # the batcher's sampling calls are its ticks and prefills, not
            # frames: its parting is reported without logits
            per_frame = fn is decode
            case["tp1"] = ref.tolist()
            case["tp1_seconds"] = tp1_s
            case["parting"] = first_parting(
                ref, got, ref_calls if per_frame else [],
                rec.calls if per_frame else [], base.num_codebooks)
        result["cases"][name] = case
        log(f"  rank {rank} {name}: {seconds:.2f} s, frames "
            f"{case['frames']}, launches "
            f"{ {n: v for n, v in launches.items() if v} }")
        dist.barrier()
    result["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


def free_addr() -> str:
    """A free local port's address, for a world's rendezvous."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sk.getsockname()[1]}"


def spawn_ranks(argvs: list, timeout: float, label: str,
                envs: list | None = None) -> list:
    """This script once a rank (one argv each, `envs` their environments)
    to the end of all; each rank's (stdout, stderr). A rank that fails or
    outlives `timeout` (then all are killed) raises with every rank's
    output tails. The ranks' "  rank ..." progress lines are logged."""
    script = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, script, *argv], cwd=os.path.dirname(script),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for argv, env in zip(argvs, envs or [cli_env()] * len(argvs))]
    outs, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate() for p in procs]
        raise RuntimeError(f"{label} ranks outlived {timeout:.0f} s:\n"
                           + "\n".join(f"--- rank {r}\n{o[-3000:]}{e[-3000:]}"
                                       for r, (o, e) in enumerate(outs)))
    for o, e in outs:
        for line in (o + e).splitlines():
            if line.startswith("  rank "):
                log(line)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError("\n".join(
            f"{label} rank {r} exited {procs[r].returncode}:\n"
            f"{outs[r][0][-2000:]}{outs[r][1][-4000:]}" for r in bad))
    return outs


def read_ranks(out_dir: str, n: int, name: str = "rank") -> list:
    out = []
    for r in range(n):
        with open(os.path.join(out_dir, f"{name}{r}.json")) as f:
            out.append(json.load(f))
    return out


def spawn_tp_ranks(out_dir: str, timeout: float) -> list:
    """Phase 10's two ranks (this script with --tp-rank) to their end;
    their rank{R}.json results."""
    addr = free_addr()
    spawn_ranks([["--tp-rank", str(r), "--tp-addr", addr, "--tp-out",
                  out_dir] for r in range(TP)], timeout, "phase 10")
    return read_ranks(out_dir, TP)


def multihost_server_check(workdir: str, timeout: float) -> dict:
    """10e: `tools.api_server --multihost` in demo mode, leader and
    follower on cuda:0 over gloo, each logging its requests' codes
    (--codes-log). One /v1/tts to the leader must give a wav of frames x
    the demo codec's frame length finite samples; SIGINT to the leader
    sends the shutdown plan; both must exit 0 with the same codes logged.
    Returns the check's numbers and its problems."""
    import re
    import signal

    from fish_speech_tpu_torch.tools.api_server import demo_codec

    coord = free_addr()
    fl = demo_codec(torch.device("cpu"))[0].frame_length
    codes_log = os.path.join(workdir, "codes")
    t0 = time.perf_counter()
    procs, errs = [], []
    for pid in range(2):
        err = open(os.path.join(workdir, f"multihost{pid}.err"), "w")
        errs.append(err)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fish_speech_tpu_torch.tools.api_server",
             "--multihost", "--coordinator", coord, "--num-processes", "2",
             "--process-id", str(pid), "--scheduler-slots", "2",
             "--cache-len", "512", "--listen", "127.0.0.1:0",
             "--vocoder-impl", "pallas", "--codes-log", codes_log,
             "--references-dir", os.path.join(workdir, "refs")],
            cwd=workdir, env=cli_env(), stdout=subprocess.PIPE, stderr=err,
            text=True))
    problems, report = [], {"frame_length": fl}
    deadline = time.monotonic() + timeout
    try:
        import queue
        import threading

        lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: [lines.put(x) for x in
                                         procs[0].stdout], daemon=True).start()
        m = None
        while m is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                break
            m = re.search(r"http://127\.0\.0\.1:(\d+), vocoder (\w+)$",
                          line.strip())
        if m is None:
            raise RuntimeError("the multihost leader did not serve within "
                               f"{timeout} s")
        report["up_s"] = time.perf_counter() - t0
        status, _, body, secs = Client(int(m.group(1)), None).call(
            "POST", "/v1/tts", {"text": "multihost", "max_new_tokens": 16})
        report["tts_s"] = secs
        frames, problem = audio_frames(body, "wav", fl, 16)
        report["frames"] = frames
        if status != 200 or problem:
            problems.append(f"10e /v1/tts: {status} {problem}")
        if procs[1].poll() is not None:
            problems.append("10e: the follower exited while serving")
        procs[0].send_signal(signal.SIGINT)
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        report["exit_codes"] = [p.returncode for p in procs]
        if report["exit_codes"] != [0, 0]:
            problems.append(f"10e exit codes {report['exit_codes']}")
        logs = []
        for pid in range(2):
            path = f"{codes_log}.{pid}"
            with open(path) as f:
                logs.append([json.loads(x) for x in f.read().splitlines()])
        report["requests_logged"] = [len(x) for x in logs]
        report["codes_equal"] = logs[0] == logs[1] and len(logs[0]) >= 2
        if not report["codes_equal"]:
            problems.append("10e: the follower's codes differ from the "
                            "leader's")
        elif frames and len(logs[0][-1]["codes"]) != frames:
            problems.append(f"10e: {frames} frames served, "
                            f"{len(logs[0][-1]['codes'])} logged")
    except Exception as e:  # noqa: BLE001 - reported, fails the phase
        problems.append(f"10e: {e!r}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for err in errs:
            err.close()
        if problems:
            for pid in range(2):
                with open(os.path.join(workdir, f"multihost{pid}.err")) as f:
                    log(f"  multihost {pid} stderr tail: {f.read()[-1500:]}")
    report["seconds"] = time.perf_counter() - t0
    return report, problems


def run_parallel(kernels: dict, chk: Checks, card: str) -> dict:
    """Phase 10 (see the module docstring): the two ranks' cases, then the
    multihost server. Prints the {"parallel": ...} line and returns the
    ranks' launches summed (the path's counts)."""
    import shutil
    import tempfile

    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix=".smoke_tp_", dir=root)
    t0 = time.perf_counter()
    report = {"card": card, "ranks": TP, "backend": "gloo",
              "device": "cuda:0 (both ranks)", "cases": {}}
    problems = []
    total = {n: 0 for n in kernels}
    try:
        ranks = spawn_tp_ranks(work, TP_PHASE_S)
        report["local_shapes"] = [r["local_shapes"] for r in ranks]
        report["setup_s"] = [r["setup_s"] for r in ranks]
        for name, route in TP_ROUTES.items():
            cs = [r["cases"][name] for r in ranks]
            tp1 = np.asarray(cs[0]["tp1"])
            equal = all(np.array_equal(np.asarray(c["codes"]), tp1)
                        for c in cs)
            entry = {"codes_equal": equal, "frames": cs[0]["frames"],
                     "tp1_seconds": cs[0]["tp1_seconds"],
                     "seconds": [c["seconds"] for c in cs],
                     "launches": [{n: v for n, v in c["launches"].items()
                                   if v} for c in cs]}
            if not equal:
                entry["parting"] = cs[0]["parting"]
                problems.append(f"10 {name}: TP = {TP} codes differ from "
                                f"TP = 1")
            for r, c in enumerate(cs):
                missing = [n for n in route if c["launches"][n] < 1]
                stray = [n for n, v in c["launches"].items()
                         if v and n not in route]
                if missing or stray:
                    problems.append(f"10 {name} rank {r}: not launched "
                                    f"{missing}, launched off route {stray}")
                for n, v in c["launches"].items():
                    total[n] += v
            report["cases"][name] = entry
    except Exception as e:  # noqa: BLE001 - reported, fails the phase
        problems.append(f"10 ranks: {e!r}")
    mh, mh_problems = multihost_server_check(work, MULTIHOST_S)
    report["multihost"] = mh
    problems += mh_problems
    shutil.rmtree(work, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t0
    report["problems"] = problems
    print(json.dumps({"parallel": report}), flush=True)
    chk.failed += problems
    return total


# ---------------------------------------------------------------------------
# Phase 11: the tools (quantize, quant_drift, latency_bench, profile_decode,
# extract_vq) at full S2-Pro width
# ---------------------------------------------------------------------------

# QUANT_DRIFT.md's go bounds that the phase holds the full serving
# configuration to: the two it calls distribution-robust. Its third, top-1
# in the bf16 top-5 >= 0.99, is in the drift lines and not held here:
# PERF.md's Findings list the seeds' misses of the random weights and
# ROADMAP's Queue C the bound's restatement
DRIFT_BOUNDS = {"max_abs_dlogit": 1.0, "mean_abs_dlogit": 0.10}
LATENCY_ARGS = ("--full", "--quant", "--kv-int8", "--w8a8", "--pallas-attn",
                "stream", "--fused-fast", "--kv-layout", "pos", "--slots",
                "2", "--max-new", "24")
PROFILE_SHAPES = ((1, 2048), (64, 384))   # (batch, cache) of 11d
PROFILE_STEPS = 8     # decode steps a profile (the profiler's host-side
                      # bookkeeping grows with its events)
PROFILE_ROWS = 6      # kernels of each profile in the phase's report
TOOLS_WAVS = 3        # 11e: seeded waveforms
TOOLS_WAV_S = 3.0     # of this many seconds
TOOLS_PHASE_S = 150.0


def drift_gate(results: dict) -> list[str]:
    """The full serving configuration's parts outside the max / mean go
    bounds."""
    return [f"11b {r['compare']} outside the go bounds: {r}"
            for r in results["serving_full"]
            if not all(r[k] <= v for k, v in DRIFT_BOUNDS.items())]


def run_tools(kernels: dict, chk: Checks, card: str, dev) -> tuple:
    """Phase 11: the port's tools at full S2-Pro width, weights drawn from
    the seed on the card. (a) a bf16 native checkpoint through
    tools.quantize --mode int8 and w4a8, the loaded leaves bit-equal to
    quantize_lm_params of the drawn tree; (b) tools.quant_drift at its
    defaults (36 layers, B = 8, prompt 48, 16 steps, cache 256), the full
    serving configuration within QUANT_DRIFT.md's max and mean go bounds,
    the others logged; (c)
    tools.latency_bench on the full serving flags: finite TTFA and RTF,
    audio > 0; (d) tools.profile_decode at B = 1 over a
    2048 cache and B = 64 over 384, 32 steps each: #1 and #2 among the
    device kernels, the idle share logged; (e) tools.extract_vq with a
    seeded S2-Pro codec.pth on three seeded 3 s waveforms: each file's
    codes equal encode_reference's. #1, #2 and #11 must launch. Prints
    the {"tools": ...} line; returns the phase's launch counts and its
    compact summary."""
    import shutil
    import tempfile

    import numpy as np

    from fish_speech_tpu_torch.codec.config import s2_pro_codec_config
    from fish_speech_tpu_torch.codec.init import init_dac_params
    from fish_speech_tpu_torch.codec.model import encode_reference
    from fish_speech_tpu_torch.models.config import s2_pro_lm_config
    from fish_speech_tpu_torch.models.init import init_dual_ar_params
    from fish_speech_tpu_torch.ops.quant import quantize_lm_params
    from fish_speech_tpu_torch.serve.wav import decode_audio_bytes, encode_wav
    from fish_speech_tpu_torch.tools import (extract_vq, latency_bench,
                                             profile_decode, quant_drift,
                                             quantize)
    from fish_speech_tpu_torch.tools.quantize import tree_bytes
    from fish_speech_tpu_torch.utils.checkpoint import (load_params,
                                                        save_params)
    from fish_speech_tpu_torch.utils.profiling import table_lines

    t_phase = time.perf_counter()
    problems: list[str] = []
    report: dict = {"card": card}
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix=".smoke_tools_", dir=root)
    for k in kernels.values():
        k.launches = 0
    # 11c's stream_tts decodes through the streaming vocoder (plain f32):
    # #3/#4 run only in the engine's warm-up of its buckets
    need = {"decode_attention_stream": "11b-d", "fast_sweep": "11b-d",
            "w4a8_matmul": "11b"}
    try:
        # (a) quantize: the CLI against quantize_lm_params, bit for bit
        t0 = time.perf_counter()
        cfg = s2_pro_lm_config(max_seq_len=SERVER_CACHE_LEN)
        drawn = init_dual_ar_params(
            torch.Generator(device=dev).manual_seed(SEED + 11), cfg,
            dtype=torch.bfloat16, device=dev)
        src = os.path.join(work, "bf16")
        save_params(src, drawn, cfg)
        quant = {"bf16_gb": tree_bytes(drawn) / 1e9,
                 "write_s": time.perf_counter() - t0}
        for mode in ("int8", "w4a8"):
            t0 = time.perf_counter()
            out = quantize.main(["--checkpoint", src, "--output",
                                 os.path.join(work, mode), "--mode", mode,
                                 "--groupsize", str(GROUPSIZE)])
            cli_s = time.perf_counter() - t0
            loaded, _ = load_params(out, device=dev)
            want = quantize_lm_params(drawn, mode=mode, groupsize=GROUPSIZE)
            diff = trees_equal(loaded, want)
            quant[mode] = {"gb": tree_bytes(loaded) / 1e9, "cli_s": cli_s,
                           "leaves_equal": not diff}
            if diff:
                problems.append(f"11a {mode}: {len(diff)} leaves differ "
                                f"from quantize_lm_params, e.g. {diff[:3]}")
            log(f"  11a quantize {mode}: {quant['bf16_gb']:.2f} GB -> "
                f"{quant[mode]['gb']:.2f} GB in {cli_s:.1f} s, leaves "
                f"{'bit-equal' if not diff else 'DIFFER'}")
            del loaded, want
            shutil.rmtree(out, ignore_errors=True)
        del drawn
        shutil.rmtree(src, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        report["quantize"] = quant

        # (b) quant_drift at its defaults
        t0 = time.perf_counter()
        drift = quant_drift.main([])
        report["quant_drift"] = {
            "seconds": time.perf_counter() - t0,
            **{f"{name}/{part}": {k: r[k] for k in (
                "max_abs_dlogit", "mean_abs_dlogit", "top1_agree",
                "top1_in_ref_top5")}
               for name, rs in drift.items()
               for part, r in zip(quant_drift.PARTS, rs)}}
        problems += drift_gate(drift)
        gc.collect()
        torch.cuda.empty_cache()

        # (c) latency_bench on the full serving flags
        t0 = time.perf_counter()
        lat = latency_bench.main(list(LATENCY_ARGS))
        report["latency_bench"] = {**lat,
                                   "seconds": time.perf_counter() - t0}
        if not (lat["ttfa_s"] is not None and math.isfinite(lat["ttfa_s"])
                and math.isfinite(lat["rtf"]) and lat["audio_s"] > 0):
            problems.append(f"11c latency_bench: {lat}")
        gc.collect()
        torch.cuda.empty_cache()

        # (d) profile_decode at the two shapes
        profiles = {}
        for b, cache in PROFILE_SHAPES:
            t0 = time.perf_counter()
            # no --logdir: the chrome trace of 32 steps takes tens of
            # seconds to write
            table = profile_decode.main([
                "--batch", str(b), "--cache", str(cache), "--steps",
                str(PROFILE_STEPS), "--kv-int8", "--pallas", "stream",
                "--fused-fast", "--kv-layout", "pos",
                "--top", str(PROFILE_ROWS)])
            names = " ".join(k["name"] for k in table["kernels"])
            found = {n: n in names for n in ("pos_attn_kernel",
                                             "sweep_kernel")}
            profiles[f"b{b}_cache{cache}"] = {
                "seconds": time.perf_counter() - t0,
                "wall_ms": table["wall_ms"], "busy_ms": table["busy_ms"],
                "idle_share": table["idle_share"], "found": found,
                "top": [[k["name"][:60], round(k["ms"], 3), k["count"]]
                        for k in table["kernels"][:PROFILE_ROWS]]}
            for line in table_lines(table, f"  11d profile_decode B={b} "
                                    f"cache={cache}", PROFILE_ROWS):
                log(line)
            if not all(found.values()):
                problems.append(f"11d B={b}: #1 / #2 not among the "
                                f"device kernels: {found}")
            gc.collect()
            torch.cuda.empty_cache()
        report["profile_decode"] = profiles

        # (e) extract_vq with a seeded S2-Pro codec.pth
        t0 = time.perf_counter()
        ccfg = s2_pro_codec_config()
        cparams = init_dac_params(
            torch.Generator(device=dev).manual_seed(SEED + 12), ccfg,
            device=dev)
        pth = os.path.join(work, "codec.pth")
        torch.save(codec_state_dict(cparams, ccfg), pth)
        del cparams
        corpus = os.path.join(work, "corpus")
        os.makedirs(corpus)
        rng = np.random.default_rng(SEED + 13)
        n = int(TOOLS_WAV_S * ccfg.sample_rate)
        for i in range(TOOLS_WAVS):
            wav = (0.3 * rng.standard_normal(n)).astype(np.float32)
            with open(os.path.join(corpus, f"w{i}.wav"), "wb") as f:
                f.write(encode_wav(wav, ccfg.sample_rate))
        written = extract_vq.main([corpus, "--codec-checkpoint", pth])
        loaded_codec, _ = extract_vq.load_codec(pth, dev)
        equal = []
        for i in range(TOOLS_WAVS):
            path = os.path.join(corpus, f"w{i}")
            with open(path + ".wav", "rb") as f:
                wav = decode_audio_bytes(f.read(), ccfg.sample_rate)
            got = np.load(path + ".npy")
            want = encode_reference(loaded_codec, ccfg, wav, device=dev)
            equal.append(bool(np.array_equal(got, want)))
        report["extract_vq"] = {"files": written, "codes_equal": equal,
                                "frames": int(got.shape[1]),
                                "seconds": time.perf_counter() - t0}
        if written != TOOLS_WAVS or not all(equal):
            problems.append(f"11e extract_vq: {written} files, codes equal "
                            f"{equal}")
        del loaded_codec
    except Exception as e:  # noqa: BLE001 - reported, fails the phase
        import traceback

        traceback.print_exc()
        problems.append(f"11: {e!r}")
    shutil.rmtree(work, ignore_errors=True)
    launches = {n: k.launches for n, k in kernels.items()}
    missing = [f"{n} ({where})" for n, where in need.items()
               if launches[n] < 1]
    if missing:
        problems.append(f"11: not launched: {missing}")
    report["launches"] = {n: v for n, v in launches.items() if v}
    report["seconds"] = time.perf_counter() - t_phase
    if report["seconds"] > TOOLS_PHASE_S:
        problems.append(f"11: {report['seconds']:.1f} s, over its "
                        f"{TOOLS_PHASE_S:.0f} s")
    report["problems"] = problems
    print(json.dumps({"tools": report}), flush=True)
    chk.failed += problems
    gc.collect()
    torch.cuda.empty_cache()
    return launches, tools_summary(report)


def tools_summary(report: dict) -> dict:
    """Phase 11's key numbers for its compact line."""
    out = {}
    if "quantize" in report:
        q = report["quantize"]
        out["quantize"] = {m: [round(q[m]["gb"], 2), q[m]["leaves_equal"]]
                           for m in ("int8", "w4a8") if m in q}
        out["quantize"]["bf16_gb"] = round(q["bf16_gb"], 2)
    if "quant_drift" in report:
        out["serving_full"] = {
            part: [v["max_abs_dlogit"], v["mean_abs_dlogit"],
                   v["top1_in_ref_top5"]]
            for k, v in report["quant_drift"].items()
            if isinstance(v, dict) and k.startswith("serving_full/")
            for part in [k.split("/")[1]]}
    if "latency_bench" in report:
        out.update({k: report["latency_bench"].get(k)
                    for k in ("ttfa_s", "rtf", "audio_s")})
    if "profile_decode" in report:
        out["idle_share"] = {k: v["idle_share"]
                             for k, v in report["profile_decode"].items()}
    if "extract_vq" in report:
        out["codes_equal"] = all(report["extract_vq"]["codes_equal"])
    return out


# ---------------------------------------------------------------------------
# Phase 12: training and the vocoder under the (data, model) mesh, two
# ranks on the one card over gloo
# ---------------------------------------------------------------------------

MESH_RANKS = 2        # phase 12: the world's ranks, all on cuda:0,
MESH_TRAIN_LEN = 512  # 12a's tokens a row,
MESH_TRAIN_B = 2      # its global batch,
MESH_LOSS_RTOL = 1e-2  # step 1 against TP = 1: the loss,
MESH_NORM_RTOL = 5e-2  # the gradient norm (bf16 over 36 layers),
MESH_CLI_STEPS = 2    # 12b's steps,
MESH_FACTOR_TOL = 2 ** -2  # a final factor's gap over its L2 norm,
MESH_VOC_ROWS = 4     # 12c's code sequences,
MESH_VOC_FRAMES = 64  # of this many frames,
MESH_PHASE_S = 240.0  # the phase's time limit
# the kernels of 12c's route (and none in 12a or 12b)
MESH_VOC_ROUTE = ("voc_block", "voc_res_stack")


def mesh_train_batch(cfg) -> dict:
    """12a's global batch (numpy, the same on every rank): text, then
    semantic tokens with codes; an ignored prefix; row 1 padded at its
    tail."""
    import numpy as np

    rng = np.random.default_rng(SEED + 12)
    b, t, k = MESH_TRAIN_B, MESH_TRAIN_LEN, cfg.num_codebooks
    tokens = rng.integers(0, cfg.vocab_size, (b, 1, t))
    tokens[:, 0, t // 4:] = rng.integers(cfg.semantic_begin_id,
                                         cfg.semantic_end_id + 1,
                                         (b, t - t // 4))
    inputs = np.concatenate([tokens, rng.integers(0, cfg.codebook_size,
                                                  (b, k, t))], 1)
    labels = inputs.copy()
    labels[:, :, :16] = -100
    masks = np.zeros((b, t), bool)
    masks[1, -32:] = True
    return {"inputs": inputs.astype(np.int32),
            "labels": labels.astype(np.int32), "attention_masks": masks}


def replicated_equal(params: dict, mesh) -> list[str]:
    """The replicated leaves (no `model` axis in their spec) that differ
    from rank 0's bit for bit (rank 0's broadcast over the model
    group)."""
    import torch.distributed as dist

    from fish_speech_tpu_torch.parallel.mesh import (MODEL_AXIS,
                                                     dual_ar_param_specs)
    from fish_speech_tpu_torch.train.step import tree_leaves

    specs = dict(tree_leaves(dual_ar_param_specs(params)))
    bad = []
    for path, leaf in tree_leaves(params):
        if MODEL_AXIS in specs[path]:
            continue
        theirs = leaf.detach().clone()
        dist.broadcast(theirs, dist.get_global_rank(mesh.model_group, 0),
                       group=mesh.model_group)
        if not torch.equal(theirs, leaf.detach()):
            bad.append("/".join(path))
    return bad


def factor_gaps(got: dict, want: dict) -> dict:
    """Each LoRA factor's distance from `want`'s over its L2 norm."""
    out = {}
    for key in want:
        for n in ("a", "b"):
            w, g = want[key][n].float(), got[key][n].float()
            out[f"{key}/{n}"] = float((g - w).norm()
                                      / w.norm().clamp_min(1e-30))
    return out


def mesh_rank_main(rank: int, addr: str, out_dir: str) -> int:
    """One rank of phase 12 (`--mesh-rank`): joins a gloo world of
    MESH_RANKS ranks on cuda:0, builds the (data 1, model 2) and (data 2,
    model 1) meshes, and writes DIR/rank{R}.json with (a) the full
    finetune under the model group (rank 0 first takes the TP = 1 step on
    the whole tree) and (c) the vocoder over the data group."""
    from datetime import timedelta

    import numpy as np
    import torch.distributed as dist

    from fish_speech_tpu_torch.codec.config import s2_pro_codec_config
    from fish_speech_tpu_torch.codec.fastpath import (dac_from_indices_fused,
                                                      pack_decoder)
    from fish_speech_tpu_torch.codec.init import init_dac_params
    from fish_speech_tpu_torch.models.config import s2_pro_lm_config
    from fish_speech_tpu_torch.models.init import init_dual_ar_params
    from fish_speech_tpu_torch.parallel.mesh import (MeshConfig, create_mesh,
                                                     shard_dual_ar_params)
    from fish_speech_tpu_torch.parallel.vocoder import decode_data_parallel
    from fish_speech_tpu_torch.text.tokenizer import ByteTokenizer
    from fish_speech_tpu_torch.train import (TrainBatch,
                                             cosine_warmup_schedule,
                                             make_optimizer, make_train_step)
    from fish_speech_tpu_torch.train.step import tree_leaves

    t_start = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                            world_size=MESH_RANKS, rank=rank,
                            timeout=timedelta(seconds=60))
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    tp_mesh = create_mesh(MeshConfig(data=1, model=MESH_RANKS),
                          backend="gloo", device=dev)
    dp_mesh = create_mesh(MeshConfig(data=MESH_RANKS, model=1),
                          backend="gloo", device=dev)
    kernels = kernel_counters()
    result: dict = {"rank": rank}

    def launched() -> dict:
        return {n: k.launches for n, k in kernels.items() if k.launches}

    # (a) the full finetune at full S2-Pro width and depth, bf16
    tokenizer = ByteTokenizer()
    cfg = s2_pro_lm_config(max_seq_len=MESH_TRAIN_LEN).with_semantic_range(
        tokenizer.semantic_begin_id, tokenizer.semantic_end_id)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    whole = init_dual_ar_params(gen, cfg, dtype=torch.bfloat16, device=dev)
    batch = TrainBatch.from_numpy(mesh_train_batch(cfg), dev)
    schedule = cosine_warmup_schedule(1e-4, 1, 10)   # step 1 at LR 0
    for k in kernels.values():
        k.launches = 0
    if rank == 0:
        opt = make_optimizer(whole, schedule)
        t0 = time.perf_counter()
        m = make_train_step(cfg, opt, remat=True)(whole, opt.init(whole),
                                                   batch)[2]
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        result["tp1"] = {"s": time.perf_counter() - t0, **m}
        del opt             # LR 0 left the whole tree as it was
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    local = shard_dual_ar_params(whole, tp_mesh)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = make_optimizer(local, schedule)
    state = opt.init(local)
    step_fn = make_train_step(cfg, opt, remat=True, mesh=tp_mesh)
    steps = []
    for i in range(2):
        t0 = time.perf_counter()
        local, state, m = step_fn(local, state, batch)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        steps.append({"step": i + 1, "s": time.perf_counter() - t0, **m})
    result["steps"] = steps
    result["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    result["finite"] = all(bool(torch.isfinite(p).all())
                           for _, p in tree_leaves(local))
    result["replicated_differ"] = replicated_equal(local, tp_mesh)
    result["train_launches"] = launched()
    del local, state, opt, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  rank {rank} 12a: steps "
        + ", ".join(f"{s['s']:.2f} s" for s in steps)
        + f", peak {result['peak_gib']:.1f} GiB")

    # (c) the vocoder over the data axis: weights replicated, rows split
    ccfg = s2_pro_codec_config()
    cparams = init_dac_params(torch.Generator(device=dev).manual_seed(
        SEED + 12), ccfg, device=dev)
    packed = pack_decoder(cparams["decoder"], ccfg, dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED + 12)
    codes = np.concatenate([
        rng.integers(0, ccfg.rvq.semantic_codebook_size,
                     (MESH_VOC_ROWS, 1, MESH_VOC_FRAMES)),
        rng.integers(0, ccfg.rvq.codebook_size,
                     (MESH_VOC_ROWS, ccfg.rvq.n_codebooks, MESH_VOC_FRAMES))],
        axis=1)
    codes = torch.from_numpy(codes).to(dev)
    dac_from_indices_fused(cparams, ccfg, codes[:1], packed=packed,
                           device=dev)            # the kernels' first use
    torch.cuda.synchronize()
    dist.barrier()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    wav = decode_data_parallel(cparams, ccfg, codes, dp_mesh, packed=packed)
    torch.cuda.synchronize()
    result["vocoder"] = {"s": time.perf_counter() - t0,
                         "shape": list(wav.shape),
                         "launches": launched()}
    if rank == 0:
        ref = dac_from_indices_fused(cparams, ccfg, codes, packed=packed,
                                     device=dev)
        result["vocoder"]["max_abs_err_vs_whole"] = max_err(wav, ref)
        result["vocoder"]["finite"] = bool(torch.isfinite(wav).all())
    result["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def cli_rank_main(out: str, argv: list) -> int:
    """One rank of 12b (`--cli-out FILE -- ARGS`): the training CLI's
    `main(ARGS)` under the world's environment, then its logged metrics
    and this rank's launches into FILE."""
    from fish_speech_tpu_torch.tools import train

    kernels = kernel_counters()
    for k in kernels.values():
        k.launches = 0
    r = train.main(argv)
    with open(out, "w") as f:
        json.dump({"history": r["history"], "final": str(r["final"]),
                   "launches": {n: k.launches for n, k in kernels.items()
                                if k.launches}}, f)
    return 0


def spawn_cli_ranks(argv: list, out_dir: str, timeout: float) -> list:
    """12b's CLI ranks (this script with --cli-out) under torchrun's
    environment on cuda:0; each rank's (stdout, its JSON)."""
    host, port = free_addr().split(":")
    envs = [dict(cli_env(), RANK=str(r), WORLD_SIZE=str(MESH_RANKS),
                 LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(MESH_RANKS),
                 MASTER_ADDR=host, MASTER_PORT=port)
            for r in range(MESH_RANKS)]
    outs = spawn_ranks([["--cli-out", os.path.join(out_dir, f"cli{r}.json"),
                         "--", *argv] for r in range(MESH_RANKS)], timeout,
                       "12b", envs)
    return list(zip((o for o, _ in outs),
                    read_ranks(out_dir, MESH_RANKS, "cli")))


def run_mesh(kernels: dict, chk: Checks, card: str, dev) -> tuple:
    """Phase 12 (see the module docstring): (a) and (c) in two ranks of
    this script (`--mesh-rank`), then (b) the training CLI as one process
    (in this one) and as two ranks. Prints the {"mesh": ...} line and
    returns 12c's launches summed over the ranks (the path's counts) and
    the phase's key numbers."""
    import shutil
    import tempfile

    import numpy as np

    from fish_speech_tpu_torch.codec.config import s2_pro_codec_config
    from fish_speech_tpu_torch.models.config import s2_pro_lm_config
    from fish_speech_tpu_torch.models.init import init_dual_ar_params
    from fish_speech_tpu_torch.text.tokenizer import ByteTokenizer
    from fish_speech_tpu_torch.tools import build_dataset, train
    from fish_speech_tpu_torch.utils.checkpoint import (load_params,
                                                        save_params)

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix=".smoke_mesh_", dir=root)
    report: dict = {"card": card, "ranks": MESH_RANKS, "backend": "gloo",
                    "device": "cuda:0 (every rank)",
                    "note": "the ranks time-share one card: their seconds "
                            "are no measure of parallel speed"}
    problems: list[str] = []
    total = {n: 0 for n in kernels}

    def left() -> float:
        return MESH_PHASE_S - (time.perf_counter() - t_phase)

    try:
        # (a) and (c), one world serving both meshes
        addr = free_addr()
        spawn_ranks([["--mesh-rank", str(r), "--mesh-addr", addr,
                      "--mesh-out", work] for r in range(MESH_RANKS)],
                    left(), "12a/c")
        ranks = read_ranks(work, MESH_RANKS)
        tp1, steps = ranks[0]["tp1"], [r["steps"] for r in ranks]
        s1 = steps[0][0]
        gaps = {"loss": abs(s1["loss"] - tp1["loss"]) / abs(tp1["loss"]),
                "grad_norm": abs(s1["grad_norm"] - tp1["grad_norm"])
                / abs(tp1["grad_norm"])}
        report["a"] = {"tp1": tp1, "steps": steps, "step1_rel_gap": gaps,
                       "peak_gib": [r["peak_gib"] for r in ranks],
                       "batch": [MESH_TRAIN_B, MESH_TRAIN_LEN]}
        if gaps["loss"] > MESH_LOSS_RTOL or gaps["grad_norm"] > MESH_NORM_RTOL:
            problems.append(f"12a step 1 against TP = 1: {gaps}")
        if any(a[m] != b[m] for a, b in zip(steps[0], steps[1])
               for m in ("loss", "grad_norm")):
            problems.append("12a: the ranks' metrics differ")
        for r, rk in enumerate(ranks):
            if not rk["finite"] or not all(math.isfinite(s[m]) for s in
                                           rk["steps"] for m in
                                           ("loss", "grad_norm")):
                problems.append(f"12a rank {r}: not finite after step 2")
            if rk["replicated_differ"]:
                problems.append(f"12a rank {r}: replicated leaves differ "
                                f"from rank 0's: {rk['replicated_differ']}")
            if rk["train_launches"]:
                problems.append(f"12a rank {r} launched "
                                f"{rk['train_launches']}")
        # (c)
        voc = [r["vocoder"] for r in ranks]
        report["c"] = voc
        err = voc[0]["max_abs_err_vs_whole"]
        frame = s2_pro_codec_config().frame_length
        if not voc[0]["finite"] or err > BATCH_TOL or voc[0]["shape"] != [
                MESH_VOC_ROWS, MESH_VOC_FRAMES * frame]:
            problems.append(f"12c: {voc[0]}")
        for r, v in enumerate(voc):
            missing = [n for n in MESH_VOC_ROUTE
                       if v["launches"].get(n, 0) < 1]
            stray = [n for n in v["launches"] if n not in MESH_VOC_ROUTE]
            if missing or stray:
                problems.append(f"12c rank {r}: not launched {missing}, "
                                f"launched off route {stray}")
            for n, c in v["launches"].items():
                total[n] += c
    except Exception as e:  # noqa: BLE001 - reported, fails the phase
        problems.append(f"12a/c: {e!r}")

    try:
        # (b) the training CLI: one process, then two ranks (--data-parallel)
        rng = np.random.default_rng(SEED + 9)
        corpus, protos = (os.path.join(work, d) for d in ("corpus", "protos"))
        write_train_corpus(corpus, rng)
        build_dataset.main(["--input", corpus, "--output", protos])
        tokenizer = ByteTokenizer()
        cfg = s2_pro_lm_config(max_seq_len=TRAIN_LEN).with_semantic_range(
            tokenizer.semantic_begin_id, tokenizer.semantic_end_id)
        drawn = init_dual_ar_params(torch.Generator(device=dev).manual_seed(
            SEED + 12), cfg, dtype=torch.bfloat16, device=dev)
        ckpt = os.path.join(work, "base")
        save_params(ckpt, drawn, cfg)
        del drawn
        gc.collect()
        torch.cuda.empty_cache()
        common = ["--proto-dir", protos, "--lora",
                  "--max-steps", str(MESH_CLI_STEPS), "--batch-size",
                  str(TRAIN_BATCH), "--max-length", str(TRAIN_LEN),
                  "--warmup-steps", "0", "--checkpoint-every", "1",
                  "--log-every", "1", "--device", "cuda:0"]
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        one = train.main(common + ["--checkpoint", ckpt, "--output-dir",
                                   os.path.join(work, "one")])
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        one_launches = {n: k.launches for n, k in kernels.items()
                        if k.launches}
        one_final = str(one["final"])
        one_hist = one["history"]
        del one
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        two_dir = os.path.join(work, "two")
        clis = spawn_cli_ranks(common + ["--checkpoint", ckpt,
                                         "--output-dir", two_dir,
                                         "--data-parallel",
                                         str(MESH_RANKS)], work, left())
        two_s = time.perf_counter() - t0
        two_hist = clis[0][1]["history"]

        def rel_gaps(metric: str) -> list:
            return [abs(a[metric] - b[metric]) / abs(b[metric])
                    for a, b in zip(two_hist, one_hist)]

        loss_gaps, norm_gaps = rel_gaps("loss"), rel_gaps("grad_norm")
        f_one, _ = load_params(one_final, device="cpu")
        f_two, _ = load_params(clis[0][1]["final"], device="cpu")
        # a factor's scale is its L2 norm: Adam's step normalizes each
        # entry by its own gradient, so an entry whose gradient nearly
        # cancels moves by a step that follows the bf16 sums' last bits
        # (the largest entry's gap is reported, not held). grad_norm
        # holds the data group's sum, which Adam's steps barely show
        gaps = factor_gaps(f_two, f_one)
        over = {k: g for k, g in gaps.items() if g > MESH_FACTOR_TOL}
        entry_gaps = {f"{key}/{n}": max_err(f_two[key][n], f_one[key][n])
                      / max(float(f_one[key][n].float().abs().max()), 1e-30)
                      for key in f_one for n in ("a", "b")}
        worst = max(gaps, key=gaps.get)
        worst_entry = max(entry_gaps, key=entry_gaps.get)
        lines = [o.splitlines() for o, _ in clis]
        report["b"] = {
            "one_process_s": one_s, "two_ranks_s": two_s,
            "losses": [[h["loss"] for h in one_hist],
                       [h["loss"] for h in two_hist]],
            "grad_norms": [[h["grad_norm"] for h in one_hist],
                           [h["grad_norm"] for h in two_hist]],
            "loss_rel_gap": loss_gaps, "grad_norm_rel_gap": norm_gaps,
            "factor_rel_l2_gap_max": [worst, gaps[worst]],
            "factors_over_2^-5": {k: g for k, g in gaps.items()
                                  if g > BATCH_TOL},
            "factors": len(gaps),
            "factor_entry_gap_max": [worst_entry, entry_gaps[worst_entry]],
            "first_line": lines[0][:1],
            "lines_by_rank": [len(x) for x in lines],
            "checkpoints": sorted(os.listdir(two_dir)),
            "launches": [one_launches] + [c[1]["launches"] for c in clis]}
        if len(loss_gaps) != MESH_CLI_STEPS or max(loss_gaps) > \
                MESH_LOSS_RTOL or max(norm_gaps) > MESH_NORM_RTOL:
            problems.append(f"12b losses or grad_norms: one {one_hist}, "
                            f"two {two_hist}")
        if over:
            problems.append(f"12b final factors over {MESH_FACTOR_TOL} of "
                            f"their L2 norm: {over}")
        if any(lines[1:]) or not lines[0] or \
                not lines[0][0].startswith(f"mesh: data {MESH_RANKS} x "
                                           "model 1"):
            problems.append(f"12b: rank 0 alone must log, mesh line "
                            f"first: {[x[:2] for x in lines]}")
        want = [f"step_{s:09d}" for s in range(1, MESH_CLI_STEPS + 1)] + [
            f"step_{MESH_CLI_STEPS:09d}_final"]
        if report["b"]["checkpoints"] != sorted(want):
            problems.append(f"12b checkpoints: {report['b']['checkpoints']}")
        if any(report["b"]["launches"]):
            problems.append(f"12b launched {report['b']['launches']}")
    except Exception as e:  # noqa: BLE001 - reported, fails the phase
        problems.append(f"12b: {e!r}")
    shutil.rmtree(work, ignore_errors=True)
    report["seconds"] = time.perf_counter() - t_phase
    if report["seconds"] > MESH_PHASE_S:
        problems.append(f"phase 12 took {report['seconds']:.1f} s > "
                        f"{MESH_PHASE_S:.0f} s")
    report["launches"] = {n: v for n, v in total.items() if v}
    report["problems"] = problems
    print(json.dumps({"mesh": report}), flush=True)
    chk.failed += problems
    summary = {}
    if "a" in report:
        summary["a_step1_rel_gap"] = report["a"]["step1_rel_gap"]
        summary["a_step_s"] = [round(s["s"], 2)
                               for s in report["a"]["steps"][0]]
        summary["a_peak_gib"] = [round(g, 1) for g in report["a"]["peak_gib"]]
        summary["c_max_abs_err"] = report["c"][0]["max_abs_err_vs_whole"]
    if "b" in report:
        summary["b_loss_rel_gap"] = report["b"]["loss_rel_gap"]
        summary["b_grad_norm_rel_gap"] = report["b"]["grad_norm_rel_gap"]
        summary["b_factor_rel_l2_gap_max"] = report["b"][
            "factor_rel_l2_gap_max"]
        summary["b_factor_entry_gap_max"] = report["b"][
            "factor_entry_gap_max"]
        summary["b_factors_over_2^-5"] = len(report["b"][
            "factors_over_2^-5"])
    return total, summary


def kernel_counters() -> dict:
    """Every hand-written kernel's launch counter by its C entry's name
    (the `{"kernels"}` line's names)."""
    from fish_speech_tpu_torch.ops import attention, fast_fused, voc_fused
    from fish_speech_tpu_torch.ops import w4a8

    return {"decode_attention_stream": attention.KERNEL,
            "decode_attention_stream_bf16": attention.BF16_KERNEL,
            "decode_attention_stream_fold": attention.FOLD_KERNEL,
            "decode_attention_stream_head": attention.STREAM_HEAD_KERNEL,
            "decode_attention_blocks": attention.BLOCKS_KERNEL,
            "decode_attention_stacked_rows": attention.ROWS_KERNEL,
            "decode_attention": attention.DENSE_KERNEL,
            "decode_attention_stacked": attention.STACKED_KERNEL,
            "decode_attention_chunked": attention.CHUNKED_KERNEL,
            "w4a8_matmul": w4a8.KERNEL,
            "w4a8_matmul_pc": w4a8.KERNEL_PC,
            "fast_sweep": fast_fused.KERNEL,
            "voc_block": voc_fused.BLOCK,
            "voc_res_stack": voc_fused.RES_STACK,
            "voc_block_i8": voc_fused.BLOCK_I8,
            "voc_res_stack_i8": voc_fused.RES_STACK_I8}


class PhaseLog:
    """One compact result line a phase, printed together just before the
    last line (the `{"kernels"}` line and the phases' own report lines
    come earlier and may fall outside a 24 KB tail): the phase, whether
    no check failed during it, its seconds, its path's launches and a
    few key numbers."""

    def __init__(self, chk: Checks):
        self.chk = chk
        self.lines: list[dict] = []
        self.start()

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._failed = len(self.chk.failed)

    def end(self, phase: str, launches: dict | None = None,
            **extra) -> None:
        failed = self.chk.failed[self._failed:]
        line = {"phase": phase, "ok": not failed,
                "seconds": round(time.perf_counter() - self._t0, 1)}
        if launches:
            line["launches"] = {n: v for n, v in launches.items() if v}
        if failed:
            line["failed"] = [f[:160] for f in failed[:3]]
        line.update(extra)
        self.lines.append(line)
        self.start()

    def print(self) -> None:
        for line in self.lines:
            print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the checks, profile one more request and "
                         "list its N costliest device kernels")
    # phase 10 runs this script again as each of its ranks
    ap.add_argument("--tp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-addr", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-out", default=None, help=argparse.SUPPRESS)
    # and phase 12 as its ranks, and as a rank of the training CLI (its
    # arguments after "--")
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-addr", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cli-out", default=None, help=argparse.SUPPRESS)
    argv, cli_argv = sys.argv[1:], []
    if "--" in argv:
        cli_argv = argv[argv.index("--") + 1:]
        argv = argv[:argv.index("--")]
    args = ap.parse_args(argv)
    if args.tp_rank is not None:
        return tp_rank_main(args.tp_rank, args.tp_addr, args.tp_out)
    if args.mesh_rank is not None:
        return mesh_rank_main(args.mesh_rank, args.mesh_addr, args.mesh_out)
    if args.cli_out is not None:
        return cli_rank_main(args.cli_out, cli_argv)

    from fish_speech_tpu_torch.codec.fastpath import pack_decoder
    from fish_speech_tpu_torch.engine.generate import (build_engine,
                                                       serving_config)
    from fish_speech_tpu_torch.ops import _cuda

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
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s")
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
    phases = PhaseLog(chk)
    phases.lines.append({"phase": "2 build", "ok": True,
                         "seconds": round(build_s, 1)})
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    attn, attn_bf16 = check_attention(chk, engine.cfg, dev, gen)
    kernels = kernel_counters()
    # #9 and #10 are on no serving path: their launches are these checks'
    for k in kernels.values():
        k.launches = 0
    head = check_attention_head(chk, engine.cfg, dev, gen)
    by_path = {"phase3_checks": {n: k.launches for n, k in kernels.items()}}
    fold = check_fold(chk, engine.cfg, dev, gen)
    w4a8_grouped, w4a8_pc = check_w4a8(chk, engine.cfg, dev, gen)
    sweep = check_fast_sweep(chk, engine.cfg, engine.params["fast_packed"],
                             dev, gen)
    res, blk = check_vocoder(chk, engine, FRAMES, dev, gen)
    res_i8, blk_i8 = check_vocoder_i8(chk, engine, FRAMES, dev, gen)
    accuracy = voc_quant_vs_bf16(engine, FRAMES, dev, gen)
    log(f"  int8 vocoder vs bf16 (S2-Pro, F={FRAMES}): rel max err "
        f"{accuracy['rel_max_err']:.4g}, corr {accuracy['corr']:.6f}")
    print(json.dumps({"voc_quant_vs_bf16": accuracy}), flush=True)
    torch.cuda.empty_cache()
    phases.end("3 checks", voc_quant_rel_max_err=round(
        accuracy["rel_max_err"], 5))

    shared = ("fast_sweep", "voc_block", "voc_res_stack")

    # phase 4: the int8 path
    int8_route = ("decode_attention_stream", *shared)
    by_path["int8"] = run_path(
        engine, "int8", [(t, MAX_NEW_TOKENS, None, int8_route)
                         for t in TEXTS], kernels, chk)
    phases.end("4 int8", by_path["int8"])
    if args.profile:
        profile_request(engine, args.profile, "int8")

    # phase 4b: the head-major routes, same engine and weights, one request
    # each; every count is set to 0 before each route
    base_cfg = engine.cfg
    for i, (route, mode, kv_cache, stack_mode, kernel) in enumerate(
            HEAD_ROUTES):
        engine.cfg = serving_config(base_cfg, kv_layout="head",
                                    kv_cache=kv_cache, attn=mode,
                                    stack_mode=stack_mode)
        path = f"head_{route}"
        by_path[path] = run_path(engine, path, [
            (TEXTS[i % len(TEXTS)], HEAD_NEW_TOKENS, None,
             (kernel, *shared))], kernels, chk)
        phases.end(f"4b {route}", by_path[path])
        if args.profile and route in ("a", "d"):
            profile_request(engine, args.profile, path)

    # phase 4c: the position-major bf16 cache, same engine and weights
    engine.cfg = serving_config(base_cfg, kv_layout="pos", kv_cache="native",
                                attn="stream")
    by_path["pos_native"] = run_path(engine, "pos_native", [
        (TEXTS[0], HEAD_NEW_TOKENS, None,
         ("decode_attention_stream_bf16", *shared))], kernels, chk)
    engine.cfg = base_cfg
    phases.end("4c pos_native", by_path["pos_native"])

    # phase 4d: the int8 vocoder (VOC_QUANT), same engine and weights
    bf16_decoder = engine.packed_decoder
    engine.packed_decoder = pack_decoder(
        engine.codec_params["decoder"], engine.codec_cfg,
        dtype=torch.bfloat16, quant=True)
    by_path["voc_quant"] = run_path(engine, "voc_quant", [
        (TEXTS[1], HEAD_NEW_TOKENS, None,
         ("decode_attention_stream", "fast_sweep", "voc_block_i8",
          "voc_res_stack_i8"))], kernels, chk)
    engine.packed_decoder = bf16_decoder
    phases.end("4d voc_quant", by_path["voc_quant"])

    # phase 6: the continuous-batching scheduler on the int8 path, phase
    # 4's weights (before phase 5 frees them)
    by_path["scheduler"] = run_scheduler(engine, kernels, chk, card)
    phases.end("6 scheduler", by_path["scheduler"])
    if args.profile:
        profile_scheduler(engine, args.profile)

    # phase 7: streaming, batched decode and encode on the same weights
    by_path["codec"] = run_codec(engine, kernels, chk, card, dev, gen)
    phases.end("7 codec", by_path["codec"])

    # phase 5: the W4A8 path with the KV-write fold, same seed
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = build_engine(device=dev, serving=True, seed=SEED, quant="w4a8",
                          groupsize=GROUPSIZE, kv_fold=True)
    torch.cuda.synchronize()
    log(f"engine (S2-Pro, W4A8 + fold): {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    fold_route = ("decode_attention_stream_fold", *shared)
    by_path["w4a8_fold"] = run_path(engine, "w4a8_fold", [
        (TEXTS[0], W4A8_NEW_TOKENS, None, ("w4a8_matmul", *fold_route)),
        (TEXTS[1], W4A8_NEW_TOKENS, None, ("w4a8_matmul", *fold_route)),
        (TEXTS[2], W4A8_NEW_TOKENS, "pc", ("w4a8_matmul_pc", *fold_route)),
    ], kernels, chk)
    phases.end("5 w4a8_fold", by_path["w4a8_fold"])
    if args.profile:
        profile_request(engine, args.profile, "w4a8_fold")

    # phase 8: the HTTP server from a checkpoint on disk (phase 5's engine
    # freed first)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    phases.start()
    by_path["server"] = run_server(kernels, chk, card, dev, args.profile)
    phases.end("8 server", by_path["server"])

    # phase 9: training and LoRA at full S2-Pro width (phase 8's engine
    # freed)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["train"] = run_train(kernels, chk, card, dev)
    phases.end("9 train", by_path["train"])

    # phase 10: tensor parallelism, two ranks on the card (phase 9's
    # engines freed)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["parallel"] = run_parallel(kernels, chk, card)
    phases.end("10 parallel", by_path["parallel"])

    # phase 11: the tools at full S2-Pro width (phase 10's ranks gone)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["tools"], tools_summary = run_tools(kernels, chk, card, dev)
    phases.end("11 tools", by_path["tools"], **tools_summary)

    # phase 12: training and the vocoder under the (data, model) mesh,
    # two ranks on the card (phase 11's engines freed)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["mesh"], mesh_summary = run_mesh(kernels, chk, card, dev)
    phases.end("12 mesh", by_path["mesh"], **mesh_summary)

    def entry(name, replaces, cases, head, path):
        """`head`: the cases whose times are summed into the headline;
        `path`: the path (or paths) whose launches are counted."""
        lib = [c.get("library_ms") for c in head]
        paths = [path] if isinstance(path, str) else path
        return {"name": name, "route": "cuda",
                "source": f"fish_speech_tpu_torch/csrc/{_cuda.SIGNATURES[name][0]}.cu",
                "replaces": replaces,
                "launches": sum(by_path[p][name] for p in paths),
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                **{k: sum(c[k] for c in head)
                   for k in ("ms", "plain_ms", "bound_ms")},
                "bound_by": head[0]["bound_by"],
                "library_ms": None if None in lib else sum(lib),
                "launches_by_path": {p: n[name] for p, n in by_path.items()},
                "cases": cases}

    def decode(cases):
        return [c for c in cases if c["m"] == 1]

    def with_prefill(e):
        """#11 / #12: beside the M = 1 headline, one prefill layer's five
        products at M = 256."""
        pre = [c for c in e["cases"] if c["m"] == PREFILL_M]
        e["prefill"] = {"m": PREFILL_M, "bound_by": pre[0]["bound_by"],
                        **{k: sum(c[k] for c in pre) for k in (
                            "ms", "plain_ms", "bound_ms", "library_ms")}}
        return e

    report = {"kernels": [
        # headline: the main path's own shape (batch 1)
        entry("decode_attention_stream",
              "fish_speech_tpu/ops/attention.py:910", attn, attn[1:2],
              ["int8", "scheduler", "codec", "server", "parallel", "tools"]),
        entry("decode_attention_stream_bf16", f"{_ATT}:910", attn_bf16,
              attn_bf16[1:2], "pos_native"),
        entry("decode_attention_stream_fold",
              "fish_speech_tpu/ops/attention.py:980", fold, fold[:1],
              "w4a8_fold"),
        # headline: one decode layer's five products (M = 1); "prefill":
        # the same at M = 256
        with_prefill(entry("w4a8_matmul", "fish_speech_tpu/ops/w4a8.py:72",
                           w4a8_grouped, decode(w4a8_grouped),
                           ["w4a8_fold", "parallel", "tools"])),
        with_prefill(entry("w4a8_matmul_pc",
                           "fish_speech_tpu/ops/w4a8.py:134", w4a8_pc,
                           decode(w4a8_pc), "w4a8_fold")),
        entry("fast_sweep", "fish_speech_tpu/ops/fast_fused.py:351", sweep,
              sweep[3:4], ["int8", "scheduler", "codec", "parallel",
                           "tools"]),
        # headline: the whole decoder's use at F frames
        entry("voc_block", "fish_speech_tpu/ops/voc_fused.py:378", blk, blk,
              ["int8", "scheduler", "codec", "server", "tools", "mesh"]),
        entry("voc_res_stack", "fish_speech_tpu/ops/voc_fused.py:459", res,
              res[:1], ["int8", "scheduler", "codec", "server", "tools",
                        "mesh"]),
        # the int8 configurations (VOC_QUANT)
        entry("voc_block_i8", "fish_speech_tpu/ops/voc_fused.py:378", blk_i8,
              blk_i8, "voc_quant"),
        entry("voc_res_stack_i8", "fish_speech_tpu/ops/voc_fused.py:459",
              res_i8, res_i8[:1], "voc_quant"),
    ]}
    # the head-major entries; headline: the batch-1 case over the full
    # cache of the route's cache; launches: their routes' requests (#9,
    # #10: the checks')
    routes_of = {"decode_attention_blocks": ["parallel"]}
    for route, _, _, _, kernel in HEAD_ROUTES:
        routes_of.setdefault(kernel, []).append(f"head_{route}")
    for name, _, replaces, _, (hk, hi8) in HEAD_ENTRIES:
        cs = head[name]
        hl = [c for c in cs if c["b"] == 1 and c["fill"] == "full"
              and c["cache"] == hk and c["int8_scores"] == hi8]
        report["kernels"].append(entry(
            name, replaces, cs, hl, routes_of.get(name, "phase3_checks")))
    print(json.dumps(report), flush=True)
    if chk.failed:
        phases.print()
        log("chip_smoke FAILED: " + ", ".join(chk.failed))
        return 1
    print(card_line(), flush=True)
    phases.print()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
