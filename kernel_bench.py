#!/usr/bin/env python3
"""Times hand-written kernels of the port on one GPU through chip_smoke's
checks, at S2-Pro width and the rows or batches given.

    python3 kernel_bench.py w4a8 [--rows 1,9,40,256] [--tree DIR]
    python3 kernel_bench.py w4a8 --phases [--rows 1,8,9,256]
    python3 kernel_bench.py sweep [--batches 256,1] [--tree DIR]
    python3 kernel_bench.py voc [--frames 16,128] [--tree DIR]
    python3 kernel_bench.py voc --quant [--frames 16,128] [--tree DIR]
    python3 kernel_bench.py voc [--quant] --phases [--frames 16,128]
    python3 kernel_bench.py attn [--tree DIR]
    python3 kernel_bench.py attn --phases
    python3 kernel_bench.py step [--frames 48] [--tree DIR]

w4a8: #11 `w4a8_matmul` and #12 `w4a8_matmul_pc` at the slow stack's five
products (`chip_smoke.check_w4a8`). sweep: #2 `fused_fast_sweep` on seeded
random int8 fast-head weights (`chip_smoke.check_fast_sweep`). voc: #4
bf16 (block 0, its conv biases drawn at random) and #3 bf16 (blocks 1-3)
on a seeded random S2-Pro decoder at each number of codec frames
(`chip_smoke.check_vocoder`): per block ms, plain ms, bound ms, the
kernel's plan and the device kernels a call, then one line with block 0's
three calls together and one with blocks 1-3 together. voc --quant
does the same for #4 int8 and #3 int8 on the decoder's int8 pack
(`chip_smoke.check_vocoder_i8`), each case with its device kernels' times
in launch order (`device_kernels_us`: the per-pass split). voc --phases
times each device kernel of #4 and #3 bf16 (`voc_phases`): variants of
csrc/voc_fused.cu without the passes' epilogue or the snake, beside an
unchanged copy, and block 0 at each tile; voc --quant --phases each
device kernel of #4 and #3 int8 (`voc_i8_phases`): variants of
csrc/voc_fused_i8.cu without the passes' epilogue, without their wgmma,
and with the k7 passes over one tap.

attn: the decode-attention kernels, #1 position-major (int8 and bf16
caches, `chip_smoke.check_attention`), #1 head-major and #6-#10
(`check_attention_head`) and #5 (`check_fold`), at B = 256, S = 384 and
B = 1, S = 2048 over 36 S2-Pro layers, each case with its chunks and CTAs.
attn --phases runs the same checks on variants of csrc/decode_attention.cu
and csrc/decode_attention_head.cu (`ATTN_VARIANTS`, beside an unchanged
copy, in the order base, variant, variant, base): `two_tiles`, where a
whole-row CTA (B = 256) holds two tiles and issues the next chunk's copy
at the chunk's start (WHOLE_BUFS = 2; the shipped sources hold one).

step: decode steps per second at batch 1 on the int8 serving path (the
engine chip_smoke's phase 4 builds, `build_engine(serving=True)` at full
S2-Pro width, random weights): a warm request, then three seeded
requests of --frames frames each through `tts_with_codes`, one JSON line
a request (frames / LM seconds); then one more request with every
`models/dual_ar.py::rms_norm` call recorded, and those calls replayed
alone: the host time a decode step spends in RMSNorm (`rms_norm_ms_a_step`,
its calls a step); last, the parts of one decode step on that engine
at a cache position of 128 (`step_parts`, host clock around
synchronised repetitions: these are sequences of many launches): the slow
stack (`forward_generate`, the restricted logits included), the fast head
over its 10 positions (`forward_generate_fast`, the priming sweep and 9
codebook steps), sampling over the vocabulary and over a codebook
(`sample_one`), and the whole step (`decode_one_token`), the JAX
package's tools/micro_bench.py's four timings. With --tree it measures
another checkout's package, such as the parent's.

w4a8 --phases asks what paces the products instead. Rows up to 8 (the
weight stream): copies of csrc/w4a8.cu that return at once (`empty`: the
launch alone), without the chunks' work (`no_mma`: the consumers only
wait for and free each stage) or without the finishing adds
(`no_finish`), timed beside an unchanged copy, and a
`strace` copy that records %globaltimer in each CTA (its start, after its
setup, after its chunks, after the cluster barrier, its end): one line
per (product, rows, kernel) with each copy's ms, the kernel's span, the
spread of the CTAs' starts and each phase's median and largest us. Rows
above 8 (the tiles): copies with one phase of the tile loop taken out
(`no_mma`: the mma.sync products, replaced by an xor of their fragments
so that the ldmatrix loads stay; `no_unpack`: the int4 unpack into the
shared int8 tile; `no_load`: the loop's cp.async copies) and times each
beside an unchanged copy (`base`), with the wrapper's plan, on weights
cycled over more than twice the L2; the copies' outputs are wrong by
design. A `trace` copy records clock64() at the phase boundaries of each
step in CTA 0's first and last warps: per warp, the median cycles of a
step spent waiting for its copies and the barrier, issuing the next
step's copies, on the ldmatrix and mma (and #11's group epilogue), and
unpacking the next step.

--tree DIR times the package of another checkout (for example the
parent's, unpacked with `git archive`) with this checkout's checks: its
`fish_speech_tpu_torch` is imported, and its kernels built, from DIR. To
compare two trees, run parent, change, change, parent in one session.

Prints the card's name and power limit, then one JSON line per case as
chip_smoke records it (ms, plain_ms, bound_ms, library_ms, ...), and for
w4a8 one line per (kernel, rows) with the five products' sums: one layer;
for voc two lines per frames, with block 0's sums and blocks 1-3's.
Exits 1 if a case failed its check, 2 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch


def ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",")]


def decoder(dev, gen):
    """A seeded random S2-Pro codec, its decoder packed in bf16, as
    chip_smoke.check_vocoder reads an engine."""
    from types import SimpleNamespace

    from fish_speech_tpu_torch.codec.config import s2_pro_codec_config
    from fish_speech_tpu_torch.codec.fastpath import pack_decoder
    from fish_speech_tpu_torch.codec.init import init_dac_params

    ccfg = s2_pro_codec_config()
    params = init_dac_params(gen, ccfg, device=dev)
    return SimpleNamespace(codec_cfg=ccfg, codec_params=params,
                           packed_decoder=pack_decoder(
                               params["decoder"], ccfg, dtype=torch.bfloat16,
                               quant=False))


def fast_stack(cfg, dev, gen) -> dict:
    """The fast head's layers as int8 sweep tiles, from seeded random
    weights at cfg's width."""
    from fish_speech_tpu_torch.ops.fast_fused import pack_fast_stack
    from fish_speech_tpu_torch.ops.quant import quantize_weight

    n_layer, dim = cfg.n_fast_layer, cfg.fast_dim
    inter = cfg.fast_intermediate_size

    def w(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.02

    return pack_fast_stack({
        "attention": {"wqkv": quantize_weight(w(n_layer, 3 * dim, dim)),
                      "wo": quantize_weight(w(n_layer, dim, dim))},
        "feed_forward": {"w1": quantize_weight(w(n_layer, inter, dim)),
                         "w2": quantize_weight(w(n_layer, dim, inter)),
                         "w3": quantize_weight(w(n_layer, inter, dim))},
        "attention_norm": 1 + w(n_layer, dim),
        "ffn_norm": 1 + w(n_layer, dim)})


# text edits of csrc/w4a8.cu's tile loop, each asserted to apply once
_LOAD = "    if (s + NST - 1 < nstep) load(s + NST - 1);\n"
_UNPACK = "    if (s + 1 < nstep) unpack(s + 1);\n"
_MMA = ("            mma_s8(acc[i][jj], a[i], b[jj / 2][2 * (jj % 2)],\n"
        "                   b[jj / 2][2 * (jj % 2) + 1]);\n")
_WAIT = "    cp_wait<NST - 3>();\n"
_STEP = "                          // stage and weight tile are free\n"
VARIANTS = {
    "base": [],
    "no_mma": [(_MMA, "            acc[i][jj][0] += a[i][0] ^ "
                      "b[jj / 2][2 * (jj % 2)] ^\n"
                      "                b[jj / 2][2 * (jj % 2) + 1];\n")],
    "no_unpack": [(_UNPACK, ""), ("  unpack(0);\n", "")],
    "no_load": [(_LOAD, "")],
}
# trace points: 4 before the wait, 0 after the barrier, 1 after the copies
# are issued, 2 after the products, 3 after the unpack
_REC = ("    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&\n"
        "        (tid == 0 || tid == T::THREADS - 32) && s < 512)\n"
        "      w4a8_trace[tid != 0][s][{}] = clock64();\n")
VARIANTS["trace"] = [
    ("namespace {\n", "__device__ long long w4a8_trace[2][512][5];\n"
                      "namespace {\n"),
    (_WAIT, _REC.format(4) + _WAIT), (_STEP, _STEP + _REC.format(0)),
    (_LOAD + "    cp_commit();\n", _LOAD + "    cp_commit();\n" + _REC.format(1)),
    (_UNPACK, _REC.format(2) + _UNPACK + _REC.format(3))]
_TRACE_C = """
extern "C" int w4a8_trace_get(void* dst, int clear) {
  void* at;
  cudaError_t e = cudaGetSymbolAddress(&at, w4a8_trace);
  if (e == cudaSuccess && dst)
    e = cudaMemcpy(dst, at, sizeof(w4a8_trace), cudaMemcpyDeviceToHost);
  if (e == cudaSuccess && clear) e = cudaMemset(at, 0, sizeof(w4a8_trace));
  return (int)e;
}
"""


# text edits of csrc/w4a8.cu's weight stream (M <= 8), each asserted to
# apply once: empty returns at once (the launch alone, on the same grid),
# no_mma skips every chunk (the consumers still wait for each stage and
# free it), no_finish skips the finishing adds; strace records
# %globaltimer (ns) in each CTA's thread 0 at its start (0), after its
# setup, x's arrival and the cluster's start (1), after its chunks (2),
# after the cluster barrier (3) and at its end (4)
_S_REC = ("  if (threadIdx.x == 0 && blockIdx.y * gridDim.x + blockIdx.x < "
          "8192) {{\n    unsigned long long t_;\n"
          "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_));\n"
          "    w4a8_strace[blockIdx.y * gridDim.x + blockIdx.x][{}] = t_;\n"
          "  }}\n")
_S_START = "  cluster_arrive();\n  __syncthreads();\n"
_S_SETUP = "    cluster_wait();     // every CTA of the cluster has started\n"
_S_LOOP = ("    if (PC) {\n#pragma unroll\n      for (int e = 0; e < 4; ++e)\n"
           "        if (dst[e])\n")
_S_SYNC = "  cluster.sync();\n  const int cnt"
_S_END = "    out[(size_t)m * N + n0 + nl] = v;\n  }\n}\n"
STREAM_VARIANTS = {
    "base": [],
    "empty": [("  cg::cluster_group cluster = cg::this_cluster();\n",
               "  if (M > 0) return;\n"
               "  cg::cluster_group cluster = cg::this_cluster();\n")],
    "no_mma": [("      const int nb = min(SB_K, pz - st * SB_K);\n      if (nb == "
                "SB_K) {\n", "      const int nb = 0;\n      if (nb == SB_K) {\n")],
    "no_finish": [("  for (int i = tid; i < cnt; i += SB_THREADS) {\n",
                   "  for (int i = tid; i < 0; i += SB_THREADS) {\n")],
    "strace": [
        ("namespace {\n",
         "__device__ unsigned long long w4a8_strace[8192][5];\nnamespace {\n"),
        (_S_START, _S_REC.format(0) + _S_START),
        (_S_SETUP, _S_SETUP + _S_REC.format(1)),
        (_S_LOOP, _S_REC.format(2) + _S_LOOP),
        (_S_SYNC, _S_SYNC.replace("  const int cnt", _S_REC.format(3)
                                  + "  const int cnt")),
        (_S_END, _S_END[:-2] + _S_REC.format(4) + "}\n")],
}
_STRACE_C = """
extern "C" int w4a8_strace_get(void* dst, int clear) {
  void* at;
  cudaError_t e = cudaGetSymbolAddress(&at, w4a8_strace);
  if (e == cudaSuccess && dst)
    e = cudaMemcpy(dst, at, sizeof(w4a8_strace), cudaMemcpyDeviceToHost);
  if (e == cudaSuccess && clear) e = cudaMemset(at, 0, sizeof(w4a8_strace));
  return (int)e;
}
"""


def phase_libs(source: str = "w4a8", variants: dict | None = None,
               fns=("w4a8_matmul", "w4a8_matmul_pc"),
               appended: dict | None = None) -> dict:
    """The variants of csrc/<source>.cu, built in parallel into the
    package's build directory: {name: ctypes library}. `appended`: C text
    added to a variant's source, by name (default: the tile trace's
    getter to "trace")."""
    import ctypes
    import subprocess

    from fish_speech_tpu_torch.ops import _cuda

    variants = VARIANTS if variants is None else variants
    src = (_cuda.CSRC / f"{source}.cu").read_text()
    # the shared vocoder helpers inline, so that edits may reach them
    common = '#include "voc_common.cuh"\n'
    if common in src:
        src = src.replace(common, (_cuda.CSRC / "voc_common.cuh").read_text())
    out = _cuda.BUILD_ROOT / "phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        for a, b in edits:
            assert text.count(a) == 1, f"{name}: the source has changed"
            text = text.replace(a, b)
        text += ({"trace": _TRACE_C} if appended is None
                 else appended).get(name, "")
        (out / f"{source}_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o",
             str(out / f"{source}_{name}.so"),
             str(out / f"{source}_{name}.cu")])
    libs = {}
    for name, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant")
        libs[name] = ctypes.CDLL(str(out / f"{source}_{name}.so"))
        for fn in fns:
            getattr(libs[name], fn).argtypes = _cuda.SIGNATURES[fn][1]
    return libs


# text edits of csrc/voc_fused.cu's passes, each asserted to apply once:
# no epilogue (the sums are computed and staged, nothing is written), no
# snake (in the passes' epilogues and #4's entry snake)
_EPI = "  tile_epilogue<BM, BN, CONS>(p, prm, out, tid, r0, n0, b);\n"
_SNAKE8 = "  return x + s2 * inv;\n}\n\n// 8 values"
VOC_VARIANTS = {
    "base": [],
    "no_epilogue": [(_EPI, "  if (p.m_hi < 0)\n  " + _EPI)],
    "no_snake": [(_SNAKE8, "  return x;\n}\n\n// 8 values")],
}


def voc_phases(cs, dev, gen, frames_list) -> None:
    """Prints one JSON line per (frames, block, variant) of the bf16
    vocoder kernels on the seeded S2-Pro decoder's weights and random
    inputs of the block's shape: the call's device time (ms) and each
    device kernel's (us, in launch order), from variants of
    csrc/voc_fused.cu (VOC_VARIANTS). Block 0 (#4): its three unit calls,
    each the entry snake, the k7 pass and the 1x1 pass; blocks 1-3 (#3):
    two memsets, the seven passes, the final conv. Then block 0 with each
    tile that divides its channels forced on every pass (unchanged source):
    one line a tile. The variants' outputs are wrong by design."""
    import ctypes

    from torch.profiler import ProfilerActivity, profile

    from fish_speech_tpu_torch.ops import _cuda
    from fish_speech_tpu_torch.ops import voc_fused as tv

    libs = phase_libs("voc_fused", VOC_VARIANTS,
                      ("voc_block", "voc_res_stack"))
    eng = decoder(dev, gen)
    packed, ccfg = eng.packed_decoder, eng.codec_cfg
    st = torch.cuda.current_stream().cuda_stream
    n_sm = _cuda.sm_count(dev.index)

    def report(frames, bi, name, call, passes):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        print(json.dumps({
            "frames": frames, "block": bi, "variant": name,
            "ms": cs.time_ms(call, 5, 1),
            "kernels_us": [e.device_time_total for e in prof.events()
                           if e.device_type
                           == torch.autograd.DeviceType.CUDA],
            "passes": passes}), flush=True)

    for frames in frames_list:
        # block 0's rows, and block 1's input rows: a frame's samples over
        # the later strides
        t_in = frames * ccfg.frame_length // math.prod(ccfg.decoder_rates[1:])
        pb = packed["blocks"][0]
        w7t, w1t = tv.res_weights_t(pb["res"])
        c = w1t.shape[-1]
        x = torch.randn((1, t_in, c), generator=gen,
                        device=dev).to(torch.bfloat16)
        y, sn, s2 = (torch.empty_like(x) for _ in range(3))
        plans = [tv.voc_res_plan(1, t_in, c, d, n_sm)["tiles"]
                 for d in tv.DILATIONS]

        def unit_calls(lib, tiles):
            def call():
                for u, d in enumerate(tv.DILATIONS):
                    last = u == len(tv.DILATIONS) - 1
                    err = lib.voc_res_stack(
                        x.data_ptr(), y.data_ptr(), w7t[u].data_ptr(),
                        w1t[u].data_ptr(), pb["res"]["vec"][u].data_ptr(),
                        pb["tail_vec"].data_ptr() if last else None,
                        sn.data_ptr(), s2.data_ptr(), *tiles[u], 1, t_in, c,
                        d, int(last), st)
                    assert err == 0, f"cudaError {err}"
            return call

        for name, lib in libs.items():
            report(frames, 0, name, unit_calls(lib, plans),
                   [f"{q} d{d}" for d in tv.DILATIONS for q in ("k7", "1x1")])
        # block 0 with one tile forced on every pass, the plan's rule aside
        for tile, (bm, bn) in enumerate(tv.TILE_SHAPES):
            if c % bn == 0:
                call = unit_calls(libs["base"], [(tile, tile)] * 3)
                print(json.dumps({"frames": frames, "block": 0,
                                  "variant": "base", "tile": f"{bm}x{bn}",
                                  "ms": cs.time_ms(call, 5, 1)}), flush=True)
        for bi in range(1, len(packed["blocks"])):
            pb, stride = packed["blocks"][bi], ccfg.decoder_rates[bi]
            res = pb["res"]
            pwt, w7t, w1t = res["wt"]
            c, c_in = w1t.shape[-1], pwt.shape[-1]
            final = bi == len(packed["blocks"]) - 1
            fw = packed["final_fw"] if final else None
            x = torch.randn((1, t_in, c_in), generator=gen,
                            device=dev).to(torch.bfloat16)
            plan = tv.voc_block_plan(1, t_in, c_in, c, stride, tv.DILATIONS,
                                     final, n_sm)
            xs, sn, s2 = (torch.empty((1, plan["rows"], c),
                                      dtype=torch.bfloat16, device=dev)
                          for _ in range(3))
            t = t_in * stride
            y = torch.empty((1, t) if final else (1, t, c),
                            dtype=torch.bfloat16, device=dev)
            tiles = (ctypes.c_int * 7)(*plan["tiles"])
            for name, lib in libs.items():
                def call():
                    err = lib.voc_block(
                        x.data_ptr(), y.data_ptr(), pwt.data_ptr(),
                        res["tconv_pb"].data_ptr(), w7t.data_ptr(),
                        w1t.data_ptr(), res["vec"].data_ptr(),
                        pb["tail_vec"].data_ptr(), _cuda.ptr(fw),
                        xs.data_ptr(), sn.data_ptr(), s2.data_ptr(), tiles,
                        1, t_in, c_in, c, stride, *tv.DILATIONS, int(final),
                        st)
                    assert err == 0, f"cudaError {err}"
                report(frames, bi, name, call,
                       [q["name"] for q in plan["passes"]])
            t_in = t


# text edits of csrc/voc_fused_i8.cu's pass kernel, each asserted to apply
# once: no epilogue (the sums are staged, nothing is rescaled or written),
# no wgmma (the ring is filled and drained, nothing multiplied), the k7
# passes over one tap instead of seven
VOC_I8_VARIANTS = {
    "base": [],
    "no_epilogue": [("    if (r0 + row >= p.m_hi) continue;\n",
                     "    if (r0 + row >= p.m_hi || p.m_lo >= 0) continue;\n")],
    "no_mma": [("      if (kk * 32 < bk) wgmma_s8<BN>(",
                "      if (kk * 32 < bk && p.m_lo < 0) wgmma_s8<BN>(")],
    "one_tap": [("  p.n_taps = 7;\n", "  p.n_taps = 1;\n")],
}


def voc_i8_phases(cs, dev, gen, frames_list) -> None:
    """Prints one JSON line per (frames, block, variant) of the int8
    vocoder kernels on the seeded S2-Pro decoder's int8 pack and random
    inputs of the block's shape: the call's device time (ms) and each
    device kernel's (us, in launch order), from variants of
    csrc/voc_fused_i8.cu (VOC_I8_VARIANTS). Block 0 (#4 int8): its first
    unit's call (d = 1); blocks 1-3 (#3 int8). The variants' outputs are
    wrong by design."""
    import ctypes

    from torch.profiler import ProfilerActivity, profile

    from fish_speech_tpu_torch.codec.fastpath import (
        RES_STACK_TILE_CAP, _tile_cap, _tile_for, pack_decoder)
    from fish_speech_tpu_torch.ops import _cuda
    from fish_speech_tpu_torch.ops import voc_fused as tv

    libs = phase_libs("voc_fused_i8", VOC_I8_VARIANTS,
                      ("voc_block_i8", "voc_res_stack_i8"))
    eng = decoder(dev, gen)
    ccfg = eng.codec_cfg
    packed = pack_decoder(eng.codec_params["decoder"], ccfg,
                          dtype=torch.bfloat16, quant=True)
    st = torch.cuda.current_stream().cuda_stream
    n_sm = _cuda.sm_count(dev.index)

    def report(frames, bi, name, call, plan):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        print(json.dumps({
            "frames": frames, "block": bi, "variant": name,
            "ms": cs.time_ms(call, 5, 1),
            "kernels_us": [(e.name[:24], e.device_time_total)
                           for e in prof.events() if e.device_type
                           == torch.autograd.DeviceType.CUDA],
            "passes": [f"{q['name']}: {q['bm']}x{q['bn']}"
                       for q in plan["passes"]]}), flush=True)

    for frames in frames_list:
        t_in = frames * ccfg.frame_length // math.prod(ccfg.decoder_rates[1:])
        pb = packed["blocks"][0]
        res = {k: v[:1] for k, v in pb["res"].items()}
        w7t, w1t = tv.res_weights_t(res)
        c = w1t.shape[-1]
        tt = _tile_for(t_in, RES_STACK_TILE_CAP)
        x = torch.randn((1, t_in, c), generator=gen,
                        device=dev).to(torch.bfloat16)
        y = torch.empty_like(x)
        plan = tv.voc_i8_plan(1, t_in, c, (1,), tt, n_sm=n_sm)
        scratch = tv._i8_scratch(plan, c, dev, 2)
        tiles = (ctypes.c_int * 2)(*plan["tiles"])
        for name, lib in libs.items():
            def call():
                err = lib.voc_res_stack_i8(
                    x.data_ptr(), y.data_ptr(), w7t.data_ptr(),
                    w1t.data_ptr(), res["vec"].data_ptr(), None,
                    *(t.data_ptr() for t in scratch), tiles, 1, t_in, c, 1,
                    tt, plan["halo"], 0, st)
                assert err == 0, f"cudaError {err}"
            report(frames, 0, name, call, plan)
        for bi in range(1, len(packed["blocks"])):
            pb, stride = packed["blocks"][bi], ccfg.decoder_rates[bi]
            res = pb["res"]
            pwt, w7t, w1t = tv.block_weights_t(res)
            c, c_in = w1t.shape[-1], pwt.shape[-1]
            t = t_in * stride
            tt = _tile_for(t, _tile_cap(c))
            final = bi == len(packed["blocks"]) - 1 and tt % 128 == 0
            fw = packed["final_fw"] if final else None
            x = torch.randn((1, t_in, c_in), generator=gen,
                            device=dev).to(torch.bfloat16)
            y = torch.empty((1, t) if final else (1, t, c),
                            dtype=torch.bfloat16, device=dev)
            plan = tv.voc_i8_plan(1, t, c, tv.DILATIONS, tt, (c_in, stride),
                                  final, n_sm)
            scratch = tv._i8_scratch(plan, c, dev, 7)
            tiles = (ctypes.c_int * 7)(*plan["tiles"])
            for name, lib in libs.items():
                def call():
                    err = lib.voc_block_i8(
                        x.data_ptr(), y.data_ptr(), pwt.data_ptr(),
                        res["tconv_pb"].data_ptr(), w7t.data_ptr(),
                        w1t.data_ptr(), res["vec"].data_ptr(),
                        pb["tail_vec"].data_ptr(), _cuda.ptr(fw),
                        *(t.data_ptr() for t in scratch), tiles, 1, t_in,
                        c_in, c, stride, *tv.DILATIONS, tt, plan["halo"],
                        int(final), st)
                    assert err == 0, f"cudaError {err}"
                report(frames, bi, name, call, plan)
            t_in = t


def phases(cs, cfg, dev, gen, rows) -> None:
    """Prints one JSON line per (product, rows, kernel): each variant's
    device time (ms) and the trace's median cycles a step per warp."""
    import ctypes

    import numpy as np

    from fish_speech_tpu_torch.ops import _cuda
    from fish_speech_tpu_torch.ops import w4a8 as tw
    from fish_speech_tpu_torch.ops.quant import quantize_weight_int4_packed

    libs = phase_libs()
    d, inter = cfg.dim, cfg.intermediate_size
    # the slow stack's products but w3, of w1's shape
    products = (("wqkv", (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim,
                 d), ("wo", d, cfg.n_head * cfg.head_dim), ("w1", inter, d),
                ("w2", d, inter))
    buf = np.zeros((2, 512, 5), np.int64)
    st = torch.cuda.current_stream().cuda_stream
    for name, n, k in products:
        qw = quantize_weight_int4_packed(
            torch.randn((n, k), generator=gen, device=dev) * 0.02,
            cs.GROUPSIZE)
        weights = cs.rotation((qw["q4"], qw["gs"]))
        g = k // cs.GROUPSIZE
        for m in (m for m in rows if m > 8):
            x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int8)
            out = torch.empty((m, n), device=dev)
            for fn in ("w4a8_matmul", "w4a8_matmul_pc"):
                plan = tw.w4a8_plan(m, n, k, g, _cuda.sm_count(dev.index),
                                    fn == "w4a8_matmul_pc")
                row = {"product": name, "m": m, "kernel": fn,
                       "plan": list(plan), "ms": {}}

                def call(f, q4, gs):
                    err = f(x8.data_ptr(), q4.data_ptr(), gs.data_ptr(),
                            out.data_ptr(), m, n, k, g, *plan, st)
                    assert err == 0, f"cudaError {err}"

                for var, lib in libs.items():
                    it = cs.cycle(weights)
                    row["ms"][var] = cs.time_ms(
                        lambda: call(getattr(lib, fn), *next(it)),
                        2 * len(weights))
                lib = libs["trace"]
                assert lib.w4a8_trace_get(None, 1) == 0
                call(getattr(lib, fn), qw["q4"], qw["gs"])
                torch.cuda.synchronize()
                assert lib.w4a8_trace_get(
                    ctypes.c_void_p(buf.ctypes.data), 0) == 0
                for w, t in zip(("warp_first", "warp_last"), buf):
                    t = t[:int((t[:, 0] > 0).sum())]
                    row[w] = {"steps": len(t), **{
                        ph: float(np.median(v)) for ph, v in (
                            ("wait_barrier", t[1:, 0] - t[1:, 4]),
                            ("copies", t[:, 1] - t[:, 0]),
                            ("ldmatrix_mma", t[:, 2] - t[:, 1]),
                            ("unpack", t[:-1, 3] - t[:-1, 2]),
                            ("step", np.diff(t[:, 0])))}}
                print(json.dumps(row), flush=True)
        del weights
        torch.cuda.empty_cache()


def stream_phases(cs, cfg, dev, gen, rows) -> None:
    """Prints one JSON line per (product, rows, kernel) of the weight
    stream (M <= 8): each variant's device time (ms, STREAM_VARIANTS, on
    weights cycled over more than twice the L2), and from the strace copy
    of one call: the kernel's span (first CTA start to last CTA end), the
    spread of the CTAs' starts, and the median and largest time (us) of
    each CTA's phases: setup (scales, x, the cluster's start), chunks,
    the wait at the cluster barrier, finish. The variants' outputs are
    wrong by design."""
    import ctypes

    import numpy as np

    from fish_speech_tpu_torch.ops import _cuda
    from fish_speech_tpu_torch.ops import w4a8 as tw
    from fish_speech_tpu_torch.ops.quant import quantize_weight_int4_packed

    libs = phase_libs("w4a8", STREAM_VARIANTS,
                      appended={"strace": _STRACE_C})
    d, inter = cfg.dim, cfg.intermediate_size
    products = (("wqkv", (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim,
                 d), ("wo", d, cfg.n_head * cfg.head_dim), ("w1", inter, d),
                ("w2", d, inter))
    buf = np.zeros((8192, 5), np.uint64)
    st = torch.cuda.current_stream().cuda_stream
    for name, n, k in products:
        qw = quantize_weight_int4_packed(
            torch.randn((n, k), generator=gen, device=dev) * 0.02,
            cs.GROUPSIZE)
        weights = cs.rotation((qw["q4"], qw["gs"]))
        g = k // cs.GROUPSIZE
        for m in (m for m in rows if m <= 8):
            x8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                               dtype=torch.int8)
            out = torch.empty((m, n), device=dev)
            for fn in ("w4a8_matmul", "w4a8_matmul_pc"):
                plan = tw.w4a8_plan(m, n, k, g, _cuda.sm_count(dev.index),
                                    fn == "w4a8_matmul_pc")
                row = {"product": name, "m": m, "kernel": fn,
                       "plan": list(plan), "ms": {}}

                def call(f, q4, gs):
                    err = f(x8.data_ptr(), q4.data_ptr(), gs.data_ptr(),
                            out.data_ptr(), m, n, k, g, *plan, st)
                    assert err == 0, f"cudaError {err}"

                for var, lib in libs.items():
                    it = cs.cycle(weights)
                    row["ms"][var] = cs.time_ms(
                        lambda: call(getattr(lib, fn), *next(it)),
                        2 * len(weights))
                lib = libs["strace"]
                q4, gs = weights[-1]
                call(getattr(lib, fn), q4, gs)     # warm
                torch.cuda.synchronize()
                assert lib.w4a8_strace_get(None, 1) == 0
                call(getattr(lib, fn), *weights[0])
                torch.cuda.synchronize()
                assert lib.w4a8_strace_get(
                    ctypes.c_void_p(buf.ctypes.data), 0) == 0
                ctas = plan[1] * -(-n // tw.STREAM_BN)
                t = buf[:ctas].astype(np.int64)
                t0 = t[:, 0].min()
                row["span_us"] = float(t[:, 4].max() - t0) / 1e3
                row["start_spread_us"] = float(t[:, 0].max() - t0) / 1e3
                for ph, a, b in (("setup", 0, 1), ("chunks", 1, 2),
                                 ("cluster_wait", 2, 3), ("finish", 3, 4)):
                    v = (t[:, b] - t[:, a]) / 1e3
                    row[ph + "_us"] = [float(np.median(v)), float(v.max())]
                print(json.dumps(row), flush=True)
        del weights
        torch.cuda.empty_cache()


def attn(cs, chk, cfg, dev, gen) -> None:
    """The decode-attention checks of chip_smoke's phase 3, one JSON line a
    case."""
    pos, pos_bf16 = cs.check_attention(chk, cfg, dev, gen)
    for name, cases in (("decode_attention_stream", pos),
                        ("decode_attention_stream_bf16", pos_bf16)):
        for c in cases:
            print(json.dumps({"kernel": name, **c}), flush=True)
    for name, cases in cs.check_attention_head(chk, cfg, dev, gen).items():
        for c in cases:
            print(json.dumps({"kernel": name, **c}), flush=True)
    for c in cs.check_fold(chk, cfg, dev, gen):
        print(json.dumps({"kernel": "decode_attention_stream_fold", **c}),
              flush=True)


# one constant of the decode-attention sources: the tiles a whole-row CTA
# holds (csrc/decode_attention*.cu WHOLE_BUFS)
_BUFS = "constexpr int WHOLE_BUFS = {};"
ATTN_VARIANTS = {"base": [], "two_tiles": [(_BUFS.format(1), _BUFS.format(2))]}


def attn_phases(cs, chk, cfg, dev, gen) -> None:
    """`attn` on each variant of the decode-attention sources
    (ATTN_VARIANTS): the variant's libraries replace the package's
    (`_cuda._libs`) for the wrappers to launch. One JSON line a (case,
    variant, run)."""
    from fish_speech_tpu_torch.ops import _cuda

    libs = {}
    for source in ("decode_attention", "decode_attention_head"):
        fns = [f for f, (src, _) in _cuda.SIGNATURES.items() if src == source]
        libs[source] = phase_libs(source, ATTN_VARIANTS, fns)
    names = list(ATTN_VARIANTS)
    for run, name in enumerate(names + names[::-1]):
        with _cuda._lock:
            for source, by_name in libs.items():
                _cuda._libs[source] = by_name[name]
        cs.log(f"attn --phases: {name} (run {run})")
        pos, pos_bf16 = cs.check_attention(chk, cfg, dev, gen)
        cases = {"decode_attention_stream": pos,
                 "decode_attention_stream_bf16": pos_bf16,
                 **cs.check_attention_head(chk, cfg, dev, gen),
                 "decode_attention_stream_fold": cs.check_fold(chk, cfg, dev,
                                                               gen)}
        for kernel, rows in cases.items():
            for c in rows:
                print(json.dumps({"kernel": kernel, "variant": name,
                                  "run": run, **c}), flush=True)


def step(cs, dev, frames: int) -> None:
    """Decode steps per second at batch 1 on the int8 serving path: one
    JSON line a request after a warm one."""
    from fish_speech_tpu_torch.engine.generate import (GenerateLongRequest,
                                                       build_engine)

    engine = build_engine(device=dev, serving=True, seed=cs.SEED)
    text = cs.SCHED_REQUESTS[0][0]
    for i in range(4):
        req = GenerateLongRequest(text=text, max_new_tokens=frames,
                                  seed=cs.SEED + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, codes, lm_s = engine.tts_with_codes(req)
        torch.cuda.synchronize()
        if i == 0:
            continue          # the warm request
        print(json.dumps({"step": "int8 path, batch 1", "request": i,
                          "frames": codes.shape[1], "lm_s": lm_s,
                          "wall_s": time.perf_counter() - t0,
                          "decode_steps_per_s": codes.shape[1] / lm_s}),
              flush=True)
    from fish_speech_tpu_torch.models import dual_ar

    inner, calls = dual_ar.rms_norm, []

    def recording(x, weight, eps):
        calls.append((x, weight, eps))
        return inner(x, weight, eps)

    dual_ar.rms_norm = recording
    try:
        _, codes, _ = engine.tts_with_codes(GenerateLongRequest(
            text=text, max_new_tokens=frames, seed=cs.SEED))
    finally:
        dual_ar.rms_norm = inner
    for _ in range(2):                    # the second replay is reported
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x, weight, eps in calls:
            inner(x, weight, eps)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
    n = codes.shape[1]
    print(json.dumps({"step": "int8 path, batch 1", "frames": n,
                      "rms_norm_calls_a_step": len(calls) / n,
                      "rms_norm_ms_a_step": 1e3 * replay_s / n}), flush=True)
    print(json.dumps({"step": "int8 path, batch 1", "parts_ms": step_parts(
        engine, dev, cs.SEED)}), flush=True)


def step_parts(engine, dev, seed: int, pos: int = 128, reps: int = 20,
               warmup: int = 3) -> dict:
    """ms of the parts of one batch-1 decode step on `engine` (the
    micro_bench parts): slow stack, fast head x 10 positions, sampling
    over the vocabulary and over a codebook, the whole step."""
    from fish_speech_tpu_torch.models.decode import (SamplingConfig,
                                                     decode_one_token,
                                                     new_fast_cache)
    from fish_speech_tpu_torch.models.dual_ar import (
        KVCache, forward_generate, forward_generate_fast, param_dtype,
        precompute_freqs_cis)
    from fish_speech_tpu_torch.ops.quant import take_rows
    from fish_speech_tpu_torch.ops.sampling import RAS_WIN_SIZE, sample_one

    params, cfg = engine.params, engine.cfg
    s = engine.cache_len
    cache = KVCache.create(cfg.n_layer, 1, s, cfg.n_local_heads,
                           cfg.head_dim, dtype=torch.int8,
                           pos_major=cfg.kv_cache_layout == "pos",
                           device=dev)
    freqs = precompute_freqs_cis(s, cfg.head_dim, cfg.rope_base, dev)
    ffreqs = precompute_freqs_cis(cfg.num_codebooks, cfg.fast_head_dim,
                                  cfg.rope_base, dev)
    fc = new_fast_cache(params, cfg, 1, dev, param_dtype(params))
    support = (cfg.semantic_begin_id, cfg.semantic_end_id, engine.im_end_id)
    cur = torch.zeros(1, cfg.num_codebooks + 1, 1, dtype=torch.int32,
                      device=dev)
    hidden = torch.zeros(1, cfg.fast_dim, dtype=torch.bfloat16, device=dev)
    code = torch.zeros(1, dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sampling = SamplingConfig.create()
    window = torch.zeros(1, RAS_WIN_SIZE, dtype=torch.int32, device=dev)

    def fast10():
        forward_generate_fast(params, cfg, hidden, fc, 0, ffreqs,
                              want_logits=False)
        for i in range(1, cfg.num_codebooks):
            forward_generate_fast(params, cfg, take_rows(
                params["fast_embeddings"], code), fc, i, ffreqs)

    vocab = torch.zeros(1, cfg.vocab_size, device=dev)
    book = torch.zeros(1, cfg.codebook_size, device=dev)
    parts = {
        "slow_stack": lambda: forward_generate(params, cfg, cur, cache, pos,
                                               freqs, logit_support=support),
        "fast_head_x10": fast10,
        "sample_vocab": lambda: sample_one(vocab, 0.7, 0.7, 30, gen=gen),
        "sample_codebook": lambda: sample_one(book, 0.7, 0.7, 30, gen=gen),
        "full_step": lambda: decode_one_token(
            params, cfg, cur, cache, pos, freqs, ffreqs, engine._bias,
            sampling, window, top_k=30, greedy=False, gen=gen,
            sample_support=support, fast_cache=fc),
    }
    out = {}
    with torch.no_grad():
        for name, fn in parts.items():
            for _ in range(warmup):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            out[name] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("w4a8", "sweep", "voc", "attn",
                                       "step"))
    ap.add_argument("--rows", type=ints, default=[1, 9, 40, 256],
                    help="w4a8: the products' rows M")
    ap.add_argument("--batches", type=ints, default=[256, 1],
                    help="sweep: the batches")
    ap.add_argument("--frames", type=ints, default=None,
                    help="voc: the codec frames (16,128); step: a "
                         "request's frames (48)")
    ap.add_argument("--quant", action="store_true",
                    help="voc: the int8 kernels (#4 int8, #3 int8)")
    ap.add_argument("--phases", action="store_true",
                    help="w4a8: time the tile loop without each phase; "
                         "voc: each pass, with and without its epilogue "
                         "or snake, and block 0 at each tile")
    ap.add_argument("--tree", help="time the package of this checkout")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    # with --tree, from DIR: its submodules then load from there too
    import fish_speech_tpu_torch
    if args.tree:
        sys.path.pop(0)
    import chip_smoke as cs
    from fish_speech_tpu_torch.models.config import s2_pro_lm_config

    if not torch.cuda.is_available():
        print("kernel_bench: CUDA is not available", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    cs.log(f"package: {os.path.dirname(fish_speech_tpu_torch.__file__)}")
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = s2_pro_lm_config()
    chk = cs.Checks()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    if args.kernel == "step":
        step(cs, dev, (args.frames or [48])[0])
    elif args.phases and args.kernel == "attn":
        attn_phases(cs, chk, cfg, dev, gen)
    elif args.phases and args.kernel == "voc":
        (voc_i8_phases if args.quant else voc_phases)(
            cs, dev, gen, args.frames or [16, 128])
    elif args.phases:
        if any(m <= 8 for m in args.rows):
            stream_phases(cs, cfg, dev, gen, args.rows)
        if any(m > 8 for m in args.rows):
            phases(cs, cfg, dev, gen, args.rows)
    elif args.kernel == "w4a8":
        groups = cs.check_w4a8(chk, cfg, dev, gen, rows=args.rows,
                               plans=False)
        for cases, name in zip(groups, ("w4a8_matmul", "w4a8_matmul_pc")):
            for c in cases:
                print(json.dumps({"kernel": name, **c}), flush=True)
            for m in args.rows:
                layer = [c for c in cases if c["m"] == m]
                print(json.dumps({
                    "kernel": name, "layer": True, "m": m,
                    "bound_by": layer[0]["bound_by"],
                    **{k: sum(c[k] for c in layer) for k in (
                        "ms", "plain_ms", "bound_ms", "library_ms")}}),
                    flush=True)
    elif args.kernel == "attn":
        attn(cs, chk, cfg, dev, gen)
    elif args.kernel == "voc":
        eng = decoder(dev, gen)
        check = cs.check_vocoder_i8 if args.quant else cs.check_vocoder
        i8 = "_i8" if args.quant else ""
        for frames in args.frames or [16, 128]:
            res, blocks = check(chk, eng, frames, dev, gen)
            for name, cases in ((f"voc_res_stack{i8}", res),
                                (f"voc_block{i8}", blocks)):
                for c in cases:
                    print(json.dumps({"kernel": name, **c}), flush=True)
            for name, cases, which in ((f"voc_res_stack{i8}", res, "0"),
                                       (f"voc_block{i8}", blocks, "1-3")):
                print(json.dumps({
                    "kernel": name, "blocks": which, "frames": frames,
                    **{k: sum(c[k] for c in cases)
                       for k in ("ms", "plain_ms", "bound_ms")}}),
                    flush=True)
    else:
        packed = fast_stack(cfg, dev, gen)
        for c in cs.check_fast_sweep(chk, cfg, packed, dev, gen,
                                     batches=args.batches):
            print(json.dumps({"kernel": "fast_sweep", **c}), flush=True)
    if chk.failed:
        cs.log("kernel_bench FAILED: " + ", ".join(chk.failed))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
