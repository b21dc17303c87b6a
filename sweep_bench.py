#!/usr/bin/env python3
"""Times the fast-head sweep (`fish_speech_tpu_torch.ops.fast_fused.
fused_fast_sweep`, the entry the engine calls) on one GPU at S2-Pro's
fast-head width: 28 layers of 1024, 16 heads of 64, 10 codebook positions,
seeded random int8 weights.

    python3 sweep_bench.py [--batches 1,3,8,40,256] [--positions 0,9]

It times the package beside it. The entry's arguments are those of every
version of the port, so the script copied into an older checkout times
that checkout's sweep the same way. Each case's cache holds the positions
before `pos`, filled by the plain sweep. Prints the card's name and power
limit, then one JSON line per (batch, position): the device time of one
sweep (ms, mean of 20 after warm-up, `chip_smoke.time_ms`).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from chip_smoke import time_ms
from fish_speech_tpu_torch.models.dual_ar import precompute_freqs_cis
from fish_speech_tpu_torch.ops import fast_fused as ff
from fish_speech_tpu_torch.ops.quant import quantize_weight

N_LAYER, DIM, N_HEAD, N_POS = 28, 1024, 16, 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="1,3,8,40,256")
    ap.add_argument("--positions", default="0,9")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_bench: CUDA is not available", file=sys.stderr)
        return 2
    batches = [int(b) for b in args.batches.split(",")]
    positions = [int(p) for p in args.positions.split(",")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(0)

    def w(*shape):
        return torch.randn(shape, generator=g, device=dev) * 0.02

    packed = ff.pack_fast_stack({
        "attention": {"wqkv": quantize_weight(w(N_LAYER, 3 * DIM, DIM)),
                      "wo": quantize_weight(w(N_LAYER, DIM, DIM))},
        "feed_forward": {"w1": quantize_weight(w(N_LAYER, 3 * DIM, DIM)),
                         "w2": quantize_weight(w(N_LAYER, DIM, 3 * DIM)),
                         "w3": quantize_weight(w(N_LAYER, 3 * DIM, DIM))},
        "attention_norm": 1 + w(N_LAYER, DIM), "ffn_norm": 1 + w(N_LAYER, DIM)})
    freqs = precompute_freqs_cis(N_POS, DIM // N_HEAD, 10000.0, dev)
    kw = dict(n_head=N_HEAD, eps=1e-6)
    for b in batches:
        xs = torch.randn((N_POS, b, DIM), generator=g,
                         device=dev).to(torch.bfloat16)
        cache = ff.FusedFastCache.create(N_LAYER, N_POS, b, DIM, dev)
        filled = 0
        for pos in positions:
            for p in range(filled, pos):
                ff.fused_fast_sweep_plain(packed, xs[p], cache, freqs, pos=p,
                                          **kw)
            filled = max(filled, pos)
            ms = time_ms(lambda: ff.fused_fast_sweep(
                packed, xs[pos], cache, freqs, pos=pos, **kw), 20)
            print(json.dumps({"b": b, "pos": pos, "ms": ms}), flush=True)
        del cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
