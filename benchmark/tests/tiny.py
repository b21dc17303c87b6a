"""A tiny configuration and traffic of the benchmark's cells, for
rehearsing their paths on the CPU."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark.harness import cell as cells

ROOT = Path(__file__).resolve().parents[1]

TINY_LM = dict(vocab_size=400, n_layer=2, n_head=4, n_local_heads=2, dim=64,
               head_dim=16, intermediate_size=128, rope_base=10000.0,
               norm_eps=1e-5, tie_word_embeddings=True,
               attention_qk_norm=True, codebook_size=64, num_codebooks=4,
               scale_codebook_embeddings=True, norm_fastlayer_input=True,
               n_fast_layer=2, fast_dim=64, fast_n_head=2,
               fast_n_local_heads=2, fast_head_dim=32,
               fast_intermediate_size=192, fast_attention_qk_norm=False)
TINY_CODEC = dict(sample_rate=44100, encoder_rates=[2, 4, 4], frame_length=128,
                  decoder_dim=128, decoder_rates=[4, 4, 2], latent_dim=64,
                  input_dim=64, codebook_dim=4, n_codebooks=3,
                  codebook_size=32, semantic_codebook_size=64,
                  downsample=[2, 2],
                  post_transformer=dict(n_layer=2, n_head=2, dim=64,
                                        intermediate_size=128, head_dim=32,
                                        rope_base=10000.0, norm_eps=1e-5,
                                        window=16))


def config(name: str) -> dict:
    """The configuration `name` with the tiny model's sizes."""
    c = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    c = copy.deepcopy(c)
    c["lm"], c["codec"] = dict(TINY_LM), copy.deepcopy(TINY_CODEC)
    c["serving"]["groupsize"] = 32
    for prec in (c["reference"], c["control"]["lm"]):
        if prec.get("slow_weights", "").startswith("int4"):
            prec["slow_weights"] = "int4_g32"
    c["check"] = {"requests": 2, "frames": 40, "min_frames": 2}
    # the tiny model's own limits: its sound CPU runs read token gaps up
    # to ~0.005 and float32 waveforms within 1e-6
    c["limits"] = {"token_gap": 0.02, "wave_err": 1e-3}
    return c


def traffic(name: str) -> dict:
    """The mix `name` with short texts, few frames, two clients."""
    m = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
    m.update(clients=2, slots=2, cache_len=256, pool=8, frames_per_byte=0.2,
             min_frames=2, greedy_every=2)
    m["text_bytes"] = {**m["text_bytes"], "median": 30, "min": 20, "max": 60}
    if m["chunk"]:
        m["chunk"] = {"first": 2, "frames": 4}
    return m


# cells on the harness's `tts` path that BENCHMARK.json leaves for later
# (PERF.md, Open questions): rehearsed here, so that they can be added as
# data alone
LATER = {"w4a8-f32voc-batch64": ("s2pro-w4a8-f32voc", "batch64")}


def cell(workload: str) -> cells.Cell:
    """The workload of BENCHMARK.json, or of `LATER` with every metric
    that names no cells, at the tiny sizes."""
    spec = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    if workload in LATER:
        conf, mix = LATER[workload]
        return cells.Cell(workload, 1, config(conf), traffic(mix),
                          [m for m in spec["end_to_end"]
                           if "workloads" not in m], spec["per_layer"])
    w = {x["name"]: x for x in spec["workloads"]}[workload]
    full = cells.load(workload, ROOT.parent / "BENCHMARK.json")
    return cells.Cell(workload, w["chips"], config(w["config"]),
                      traffic(w["traffic"]), full.end_to_end, full.per_layer)
