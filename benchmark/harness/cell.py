"""A cell by name: its configuration, traffic mix and metrics, found as
files by the names `BENCHMARK.json` gives, and the engine built from them.

`benchmark/configs/<config>.json`, `benchmark/traffic/<traffic>.json` and
`benchmark/metrics/<metric>.py` are the only places a cell's parts live;
adding a cell, a configuration, a mix or a metric adds files and edits
none of these.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]          # benchmark/


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, spec_path: Path, root: Path = ROOT) -> Cell:
    """The workload `name` of the spec, its files read under `root`."""
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path}")
    w = cells[name]
    config = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(name, w["chips"], config, traffic,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The `read(run) -> float | None` of <root>/metrics/<metric>.py."""
    path = root / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def lm_shape(config: dict, cache_len: int) -> dict:
    """The language model's sizes with the tokenizer's ids filled in."""
    from ..reference import prompt as ref_prompt

    ids = ref_prompt.ids(config["lm"]["codebook_size"])
    return {**config["lm"], "max_seq_len": cache_len,
            "semantic_begin_id": ids["semantic_begin_id"],
            "semantic_end_id": ids["semantic_end_id"],
            "im_end_id": ids["<|im_end|>"]}


def build_engine(config: dict, traffic: dict, params: dict,
                 codec_params: dict, device):
    """The serving engine through the program's public pieces, as
    `engine.generate.build_engine` assembles it, on the benchmark's
    weights: `serving_config`, `quantize_lm_params`,
    `enable_fused_fast_head`, `TTSEngine` with the cell's scheduler
    slots."""
    from fish_speech_tpu_torch.codec.config import (CodecTransformerConfig,
                                                    DACConfig, RVQConfig)
    from fish_speech_tpu_torch.engine.generate import (TTSEngine,
                                                       serving_config)
    from fish_speech_tpu_torch.models.config import DualARConfig
    from fish_speech_tpu_torch.ops.fast_fused import enable_fused_fast_head
    from fish_speech_tpu_torch.ops.quant import quantize_lm_params
    from fish_speech_tpu_torch.text.tokenizer import ByteTokenizer

    lm, srv, c = config["lm"], config["serving"], config["codec"]
    cache_len = traffic["cache_len"]
    tokenizer = ByteTokenizer(n_semantic=lm["codebook_size"])
    cfg = DualARConfig(**lm, max_seq_len=cache_len).with_semantic_range(
        tokenizer.semantic_begin_id, tokenizer.semantic_end_id)
    # the position-major int8 cache read by #1 (or #5, folded)
    served = serving_config(cfg, kv_fold=srv["kv_fold"])
    q = enable_fused_fast_head(quantize_lm_params(
        params, mode=srv["quant"], groupsize=srv["groupsize"]))
    q = _own_storage(q, params)
    t = c["post_transformer"]
    ccfg = DACConfig(
        sample_rate=c["sample_rate"],
        encoder_rates=tuple(c["encoder_rates"]), decoder_dim=c["decoder_dim"],
        decoder_rates=tuple(c["decoder_rates"]),
        latent_dim=c["latent_dim"],
        rvq=RVQConfig(
            input_dim=c["input_dim"], n_codebooks=c["n_codebooks"],
            codebook_size=c["codebook_size"], codebook_dim=c["codebook_dim"],
            semantic_codebook_size=c["semantic_codebook_size"],
            downsample_factor=tuple(c["downsample"]),
            pre_post_transformer=CodecTransformerConfig(
                n_layer=t["n_layer"], n_head=t["n_head"], dim=t["dim"],
                intermediate_size=t["intermediate_size"],
                head_dim=t["head_dim"], rope_base=t["rope_base"],
                norm_eps=t["norm_eps"], window_size=t["window"])))
    if ccfg.frame_length != c["frame_length"]:
        raise ValueError("the codec's frame length is not the file's")
    return TTSEngine(q, served, tokenizer, codec_params, ccfg,
                     cache_len=cache_len, device=device,
                     voc_quant=False,
                     scheduler_slots=traffic["slots"],
                     vocoder_impl=srv["vocoder"])


def _own_storage(tree, drawn):
    """Copy the leaves that still share the drawn buffer (the program casts
    bf16 leaves to bf16, which keeps them as views), so the draw's buffer
    is freed once the caller lets go of it."""
    import torch

    flat = []

    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                leaves(v)
        elif isinstance(t, torch.Tensor):
            flat.append(t.untyped_storage().data_ptr())

    leaves(drawn)
    shared = set(flat)

    def visit(t):
        if isinstance(t, dict):
            return {k: visit(v) for k, v in t.items()}
        if (isinstance(t, torch.Tensor)
                and t.untyped_storage().data_ptr() in shared):
            return t.clone()
        return t

    return visit(tree)
