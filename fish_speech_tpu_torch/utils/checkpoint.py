"""Checkpoint IO: the native safetensors layout and the reference layouts.

Counterpart of `fish_speech_tpu/utils/checkpoint.py`, on the port's own
safetensors reader and writer (utils/safetensors.py).

The native format: a directory with `config.json` and `model.safetensors`
holding the parameter tree flattened with '/'-joined keys (list indices as
numbers). The JAX package widens its native int4 leaves to int8 on disk and
lists their keys in `quant_meta.json`, and so does `save_params` for the
port's carried form of them (ops/quant.py, mode "int4"); `load_params`
packs such a leaf pair ({"q", "gs"}) into the port's split-half nibble
form ({"q4", "gs"}), as `models.init.lm_params_from_jax` does for a JAX
int4 tree. The port's own packed int4 is int8 on disk and needs no such
list.

The reference layouts (`load_torch_lm_checkpoint`): a sharded safetensors
checkpoint with its index, one `model.safetensors`, or `model.pth` (the
Lightning "model." prefix stripped, `audio_*` keys dropped); fish_qwen3_omni
names are mapped to the Dual-AR names. Tensors come back on the CPU, mapped
from the files and in their stored dtype, so that `convert_dual_ar_state_dict`
reads each from disk once on its way to the card.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant import pack_int4_params
from .safetensors import load_file, save_file


def sd_tensor(v) -> torch.Tensor:
    """A state-dict entry (a torch tensor or an array) as a torch tensor,
    without a copy where it already is one."""
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.asarray(v))

def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def save_params(path: str | Path, params: dict, config=None) -> None:
    """The tree's leaves to `path`/model.safetensors, and `config` (a
    dataclass or a dict) to `path`/config.json."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = _flatten(params)
    # the JAX native int4 form ({"q" int8 values, "gs"}): listed as JAX
    # lists its int4 leaves, widened to int8 on disk
    int4_keys = sorted(k for k in flat if k.endswith("/q")
                       and k[:-1] + "gs" in flat and k[:-1] + "s" not in flat)
    if int4_keys:
        (path / "quant_meta.json").write_text(json.dumps(
            {"int4_keys": int4_keys}))
    save_file(flat, path / "model.safetensors")
    if config is not None:
        cfg_dict = (dataclasses.asdict(config)
                    if dataclasses.is_dataclass(config) else dict(config))
        (path / "config.json").write_text(json.dumps(cfg_dict, indent=2))


def load_params(path: str | Path, dtype: torch.dtype | None = None,
                device=None) -> tuple[dict, dict | None]:
    """(parameter tree on `device` (CUDA unless named), config dict or
    None). Floating leaves are cast to `dtype` when one is given; integer
    leaves (int8 q-values) never are. Native int4 leaves listed in
    quant_meta.json are packed into the port's {"q4", "gs"} form."""
    path = Path(path)
    device = resolve_device(device)
    flat = load_file(path / "model.safetensors")
    meta_file = path / "quant_meta.json"
    int4_keys = (set(json.loads(meta_file.read_text()).get("int4_keys", []))
                 if meta_file.exists() else set())
    for k in int4_keys:
        if flat[k].dtype != torch.int8:
            raise ValueError(f"{path}: int4 leaf {k} is {flat[k].dtype} on "
                             "disk, not int8")

    def restore(v: torch.Tensor) -> torch.Tensor:
        if dtype is not None and v.is_floating_point():
            return v.to(device=device, dtype=dtype)
        return v.to(device)

    params = pack_int4_params(_unflatten({k: restore(v)
                                          for k, v in flat.items()}))
    config = None
    cfg_file = path / "config.json"
    if cfg_file.exists():
        config = json.loads(cfg_file.read_text())
    return params, config


def _remap_fish_qwen3_omni_keys(weights: dict) -> dict:
    """fish_qwen3_omni names -> Dual-AR names (ref llama.py:229-246)."""
    if not any(k.startswith(("text_model.", "audio_decoder."))
               for k in weights):
        return weights
    new = {}
    for k, v in weights.items():
        if k.startswith("text_model.model."):
            nk = k[len("text_model.model."):]
        elif k.startswith("audio_decoder."):
            suffix = k[len("audio_decoder."):]
            nk = (suffix if suffix.startswith("codebook_embeddings.")
                  else "fast_" + suffix)
        else:
            nk = k
        new[nk] = v
    return new


def load_torch_lm_checkpoint(path: str | Path) -> dict[str, torch.Tensor]:
    """A reference checkpoint directory -> {Dual-AR name: CPU tensor}. Feed
    the result to models.init.convert_dual_ar_state_dict."""
    path = Path(path)
    index_json = path / "model.safetensors.index.json"
    single_st = path / "model.safetensors"
    pth_file = path / "model.pth"

    if index_json.exists():
        st_index = json.loads(index_json.read_text())
        weights = {}
        for shard in sorted(set(st_index["weight_map"].values())):
            weights.update(load_file(path / shard))
        return _remap_fish_qwen3_omni_keys(weights)
    if single_st.exists():
        return _remap_fish_qwen3_omni_keys(load_file(single_st))
    if pth_file.exists():
        weights = torch.load(pth_file, map_location="cpu", mmap=True,
                             weights_only=True)
        if "state_dict" in weights:
            weights = weights["state_dict"]
        if weights and next(iter(weights)).startswith("model."):
            weights = {k[len("model."):]: v for k, v in weights.items()}
        return {k: v for k, v in weights.items() if "audio_" not in k}
    raise FileNotFoundError(f"No model weights found in {path}")


def load_torch_codec_checkpoint(path: str | Path) -> dict[str, torch.Tensor]:
    """codec.pth -> {name: f32 CPU tensor}, the 'generator.' prefix
    stripped (ref dac/inference.py:35-40). Feed the result to
    codec.convert.convert_dac_state_dict."""
    state_dict = torch.load(str(path), map_location="cpu", mmap=True,
                            weights_only=True)
    if "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    if any("generator" in k for k in state_dict):
        state_dict = {k.replace("generator.", ""): v
                      for k, v in state_dict.items() if "generator." in k}
    return {k: v.float() for k, v in state_dict.items()}
