"""LoRA finetuning, functional style.

Counterpart of `fish_speech_tpu/train/lora.py` (the reference swaps
nn.Linear / Embedding modules for loralib wrappers, ref
fish_speech/models/text2semantic/lora.py:25-91). Here LoRA is a separate
flat dict of (a, b) factors keyed by the base weight's path in JAX's
`keystr` form ("['layers']['attention']['wqkv']"), so that LoRA
checkpoints move between the packages. The forward path is unchanged:
`merge_lora` materializes W + (alpha / r) * b @ a each step, and the
gradients reach only the factors (the base is frozen).

Covered weights (the reference's target list, lora.py:34-60): attention
wqkv / wo and mlp w1 / w2 / w3 in both stacks (stacked layers get stacked
factors), fast_output, output (untied) and the three embedding tables.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import DualARConfig
from ..models.init import lm_params_from_jax
from .step import (Optimizer, OptState, TrainBatch, dual_ar_loss, grads_of,
                   tree_leaves)


@dataclass(frozen=True)
class LoraConfig:
    r: int = 8
    lora_alpha: float = 16.0

    @property
    def scale(self) -> float:
        return self.lora_alpha / self.r


_TARGET_LEAVES = {"wqkv", "wo", "w1", "w2", "w3"}
_TARGET_TOP = {"embeddings", "codebook_embeddings", "fast_embeddings",
               "output", "fast_output"}


def _keystr(path: tuple) -> str:
    """A dict key path as `jax.tree_util.keystr` writes it."""
    return "".join(f"[{k!r}]" for k in path)


def _is_target(path: tuple) -> bool:
    return path[-1] in _TARGET_LEAVES or (path[-1] in _TARGET_TOP
                                          and len(path) == 1)


def init_lora_params(gen: torch.Generator, params: dict,
                     cfg: LoraConfig) -> dict:
    """Flat {keystr: {"a", "b"}} dict, one entry per target weight, in
    JAX's key order: a ~ N(0, 0.02) drawn from `gen` (on the weights'
    device), b = 0, so training starts at the base model (the loralib
    convention)."""
    out = {}
    for path, w in tree_leaves(params):
        if not _is_target(path) or w.ndim < 2:
            continue
        *batch, out_dim, in_dim = w.shape
        a = 0.02 * torch.randn((*batch, cfg.r, in_dim), generator=gen,
                               dtype=torch.float32, device=w.device)
        out[_keystr(path)] = {
            "a": a.to(w.dtype),
            "b": torch.zeros((*batch, out_dim, cfg.r), dtype=w.dtype,
                             device=w.device)}
    return out


def lora_params_from_jax(tree: dict, device=None) -> dict:
    """JAX's flat factor dict, every leaf a numpy array, as the port's
    (same keys, on `device`, CUDA unless named)."""
    return lm_params_from_jax(tree, device)


def merge_lora(params: dict, lora: dict, cfg: LoraConfig) -> dict:
    """W + scale * (b @ a) at every target, identity elsewhere. The product
    is taken in the weight's dtype, then scaled, then added (JAX's rounding
    order)."""
    def visit(tree, prefix):
        out = {}
        for k, w in tree.items():
            path = prefix + (k,)
            if isinstance(w, dict):
                out[k] = visit(w, path)
                continue
            lw = lora.get(_keystr(path))
            out[k] = w if lw is None else \
                w + cfg.scale * (lw["b"] @ lw["a"]).to(w.dtype)
        return out

    return visit(params, ())


def make_lora_optimizer(schedule) -> Optimizer:
    """The training CLI's LoRA optimizer: optax's `chain(
    clip_by_global_norm(1.0), adamw(schedule, b1=0.9, b2=0.95))`, whose
    default weight decay (1e-4) applies to every factor."""
    return Optimizer(schedule, b1=0.9, b2=0.95, weight_decay=1e-4,
                     clip_norm=1.0)


def make_lora_train_step(cfg_model: DualARConfig, base_params: dict,
                         lora_cfg: LoraConfig, optimizer: Optimizer,
                         remat: bool = True):
    """(lora, opt_state, batch) -> (lora, opt_state, metrics), opt_state
    being `optimizer.init(lora)`: only the factors train (ref lit_module.py's
    LoRA-only checkpoint). The base is frozen (`requires_grad=False`) and
    left bit for bit as it was."""
    del optimizer  # bound to the factors by init
    for _, w in tree_leaves(base_params):
        w.requires_grad_(False)

    def step(lora: dict, opt_state: OptState, batch: TrainBatch):
        merged = merge_lora(base_params, lora, lora_cfg)
        loss, metrics = dual_ar_loss(merged, cfg_model, batch, remat)
        metrics["grad_norm"] = opt_state.apply(
            grads_of(loss, opt_state.leaves))
        return lora, opt_state, metrics

    return step
