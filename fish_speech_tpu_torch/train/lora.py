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

On a (data, model) mesh the factors are whole on every rank and the base
is the rank's slices: `merge_lora` adds the slice of the delta that the
target's spec gives the rank, through the copy operator, so a factor's
gradient is summed over the model group (each rank's is the part its
slice contributes); the step then sums it over the data group.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import DualARConfig
from ..models.init import lm_params_from_jax
from ..parallel.collectives import copy_to_group
from ..parallel.mesh import MODEL_AXIS, dual_ar_param_specs
from .step import (Optimizer, OptState, TrainBatch, data_sum, dual_ar_loss,
                   grads_of, mesh_config, mesh_context, tree_leaves)


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


def _local_factors(lw: dict, w: torch.Tensor, spec: tuple, mesh):
    """(b, a) whose product is the rank's slice of the delta of a target
    `w` under `spec`: b's rows for an output-sharded weight, a's columns
    for an input-sharded one, both through the copy operator."""
    b, a = lw["b"], lw["a"]
    if MODEL_AXIS not in spec:
        return b, a
    b, a = copy_to_group(b, mesh.model_group), copy_to_group(a,
                                                             mesh.model_group)
    axis = spec.index(MODEL_AXIS) - len(spec)          # -2 rows, -1 columns
    src = b if axis == -2 else a
    step = src.shape[axis] // mesh.model
    part = src.narrow(axis, mesh.model_index * step, step)
    return (part, a) if axis == -2 else (b, part)


def merge_lora(params: dict, lora: dict, cfg: LoraConfig,
               mesh=None) -> dict:
    """W + scale * (b @ a) at every target, identity elsewhere. The product
    is taken in the weight's dtype, then scaled, then added (JAX's rounding
    order). With a mesh whose model axis is above 1, `params` are the
    rank's slices and the factors whole (see the module docstring)."""
    sharded = mesh is not None and mesh.model > 1

    def visit(tree, specs, prefix):
        out = {}
        for k, w in tree.items():
            path = prefix + (k,)
            if isinstance(w, dict):
                out[k] = visit(w, specs and specs[k], path)
                continue
            lw = lora.get(_keystr(path))
            if lw is None:
                out[k] = w
                continue
            b, a = (_local_factors(lw, w, specs[k], mesh) if sharded
                    else (lw["b"], lw["a"]))
            out[k] = w + cfg.scale * (b @ a).to(w.dtype)
        return out

    return visit(params, dual_ar_param_specs(params) if sharded else None,
                 ())


def make_lora_optimizer(schedule) -> Optimizer:
    """The training CLI's LoRA optimizer: optax's `chain(
    clip_by_global_norm(1.0), adamw(schedule, b1=0.9, b2=0.95))`, whose
    default weight decay (1e-4) applies to every factor."""
    return Optimizer(schedule, b1=0.9, b2=0.95, weight_decay=1e-4,
                     clip_norm=1.0)


def make_lora_train_step(cfg_model: DualARConfig, base_params: dict,
                         lora_cfg: LoraConfig, optimizer: Optimizer,
                         remat: bool = True, mesh=None):
    """(lora, opt_state, batch) -> (lora, opt_state, metrics), opt_state
    being `optimizer.init(lora)`: only the factors train (ref lit_module.py's
    LoRA-only checkpoint). The base is frozen (`requires_grad=False`) and
    left bit for bit as it was. mesh: as `make_train_step`'s, the base
    being the rank's slices and the factors whole on every rank (so the
    global norm counts each once)."""
    del optimizer  # bound to the factors by init
    for _, w in tree_leaves(base_params):
        w.requires_grad_(False)
    cfg_model = mesh_config(cfg_model, mesh)
    data_group = None if mesh is None else mesh.data_group

    def step(lora: dict, opt_state: OptState, batch: TrainBatch):
        with mesh_context(mesh):
            merged = merge_lora(base_params, lora, lora_cfg, mesh)
            loss, metrics = dual_ar_loss(merged, cfg_model, batch, remat,
                                         data_group)
            grads = data_sum(grads_of(loss, opt_state.leaves), data_group)
        metrics["grad_norm"] = opt_state.apply(grads)
        return lora, opt_state, metrics

    return step
