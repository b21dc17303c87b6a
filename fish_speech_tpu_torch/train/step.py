"""Training step: the dual cross-entropy loss, AdamW with global-norm
clipping, and the step function.

Counterpart of `fish_speech_tpu/train/step.py` (ref
fish_speech/models/text2semantic/lit_module.py:109-204):
  base_loss     = CE(token_logits, labels[:, 0]) ignoring -100
  semantic_loss = CE(codebook_logits, labels[:, 1:]) at semantic positions
  top-5 accuracy over the codebook predictions (pad / ignore masked)

`forward_train` gives codebook logits at every position; the semantic
positions are a loss mask. The optimizer is optax's chain
`clip_by_global_norm(clip) -> adamw(schedule, b1, b2, weight_decay, mask)`
as `torch.optim.AdamW` (eps 1e-8, decay decoupled, the moments in the
parameters' dtype) with two parameter groups (decayed or not), its rate
set by `LambdaLR` at the optimizer's own step count from 0, and optax's
clip formula: g / ||g|| * clip when ||g|| >= clip, with no epsilon.

Parameters are the nested dicts of models/init.py; a step updates them in
place and also returns them, as the JAX step returns its new tree.

On a (data, model) mesh (`make_train_step(..., mesh=)`) every rank holds
its parameter slices (`parallel.mesh.shard_dual_ar_params`) and its data
rows of the global batch (`shard_batch`), and the step reproduces JAX's
sharded step, where GSPMD inserts the collectives:
- the forward pass runs under the model group (models/dual_ar.py);
- the loss is the global batch's mean: the masked sums and counts of
  each cross-entropy and of the top-5 accuracy are summed over the data
  group (not the ranks' means averaged);
- the gradients are summed over the data group;
- the global norm counts a model-sharded leaf's squares over the model
  group and a replicated leaf's once.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..models.config import DualARConfig
from ..models.dual_ar import forward_train
from ..parallel.collectives import all_reduce_sum, reduce_from_group
from ..parallel.mesh import MODEL_AXIS, dual_ar_param_specs
from ..parallel.tp import decode_mesh

CODEBOOK_PAD_TOKEN_ID = 0  # ref lit_module.py:10
ADAM_EPS = 1e-8            # optax's adamw default (eps_root 0)


class TrainBatch(NamedTuple):
    inputs: torch.Tensor           # (B, K+1, T) int
    labels: torch.Tensor           # (B, K+1, T) int, -100 = ignore
    attention_masks: torch.Tensor  # (B, T) bool, True at PAD positions

    @staticmethod
    def from_numpy(batch: dict, device) -> "TrainBatch":
        """A collated batch (`data.TextDataCollator`) on `device`."""
        return TrainBatch(*(torch.from_numpy(batch[k]).to(device)
                            for k in TrainBatch._fields))


def tree_leaves(tree: dict, prefix: tuple = ()) -> list:
    """[(key path, leaf)] in sorted key order, the order in which JAX
    flattens a dict (and so sums the global norm)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(tree_leaves(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, group=None) -> torch.Tensor:
    """Mean CE over mask; logits (..., V), labels (...), mask (...) bool.
    `group`: the data group, over which the sum and the count are summed
    (the mean over the global batch)."""
    safe = labels.clamp_min(0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    denom = all_reduce_sum(mask.sum(), group).clamp_min(1)
    return reduce_from_group(torch.where(mask, nll, 0.0).sum(), group) / denom


def get_batch_logps(logits: torch.Tensor, labels: torch.Tensor,
                    average_log_prob: bool = False) -> torch.Tensor:
    """Per-sequence label log-probabilities (DPO-style preference scoring;
    ref lit_module.py:76-107). logits (B, T, K, V); labels (B, T, K) with
    -100 ignored. Returns (B,): the sum (or mean) of the per-token
    log-probabilities, the documented contract the JAX function keeps (the
    reference's code returns (B, T))."""
    if logits.shape[:-1] != labels.shape:
        raise ValueError(f"logits {tuple(logits.shape)} do not match labels "
                         f"{tuple(labels.shape)}")
    loss_mask = labels != -100
    safe = labels.long().clamp_min(0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    per_token = logp.gather(-1, safe[..., None])[..., 0]
    per_token = torch.where(loss_mask, per_token, 0.0)
    b = per_token.shape[0]
    total = per_token.reshape(b, -1).sum(-1)
    if average_log_prob:
        return total / loss_mask.reshape(b, -1).sum(-1).clamp_min(1)
    return total


def dual_ar_loss(params: dict, cfg: DualARConfig, batch: TrainBatch,
                 remat: bool = True, data_group=None):
    """(loss, metrics): the scalar loss and {"loss", "base_loss",
    "semantic_loss", "top_5_accuracy"} as 0-d tensors. `data_group`: the
    data group of a mesh, `batch` the rank's rows; the loss and metrics
    are the global batch's, the same on every rank."""
    out = forward_train(params, cfg, batch.inputs, labels=batch.labels,
                        key_padding_mask=batch.attention_masks, remat=remat)
    labels = batch.labels.long()
    token_labels = labels[:, 0]                                # (B, T)
    base_loss = _masked_ce(out.token_logits, token_labels,
                           token_labels != -100, data_group)

    semantic_mask = ((token_labels >= cfg.semantic_begin_id)
                     & (token_labels <= cfg.semantic_end_id))   # (B, T)
    cb_labels = labels[:, 1:].transpose(1, 2)                   # (B, T, K)
    cb_mask = semantic_mask[..., None] & (cb_labels != -100)
    semantic_loss = _masked_ce(out.codebook_logits, cb_labels, cb_mask,
                               data_group)

    # top-5 accuracy (ref lit_module.py:193-204)
    with torch.no_grad():
        acc_mask = cb_mask & (cb_labels != CODEBOOK_PAD_TOKEN_ID)
        top5 = torch.topk(out.codebook_logits, 5, dim=-1).indices
        correct = (top5 == cb_labels[..., None]).any(-1) & acc_mask
        accuracy = (all_reduce_sum(correct.sum(), data_group)
                    / all_reduce_sum(acc_mask.sum(), data_group).clamp_min(1))

    loss = base_loss + semantic_loss
    metrics = {"loss": loss.detach(), "base_loss": base_loss.detach(),
               "semantic_loss": semantic_loss.detach(),
               "top_5_accuracy": accuracy}
    return loss, metrics


def grads_of(loss: torch.Tensor, leaves: list) -> list:
    """d loss / d leaf for each leaf; zeros where a leaf took no part (JAX's
    gradient of an unused input)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def data_sum(grads: list, data_group) -> list:
    """Each gradient summed over the data group (a rank's is its rows'
    part of the global mean's gradient)."""
    if data_group is None:
        return grads
    return [all_reduce_sum(g, data_group) for g in grads]


def sharded_leaves(params: dict) -> list:
    """Whether each leaf (`tree_leaves` order) is sharded over `model`
    (`parallel.mesh.dual_ar_param_specs`)."""
    return [MODEL_AXIS in spec for _, spec in
            tree_leaves(dual_ar_param_specs(params))]


def global_norm(grads: list, sharded: list | None = None,
                model_group=None) -> torch.Tensor:
    """The gradients' global L2 norm (f32). With `sharded` flags and a
    model group: a sharded leaf's squares are summed over the group, a
    replicated leaf's are counted once."""
    sq = [g.float().square().sum() for g in grads]
    if model_group is None or not any(sharded or ()):
        return torch.sqrt(sum(sq))
    rep = sum((s for s, sh in zip(sq, sharded) if not sh),
              torch.zeros((), device=sq[0].device))
    shd = sum(s for s, sh in zip(sq, sharded) if sh)
    return torch.sqrt(rep + all_reduce_sum(shd, model_group))


def mesh_context(mesh):
    """The decode-mesh registry set to `mesh` (the model group's
    branches of models/dual_ar.py read it); nothing without a mesh."""
    return contextlib.nullcontext() if mesh is None else decode_mesh(mesh)


def mesh_config(cfg: DualARConfig, mesh) -> DualARConfig:
    """`cfg` with its tensor-parallel width set to the mesh's model axis."""
    if mesh is None or cfg.tp_shards == mesh.model:
        return cfg
    return dataclasses.replace(cfg, tp_shards=mesh.model)


def dual_ar_grads(params: dict, cfg: DualARConfig, batch: TrainBatch,
                  remat: bool = True, mesh=None):
    """(metrics, grads): the loss's metrics and its gradient as a tree like
    `params` (`jax.value_and_grad(dual_ar_loss, has_aux=True)`). Marks every
    leaf as requiring a gradient. mesh: as `make_train_step`'s; the
    gradient is then the rank's slices of the global batch's."""
    paths, leaves = zip(*tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    data_group = None if mesh is None else mesh.data_group
    with mesh_context(mesh):
        loss, metrics = dual_ar_loss(params, mesh_config(cfg, mesh), batch,
                                     remat, data_group)
        grads_list = data_sum(grads_of(loss, list(leaves)), data_group)
    grads: dict = {}
    for path, g in zip(paths, grads_list):
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    return metrics, grads


def _decay_mask(params: dict) -> dict:
    """No weight decay for biases, norms, embeddings (ref
    lit_module.py:44-57): a tree of bools like `params`."""
    def visit(tree, prefix):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = visit(v, prefix + (k,))
                continue
            name = "/".join(prefix + (k,))
            out[k] = not ("norm" in name or "embeddings" in name
                          or name.endswith("_b") or name.endswith("/b")
                          ) and v.ndim >= 2
        return out

    return visit(params, ())


class OptState:
    """The optimizer bound to its leaves: torch AdamW, its LambdaLR, the
    clip. `apply(grads)` is one optimizer update."""

    def __init__(self, leaves: list, opt: torch.optim.AdamW,
                 sched: torch.optim.lr_scheduler.LambdaLR, clip_norm: float):
        self.leaves = leaves
        self.opt = opt
        self.sched = sched
        self.clip_norm = clip_norm

    def apply(self, grads: list,
              g_norm: torch.Tensor | None = None) -> torch.Tensor:
        """Clip `grads` (one a leaf) by their global norm (`g_norm`, or
        `global_norm(grads)`), take one AdamW step at this count's rate,
        and return the unclipped norm."""
        if g_norm is None:
            g_norm = global_norm(grads)
        if not bool(g_norm < self.clip_norm):
            grads = [(g / g_norm.to(g.dtype)) * self.clip_norm for g in grads]
        for p, g in zip(self.leaves, grads):
            p.grad = g
        self.opt.step()
        self.sched.step()
        for p in self.leaves:
            p.grad = None
        return g_norm


@dataclass(frozen=True)
class Optimizer:
    """AdamW with global-norm clipping (optax's `chain(clip_by_global_norm,
    adamw)`): `init(params)` binds it to a tree's leaves. decay_mask: a
    tree of bools like the params (False: no decay), or None to decay
    every leaf (optax's default)."""
    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 1e-4
    clip_norm: float = 1.0
    decay_mask: dict | None = None

    def init(self, params: dict) -> OptState:
        leaves = [p for _, p in tree_leaves(params)]
        for p in leaves:
            p.requires_grad_(True)
        if self.decay_mask is None:
            decay = [True] * len(leaves)
        else:
            decay = [m for _, m in tree_leaves(self.decay_mask)]
        groups = [{"params": [p for p, d in zip(leaves, decay) if d == flag],
                   "weight_decay": self.weight_decay if flag else 0.0}
                  for flag in (True, False)]
        # lr 1.0 a group: LambdaLR then sets schedule(count) itself
        opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=1.0,
                                betas=(self.b1, self.b2), eps=ADAM_EPS)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, self.schedule)
        return OptState(leaves, opt, sched, self.clip_norm)


def make_optimizer(params: dict, schedule, weight_decay: float = 0.01,
                   b1: float = 0.9, b2: float = 0.95,
                   clip_norm: float = 1.0) -> Optimizer:
    """AdamW matching configs/text2semantic_finetune.yaml (betas [0.9,
    0.95]), no decay for biases, norms and embeddings."""
    return Optimizer(schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                     clip_norm=clip_norm, decay_mask=_decay_mask(params))


def make_train_step(cfg: DualARConfig, optimizer: Optimizer,
                    remat: bool = True, mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), metrics
    with the unclipped gradient norm as "grad_norm". With `remat` each
    layer is recomputed in the backward pass. opt_state is
    `optimizer.init(params)`.

    mesh: a `parallel.mesh.Mesh`; params are then the rank's slices, the
    batch its data rows, cfg.tp_shards is set to the model axis, and the
    metrics are the global batch's on every rank (see the module
    docstring)."""
    del optimizer  # bound to the leaves by init; kept for the JAX signature
    cfg = mesh_config(cfg, mesh)
    data_group = None if mesh is None else mesh.data_group
    model_group = None if mesh is None else mesh.model_group

    def step(params: dict, opt_state: OptState, batch: TrainBatch):
        with mesh_context(mesh):
            loss, metrics = dual_ar_loss(params, cfg, batch, remat,
                                         data_group)
            grads = data_sum(grads_of(loss, opt_state.leaves), data_group)
        sharded = None if model_group is None else sharded_leaves(params)
        metrics["grad_norm"] = opt_state.apply(
            grads, global_norm(grads, sharded, model_group))
        return params, opt_state, metrics

    return step
