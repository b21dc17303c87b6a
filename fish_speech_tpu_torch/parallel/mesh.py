"""The (data, model) mesh and the Dual-AR sharding rules.

Counterpart of `fish_speech_tpu/parallel/mesh.py`. The JAX package places
global arrays on a `jax.sharding.Mesh` and lets GSPMD insert the
collectives; here every rank of a `torch.distributed` world holds only its
own slices, and the collectives are written out (parallel/collectives.py,
called from models/dual_ar.py).

- Ranks are laid out row-major over (data, model), as JAX's
  `devices.reshape(data, model)`: rank r has data index r // model and
  model index r % model.
- The model group (the ranks of one data index) shards the Dual-AR stack
  Megatron-style: wqkv, w1 and w3 by output rows, wo and w2 by input
  columns, the vocabulary- or out-sharded heads by rows.
- The data group (the ranks of one model index) splits the batch.

The spec rules are the JAX package's, with a PartitionSpec written as a
tuple of axis names (None: that axis is whole).
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import timedelta

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
# every collective of a mesh gives up after this long: gloo's own default
# (30 minutes) would hang a test or a smoke run on a lost rank
TIMEOUT = timedelta(seconds=60)
BACKENDS = ("gloo", "nccl")


@dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: its coordinates, its two process
    groups (None where the group is this rank alone, or where the mesh
    only names coordinates, as `mesh_coords` makes it), the backend and
    the rank's device."""
    data: int
    model: int
    rank: int
    device: torch.device
    backend: str | None = None
    model_group: object | None = None
    data_group: object | None = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def mesh_coords(cfg: MeshConfig, rank: int,
                device: torch.device | str = "cpu") -> Mesh:
    """Rank `rank`'s coordinates on a (data, model) mesh, without process
    groups: enough to cut its slices (`shard_dual_ar_params`,
    `shard_kv_cache`, `shard_batch`), not to run a collective."""
    if not 0 <= rank < cfg.data * cfg.model:
        raise ValueError(f"rank {rank} is outside the mesh {cfg}")
    return Mesh(cfg.data, cfg.model, rank, torch.device(device))


def create_mesh(cfg: MeshConfig | None = None, *, backend: str,
                device: torch.device | str) -> Mesh:
    """This rank's mesh over the initialized default process group.

    backend: "nccl" when each rank owns a card, "gloo" when ranks share
    one (or on the CPU); it is never inferred, and must be the default
    group's. device: the rank's device. Every rank must call this, in the
    same order as its other group creations: `dist.new_group` is a
    collective call over the whole world."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs torch.distributed initialized "
                           "(init_process_group with an explicit timeout)")
    if dist.get_backend() != backend:
        raise ValueError(f"the default process group runs "
                         f"{dist.get_backend()!r}, not {backend!r}")
    world = dist.get_world_size()
    if cfg is None:
        cfg = MeshConfig(data=1, model=world)
    if cfg.data * cfg.model != world:
        raise ValueError(f"mesh {cfg} does not cover {world} ranks")
    rank = dist.get_rank()

    def groups(members: list[list[int]]):
        """One group per member list (every rank creates each), and the
        one holding this rank; None for groups of one rank."""
        mine = None
        for ranks in members:
            if len(ranks) == 1:
                continue
            g = dist.new_group(ranks=ranks, timeout=TIMEOUT, backend=backend)
            if rank in ranks:
                mine = g
        return mine

    model_group = groups([[d * cfg.model + m for m in range(cfg.model)]
                          for d in range(cfg.data)])
    data_group = groups([[d * cfg.model + m for d in range(cfg.data)]
                         for m in range(cfg.model)])
    return Mesh(cfg.data, cfg.model, rank, torch.device(device), backend,
                model_group, data_group)


# ---------------------------------------------------------------------------
# Dual-AR parameter specs
# ---------------------------------------------------------------------------

def is_quant_leaf(p) -> bool:
    """A quantized weight subtree: int8 {"q", "s"}, groupwise int4 {"q",
    "gs"} (the JAX checkpoint form) or packed int4 {"q4", "gs"}."""
    return isinstance(p, dict) and set(p) in ({"q", "s"}, {"q", "gs"},
                                              {"q4", "gs"})


def dual_ar_param_specs(params: dict) -> dict:
    """The spec tree of a Dual-AR parameter tree (models/init.py's
    layout), leaf for leaf the JAX package's: wqkv, w1 and w3 sharded by
    output rows and wo and w2 by input columns over `model` (Megatron);
    embeddings and norms replicated; `output`, `fast_output`,
    `codebook_output` and `fast_project_in` sharded by rows; the packed
    fast stack replicated (the fused sweep splits the batch instead)."""

    def stack_specs(layers: dict) -> dict:
        specs = {
            "attention": {
                "wqkv": (None, MODEL_AXIS, None),
                "wo": (None, None, MODEL_AXIS),
            },
            "feed_forward": {
                "w1": (None, MODEL_AXIS, None),
                "w2": (None, None, MODEL_AXIS),
                "w3": (None, MODEL_AXIS, None),
            },
            "attention_norm": (None, None),
            "ffn_norm": (None, None),
        }
        attn = layers["attention"]
        if "wqkv_b" in attn:
            specs["attention"]["wqkv_b"] = (None, MODEL_AXIS)
        if "wo_b" in attn:
            specs["attention"]["wo_b"] = (None, None)
        if "q_norm" in attn:
            specs["attention"]["q_norm"] = (None, None)
            specs["attention"]["k_norm"] = (None, None)
        return specs

    specs = {k: v for k, v in {
        "embeddings": (None, None),
        "codebook_embeddings": (None, None),
        "norm": (None,),
        "fast_embeddings": (None, None),
        "fast_norm": (None,),
        "fast_output": (MODEL_AXIS, None),
    }.items() if k in params}
    if "layers" in params:
        specs["layers"] = stack_specs(params["layers"])
    if "fast_layers" in params:
        specs["fast_layers"] = stack_specs(params["fast_layers"])
    if "fast_packed" in params:
        specs["fast_packed"] = {k: () for k in params["fast_packed"]}
    if "output" in params:
        specs["output"] = (MODEL_AXIS, None)
    if "fast_project_in" in params:
        specs["fast_project_in"] = {"w": (MODEL_AXIS, None),
                                    "b": (MODEL_AXIS,)}
    if "codebook_norm" in params:
        specs["codebook_norm"] = (None,)
    if "codebook_output" in params:
        specs["codebook_output"] = (MODEL_AXIS, None)
    return _expand_quant_specs(params, specs)


def _expand_quant_specs(params: dict, specs: dict) -> dict:
    """The spec of a quantized leaf's parts: "q" takes the weight's spec;
    "s" drops the input axis; "gs" keeps q's rank with the groups axis
    replicated; packed int4 ("q4") replicates its packed axis, because
    byte j holds values j and j + in/2, so a contiguous split of the bytes
    is not a contiguous split of the activations."""
    def expand(p, s):
        if isinstance(p, dict) and not is_quant_leaf(p):
            return {k: expand(p[k], s[k]) for k in p}
        if not is_quant_leaf(p):
            return s
        if "q4" in p:
            qs = (*s[:-1], None)
            return {"q4": qs, "gs": qs}
        if "s" in p:
            return {"q": s, "s": tuple(s[:-1])}
        return {"q": s, "gs": (*s[:-1], None)}

    return {k: expand(params[k], specs[k]) for k in params}


def _local(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of `x` under `spec`: the i-th of n contiguous
    chunks of every sharded axis (i the rank's index on that axis); a
    leaf with no sharded axis is returned as it is."""
    sliced = False
    for axis, name in enumerate(spec):
        if name is None:
            continue
        names = name if isinstance(name, tuple) else (name,)
        n, i = 1, 0
        for nm in names:              # row-major over the named axes
            size = mesh.shape[nm]
            idx = mesh.data_index if nm == DATA_AXIS else mesh.model_index
            n, i = n * size, i * size + idx
        if n == 1:
            continue
        if x.shape[axis] % n:
            raise ValueError(f"axis {axis} of {tuple(x.shape)} does not "
                             f"split into {n} shards")
        step = x.shape[axis] // n
        x = x.narrow(axis, i * step, step)
        sliced = True
    if not sliced:
        return x
    # a copy of its own, so the whole tensor can be freed, and a leaf
    # (a parameter that took a step is one with a gradient)
    with torch.no_grad():
        return x.clone(memory_format=torch.contiguous_format)


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def shard_dual_ar_params(params: dict, mesh: Mesh) -> dict:
    """This rank's slices of a whole parameter tree (`dual_ar_param_specs`
    on `mesh`): the m-th contiguous chunk of every model-sharded axis, the
    rest whole."""
    specs = dual_ar_param_specs(params)
    return _map(lambda x, s: _local(x, s, mesh), params, specs)


def unshard_dual_ar_params(local: dict, mesh: Mesh) -> dict:
    """The whole parameter tree from this rank's slices, the inverse of
    `shard_dual_ar_params`: every model-sharded axis gathered over the
    model group (bits move), the rest as it is, detached. A collective:
    every rank of the model group must call it; each gets the whole
    tree."""
    from .collectives import all_gather

    def whole(x, spec):
        x = x.detach()
        for axis, name in enumerate(spec):
            if name == MODEL_AXIS:
                x = all_gather(x, mesh.model_group, dim=axis)
            elif name is not None:
                raise ValueError(f"a parameter spec names {name!r}")
        return x

    return _map(whole, local, dual_ar_param_specs(local))


# ---------------------------------------------------------------------------
# KV caches and batches
# ---------------------------------------------------------------------------

def kv_cache_spec(layout: str = "head", int8: bool = False):
    """The spec of a models.dual_ar.KVCache: batch over `data`, KV heads
    over `model`. head-major k/v (L, B, Hkv, S, D), scales (L, B, Hkv, S);
    position-major k/v (L, S, B, Hkv, D). The position-major int8 scales
    (L, B, flat) split their flat axis over `model` as in JAX, where that
    axis is shard-blocked: block j holds shard j's heads' s-major flat
    (S * Hkv_local). A rank's block is its local flat (L, B_local,
    S*Hkv_local), which `shard_kv_cache` cuts out of the single-device
    flat (L, B, S*Hkv); the shard-blocked whole never exists here."""
    from ..models.dual_ar import KVCache

    if layout == "pos":
        kv = (None, None, DATA_AXIS, MODEL_AXIS, None)
        sc = (None, DATA_AXIS, MODEL_AXIS)
    else:
        kv = (None, DATA_AXIS, MODEL_AXIS, None, None)
        sc = (None, DATA_AXIS, MODEL_AXIS, None)
    if not int8:
        return KVCache(kv, kv, pos_major=layout == "pos")
    return KVCache(kv, kv, sc, sc, pos_major=layout == "pos")


def shard_kv_cache(cache, mesh: Mesh):
    """This rank's cache from a whole one (the single-device layout): its
    batch rows and KV heads. A position-major int8 cache's flat scales
    (L, B, S*Hkv) become the local flat (L, B_local, S*Hkv_local) over
    the rank's heads, the layout the stream kernel reads."""
    from ..models.dual_ar import KVCache

    spec = kv_cache_spec("pos" if cache.pos_major else "head",
                         int8=cache.ks is not None)
    k = _local(cache.k, spec.k, mesh)
    v = _local(cache.v, spec.v, mesh)
    if cache.ks is None:
        return KVCache(k, v, pos_major=cache.pos_major)
    if not cache.pos_major:
        return KVCache(k, v, _local(cache.ks, spec.ks, mesh),
                       _local(cache.vs, spec.vs, mesh))
    n_layer, b, flat = cache.ks.shape
    hkv = cache.k.shape[3]

    def flat_local(a):
        a = a.reshape(n_layer, b, flat // hkv, hkv)
        a = _local(a, (None, DATA_AXIS, None, MODEL_AXIS), mesh)
        return a.reshape(n_layer, a.shape[1], -1)

    return KVCache(k, v, flat_local(cache.ks), flat_local(cache.vs),
                   pos_major=True)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data rank's rows of a batch-leading tensor."""
    return _local(x, (DATA_AXIS,), mesh)


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch from the data ranks' rows, the inverse of
    `shard_batch` (a collective over the data group)."""
    from .collectives import all_gather

    return all_gather(x, mesh.data_group, dim=0)
