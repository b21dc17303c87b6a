"""Tensor-parallel dispatch of the serving kernels.

Counterpart of `fish_speech_tpu/parallel/tp.py`. The JAX package wraps
each Pallas kernel in `jax.shard_map` so that every device runs it on its
own shard; here every rank already holds only its shard, so a wrapper
checks the decode mesh and calls the port's kernel wrapper on the rank's
local tensors. This module holds

- the process-wide decode mesh registry (`decode_mesh`): a decode step
  run under it with `cfg.tp_shards > 1` takes the tensor-parallel
  branches of models/dual_ar.py and models/decode.py;
- `stream_attention_tp` (#1) and `blocks_attention_tp` (#6): decode
  attention over the rank's Hkv / tp heads and its batch rows. Attention
  is head-local under GQA, so neither needs a collective;
- `fused_fast_sweep_tp` (#2): the fused fast-head sweep on this rank's
  rows of the batch, the packed weights whole on every rank, the rows
  gathered back over the model group afterwards. With the data split
  before it, the batch is split over the whole world.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from .collectives import all_gather
from .mesh import Mesh

_DECODE_MESH: list[Mesh | None] = [None]


def set_decode_mesh(mesh: Mesh | None) -> None:
    _DECODE_MESH[0] = mesh


def get_decode_mesh() -> Mesh | None:
    return _DECODE_MESH[0]


@contextmanager
def decode_mesh(mesh: Mesh | None):
    """Run decode under this mesh: generate, decode_one_token,
    new_fast_cache and ContinuousBatcher read it (cfg.tp_shards must equal
    mesh.model, checked where it is read)."""
    prev = _DECODE_MESH[0]
    _DECODE_MESH[0] = mesh
    try:
        yield mesh
    finally:
        _DECODE_MESH[0] = prev


def _mesh_or_die(tp_shards: int) -> Mesh:
    mesh = get_decode_mesh()
    if mesh is None:
        raise RuntimeError(
            f"cfg.tp_shards={tp_shards} > 1 but no decode mesh is set: run "
            "decode under parallel.tp.decode_mesh(mesh)")
    if mesh.model != tp_shards:
        raise ValueError(f"cfg.tp_shards={tp_shards} != mesh model axis "
                         f"{mesh.model}")
    return mesh


def tp_mesh(tp_shards: int) -> Mesh | None:
    """The decode mesh of a tensor-parallel step: None at tp_shards == 1,
    else the registered mesh (raises if none is set or its model axis
    differs)."""
    return None if tp_shards == 1 else _mesh_or_die(tp_shards)


def active_mesh(tp_shards: int) -> Mesh | None:
    """The decode mesh a step with this cfg.tp_shards runs under: the
    registered one (its model axis checked), which tp_shards > 1 needs;
    None when no mesh is set and tp_shards == 1."""
    if tp_shards > 1 or get_decode_mesh() is not None:
        return _mesh_or_die(tp_shards)
    return None


def stream_attention_tp(q, k_full, v_full, ks_full, vs_full, layer: int,
                        lengths, starts, *, int8_scores: bool,
                        pos_major: bool, tp_shards: int) -> torch.Tensor:
    """`ops.attention.decode_attention_stream` (#1) on the rank's shard:
    q (B_local, Hkv/tp, G, D), the cache at its local heads and rows, and
    (position-major int8) its local flat scales (L, B_local,
    S*Hkv/tp)."""
    from ..ops.attention import decode_attention_stream

    _mesh_or_die(tp_shards)
    return decode_attention_stream(q, k_full, v_full, ks_full, vs_full,
                                   layer, lengths, starts, int8_scores,
                                   pos_major=pos_major)


def blocks_attention_tp(q, k_full, v_full, ks_full, vs_full, layer: int,
                        lengths, starts, *, rows: int, chunk: int,
                        int8_scores: bool, tp_shards: int) -> torch.Tensor:
    """`ops.attention.decode_attention_blocks` (#6), head-major, on the
    rank's shard, as `stream_attention_tp`."""
    from ..ops.attention import decode_attention_blocks

    _mesh_or_die(tp_shards)
    return decode_attention_blocks(q, k_full, v_full, ks_full, vs_full,
                                   layer, lengths, starts, rows=rows,
                                   chunk=chunk, int8_scores=int8_scores)


def fused_fast_sweep_tp(packed: dict, x: torch.Tensor, cache, freqs_table,
                        *, pos: int, n_head: int, eps: float,
                        tp_shards: int) -> torch.Tensor:
    """`ops.fast_fused.fused_fast_sweep` (#2) on this rank's rows.

    x: (B_pad, dim), the data rank's batch padded to a multiple of the
    model-group size, the same on every rank of the group; `cache`: the
    rank's FusedFastCache of B_pad / tp rows. The rank sweeps its
    contiguous block of rows and the blocks are gathered back in rank
    order: (B_pad, dim) bf16, the same on every rank."""
    from ..ops.fast_fused import fused_fast_sweep

    mesh = _mesh_or_die(tp_shards)
    rows = cache.k.shape[2]
    if x.shape[0] != rows * mesh.model:
        raise ValueError(f"x has {x.shape[0]} rows; the sweep splits "
                         f"{rows} x {mesh.model}")
    mine = x[mesh.model_index * rows:(mesh.model_index + 1) * rows]
    out = fused_fast_sweep(packed, mine, cache, freqs_table, pos=pos,
                           n_head=n_head, eps=eps)
    return all_gather(out, mesh.model_group, dim=0)
