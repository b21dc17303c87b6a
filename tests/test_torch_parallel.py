"""The port's parallel slice in one process, against the JAX package's:
the spec trees of parallel/mesh.py leaf for leaf, each rank's slices of
the weights and of the KV cache against the shards that JAX places on
the 8 virtual CPU devices of a (data 2, model 4) mesh, and the multihost
plan's bytes round trip and single-process apply (serve/multihost.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from fish_speech_tpu.models.config import tiny_dual_ar_config as j_tiny
from fish_speech_tpu.models.dual_ar import KVCache as JKVCache
from fish_speech_tpu.models.init import init_dual_ar_params as j_init
from fish_speech_tpu.ops.fast_fused import enable_fused_fast_head as j_fused
from fish_speech_tpu.ops.quant import quantize_lm_params as j_quantize
from fish_speech_tpu.parallel import mesh as jmesh
from fish_speech_tpu_torch.engine.scheduler import (ContinuousBatcher,
                                                    SlotRequest)
from fish_speech_tpu_torch.models.config import tiny_dual_ar_config
from fish_speech_tpu_torch.models.dual_ar import KVCache
from fish_speech_tpu_torch.models.init import (init_dual_ar_params,
                                               lm_params_from_jax)
from fish_speech_tpu_torch.ops.sampling import semantic_logit_bias
from fish_speech_tpu_torch.parallel.mesh import (
    MeshConfig,
    dual_ar_param_specs,
    kv_cache_spec,
    mesh_coords,
    shard_batch,
    shard_dual_ar_params,
    shard_kv_cache,
)
from fish_speech_tpu_torch.serve.multihost import (SlotAssignment, TickPlan,
                                                   apply_plan, broadcast_plan)

DATA, MODEL = 2, 4
IM_END = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_tree(form: str):
    """The tiny config's JAX parameter tree in `form`."""
    cfg = j_tiny()
    if form == "fused":             # the fused sweep's "3x" fast stack
        cfg = dataclasses.replace(cfg, fast_intermediate_size=96)
    if form == "naive_untied":
        cfg = dataclasses.replace(cfg, model_type="naive",
                                  tie_word_embeddings=False)
    params = j_init(jax.random.key(0), cfg)
    if form in ("int8", "fused"):
        params = j_quantize(params)
    elif form in ("int4", "w4a8"):
        params = j_quantize(params, mode=form, groupsize=16)
    if form == "fused":
        params = j_fused(params)
    return params


def _spec_tuples(specs):
    return jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(x, P))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("form", ["plain", "int8", "int4", "w4a8", "fused",
                                  "naive_untied"])
def test_param_specs_match_jax(form):
    """dual_ar_param_specs == the JAX function's, leaf for leaf, with a
    PartitionSpec as a tuple (quantized leaves' q / s / gs / q4 rules
    included; tests/test_mesh.py's quantized-spec counterpart)."""
    params = _jax_tree(form)
    want = _spec_tuples(jmesh.dual_ar_param_specs(params))
    # the spec rules read only the tree's keys: the int4 form's {"q",
    # "gs"} leaves are held as they are, not packed
    assert dual_ar_param_specs(_np(params)) == want
    if form != "int4":
        port = lm_params_from_jax(_np(params), device="cpu")
        assert dual_ar_param_specs(port) == want


def _device_shard(arr, r: int) -> np.ndarray:
    dev = jax.devices()[r]
    (shard,) = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


def _as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("form", ["plain", "int8", "w4a8", "fused"])
def test_rank_slices_match_jax_shards(form):
    """On JAX's (data 2, model 4) mesh of the 8 virtual CPU devices, rank
    r's `shard_dual_ar_params` slice of every leaf == the data of JAX
    device r's addressable shard, for every rank."""
    params = _jax_tree(form)
    jmesh_ = jmesh.create_mesh(jmesh.MeshConfig(data=DATA, model=MODEL))
    sharded = jmesh.shard_dual_ar_params(params, jmesh_)
    port = lm_params_from_jax(_np(params), device="cpu")
    want = dict(_leaves(sharded))
    for r in range(DATA * MODEL):
        local = shard_dual_ar_params(port, mesh_coords(
            MeshConfig(DATA, MODEL), r))
        for path, t in _leaves(local):
            j = _device_shard(want[path], r)
            if path[0] == "fast_packed":    # the port drops the pad tile
                j = j[:, :13] if path[1] == "w" else (
                    j[:, :13, 0] if path[1] == "s" else j)
            assert tuple(t.shape) == j.shape, (r, path)
            np.testing.assert_array_equal(_as_np(t), j.astype(np.float32)
                                          if j.dtype.name == "bfloat16"
                                          else j, str((r, path)))


def _kv_arrays(pos_major: bool, rng):
    """A filled int8 cache at (L, B, Hkv, S, D) = (2, 2, 8, 16, 8): the
    port's single-device layout (numpy)."""
    n_layer, b, hkv, s, d = 2, DATA, 8, 16, 8
    shape = (n_layer, s, b, hkv, d) if pos_major else (n_layer, b, hkv, s, d)
    k = rng.integers(-127, 128, shape).astype(np.int8)
    v = rng.integers(-127, 128, shape).astype(np.int8)
    sshape = (n_layer, b, s * hkv) if pos_major else (n_layer, b, hkv, s)
    ks = rng.random(sshape, dtype=np.float32)
    vs = rng.random(sshape, dtype=np.float32)
    return k, v, ks, vs, hkv


def _shard_blocked(flat: np.ndarray, hkv: int, tp: int) -> np.ndarray:
    """The JAX TP layout of position-major flat scales (L, B, S*Hkv):
    block j holds shard j's heads' s-major flat."""
    n_layer, b, n = flat.shape
    s = n // hkv
    return (flat.reshape(n_layer, b, s, tp, hkv // tp)
            .transpose(0, 1, 3, 2, 4).reshape(n_layer, b, n))


@pytest.mark.parametrize("layout", ["head", "pos"])
def test_kv_cache_slices_match_jax_shards(layout):
    """shard_kv_cache on an int8 cache == JAX's shard_kv_cache shards on
    the (2, 4) mesh for every rank: the batch rows over `data` and the KV
    heads over `model`; position-major flat scales go to JAX in its
    shard-blocked layout, whose model-axis block j is the port's local
    flat."""
    pos = layout == "pos"
    k, v, ks, vs, hkv = _kv_arrays(pos, np.random.default_rng(5))
    jks, jvs = ((_shard_blocked(ks, hkv, MODEL), _shard_blocked(vs, hkv,
                                                               MODEL))
                if pos else (ks, vs))
    jmesh_ = jmesh.create_mesh(jmesh.MeshConfig(data=DATA, model=MODEL))
    jc = jmesh.shard_kv_cache(JKVCache(*(jnp.asarray(a) for a in
                                         (k, v, jks, jvs))), jmesh_)
    port = KVCache(*(torch.from_numpy(a) for a in (k, v, ks, vs)),
                   pos_major=pos)
    spec, jspec = (kv_cache_spec(layout, int8=True),
                   jmesh.kv_cache_spec(layout, int8=True))
    assert [getattr(spec, n) for n in ("k", "v", "ks", "vs")] == [
        tuple(getattr(jspec, n)) for n in ("k", "v", "ks", "vs")]
    for r in range(DATA * MODEL):
        local = shard_kv_cache(port, mesh_coords(MeshConfig(DATA, MODEL), r))
        for name in ("k", "v", "ks", "vs"):
            np.testing.assert_array_equal(
                getattr(local, name).numpy(),
                _device_shard(getattr(jc, name), r), f"rank {r} {name}")
        assert local.pos_major == pos


def test_shard_batch_rows():
    x = torch.arange(12).reshape(4, 3)
    for r in range(DATA * MODEL):
        d = r // MODEL
        np.testing.assert_array_equal(
            shard_batch(x, mesh_coords(MeshConfig(DATA, MODEL), r)).numpy(),
            x[2 * d:2 * d + 2].numpy())


def _prompt(cfg, t: int, rng) -> np.ndarray:
    p = rng.integers(0, 100, size=(cfg.num_codebooks + 1, t)).astype(np.int32)
    p[1:] = rng.integers(0, cfg.codebook_size, size=(cfg.num_codebooks, t))
    return p


def test_plan_roundtrip_and_apply():
    """A TickPlan survives its bytes; with one process the broadcast hands
    the plan back and apply_plan drives the batcher: the assigned request
    emits its prefill column and four ticks, the first five columns of the
    same request run alone (tests/test_scheduler.py's counterpart)."""
    cfg = tiny_dual_ar_config()
    params = init_dual_ar_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    bias = semantic_logit_bias(cfg.vocab_size, cfg.semantic_begin_id,
                               cfg.semantic_end_id, IM_END)
    prompt = _prompt(cfg, 8, np.random.default_rng(9))

    def batcher():
        return ContinuousBatcher(params, cfg, num_slots=2, cache_len=128,
                                 im_end_id=IM_END, bias=bias, greedy=True,
                                 prompt_bucket=32, device="cpu")

    plan = TickPlan(assignments=[SlotAssignment(
        slot=0, request_id=1, prompt=prompt, max_new_tokens=16,
        temperature=0.7, top_p=0.7)], n_ticks=4, cancels=[1])
    restored = TickPlan.from_bytes(plan.to_bytes())
    assert (restored.n_ticks, restored.cancels, restored.shutdown) == (
        4, [1], False)
    np.testing.assert_array_equal(restored.assignments[0].prompt, prompt)
    assert broadcast_plan(plan) is plan         # one process: no-op
    assert broadcast_plan(None) == TickPlan()

    b = batcher()
    registry: dict = {}
    apply_plan(b, restored, registry)
    req = registry[1]
    assert b.slot_req[0] is req and len(req.result) == 5
    alone = batcher().run([SlotRequest(request_id=1, prompt=prompt,
                                       max_new_tokens=16)])[1]
    np.testing.assert_array_equal(np.stack(req.result, axis=1),
                                  alone[:, :5])
