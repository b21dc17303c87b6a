"""The port's LoRA (train/lora.py) against the JAX package's on the tiny
configs in f32: zero-initialised factors leave the model as it was, the
targets are JAX's keys, `merge_lora` from the same factors, and two LoRA
steps with the training CLI's optimizer against JAX's
`make_lora_train_step` and optax."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.models.config import tiny_dual_ar_config
from fish_speech_tpu.models.init import init_dual_ar_params
from fish_speech_tpu.train import lora as jlora
from fish_speech_tpu.train import scheduler as jsched
from fish_speech_tpu.train import step as jstep
from fish_speech_tpu_torch.models.config import DualARConfig as TCfg
from fish_speech_tpu_torch.models.init import lm_params_from_jax
from fish_speech_tpu_torch.train import lora as tlora
from fish_speech_tpu_torch.train import scheduler as tsched
from fish_speech_tpu_torch.train import step as tstep

LR = 1e-2
LCFG = dict(r=4, lora_alpha=8.0)


def cfgs(kind):
    cfg = tiny_dual_ar_config()
    if kind == "untied":
        cfg = dataclasses.replace(cfg, tie_word_embeddings=False,
                                  attention_qkv_bias=True)
    return cfg, TCfg(**dataclasses.asdict(cfg))


def np_tree(cfg, seed=0):
    return jax.tree.map(np.asarray, init_dual_ar_params(jax.random.key(seed),
                                                        cfg))


def np_lora(cfg, tree, seed=1, b_std=0.0):
    """JAX's factors as numpy; b drawn too when b_std > 0 (a trained-like
    state, so that the merge does something)."""
    lora = jax.tree.map(np.asarray, jlora.init_lora_params(
        jax.random.key(seed), jax.tree.map(jnp.asarray, tree),
        jlora.LoraConfig(**LCFG)))
    rng = np.random.default_rng(seed)
    for v in lora.values():
        v["b"] = (b_std * rng.normal(size=v["b"].shape)).astype(np.float32)
    return lora


def batch(cfg, b=2, t=12, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, 1, t))
    tokens[:, 0, t // 2:] = rng.integers(cfg.semantic_begin_id,
                                         cfg.semantic_end_id + 1,
                                         size=(b, t - t // 2))
    codes = rng.integers(0, cfg.codebook_size, size=(b, cfg.num_codebooks, t))
    inputs = np.concatenate([tokens, codes], axis=1).astype(np.int32)
    labels = inputs.copy()
    labels[:, :, :2] = -100
    masks = np.zeros((b, t), bool)
    masks[1, -2:] = True
    return {"inputs": inputs, "labels": labels, "attention_masks": masks}


def as_np(tree):
    if isinstance(tree, dict):
        return {k: as_np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("kind", ["tiny", "untied"])
def test_targets_are_jax_keys(kind):
    cfg, _ = cfgs(kind)
    tree = np_tree(cfg)
    want = np_lora(cfg, tree)
    got = tlora.init_lora_params(torch.Generator().manual_seed(1),
                                 lm_params_from_jax(tree, device="cpu"),
                                 tlora.LoraConfig(**LCFG))
    assert list(got) == list(want)
    for k in want:
        for n in ("a", "b"):
            assert tuple(got[k][n].shape) == want[k][n].shape, (k, n)
        assert not got[k]["b"].any()
        assert 0.015 < float(got[k]["a"].std()) < 0.025, k
    assert "['layers']['attention']['wqkv']" in got
    assert ("['output']" in got) == (kind == "untied")


def test_zero_init_is_identity():
    cfg, _ = cfgs("tiny")
    params = lm_params_from_jax(np_tree(cfg), device="cpu")
    lcfg = tlora.LoraConfig(**LCFG)
    lora = tlora.init_lora_params(torch.Generator().manual_seed(1), params,
                                  lcfg)
    merged = tlora.merge_lora(params, lora, lcfg)
    for (pa, a), (pb, b) in zip(leaves(as_np(params)), leaves(as_np(merged))):
        assert pa == pb
        np.testing.assert_array_equal(a, b, str(pa))


@pytest.mark.parametrize("kind", ["tiny", "untied"])
def test_merge_matches_jax(kind):
    """From the same factors (b drawn): the merged weights agree to f32
    rounding (the rank-4 products sum in another order)."""
    cfg, _ = cfgs(kind)
    tree = np_tree(cfg)
    lora = np_lora(cfg, tree, b_std=0.05)
    want = jax.tree.map(np.asarray, jlora.merge_lora(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, lora),
        jlora.LoraConfig(**LCFG)))
    got = as_np(tlora.merge_lora(lm_params_from_jax(tree, device="cpu"),
                                 tlora.lora_params_from_jax(lora, "cpu"),
                                 tlora.LoraConfig(**LCFG)))
    moved = 0
    for (path, g), (_, w) in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7, err_msg=str(path))
        moved += not np.array_equal(w, dict(leaves(tree))[path])
    assert moved >= 5


def test_two_lora_steps_match_jax():
    """The CLI's optimizer (clip 1.0, AdamW b2 0.95, optax's default decay
    1e-4 on every factor) and a warm-up of 1 (LR 0, then LR): metrics,
    grad_norm and the factors after each step; the base is untouched."""
    cfg, tcfg = cfgs("untied")
    tree = np_tree(cfg)
    lora = np_lora(cfg, tree)
    lcfg_j, lcfg_t = jlora.LoraConfig(**LCFG), tlora.LoraConfig(**LCFG)

    schedule = jsched.cosine_warmup_schedule(LR, 1, 10)
    jopt = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(schedule, b1=0.9, b2=0.95))
    jl = jax.tree.map(jnp.asarray, lora)
    jstate = jopt.init(jl)
    jfn = jlora.make_lora_train_step(cfg, jax.tree.map(jnp.asarray, tree),
                                     lcfg_j, jopt, remat=False)

    base = lm_params_from_jax(tree, device="cpu")
    topt = tlora.make_lora_optimizer(tsched.cosine_warmup_schedule(LR, 1, 10))
    tl = tlora.lora_params_from_jax(lora, "cpu")
    tstate = topt.init(tl)
    tfn = tlora.make_lora_train_step(tcfg, base, lcfg_t, topt, remat=True)

    for i, seed in enumerate((0, 1)):
        b = batch(cfg, seed=seed)
        jl, jstate, jm = jfn(jl, jstate, jstep.TrainBatch(
            **{k: jnp.asarray(v) for k, v in b.items()}))
        tl, tstate, tm = tfn(tl, tstate, tstep.TrainBatch.from_numpy(b,
                                                                     "cpu"))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"{i} {k}")
        # Adam moves each factor entry by ~LR: 2e-4 of it covers the
        # gradients' f32 sum-order differences (test_torch_train.py)
        for (path, g), (_, w) in zip(leaves(as_np(tl)),
                                     leaves(jax.tree.map(np.asarray, jl))):
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * LR,
                                       err_msg=f"{i} {path}")
    assert any(v["b"].abs().sum() > 0 for v in tl.values())
    for (path, a), (_, w) in zip(leaves(as_np(base)), leaves(tree)):
        np.testing.assert_array_equal(a, w, str(path))
    assert not any(t.requires_grad for _, t in tstep.tree_leaves(base))
