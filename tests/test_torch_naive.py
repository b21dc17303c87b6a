"""The naive (parallel) codebook head on the port against the JAX package:
its init and conversion, `forward_train` against the `lm_naive.npz`
golden and against JAX, its loss and gradients, and greedy `generate`
code for code."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.models import decode as jdec
from fish_speech_tpu.models import dual_ar as jdual
from fish_speech_tpu.models.config import tiny_dual_ar_config
from fish_speech_tpu.models.init import (
    convert_dual_ar_state_dict,
    init_dual_ar_params,
)
from fish_speech_tpu.ops.sampling import semantic_logit_bias as jbias
from fish_speech_tpu.train import step as jstep
from fish_speech_tpu_torch.models import decode as tdec
from fish_speech_tpu_torch.models import dual_ar as tdual
from fish_speech_tpu_torch.models import init as tinit
from fish_speech_tpu_torch.models.config import DualARConfig as TCfg
from fish_speech_tpu_torch.ops.sampling import semantic_logit_bias as tbias
from fish_speech_tpu_torch.train import step as tstep

from ref_harness import random_lm_prompt

GOLDEN = Path(__file__).parent / "goldens" / "lm_naive.npz"
IM_END_ID = 4


def cfgs(**kw):
    cfg = dataclasses.replace(tiny_dual_ar_config(), model_type="naive", **kw)
    return cfg, TCfg(**dataclasses.asdict(cfg))


def np_tree(cfg):
    return jax.tree.map(np.asarray, init_dual_ar_params(jax.random.key(0),
                                                        cfg))


def shapes(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from shapes(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape)


def test_init_and_convert_match_jax():
    cfg, tcfg = cfgs()
    want = np_tree(cfg)
    drawn = tinit.init_dual_ar_params(torch.Generator().manual_seed(0), tcfg,
                                      device="cpu")
    assert list(shapes(drawn)) == list(shapes(want))
    assert "codebook_output" in drawn and "fast_layers" not in drawn
    golden = np.load(GOLDEN)
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("sd:")}
    got = tinit.convert_dual_ar_state_dict(sd, tcfg, device="cpu")
    ref = jax.tree.map(np.asarray, convert_dual_ar_state_dict(sd, cfg))
    carried = tinit.lm_params_from_jax(ref, device="cpu")
    for (path, a), (_, b) in zip(tstep.tree_leaves(got),
                                 tstep.tree_leaves(carried)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), str(path))


def test_forward_matches_golden():
    """JAX's own tolerance for this golden (tests/test_naive_model.py)."""
    golden = np.load(GOLDEN)
    _, tcfg = cfgs()
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("sd:")}
    params = tinit.convert_dual_ar_state_dict(sd, tcfg, device="cpu")
    with torch.no_grad():
        out = tdual.forward_train(params, tcfg,
                                  torch.from_numpy(golden["prompt"]),
                                  remat=False)
    np.testing.assert_allclose(out.token_logits.numpy(),
                               golden["golden_token_logits"], atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(out.codebook_logits.numpy(),
                               golden["golden_codebook_logits"], atol=2e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("fast_input", [False, True])
def test_forward_loss_and_grads_match_jax(fast_input):
    """A padded batch with ignored labels: the logits, the loss and its
    metrics, and every gradient leaf (f32; 1e-5 of each leaf's largest
    entry, as tests/test_torch_train.py)."""
    cfg, tcfg = cfgs(norm_fastlayer_input=fast_input,
                     tie_word_embeddings=not fast_input)
    tree = np_tree(cfg)
    rng = np.random.default_rng(1)
    inputs = np.stack([random_lm_prompt(cfg, 14, rng) for _ in range(2)])
    labels = inputs.copy()
    labels[:, :, :3] = -100
    masks = np.zeros((2, 14), bool)
    masks[1, -4:] = True
    b = {"inputs": inputs, "labels": labels, "attention_masks": masks}

    jparams = jax.tree.map(jnp.asarray, tree)
    jout = jdual.forward_train(jparams, cfg, jnp.asarray(inputs),
                               key_padding_mask=jnp.asarray(masks),
                               remat=False)
    params = tinit.lm_params_from_jax(tree, device="cpu")
    with torch.no_grad():
        tout = tdual.forward_train(params, tcfg, torch.from_numpy(inputs),
                                   key_padding_mask=torch.from_numpy(masks))
    for name in ("token_logits", "codebook_logits"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)

    (_, jm), jg = jax.value_and_grad(jstep.dual_ar_loss, has_aux=True)(
        jparams, cfg, jstep.TrainBatch(**{k: jnp.asarray(v)
                                          for k, v in b.items()}), False)
    tm, tg = tstep.dual_ar_grads(params, tcfg,
                                 tstep.TrainBatch.from_numpy(b, "cpu"))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    jg = dict(tstep.tree_leaves(jax.tree.map(np.asarray, jg)))
    for path, g in tstep.tree_leaves(tg):
        scale = max(float(np.abs(jg[path]).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), jg[path], rtol=0,
                                   atol=1e-5 * scale, err_msg=str(path))


def test_greedy_generate_matches_jax():
    """Two left-padded prompts, greedy: the port's codes and lengths equal
    JAX's, the K codes of a frame all from one naive-head call."""
    cfg, tcfg = cfgs()
    tree = np_tree(cfg)
    rng = np.random.default_rng(2)
    prompts = [random_lm_prompt(cfg, n, rng) for n in (10, 7)]
    t = max(p.shape[1] for p in prompts)
    batch = np.zeros((2, cfg.num_codebooks + 1, t), np.int32)
    starts = np.array([t - p.shape[1] for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        batch[i, :, starts[i]:] = p

    want, wlen = jdec.generate(
        jax.tree.map(jnp.asarray, tree), cfg, jnp.asarray(batch),
        jnp.asarray(starts), jax.random.key(0), jdec.SamplingConfig.create(),
        jbias(cfg.vocab_size, cfg.semantic_begin_id, cfg.semantic_end_id,
              IM_END_ID), max_new_tokens=12, im_end_id=IM_END_ID,
        greedy=True, cache_len=64)
    got, glen = tdec.generate(
        tinit.lm_params_from_jax(tree, device="cpu"), tcfg,
        torch.from_numpy(batch), torch.from_numpy(starts), None,
        tdec.SamplingConfig.create(),
        tbias(cfg.vocab_size, cfg.semantic_begin_id, cfg.semantic_end_id,
              IM_END_ID), max_new_tokens=12, im_end_id=IM_END_ID,
        greedy=True, cache_len=64, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))


def test_sampled_generate_per_row_parameters():
    """Sampling with per-row temperature, top-p and top-k: each row's
    parameters cover its K codebook rows; codes stay in range."""
    _, tcfg = cfgs()
    params = tinit.init_dual_ar_params(torch.Generator().manual_seed(0),
                                       tcfg, device="cpu")
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(np.stack([random_lm_prompt(tcfg, 8, rng)
                                        for _ in range(2)]))
    sampling = tdec.SamplingConfig(torch.tensor([0.7, 1.2]),
                                   torch.tensor([0.8, 0.95]),
                                   torch.tensor([5, 30], dtype=torch.int32))
    codes, _ = tdec.generate(
        params, tcfg, prompt, torch.zeros(2, dtype=torch.int32),
        torch.Generator().manual_seed(0), sampling,
        tbias(tcfg.vocab_size, tcfg.semantic_begin_id, tcfg.semantic_end_id,
              IM_END_ID), max_new_tokens=6, im_end_id=IM_END_ID,
        cache_len=32, device="cpu")
    assert codes.shape == (2, tcfg.num_codebooks + 1, 6)
    assert ((codes[:, 1:] >= 0) & (codes[:, 1:] < tcfg.codebook_size)).all()
