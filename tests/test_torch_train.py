"""The port's training step (train/step.py, train/scheduler.py,
models/dual_ar.py::forward_train) against the JAX package's on the tiny
configs in f32: the loss and its metrics on a padded batch with ignored
labels, every gradient leaf against `jax.grad`, remat against none, two
optimizer steps against optax (with and without clipping),
`get_batch_logps`, both schedules and the decay mask."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.models.config import tiny_dual_ar_config
from fish_speech_tpu.models.init import init_dual_ar_params
from fish_speech_tpu.train import scheduler as jsched
from fish_speech_tpu.train import step as jstep
from fish_speech_tpu_torch.models.config import DualARConfig as TCfg
from fish_speech_tpu_torch.models.init import lm_params_from_jax
from fish_speech_tpu_torch.train import scheduler as tsched
from fish_speech_tpu_torch.train import step as tstep

# f32 on both sides; the sums run in other orders (XLA's fused reductions
# against torch's), so a loss or metric agrees to a few f32 ulps of its
# size, a gradient leaf to 1e-5 of the leaf's largest entry
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
LR = 1e-2


def jax_cfg(kind: str):
    cfg = tiny_dual_ar_config()
    if kind == "wide":
        # every optional leaf: untied output, q/k norms, biases, and the
        # S2-Pro switches
        cfg = dataclasses.replace(
            cfg, tie_word_embeddings=False, attention_qkv_bias=True,
            attention_o_bias=True, attention_qk_norm=True,
            scale_codebook_embeddings=True, norm_fastlayer_input=True)
    return cfg


def port_cfg(cfg):
    return TCfg(**dataclasses.asdict(cfg))


def np_params(cfg, seed: int = 0) -> dict:
    """JAX's init as numpy, the 1-D leaves (norms, biases) moved off their
    constant values so that their gradients matter."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, init_dual_ar_params(jax.random.key(seed),
                                                        cfg))

    def nudge(a):
        if a.ndim == 2 and a.shape[0] <= 2:  # stacked 1-D leaves
            return (a + rng.normal(0, 0.05, a.shape)).astype(a.dtype)
        if a.ndim == 1:
            return (a + rng.normal(0, 0.05, a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(nudge, tree)


def np_batch(cfg, b: int = 2, t: int = 16, seed: int = 0) -> dict:
    """Text then semantic tokens with their codes, an ignored prefix,
    ignored codes inside the semantic part, a padded tail on row 0."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, 1, t))
    tokens[:, 0, t // 2:] = rng.integers(cfg.semantic_begin_id,
                                         cfg.semantic_end_id + 1,
                                         size=(b, t - t // 2))
    codes = rng.integers(0, cfg.codebook_size, size=(b, cfg.num_codebooks, t))
    inputs = np.concatenate([tokens, codes], axis=1).astype(np.int32)
    labels = inputs.copy()
    labels[:, :, : t // 4] = -100
    labels[1, 2:, -3:] = -100
    labels[0, 1:, t - 5] = 0          # a codebook pad label
    masks = np.zeros((b, t), dtype=bool)
    masks[0, -3:] = True
    return {"inputs": inputs, "labels": labels, "attention_masks": masks}


def jax_batch(b):
    return jstep.TrainBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def port_batch(b):
    return tstep.TrainBatch.from_numpy(b, "cpu")


def port_tree(tree):
    return lm_params_from_jax(tree, device="cpu")


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree.detach() if isinstance(
            tree, torch.Tensor) else tree)


def assert_trees_close(got, want, rtol, what):
    got, want = dict(flat(got)), dict(flat(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=rtol * scale,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("kind", ["tiny", "wide"])
def test_loss_metrics_and_grads_match_jax(kind):
    cfg = jax_cfg(kind)
    tree = np_params(cfg)
    batch = np_batch(cfg)
    (_, jm), jg = jax.value_and_grad(jstep.dual_ar_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), cfg, jax_batch(batch), False)
    tm, tg = tstep.dual_ar_grads(port_tree(tree), port_cfg(cfg),
                                 port_batch(batch), remat=False)
    assert tm.keys() == jm.keys()
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert 0 < float(tm["top_5_accuracy"]) < 1
    assert_trees_close(tg, jax.tree.map(np.asarray, jg), GRAD_RTOL, "grad")


def test_remat_matches_no_remat():
    """Recomputing each layer in the backward pass changes no bit of the
    loss or the gradients."""
    cfg = jax_cfg("wide")
    tree = np_params(cfg)
    batch = port_batch(np_batch(cfg))
    m0, g0 = tstep.dual_ar_grads(port_tree(tree), port_cfg(cfg), batch,
                                 remat=False)
    m1, g1 = tstep.dual_ar_grads(port_tree(tree), port_cfg(cfg), batch,
                                 remat=True)
    for k in m0:
        assert float(m0[k]) == float(m1[k]), k
    for (path, a), (_, b) in zip(flat(g0), flat(g1)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("clip_norm", [1e4, 0.5])
def test_two_steps_match_optax(clip_norm):
    """Two `make_train_step` steps (warm-up of 1: the first at LR 0)
    against optax's chain; 0.5 clips both steps' gradients (their norms
    are ~2.8-3.0 here), 1e4 neither."""
    cfg = jax_cfg("tiny")
    tree = np_params(cfg)
    batches = [np_batch(cfg, seed=s) for s in (0, 1)]

    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jstep.make_optimizer(jparams, jsched.cosine_warmup_schedule(
        LR, 1, 10), clip_norm=clip_norm)
    jstate = jopt.init(jparams)
    jfn = jstep.make_train_step(cfg, jopt, remat=False)

    tparams = port_tree(tree)
    topt = tstep.make_optimizer(tparams, tsched.cosine_warmup_schedule(
        LR, 1, 10), clip_norm=clip_norm)
    tstate = topt.init(tparams)
    tfn = tstep.make_train_step(port_cfg(cfg), topt, remat=False)

    norms = []
    for i, b in enumerate(batches):
        jparams, jstate, jm = jfn(jparams, jstate, jax_batch(b))
        tparams, tstate, tm = tfn(tparams, tstate, port_batch(b))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, err_msg=f"{i} {k}")
        norms.append(float(tm["grad_norm"]))
        if i == 0:  # LR 0: nothing moved
            for (path, a), (_, b0) in zip(flat(tparams), flat(tree)):
                np.testing.assert_array_equal(a, b0, err_msg=str(path))
    assert tstate.sched.last_epoch == 2   # optax's count
    assert (min(norms) > clip_norm) == (clip_norm < 1)
    # an Adam step moves a weight by ~LR whatever the size of its
    # gradient, so a small gradient's relative error (other sum orders)
    # reaches the update whole, and more where the two steps' gradients
    # cancel in the first moment: the largest seen is 4.5e-5 of the LR
    got, want = dict(flat(tparams)), dict(flat(jax.tree.map(np.asarray,
                                                            jparams)))
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=2e-4 * LR,
                                   err_msg=str(path))


@pytest.mark.parametrize("average", [False, True])
def test_get_batch_logps_matches_jax(average):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 1, (2, 5, 3, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5, 3)).astype(np.int32)
    labels[0, 1, :] = -100
    labels[1, :, 2] = -100
    want = np.asarray(jstep.get_batch_logps(jnp.asarray(logits),
                                            jnp.asarray(labels), average))
    got = tstep.get_batch_logps(torch.from_numpy(logits),
                                torch.from_numpy(labels), average).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("cosine_warmup_schedule", (1e-3, 4, 20)),
    ("cosine_warmup_schedule", (3e-4, 0, 10, 1.5, 0.1)),
    ("constant_warmup_schedule", (1e-3, 5)),
])
def test_schedules_match_jax(name, args):
    """The port computes in float64, JAX in float32: 1e-6 relative, and an
    f32 ulp of the base rate where the cosine nears 0."""
    j = getattr(jsched, name)(*args)
    t = getattr(tsched, name)(*args)
    assert t(0) == 0.0 or args[1] == 0
    for s in range(25):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6,
                                   atol=1e-7 * args[0],
                                   err_msg=str(s))


def test_lambda_lr_reads_the_schedule_from_step_0():
    """LambdaLR over groups at lr 1.0 sets each step's rate to
    schedule(count), the count optax passes its schedule."""
    sched = tsched.cosine_warmup_schedule(1e-3, 2, 6)
    p = {"w": torch.zeros(2, 2)}
    state = tstep.Optimizer(sched).init(p)
    seen = []
    for _ in range(5):
        seen.append(state.opt.param_groups[0]["lr"])
        state.apply([torch.ones(2, 2)])
    assert seen == [sched(s) for s in range(5)]


@pytest.mark.parametrize("kind", ["tiny", "wide"])
def test_decay_mask_matches_jax(kind):
    cfg = jax_cfg(kind)
    tree = np_params(cfg)
    want = jstep._decay_mask(tree)
    got = tstep._decay_mask(port_tree(tree))
    assert dict(flat(got)) == dict(flat(want))
    assert any(v for _, v in flat(got)) and not all(v for _, v in flat(got))
