"""Port's stream decode attention (plain version) vs the JAX Pallas kernel
(interpret mode on the CPU), position-major int8 layout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fish_speech_tpu.ops.attention import pallas_decode_attention_stream
from fish_speech_tpu_torch.ops.attention import (
    KERNEL,
    decode_attention_stream,
    decode_attention_stream_plain,
)


def _inputs(seed=17):
    # shapes of tests/test_pallas_attention.py::test_stream_kernel_pos_major
    rng = np.random.default_rng(seed)
    L, b, hkv, g, d, s = 2, 4, 8, 4, 32, 128
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    lengths = np.asarray([100, 128, 37, 64], np.int32)
    starts = np.asarray([0, 30, 5, 0], np.int32)
    k8 = rng.integers(-127, 128, (L, s, b, hkv, d)).astype(np.int8)
    v8 = rng.integers(-127, 128, (L, s, b, hkv, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (L, b, s * hkv)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (L, b, s * hkv)).astype(np.float32)
    return q, k8, v8, ks, vs, lengths, starts


@pytest.mark.parametrize("int8_scores", [False, True])
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_matches_pallas_stream(int8_scores, layer):
    q, k8, v8, ks, vs, lengths, starts = _inputs()
    ref = pallas_decode_attention_stream(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8), jnp.asarray(v8),
        jnp.asarray(ks), jnp.asarray(vs), jnp.int32(layer),
        jnp.asarray(lengths), jnp.asarray(starts), rows=2, chunk=64,
        int8_scores=int8_scores, pos_major=True)
    t = torch.from_numpy
    got = decode_attention_stream_plain(
        t(q).to(torch.bfloat16), t(k8), t(v8), t(ks), t(vs), layer,
        t(lengths), t(starts), int8_scores=int8_scores)
    assert got.dtype == torch.bfloat16
    # both round p * v_scale to bf16 before the value product, but at
    # different running maxima (the kernel's online softmax over 64-row
    # chunks vs one exact softmax), and the output is bf16: outputs of
    # magnitude <= ~1.1 agree to 2 bf16 ulps (2^-7); measured 1 ulp
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=2 ** -7,
                               rtol=0)


def test_wrapper_takes_plain_path_on_cpu():
    q, k8, v8, ks, vs, lengths, starts = _inputs(3)
    t = torch.from_numpy
    before = KERNEL.launches
    a = decode_attention_stream(t(q).to(torch.bfloat16), t(k8), t(v8), t(ks),
                                t(vs), 1, t(lengths), t(starts))
    b = decode_attention_stream_plain(t(q).to(torch.bfloat16), t(k8), t(v8),
                                      t(ks), t(vs), 1, t(lengths), t(starts))
    assert torch.equal(a, b)
    assert KERNEL.launches == before   # a CPU call is not a kernel launch

