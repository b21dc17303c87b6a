"""The port's streaming vocoders (codec/streaming.py) against the port's
full decode and against the JAX package's streaming vocoders, on the tiny
codec with parameters drawn by JAX and carried over."""

import numpy as np
import pytest
import torch

import jax

from fish_speech_tpu.codec import init_dac_params, tiny_codec_config
from fish_speech_tpu.codec import streaming as jstream
from fish_speech_tpu_torch.codec import streaming as tstream
from fish_speech_tpu_torch.codec.config import tiny_codec_config as tiny_t
from fish_speech_tpu_torch.codec.init import codec_params_from_jax
from fish_speech_tpu_torch.codec.model import dac_from_indices

CFG = tiny_t()


def _codes(t, seed=0):
    rng = np.random.default_rng(seed)
    n_q = CFG.rvq.total_codebooks
    return np.concatenate(
        [rng.integers(0, CFG.rvq.semantic_codebook_size, size=(1, t)),
         rng.integers(0, CFG.rvq.codebook_size, size=(n_q - 1, t))],
        axis=0).astype(np.int32)


@pytest.fixture(scope="module", params=[0, 1])
def both(request):
    """(JAX parameters, the same as the port's tree on the CPU)."""
    jp = init_dac_params(jax.random.key(request.param), tiny_codec_config())
    return jp, codec_params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def _full(params, codes):
    return dac_from_indices(params, CFG, torch.from_numpy(
        codes.astype(np.int64))[None])[0].numpy()


# uneven pieces, one of them empty
PIECES = ((0, 5), (5, 23), (23, 23), (23, 50), (50, 61))


def test_stateful_matches_full_decode(both):
    """Fed in uneven pieces, the chunks concatenate to the full decode of
    the same codes (atol 1e-5, JAX's test); after reset() the vocoder
    serves a second stream."""
    _, params = both
    codes = _codes(61)
    sv = tstream.StatefulVocoder(params, CFG, chunk_frames=8, device="cpu")
    chunks = []
    for a, b in PIECES:
        chunks.extend(sv.feed(codes[:, a:b]))
    chunks.extend(sv.feed(final=True))
    streamed = np.concatenate(chunks)
    full = _full(params, codes)
    assert streamed.shape == full.shape
    np.testing.assert_allclose(streamed, full, atol=1e-5, rtol=1e-5)
    sv.reset()
    codes2 = _codes(16, seed=9)
    streamed2 = np.concatenate(list(sv.feed(codes2, final=True)))
    np.testing.assert_allclose(streamed2, _full(params, codes2), atol=1e-5,
                               rtol=1e-5)


def test_stateful_long_past_window(both):
    """120 frames, the attention window 16: the rolling KV cache evicts."""
    _, params = both
    codes = _codes(120, seed=2)
    sv = tstream.StatefulVocoder(params, CFG, chunk_frames=8, device="cpu")
    streamed = np.concatenate(list(sv.feed(codes, final=True)))
    full = _full(params, codes)
    assert streamed.shape == full.shape
    np.testing.assert_allclose(streamed, full, atol=1e-5, rtol=1e-5)


def test_stateful_matches_jax_chunk_for_chunk(both):
    """The same feeds through JAX's StatefulVocoder: the same number of
    chunks, each of the same length and within 1e-5 (f32 convs in another
    sum order)."""
    jp, params = both
    codes = _codes(61, seed=4)
    sv = tstream.StatefulVocoder(params, CFG, chunk_frames=8, device="cpu")
    jv = jstream.StatefulVocoder(jp, tiny_codec_config(), chunk_frames=8)
    got, want = [], []
    for a, b in PIECES:
        got.extend(sv.feed(codes[:, a:b]))
        want.extend(jv.feed(codes[:, a:b]))
    got.extend(sv.feed(final=True))
    want.extend(jv.feed(final=True))
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)


def test_streaming_vocoder_matches_jax(both):
    """The windowed fallback: through the prefix phase and well into the
    window phase (history 24, chunk 8), chunk for chunk against JAX's, and
    concatenated against the full decode."""
    jp, params = both
    codes = _codes(120, seed=5)
    sv = tstream.StreamingVocoder(params, CFG, chunk_frames=8,
                                  history_frames=24, device="cpu")
    jv = jstream.StreamingVocoder(jp, tiny_codec_config(), chunk_frames=8,
                                  history_frames=24)
    got, want = [], []
    for a, b in ((0, 5), (5, 23), (23, 90), (90, 120)):
        got.extend(sv.feed(codes[:, a:b]))
        want.extend(jv.feed(codes[:, a:b]))
    got.extend(sv.feed(final=True))
    want.extend(jv.feed(final=True))
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate(got), _full(params, codes),
                               atol=1e-5, rtol=1e-5)


def test_stateful_guards_as_jax(both):
    """A flush with final=True ends the stream: feed raises RuntimeError
    until reset(); a stream past max_frames raises ValueError. JAX's
    vocoder raises the same on the same feeds."""
    jp, params = both
    for make in (lambda: tstream.StatefulVocoder(
            params, CFG, chunk_frames=8, max_frames=32, device="cpu"),
                 lambda: jstream.StatefulVocoder(
            jp, tiny_codec_config(), chunk_frames=8, max_frames=32)):
        sv = make()
        tail = list(sv.feed(_codes(5), final=True))
        assert [len(t) for t in tail] == [5 * CFG.frame_length]
        with pytest.raises(RuntimeError):
            list(sv.feed(_codes(8)))
        sv.reset()
        assert len(list(sv.feed(_codes(24)))) == 3
        with pytest.raises(ValueError):
            list(sv.feed(_codes(16)))


def test_state_shapes_match_jax(both):
    """init_vocoder_state shapes every carried tensor as JAX's does (the
    depthwise ConvNeXt context at the stage's width), "pos" 0."""
    jp, params = both
    want = jstream.init_vocoder_state(jp, tiny_codec_config())
    got = tstream.init_vocoder_state(params, CFG)
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g = [x for x in jax.tree.leaves(got)]
    assert int(got["pos"]) == int(want["pos"]) == 0
    assert [tuple(np.shape(x)) for x in flat_g] == \
        [tuple(np.shape(x)) for x in flat_w]
    assert all(float(torch.as_tensor(x).abs().sum()) == 0 for x in flat_g)


def test_stream_step_takes_a_device_position(both):
    """vocoder_stream_step with "pos" as a 0-d tensor equals the host-int
    position, over two steps (the second at pos 8)."""
    _, params = both
    freqs = tstream.precompute_freqs_cis(64, CFG.rvq.pre_post_transformer
                                         .head_dim,
                                         CFG.rvq.pre_post_transformer
                                         .rope_base)
    codes = torch.from_numpy(_codes(16, seed=6).astype(np.int64))[None]
    st_i = tstream.init_vocoder_state(params, CFG)
    st_t = dict(st_i, pos=torch.tensor(0))
    outs = []
    for st in (st_i, st_t):
        w1, st = tstream.vocoder_stream_step(params, CFG, st,
                                             codes[..., :8], freqs)
        w2, st = tstream.vocoder_stream_step(params, CFG, st,
                                             codes[..., 8:], freqs)
        outs.append(torch.cat([w1, w2], dim=-1))
        assert int(st["pos"]) == 16
    assert torch.equal(outs[0], outs[1])
