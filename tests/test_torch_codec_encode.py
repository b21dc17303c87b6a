"""The port's codec encode path (codec/model.py encoder and dac_encode,
codec/rvq.py rvq_encode) against the reference goldens and the JAX
package, and the codec init's draw order."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.codec import (
    convert_dac_state_dict,
    dac_encode as jax_dac_encode,
    init_dac_params as jax_init,
    tiny_codec_config,
)
from fish_speech_tpu.codec import model as jmodel
from fish_speech_tpu.codec import rvq as jrvq
from fish_speech_tpu_torch.codec import model as tmodel
from fish_speech_tpu_torch.codec import rvq as trvq
from fish_speech_tpu_torch.codec.config import tiny_codec_config as tiny_t
from fish_speech_tpu_torch.codec.init import (
    codec_params_from_jax,
    init_dac_params,
)

GOLDEN = Path(__file__).parent / "goldens" / "codec_tiny.npz"
CFG = tiny_t()


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def golden_params(golden):
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("sd:")}
    return convert_dac_state_dict(sd, tiny_codec_config())


def _port(jp):
    return codec_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def random_params():
    """JAX's seeded random codec (encoder included) and the same carried."""
    jp = jax_init(jax.random.key(7), tiny_codec_config())
    return jp, _port(jp)


def _wav(n, seed=0):
    return (np.random.default_rng(seed).standard_normal((2, n))
            * 0.1).astype(np.float32)


def test_dac_encode_matches_golden(golden, golden_params):
    """The reference's codes for the golden waveform: a match above 0.99
    (argmin near-ties can flip under another f32 sum order, JAX's own
    bound) and the same code lengths."""
    res = tmodel.dac_encode(_port(golden_params), CFG,
                            torch.from_numpy(golden["wav"]), device="cpu")
    codes = res.codes.numpy()
    assert codes.shape == tuple(golden["golden_codes"].shape)
    np.testing.assert_array_equal(res.code_lengths.numpy(),
                                  golden["golden_lens"])
    match = (codes == golden["golden_codes"]).mean()
    assert match > 0.99, match


@pytest.mark.parametrize("n", [3 * 512, 3 * 512 + 100])
def test_dac_encode_matches_jax(random_params, n):
    """JAX's dac_encode on the same random parameters and waveform, a whole
    number of frames and one that is right-padded: codes (match above
    0.99) and code lengths, with and without audio_lengths."""
    jp, tp = random_params
    wav = _wav(n, seed=n)
    lens = np.array([n, n - 700], np.int32)
    for al in (None, lens):
        want = jax_dac_encode(jp, tiny_codec_config(), jnp.asarray(wav),
                              None if al is None else jnp.asarray(al))
        got = tmodel.dac_encode(tp, CFG, torch.from_numpy(wav),
                                None if al is None else torch.from_numpy(al),
                                device="cpu")
        assert got.codes.shape == want.codes.shape
        np.testing.assert_array_equal(got.code_lengths.numpy(),
                                      np.asarray(want.code_lengths))
        match = (got.codes.numpy() == np.asarray(want.codes)).mean()
        assert match > 0.99, match


def test_encoder_latents_match_jax(random_params):
    """The encoder's latents (B, T / hop, latent_dim) against JAX's, f32
    in another sum order (atol 1e-4 at latents of magnitude ~1e-2..1)."""
    jp, tp = random_params
    wav = _wav(4 * 512, seed=3)[..., None]
    want = np.asarray(jmodel.encoder(jp["encoder"], tiny_codec_config(),
                                     jnp.asarray(wav)))
    got = tmodel.encoder(tp["encoder"], CFG, torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_rvq_encode_matches_jax(random_params):
    """rvq_encode on the same latents: the codes (match above 0.99) and
    the quantized latents z, decoded back and padded or cropped on the
    left to the input's length (atol 1e-4)."""
    jp, tp = random_params
    for t in (16, 14):        # a multiple of the downsample, and not
        z = (np.random.default_rng(t).standard_normal(
            (2, t, CFG.rvq.input_dim)) * 0.5).astype(np.float32)
        want = jrvq.rvq_encode(jp["quantizer"], tiny_codec_config().rvq,
                               jnp.asarray(z))
        got = trvq.rvq_encode(tp["quantizer"], CFG.rvq, torch.from_numpy(z))
        assert got.z.shape == want.z.shape == z.shape
        match = (got.codes.numpy() == np.asarray(want.codes)).mean()
        assert match > 0.99, match
        # z follows the codes: here every code agrees
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(want.codes))
        np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z),
                                   atol=1e-4, rtol=1e-3)


def test_vq_stage_distance_and_ties():
    """_normalized is x / max(|x|, eps) (a zero row stays zero), and
    equal distances pick the first entry, as jnp.argmin does."""
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    np.testing.assert_allclose(trvq._normalized(x).numpy(),
                               [[0.6, 0.8], [0.0, 0.0]])
    # codebook rows 1 and 2 are the same direction: the residual picks 1
    cb = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [0.0, 2.0]]])
    eye = torch.eye(2)[None]
    z = torch.tensor([[[0.0, 0.5], [2.0, 0.0]]])
    _, codes = trvq._vq_encode_stage(z, cb, eye, torch.zeros(1, 2), eye,
                                     torch.zeros(1, 2))
    assert codes.tolist() == [[[1, 0]]]


def test_dac_decode_latents_matches_jax(random_params):
    jp, tp = random_params
    z = (np.random.default_rng(1).standard_normal(
        (1, 8, CFG.resolved_latent_dim)) * 0.1).astype(np.float32)
    want = np.asarray(jmodel.dac_decode_latents(jp, tiny_codec_config(),
                                                jnp.asarray(z)))
    got = tmodel.dac_decode_latents(tp, CFG, torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def _decode_leaves(p):
    """The decode side's leaves, keys sorted: the quantizer's decode keys,
    then the decoder."""
    keys = ("post_module", "residual_codebooks", "residual_out_b",
            "residual_out_w", "semantic_codebooks", "semantic_out_b",
            "semantic_out_w", "upsample")
    out = []

    def visit(x):
        if isinstance(x, dict):
            for k in sorted(x):
                visit(x[k])
        elif isinstance(x, list):
            for v in x:
                visit(v)
        else:
            out.append(x)
    visit({"decoder": p["decoder"],
           "quantizer": {k: p["quantizer"][k] for k in keys}})
    return out


def test_init_draws_decode_params_as_before():
    """A seed gives the decode parameters it gave before the encoder was
    ported: the encoder and the quantizer's encode side are drawn after
    them. The fingerprint (leaf count, sum, sum of squares) is that of the
    port's codec init at commit b499b89 (tiny codec, seed 0, CPU)."""
    gen = torch.Generator().manual_seed(0)
    p = init_dac_params(gen, CFG, device="cpu")
    leaves = _decode_leaves(p)
    assert len(leaves) == 115
    assert float(sum(t.double().sum() for t in leaves)) == pytest.approx(
        1334.1614732514468, rel=1e-12)
    assert float(sum((t.double() ** 2).sum() for t in leaves)) == \
        pytest.approx(1997.7522823524644, rel=1e-12)
    # the encoder's tree as JAX's
    jp = jax_init(jax.random.key(0), tiny_codec_config())
    shapes = jax.tree.map(np.shape, jp)
    assert jax.tree.map(lambda t: tuple(t.shape), p) == shapes
    gen2 = torch.Generator().manual_seed(0)
    p2 = init_dac_params(gen2, CFG, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(p),
                                                 jax.tree.leaves(p2)))
