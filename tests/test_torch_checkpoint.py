"""The port's checkpoint loading against the JAX package's: the reference
disk layouts (sharded fish_qwen3_omni safetensors with its index, one
safetensors file, model.pth), the port's own safetensors reader and writer
against the `safetensors` package, the codec conversion with weight-norm
folding, and the native save_params / load_params format (the port's own
trees, and JAX's int8, w4a8 and int4 checkpoints)."""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).parent))

from test_checkpoint_ingestion import (  # noqa: E402 - the JAX test's data
    _qwen3ish_config,
    _reference_state_dict,
    _to_qwen3_omni_names,
)

from fish_speech_tpu.codec import convert_dac_state_dict as j_convert_dac  # noqa: E402
from fish_speech_tpu.codec import tiny_codec_config  # noqa: E402
from fish_speech_tpu.models.config import tiny_dual_ar_config  # noqa: E402
from fish_speech_tpu.models.dual_ar import forward_train  # noqa: E402
from fish_speech_tpu.models.init import (  # noqa: E402
    convert_dual_ar_state_dict as j_convert_lm,
    init_dual_ar_params as j_init,
)
from fish_speech_tpu.ops.quant import quantize_lm_params as j_quantize  # noqa: E402
from fish_speech_tpu.utils.checkpoint import save_params as j_save  # noqa: E402
from fish_speech_tpu_torch.codec import config as tcodec_cfg  # noqa: E402
from fish_speech_tpu_torch.codec.convert import convert_dac_state_dict  # noqa: E402
from fish_speech_tpu_torch.codec.init import codec_params_from_jax  # noqa: E402
from fish_speech_tpu_torch.codec.model import dac_from_indices  # noqa: E402
from fish_speech_tpu_torch.models import dual_ar as tdual  # noqa: E402
from fish_speech_tpu_torch.models.config import DualARConfig as TCfg  # noqa: E402
from fish_speech_tpu_torch.models.init import (  # noqa: E402
    convert_dual_ar_state_dict,
    init_dual_ar_params,
    lm_params_from_jax,
)
from fish_speech_tpu_torch.ops.quant import quantize_lm_params  # noqa: E402
from fish_speech_tpu_torch.utils import safetensors as tst  # noqa: E402
from fish_speech_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_params,
    load_torch_codec_checkpoint,
    load_torch_lm_checkpoint,
    save_params,
)

GOLDEN = Path(__file__).parent / "goldens" / "codec_tiny.npz"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _assert_trees_equal(got: dict, want: dict, atol: float = 0.0):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for path, a in w.items():
        b = g[path]
        if a is None:
            assert b is None, path
            continue
        assert tuple(b.shape) == tuple(a.shape), path
        assert b.dtype == a.dtype, (path, b.dtype, a.dtype)
        if atol:
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=atol, err_msg=str(path))
        else:
            assert torch.equal(b, a), path


# --- the reference LM layouts ------------------------------------------------


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """The JAX test's three disk layouts of one reference state dict,
    written with the `safetensors` package and torch.save."""
    from safetensors.numpy import save_file

    tmp = tmp_path_factory.mktemp("layouts")
    cfg = _qwen3ish_config()
    sd = _reference_state_dict(cfg, np.random.default_rng(0))
    d1 = tmp / "single"
    d1.mkdir()
    save_file(sd, str(d1 / "model.safetensors"))
    d2 = tmp / "sharded"
    d2.mkdir()
    qsd = _to_qwen3_omni_names(sd)
    keys = sorted(qsd)
    half = len(keys) // 2
    weight_map = {}
    for fname, ks in (("model-00001-of-00002.safetensors", keys[:half]),
                      ("model-00002-of-00002.safetensors", keys[half:])):
        save_file({k: qsd[k] for k in ks}, str(d2 / fname))
        weight_map.update({k: fname for k in ks})
    (d2 / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": weight_map}))
    d3 = tmp / "pth"
    d3.mkdir()
    tsd = {"model." + k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    tsd["model.audio_projector.weight"] = torch.zeros(3, 3)  # dropped
    torch.save(tsd, d3 / "model.pth")
    return cfg, sd, {"single": d1, "sharded": d2, "pth": d3}


@pytest.mark.parametrize("layout", ["single", "sharded", "pth"])
def test_lm_layouts_load_as_jax(layouts, layout):
    """Each layout through the port's loader and converter: every leaf
    equal to JAX's conversion of the same state dict, carried; the same
    teacher-forced logits as JAX's forward."""
    cfg, sd, dirs = layouts
    loaded = load_torch_lm_checkpoint(dirs[layout])
    assert "audio_projector.weight" not in loaded
    assert set(loaded) == set(sd)
    tcfg = TCfg(**dataclasses.asdict(cfg))
    port = convert_dual_ar_state_dict(loaded, tcfg, device="cpu")
    jparams = j_convert_lm(sd, cfg)
    _assert_trees_equal(port, lm_params_from_jax(_np(jparams), device="cpu"))

    rng = np.random.default_rng(1)
    inp = np.concatenate([
        rng.integers(0, cfg.vocab_size, (1, 1, 6)),
        rng.integers(0, cfg.codebook_size, (1, cfg.num_codebooks, 6)),
    ], axis=1).astype(np.int32)
    want = np.asarray(forward_train(jparams, cfg, jnp.asarray(inp),
                                    remat=False).token_logits, np.float32)
    cache = tdual.KVCache.create(tcfg.n_layer, 1, tcfg.max_seq_len,
                                 tcfg.n_local_heads, tcfg.head_dim,
                                 dtype=torch.float32)
    table = tdual.precompute_freqs_cis(tcfg.max_seq_len, tcfg.head_dim,
                                       tcfg.rope_base)
    got = tdual.forward_generate(port, tcfg, torch.from_numpy(inp), cache, 0,
                                 table, last_only=False).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lm_convert_bf16_on_the_way_in(layouts):
    """dtype=bf16 (the server's load) rounds as JAX's conversion does."""
    cfg, sd, dirs = layouts
    port = convert_dual_ar_state_dict(
        load_torch_lm_checkpoint(dirs["sharded"]),
        TCfg(**dataclasses.asdict(cfg)), dtype=torch.bfloat16, device="cpu")
    want = lm_params_from_jax(_np(j_convert_lm(sd, cfg, dtype=jnp.bfloat16)),
                              device="cpu")
    _assert_trees_equal(port, want)


# --- the safetensors reader and writer ----------------------------------------


def test_safetensors_bf16_shard_reads_bit_equal(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    ref = {"w": torch.randn(5, 7, generator=g).to(torch.bfloat16),
           "b": torch.randn(9, generator=g).to(torch.bfloat16),
           "n": torch.randn(3, 2, generator=g),
           "i": torch.arange(-4, 4, dtype=torch.int8),
           "e": torch.zeros(0, 4, dtype=torch.bfloat16)}
    save_file(ref, str(tmp_path / "x.safetensors"),
              metadata={"format": "pt"})     # skipped by the reader
    got = tst.load_file(tmp_path / "x.safetensors")
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("dtype", ["float32", "float16", "float64", "int8",
                                   "uint8", "int16", "int32", "int64",
                                   "bool"])
def test_safetensors_writer_matches_package(tmp_path, dtype):
    """The port's file reads through safetensors.numpy.load_file, and is
    the package's own file byte for byte."""
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(3)
    arrs = {
        "z": (rng.normal(size=(4, 3)) * 50).astype(dtype),
        "a": rng.normal(size=(5,)).astype(np.float32),
        "m": rng.integers(-3, 3, size=(2, 2, 3)).astype(np.int8),
        "e": np.zeros((0, 2), dtype=dtype),
    }
    tst.save_file(arrs, tmp_path / "port.safetensors")
    back = load_file(str(tmp_path / "port.safetensors"))
    for k, v in arrs.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
    save_file(arrs, str(tmp_path / "pkg.safetensors"))
    assert ((tmp_path / "port.safetensors").read_bytes()
            == (tmp_path / "pkg.safetensors").read_bytes())


def test_safetensors_rejects_bad_offsets(tmp_path):
    import struct

    header = json.dumps({"w": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 12]}}).encode()
    header += b" " * (-len(header) % 8)
    (tmp_path / "bad.safetensors").write_bytes(
        struct.pack("<Q", len(header)) + header + b"\0" * 16)
    with pytest.raises(ValueError):
        tst.load_file(tmp_path / "bad.safetensors")


# --- the codec -------------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_codec_convert_matches_jax(golden, tmp_path):
    """The golden's reference state dict (weight-norm pairs) through the
    port's converter, and through a codec.pth with the 'generator.' prefix
    and the port's loader: every leaf within 1e-6 of JAX's conversion,
    carried; the decode of the golden codes matches the reference audio
    as tests/test_torch_codec.py holds it."""
    sd = {k[3:]: golden[k] for k in golden.files if k.startswith("sd:")}
    want = codec_params_from_jax(
        _np(j_convert_dac(sd, tiny_codec_config())), device="cpu")
    cfg = tcodec_cfg.tiny_codec_config()
    port = convert_dac_state_dict(sd, cfg, device="cpu")
    _assert_trees_equal(port, want, atol=1e-6)

    torch.save({"generator." + k: torch.from_numpy(np.array(v))
                for k, v in sd.items()}, tmp_path / "codec.pth")
    from_pth = convert_dac_state_dict(
        load_torch_codec_checkpoint(tmp_path / "codec.pth"), cfg,
        device="cpu")
    _assert_trees_equal(from_pth, want, atol=1e-6)

    codes = torch.from_numpy(golden["codes1"])
    audio = dac_from_indices(from_pth, cfg, codes).numpy()
    np.testing.assert_allclose(audio, golden["golden_audio"][:, 0, :],
                               atol=2e-4, rtol=1e-3)


# --- the native format -------------------------------------------------------


def _tiny_port_tree(mode: str) -> dict:
    cfg = TCfg(**dataclasses.asdict(tiny_dual_ar_config()))
    params = init_dual_ar_params(torch.Generator().manual_seed(0), cfg,
                                 dtype=torch.bfloat16, device="cpu")
    return quantize_lm_params(params, mode=mode, groupsize=32)


@pytest.mark.parametrize("mode", ["int8", "w4a8"])
def test_native_roundtrip_port_tree(tmp_path, mode):
    params = _tiny_port_tree(mode)
    save_params(tmp_path / "ckpt", params, config=tiny_dual_ar_config())
    loaded, cfg_dict = load_params(tmp_path / "ckpt", device="cpu")
    assert cfg_dict["vocab_size"] == tiny_dual_ar_config().vocab_size
    assert not (tmp_path / "ckpt" / "quant_meta.json").exists()
    _assert_trees_equal(loaded, params)


@pytest.mark.parametrize("mode", ["int8", "w4a8", "int4"])
def test_native_checkpoint_from_jax(tmp_path, mode):
    """A checkpoint written by JAX's save_params loads through the port's
    load_params to what lm_params_from_jax gives for the JAX tree; the
    native int4 leaves (widened to int8 on disk, listed in
    quant_meta.json) arrive packed."""
    cfg = tiny_dual_ar_config()
    params = j_init(jax.random.key(0), cfg, dtype=jnp.bfloat16)
    params = j_quantize(params, mode=mode, groupsize=32)
    j_save(tmp_path / "ckpt", params, config=cfg)
    assert (tmp_path / "ckpt" / "quant_meta.json").exists() == (mode == "int4")
    loaded, _ = load_params(tmp_path / "ckpt", device="cpu")
    want = lm_params_from_jax(_np(params), device="cpu")
    _assert_trees_equal(loaded, want)
    if mode != "int8":
        assert set(loaded["layers"]["attention"]["wqkv"]) == {"q4", "gs"}


def test_load_params_casts_floats_only(tmp_path):
    params = _tiny_port_tree("int8")
    save_params(tmp_path / "ckpt", params)
    loaded, cfg_dict = load_params(tmp_path / "ckpt", dtype=torch.float32,
                                   device="cpu")
    assert cfg_dict is None
    for path, leaf in _leaves(loaded):
        want = dict(_leaves(params))[path]
        if want.is_floating_point():
            assert leaf.dtype == torch.float32
            assert torch.equal(leaf, want.float())
        else:
            assert torch.equal(leaf, want), path
