"""The port's TTS engine end to end on a tiny model (text -> codes -> wav),
and its import hygiene: the port and chip_smoke.py load neither JAX nor the
JAX package, and the entry points refuse to fall back to the CPU."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.codec.config import tiny_codec_config
from fish_speech_tpu_torch.engine.generate import (
    GenerateLongRequest,
    build_engine,
)
from fish_speech_tpu_torch.models.config import DualARConfig

ROOT = Path(__file__).resolve().parent.parent


def tiny_lm_config() -> DualARConfig:
    """Slow stack with GQA; fast stack in the fused sweep's 3x family."""
    return DualARConfig(
        vocab_size=320, n_layer=2, n_head=4, n_local_heads=2, dim=64,
        head_dim=16, intermediate_size=128, max_seq_len=256,
        rope_base=10000.0, codebook_size=32, num_codebooks=4,
        n_fast_layer=2, fast_dim=64, fast_n_head=2, fast_n_local_heads=2,
        fast_head_dim=32, fast_intermediate_size=192)


@pytest.fixture(scope="module")
def engine():
    # decoder_dim 1088: block 0 has 544 channels, above the fused-block
    # width, so the vocoder runs both kernels' paths (res stack and block)
    codec = dataclasses.replace(tiny_codec_config(), decoder_dim=1088)
    return build_engine(device="cpu", serving=True, seed=3,
                        lm_cfg=tiny_lm_config(), codec_cfg=codec,
                        cache_len=256)


def test_serving_engine_configuration(engine):
    cfg = engine.cfg
    assert cfg.w8a8_matmuls and cfg.kv_cache_dtype == "int8"
    assert cfg.kv_cache_layout == "pos" and cfg.use_pallas_attention
    assert "fast_packed" in engine.params
    assert "fast_layers" not in engine.params


@pytest.fixture(scope="module")
def engine_w4a8():
    """The second serving path: packed int4 slow stack (groups of 32 at
    this width) with W4A8 products, and the KV-write fold."""
    return build_engine(device="cpu", serving=True, seed=3,
                        lm_cfg=tiny_lm_config(), codec_cfg=tiny_codec_config(),
                        cache_len=256, quant="w4a8", groupsize=32,
                        kv_fold=True)


def test_w4a8_engine_configuration(engine_w4a8):
    cfg, params = engine_w4a8.cfg, engine_w4a8.params
    assert cfg.w8a8_matmuls and cfg.kv_fold_write and cfg.slow_attn.kv_fold
    assert cfg.kv_cache_layout == "pos" and cfg.use_pallas_attention
    for sub, leaf in (("attention", "wqkv"), ("attention", "wo"),
                      ("feed_forward", "w1"), ("feed_forward", "w2"),
                      ("feed_forward", "w3")):
        assert set(params["layers"][sub][leaf]) == {"q4", "gs"}, leaf
    assert set(params["embeddings"]) == {"q", "s"}
    assert "fast_packed" in params
    with pytest.raises(ValueError):
        build_engine(device="cpu", serving=False, quant="w4a8")


def test_w4a8_fold_tts_text_to_wav(engine_w4a8, monkeypatch):
    from fish_speech_tpu_torch.models import dual_ar
    from fish_speech_tpu_torch.ops import w4a8

    calls = {"fold": 0, "w4a8": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(dual_ar, "decode_attention_stream_fold",
                        counted("fold", dual_ar.decode_attention_stream_fold))
    monkeypatch.setattr(w4a8, "w4a8_matmul",
                        counted("w4a8", w4a8.w4a8_matmul))
    req = GenerateLongRequest(text="Hello there.", seed=5, max_new_tokens=8)
    wav, codes, _ = engine_w4a8.tts_with_codes(req)
    n = codes.shape[1]
    cfg = engine_w4a8.cfg
    assert 1 <= n <= 8
    assert codes.min() >= 0 and codes.max() < cfg.codebook_size
    assert wav.shape == (n * engine_w4a8.codec_cfg.frame_length,)
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    # every decode step went through the fold (one a layer), and every
    # slow-stack product through the W4A8 product (5 a layer, prefill too)
    assert calls["fold"] >= (n - 1) * cfg.n_layer
    assert calls["fold"] % cfg.n_layer == 0
    assert calls["w4a8"] == 5 * (cfg.n_layer + calls["fold"])


def test_tts_text_to_wav(engine):
    req = GenerateLongRequest(text="<|speaker:0|>Hello there.", seed=7,
                              max_new_tokens=12)
    wav, codes, lm_s = engine.tts_with_codes(req)
    n = codes.shape[1]
    assert 1 <= n <= 12 and lm_s > 0
    assert codes.shape[0] == engine.cfg.num_codebooks
    assert codes.min() >= 0 and codes.max() < engine.cfg.codebook_size
    assert wav.shape == (n * engine.codec_cfg.frame_length,)
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    # a seed fixes the request's output
    again, codes2, _ = engine.tts_with_codes(req)
    np.testing.assert_array_equal(codes2, codes)
    np.testing.assert_array_equal(again, wav)
    np.testing.assert_array_equal(engine.tts(req), wav)


# route -> (attn, kv_cache, stack_mode, the dual_ar function it calls)
HEAD_ROUTES = {
    "a": ("blocks16", "int8", "carry", "decode_attention_blocks"),
    "b": ("blocks16-bf16", "int8", "carry", "decode_attention_blocks"),
    "c": ("stream16", "int8", "carry", "decode_attention_stream"),
    "d": ("rows", "native", "carry", "decode_attention_stacked_rows"),
    "e": ("rows", "int8", "carry", "decode_attention_stacked_rows"),
    "f": ("rows", "native", "scan", "decode_attention"),
}
ATTN_FNS = ("decode_attention_blocks", "decode_attention_stream",
            "decode_attention_stacked_rows", "decode_attention",
            "decode_attention_stream_fold")


@pytest.mark.parametrize("route", list(HEAD_ROUTES))
def test_head_major_engine_route(route, monkeypatch):
    """build_engine(kv_layout="head", ...) answers a request, and every
    decode step's attention goes through the route's function (one call a
    layer) and no other."""
    from fish_speech_tpu_torch.models import dual_ar

    attn, kv_cache, stack_mode, fn = HEAD_ROUTES[route]
    engine = build_engine(device="cpu", seed=3, lm_cfg=tiny_lm_config(),
                          codec_cfg=tiny_codec_config(), cache_len=256,
                          kv_layout="head", kv_cache=kv_cache, attn=attn,
                          stack_mode=stack_mode)
    cfg = engine.cfg
    assert cfg.kv_cache_layout == "head" and cfg.kv_cache_dtype == kv_cache
    assert cfg.decode_stack_mode == stack_mode and "fast_packed" in \
        engine.params
    calls = dict.fromkeys(ATTN_FNS, 0)

    def counted(name, f):
        def wrapped(*a, **kw):
            calls[name] += 1
            return f(*a, **kw)
        return wrapped

    for name in ATTN_FNS:
        monkeypatch.setattr(dual_ar, name, counted(name,
                                                   getattr(dual_ar, name)))
    req = GenerateLongRequest(text="Hello there.", seed=5, max_new_tokens=6)
    wav, codes, _ = engine.tts_with_codes(req)
    n = codes.shape[1]
    assert 1 <= n <= 6
    assert codes.min() >= 0 and codes.max() < cfg.codebook_size
    assert wav.shape == (n * engine.codec_cfg.frame_length,)
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    assert calls[fn] >= (n - 1) * cfg.n_layer and calls[fn] % cfg.n_layer == 0
    assert all(c == 0 for name, c in calls.items() if name != fn), calls


def test_pos_native_engine_route(monkeypatch):
    """build_engine(kv_layout="pos", kv_cache="native", attn="stream")
    answers a request; every decode step's attention goes through the stream
    function on the position-major bf16 cache, one call a layer."""
    from fish_speech_tpu_torch.models import dual_ar

    engine = build_engine(device="cpu", seed=3, lm_cfg=tiny_lm_config(),
                          codec_cfg=tiny_codec_config(), cache_len=256,
                          kv_layout="pos", kv_cache="native", attn="stream")
    cfg = engine.cfg
    assert cfg.kv_cache_layout == "pos" and cfg.kv_cache_dtype == "native"
    seen = []

    def stream(q, k, *a, **kw):
        seen.append((k.dtype, k.dim(), kw.get("pos_major")))
        return fn(q, k, *a, **kw)
    fn = dual_ar.decode_attention_stream
    monkeypatch.setattr(dual_ar, "decode_attention_stream", stream)
    req = GenerateLongRequest(text="Hello there.", seed=5, max_new_tokens=6)
    wav, codes, _ = engine.tts_with_codes(req)
    n = codes.shape[1]
    assert 1 <= n <= 6
    assert codes.min() >= 0 and codes.max() < cfg.codebook_size
    assert wav.shape == (n * engine.codec_cfg.frame_length,)
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    assert len(seen) >= (n - 1) * cfg.n_layer and len(seen) % cfg.n_layer == 0
    assert set(seen) == {(torch.bfloat16, 5, True)}


def test_voc_quant_engine(monkeypatch):
    """build_engine(voc_quant=True) packs the int8 vocoder and answers a
    request; voc_quant=None reads VOC_QUANT, as the JAX packer does."""
    kw = dict(device="cpu", seed=3, lm_cfg=tiny_lm_config(),
              codec_cfg=tiny_codec_config(), cache_len=256)
    engine = build_engine(voc_quant=True, **kw)
    res = engine.packed_decoder["blocks"][0]["res"]
    assert res["w7"].dtype == torch.int8 and res["vec"].shape[1] == 8
    req = GenerateLongRequest(text="Hello there.", seed=5, max_new_tokens=6)
    wav, codes, _ = engine.tts_with_codes(req)
    n = codes.shape[1]
    assert 1 <= n <= 6
    assert wav.shape == (n * engine.codec_cfg.frame_length,)
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    monkeypatch.setenv("VOC_QUANT", "1")
    assert build_engine(**kw).packed_decoder["blocks"][0]["res"][
        "w7"].dtype == torch.int8
    monkeypatch.delenv("VOC_QUANT")
    assert build_engine(**kw).packed_decoder["blocks"][0]["res"][
        "w7"].dtype == torch.float32


def test_engine_refuses_unported_or_unreadable_configurations():
    kw = dict(device="cpu", lm_cfg=tiny_lm_config(),
              codec_cfg=tiny_codec_config(), cache_len=256)
    # a position-major cache is readable by the stream kernel only
    with pytest.raises(ValueError, match="streaming"):
        build_engine(kv_layout="pos", attn="rows", **kw)
    # the fold writes the position-major int8 cache only
    with pytest.raises(ValueError, match="kv_fold"):
        build_engine(kv_layout="pos", kv_cache="native", kv_fold=True, **kw)
    with pytest.raises(ValueError, match="kv_fold"):
        build_engine(kv_layout="head", kv_fold=True, **kw)
    with pytest.raises(ValueError, match="stack_mode"):
        build_engine(kv_layout="head", stack_mode="loop", **kw)


_HYGIENE = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import torch
torch.cuda.is_available = lambda: False
import fish_speech_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "fish_speech_tpu"))
assert not bad, bad
from fish_speech_tpu_torch.codec.fastpath import dac_from_indices_fused
from fish_speech_tpu_torch.codec.model import dac_encode
from fish_speech_tpu_torch.codec.streaming import StatefulVocoder
from fish_speech_tpu_torch.engine.generate import TTSEngine, build_engine
from fish_speech_tpu_torch.models.decode import generate
for entry in (build_engine,
              lambda: TTSEngine(None, None, None),
              lambda: generate(None, None, torch.zeros(1), None, None, None,
                               None, max_new_tokens=1, im_end_id=0),
              lambda: dac_from_indices_fused(None, None, torch.zeros(1)),
              lambda: StatefulVocoder(None, None),
              lambda: dac_encode(None, None, torch.zeros(1))):
    try:
        entry()
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), e
    else:
        raise AssertionError("an entry point ran without a GPU")
assert chip_smoke.main() != 0
print("clean")
"""


def test_port_imports_no_jax_and_needs_cuda():
    out = subprocess.run(
        [sys.executable, "-c", _HYGIENE.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("clean")
    # with no GPU, chip_smoke prints no result line
    assert '"ok"' not in out.stdout
