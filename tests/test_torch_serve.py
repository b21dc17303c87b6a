"""The port's HTTP server and what it stands on, against the JAX package's
and the packages it uses: the msgpack codec against `msgpack`, the request
schemas against the JAX package's pydantic models, the scenarios of
tests/test_server.py against the port's server on 127.0.0.1 (tiny engine,
JAX weights carried to the port, the CPU), the vqgan bodies against the
JAX server's on the same weights, an engine built by the CLI from a
checkpoint on disk with the serving flags, and the demo-mode CLIs as
subprocesses."""

import base64
import dataclasses
import http.client
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import msgpack
import numpy as np
import pydantic
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from fish_speech_tpu.codec import init_dac_params as j_codec_init
from fish_speech_tpu.codec import tiny_codec_config as j_tiny_codec
from fish_speech_tpu.models.config import DualARConfig
from fish_speech_tpu.models.init import init_dual_ar_params as j_lm_init
from fish_speech_tpu.serve import schema as jschema
from fish_speech_tpu_torch.codec import config as tcodec
from fish_speech_tpu_torch.codec.init import codec_params_from_jax
from fish_speech_tpu_torch.engine.generate import TTSEngine
from fish_speech_tpu_torch.models.config import DualARConfig as TCfg
from fish_speech_tpu_torch.models.init import lm_params_from_jax
from fish_speech_tpu_torch.serve import msgpack as tmsgpack
from fish_speech_tpu_torch.serve import schema as tschema
from fish_speech_tpu_torch.serve.app import create_server
from fish_speech_tpu_torch.serve.wav import encode_wav
from fish_speech_tpu_torch.text.tokenizer import ByteTokenizer

ROOT = Path(__file__).resolve().parent.parent


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --- msgpack -----------------------------------------------------------------

MSGPACK_TABLE = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, 1.5, -2.25, 1e300, "", "a",
    "x" * 31, "x" * 32, "x" * 255, "x" * 256, "x" * 65536, "é☃", b"", b"ab",
    b"x" * 256, b"x" * 70000, [], [1, 2], list(range(15)), list(range(16)),
    list(range(70000)), {}, {"a": 1}, {str(i): i for i in range(16)},
    {"tokens": [[[1, 2], [3, 4]]], "audio": b"zz", "seed": None,
     "top_p": 0.7},
]


@pytest.mark.parametrize("i", range(len(MSGPACK_TABLE)))
def test_msgpack_table_matches_package(i):
    v = MSGPACK_TABLE[i]
    packed = msgpack.packb(v)
    assert tmsgpack.packb(v) == packed
    assert tmsgpack.unpackb(packed) == msgpack.unpackb(packed)


_json_like = st.recursive(
    st.none() | st.booleans()
    | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
    | st.floats(allow_nan=False) | st.text() | st.binary(),
    lambda inner: st.lists(inner, max_size=6)
    | st.dictionaries(st.text(max_size=8), inner, max_size=6),
    max_leaves=20)


@settings(max_examples=60, deadline=None)
@given(_json_like)
def test_msgpack_round_trip(v):
    packed = tmsgpack.packb(v)
    assert packed == msgpack.packb(v)
    assert tmsgpack.unpackb(packed) == v
    assert msgpack.unpackb(packed) == v


@pytest.mark.parametrize("bad", [b"\xd4\x01\x02", b"\xc7\x01\x05x", b"\xc1",
                                 b"\x92\x01", b"\xa5abc", b"\x01\x02",
                                 b"\x81\x01\x02", b"\xa1\xff", b""])
def test_msgpack_refuses(bad):
    """ext types, reserved bytes, truncation, extra data, int map keys
    and bad utf-8 raise a ValueError (the app's 400); msgpack raises too,
    but for an ext type, which it returns as an ExtType."""
    with pytest.raises(ValueError):
        tmsgpack.unpackb(bad)
    if bad[:1] in (b"\xc7", b"\xd4"):
        assert isinstance(msgpack.unpackb(bad), msgpack.ExtType)
    else:
        with pytest.raises(Exception):
            msgpack.unpackb(bad)


# --- schemas ---------------------------------------------------------------

_B64 = base64.b64encode(b"ABC" * 70).decode()        # 280 characters
SCHEMA_TABLE = [("ServeTTSRequest", d) for d in [
    {"text": "a"}, {}, {"text": None}, {"text": 1}, {"text": b"ab"},
    {"text": "a", "extra": 5}, [1], "x", None,
    {"text": "a", "top_p": 1}, {"text": "a", "top_p": True},
    {"text": "a", "top_p": "0.5"}, {"text": "a", "top_p": 0.05},
    {"text": "a", "top_p": float("nan")}, {"text": "a", "top_p": 2 ** 70},
    {"text": "a", "temperature": 1.0000001},
    {"text": "a", "temperature": float("inf")},
    {"text": "a", "repetition_penalty": 2},
    {"text": "a", "chunk_length": 150.0}, {"text": "a", "chunk_length": 150.5},
    {"text": "a", "chunk_length": "150"}, {"text": "a", "chunk_length": True},
    {"text": "a", "chunk_length": 99}, {"text": "a", "chunk_length": "1_000"},
    {"text": "a", "chunk_length": 1000.0000001},
    {"text": "a", "top_p": 0.5, "temperature": "x", "chunk_length": 5},
    {"text": "a", "normalize": "yes"}, {"text": "a", "normalize": 1},
    {"text": "a", "normalize": 2}, {"text": "a", "normalize": 2.0},
    {"text": "a", "normalize": 0.5}, {"text": "a", "normalize": "OFF"},
    {"text": "a", "normalize": None}, {"text": "a", "normalize": b"true"},
    {"text": "a", "normalize": " true"}, {"text": "a", "streaming": "1"},
    {"text": "a", "seed": None}, {"text": "a", "seed": "5"},
    {"text": "a", "seed": 5.0}, {"text": "a", "seed": "  7 "},
    {"text": "a", "seed": "1.0"}, {"text": "a", "seed": "1e3"},
    {"text": "a", "seed": ""}, {"text": "a", "seed": "+5"},
    {"text": "a", "seed": "0x10"}, {"text": "a", "seed": b"5"},
    {"text": "a", "seed": float("inf")}, {"text": "a", "seed": [1]},
    {"text": "a", "max_new_tokens": -5}, {"text": "a", "max_new_tokens": 1e20},
    {"text": "a", "max_new_tokens": 10 ** 30},
    {"text": "a", "format": "WAV"}, {"text": "a", "format": b"wav"},
    {"text": "a", "format": "opus"}, {"text": "a", "latency": "balanced"},
    {"text": "a", "use_memory_cache": "on"},
    {"text": "a", "reference_id": 5}, {"text": "a", "reference_id": b"x"},
    {"text": "a", "references": [{"audio": "abc", "text": "t"}]},
    {"text": "a", "references": [{"audio": "QUJD" * 63, "text": "t"}]},
    {"text": "a", "references": [{"audio": _B64, "text": "t"}]},
    {"text": "a", "references": [{"audio": _B64 + "A", "text": "t"}]},
    {"text": "a", "references": [{"audio": "!!" * 200, "text": "t"}]},
    {"text": "a", "references": [{"audio": b"\x00\x01", "text": "t"}]},
    {"text": "a", "references": [{"audio": 1, "text": "t"}]},
    {"text": "a", "references": [{"text": "t"}, {"audio": 2}]},
    {"text": "a", "references": "x"},
]] + [("UpdateReferenceRequest", d) for d in [
    {"old_reference_id": "a b_c-1", "new_reference_id": "x"},
    {"old_reference_id": "a\n", "new_reference_id": "x"},
    {"old_reference_id": "", "new_reference_id": "x"},
    {"old_reference_id": "a" * 256, "new_reference_id": "x"},
    {"old_reference_id": "é", "new_reference_id": "x"},
    {"old_reference_id": "a"}, {},
    {"old_reference_id": 1, "new_reference_id": 2},
]] + [("AddReferenceRequest", d) for d in [
    {"id": "a", "audio": b"x", "text": "t"},
    {"id": "a", "audio": "x", "text": ""},
    {"id": "a", "audio": "x" * 300, "text": "t"},
    {"id": "a/b", "audio": b"x", "text": "t"},
]] + [("ServeVQGANEncodeRequest", d) for d in [
    {"audios": [b"a", "b"]}, {"audios": "ab"}, {"audios": [1]}, {},
]] + [("ServeVQGANDecodeRequest", d) for d in [
    {"tokens": [[[1, 2], [3, 4]]]}, {"tokens": [[[1.0, "2"]]]},
    {"tokens": [[1]]}, {"tokens": [[[1.5]]]}, {"tokens": []},
    {"tokens": [[[True]]]}, {"tokens": [[[1, "x"], 2], [[3.5]]]},
]]


def _pydantic_outcome(name, data):
    try:
        return "ok", getattr(jschema, name).model_validate(data).model_dump()
    except pydantic.ValidationError as e:
        return "invalid", [(x["type"], x["loc"], x["msg"], x.get("ctx"))
                           for x in e.errors(include_url=False,
                                             include_input=False)]


def _port_outcome(name, data):
    def dump(o):
        if dataclasses.is_dataclass(o):
            return {f.name: dump(getattr(o, f.name))
                    for f in dataclasses.fields(o)}
        return [dump(x) for x in o] if isinstance(o, list) else o

    try:
        return "ok", dump(getattr(tschema, name).from_dict(data))
    except tschema.ValidationError as e:
        return "invalid", [(x["type"], x["loc"], x["msg"], x.get("ctx"))
                           for x in e.errors()]


@pytest.mark.parametrize("i", range(len(SCHEMA_TABLE)))
def test_schema_matches_pydantic(i):
    """The same accept or reject, the same values, and the same errors
    (type, location, message, context) as the JAX package's models."""
    name, data = SCHEMA_TABLE[i]
    assert _port_outcome(name, data) == _pydantic_outcome(name, data)


# --- the port's server -----------------------------------------------------


def _tiny_parts(max_seq_len: int = 512):
    """test_server.py's tiny engine: its configs and JAX weights."""
    tok = ByteTokenizer(n_semantic=64)
    cfg = DualARConfig(
        vocab_size=tok.vocab_size,
        n_layer=1, n_head=2, n_local_heads=2, dim=32, head_dim=16,
        intermediate_size=64, max_seq_len=max_seq_len,
        codebook_size=64, num_codebooks=4,
        semantic_begin_id=tok.semantic_begin_id,
        semantic_end_id=tok.semantic_end_id,
        n_fast_layer=1, fast_dim=32, fast_n_head=2, fast_n_local_heads=2,
        fast_head_dim=16, fast_intermediate_size=64)
    return tok, cfg, j_lm_init(jax.random.key(0), cfg), \
        j_codec_init(jax.random.key(1), j_tiny_codec())


def _engine(max_seq_len: int = 512, **kw) -> TTSEngine:
    tok, cfg, params, cparams = _tiny_parts(max_seq_len)
    return TTSEngine(lm_params_from_jax(_np(params), device="cpu"),
                     TCfg(**dataclasses.asdict(cfg)), tok,
                     codec_params=codec_params_from_jax(_np(cparams),
                                                        device="cpu"),
                     codec_cfg=tcodec.tiny_codec_config(),
                     cache_len=max_seq_len, device="cpu", **kw)


class Served:
    """A port server in a thread, and a small client."""

    def __init__(self, engine, ref_dir=None, api_key=None):
        self.engine = engine
        self.server = create_server(engine, "127.0.0.1", 0, ref_dir=ref_dir,
                                    api_key=api_key)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def request(self, method, path, body=None, headers=None):
        """(status, headers, body bytes); a dict body goes as JSON."""
        hdrs = dict(headers or {})
        if isinstance(body, dict):
            body = json.dumps(body).encode()
            hdrs.setdefault("Content-Type", "application/json")
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}", data=body, headers=hdrs,
            method=method)
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.headers, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers, e.read()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.server.app.close()
        self.engine.close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture
def served(tmp_path):
    s = Served(_engine(), ref_dir=str(tmp_path / "refs"))
    yield s
    s.close()


def test_server_endpoints(served):
    """test_server.py's endpoint scenario, request for request."""
    s = served
    st_, _, body = s.request("GET", "/v1/health")
    assert st_ == 200 and json.loads(body)["status"] == "ok"
    st_, _, body = s.request("POST", "/v1/tts", {
        "text": "hi", "max_new_tokens": 4, "chunk_length": 200})
    assert st_ == 200 and body[:4] == b"RIFF"
    st_, _, pcm = s.request(
        "POST", "/v1/tts", msgpack.packb({"text": "yo", "max_new_tokens": 4,
                                          "format": "pcm",
                                          "chunk_length": 200}),
        {"Content-Type": "application/msgpack"})
    assert st_ == 200 and len(pcm) > 0 and len(pcm) % 2 == 0
    st_, h, body = s.request("POST", "/v1/tts", {
        "text": "stream me", "max_new_tokens": 4, "streaming": True,
        "chunk_length": 200})
    assert st_ == 200 and body[:4] == b"RIFF"
    assert h["Transfer-Encoding"] == "chunked"
    codes = np.zeros((4, 3), dtype=np.int32).tolist()
    st_, _, body = s.request("POST", "/v1/vqgan/decode", {"tokens": [codes]})
    assert st_ == 200 and len(json.loads(body)["audios"]) == 1

    wav_bytes = encode_wav(np.zeros(s.engine.codec_cfg.frame_length * 2,
                                    np.float32), 44100)
    st_, _, body = s.request(
        "POST", "/v1/references/add",
        msgpack.packb({"id": "alice", "text": "hello", "audio": wav_bytes}),
        {"Content-Type": "application/msgpack"})
    assert st_ == 200
    st_, _, body = s.request("GET", "/v1/references/list")
    assert json.loads(body)["reference_ids"] == ["alice"]
    st_, _, body = s.request("POST", "/v1/tts", {
        "text": "cloned", "max_new_tokens": 4, "reference_id": "alice",
        "chunk_length": 200})
    assert st_ == 200 and body[:4] == b"RIFF"
    st_, _, body = s.request("POST", "/v1/references/update", {
        "old_reference_id": "alice", "new_reference_id": "bob"})
    assert st_ == 200 and json.loads(body)["success"] is True
    st_, _, _ = s.request("POST", "/v1/references/update", {
        "old_reference_id": "bob"})            # missing field -> 400
    assert st_ == 400
    st_, _, body = s.request("DELETE", "/v1/references/delete",
                             json.dumps({"reference_id": "bob"}).encode())
    assert json.loads(body)["success"] is True

    st_, h, mp3 = s.request("POST", "/v1/tts", {
        "text": "compressed", "max_new_tokens": 4, "format": "mp3",
        "chunk_length": 200})
    assert st_ == 200 and h["Content-Type"] == "audio/mpeg"
    assert mp3[:2] in (b"\xff\xfb", b"\xff\xfa", b"\xff\xf3") or \
        mp3[:3] == b"ID3"
    st_, h, opus = s.request("POST", "/v1/tts", {
        "text": "compressed", "max_new_tokens": 4, "format": "opus",
        "chunk_length": 200})
    assert st_ == 200 and h["Content-Type"] == "audio/ogg"
    assert opus[:4] == b"OggS" and b"OpusHead" in opus[:64]
    st_, _, _ = s.request("POST", "/v1/tts", {
        "text": "x", "max_new_tokens": 4, "format": "mp3", "streaming": True,
        "chunk_length": 200})
    assert st_ == 400


def test_server_errors_and_auth(tmp_path):
    """401 without the key on /v1/*, 422 for a schema failure, 400 for a
    malformed JSON or msgpack body, 404 / 405, the UI without a key, and
    replies in msgpack when Accept asks."""
    s = Served(_engine(), api_key="k")
    try:
        auth = {"Authorization": "Bearer k"}
        assert s.request("GET", "/v1/health")[0] == 401
        assert s.request("GET", "/v1/health",
                         headers={"Authorization": "Bearer x"})[0] == 401
        st_, _, body = s.request("POST", "/v1/health", b"", auth)
        assert st_ == 200
        st_, h, body = s.request("GET", "/v1/health",
                                 headers={**auth,
                                          "Accept": "application/msgpack"})
        assert h["Content-Type"] == "application/msgpack"
        assert msgpack.unpackb(body) == {"status": "ok"}
        st_, _, body = s.request("POST", "/v1/tts", {"text": "a",
                                                     "top_p": 3}, auth)
        assert st_ == 422
        assert json.loads(body)["detail"][0]["loc"] == ["top_p"]
        assert s.request("POST", "/v1/tts", b"{x", {
            **auth, "Content-Type": "application/json"})[0] == 400
        assert s.request("POST", "/v1/tts", b"\xd4\x01\x02", {
            **auth, "Content-Type": "application/msgpack"})[0] == 400
        assert s.request("GET", "/v1/nothing", headers=auth)[0] == 404
        assert s.request("GET", "/v1/tts", headers=auth)[0] == 405
        st_, h, body = s.request("GET", "/ui")
        assert st_ == 200 and h["Content-Type"].startswith("text/html")
        # a body over the 256 MB limit is refused before it is read
        conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=30)
        conn.putrequest("POST", "/v1/tts")
        conn.putheader("Authorization", "Bearer k")
        conn.putheader("Content-Length", str(256 * 1024 * 1024 + 1))
        conn.endheaders()
        assert conn.getresponse().status == 413
        conn.close()
        # a chunk size or a Content-Length that is not a number: 400
        for name, value, data in (("Transfer-Encoding", "chunked",
                                   b"zz\r\n{}\r\n0\r\n\r\n"),
                                  ("Content-Length", "ten", b"")):
            conn = http.client.HTTPConnection("127.0.0.1", s.port,
                                              timeout=30)
            conn.putrequest("POST", "/v1/tts")
            conn.putheader("Authorization", "Bearer k")
            conn.putheader("Content-Type", "application/json")
            conn.putheader(name, value)
            conn.endheaders(data)
            resp = conn.getresponse()
            assert resp.status == 400, name
            assert json.loads(resp.read())["error"] == "malformed request body"
            conn.close()
    finally:
        s.close()


def test_vqgan_decode_batched(served):
    """A multi-item /v1/vqgan/decode is one batched vocoder call whose
    items equal their single decodes; /v1/vqgan/encode serves a repeat
    from its LRU."""
    s, engine = served, served.engine
    ccfg = engine.codec_cfg
    rng = np.random.default_rng(0)
    codes = [rng.integers(0, 16, size=(ccfg.rvq.total_codebooks, t))
             .astype(np.int32) for t in (3, 5, 2)]
    singles = [engine.decode_codes(c) for c in codes]
    calls = []
    orig = engine._vocode

    def counting(c, impl=None):
        calls.append(tuple(c.shape))
        return orig(c, impl)

    engine._vocode = counting
    wavs = engine.decode_codes_batch(codes)
    assert len(calls) == 1 and calls[0][0] == 4
    for got, want in zip(wavs, singles):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    calls.clear()
    st_, _, body = s.request("POST", "/v1/vqgan/decode",
                             {"tokens": [c.tolist() for c in codes]})
    engine._vocode = orig
    assert st_ == 200 and len(calls) == 1
    audios = json.loads(body)["audios"]
    for a, want in zip(audios, singles):
        got = np.frombuffer(base64.b64decode(a), np.float16)
        np.testing.assert_allclose(got, want.astype(np.float16), atol=1e-3)

    payload = msgpack.packb({"audios": [encode_wav(
        np.zeros(ccfg.frame_length * 4, np.float32), 44100)]})
    hdr = {"Content-Type": "application/msgpack"}
    st1, _, b1 = s.request("POST", "/v1/vqgan/encode", payload, hdr)
    n_enc = [0]
    orig_enc = engine.encode_reference
    engine.encode_reference = lambda w: (
        n_enc.__setitem__(0, n_enc[0] + 1) or orig_enc(w))
    st2, _, b2 = s.request("POST", "/v1/vqgan/encode", payload, hdr)
    engine.encode_reference = orig_enc
    assert st1 == st2 == 200 and n_enc[0] == 0
    assert json.loads(b1)["tokens"] == json.loads(b2)["tokens"]


def test_vqgan_bodies_match_jax_server(tmp_path):
    """/v1/vqgan/decode and /v1/vqgan/encode from the port's server
    against the JAX server's, both on the plain f32 decoder ("lax") with
    the same weights: the codes equal, the f16 audio within one f16 step
    at |x| < 1 (1e-3)."""
    from aiohttp.test_utils import TestClient, TestServer

    import asyncio

    from fish_speech_tpu.engine import TTSEngine as JEngine
    from fish_speech_tpu.serve.app import create_app

    tok, cfg, params, cparams = _tiny_parts()
    jeng = JEngine(params, cfg, tok, codec_params=cparams,
                   codec_cfg=j_tiny_codec(), cache_len=512,
                   vocoder_impl="lax")
    rng = np.random.default_rng(5)
    codes = [rng.integers(0, 32, size=(4, t)).tolist() for t in (3, 7)]
    wav = encode_wav((0.3 * np.sin(np.arange(4000) / 9)).astype(np.float32),
                     44100)
    bodies = [("/v1/vqgan/decode", {"tokens": codes}),
              ("/v1/vqgan/encode", {"audios": [wav]})]

    async def jax_side():
        client = TestClient(TestServer(create_app(jeng)))
        await client.start_server()
        try:
            out = []
            for path, data in bodies:
                r = await client.post(path, data=msgpack.packb(data),
                                      headers={"Content-Type":
                                               "application/msgpack",
                                               "Accept":
                                               "application/msgpack"})
                assert r.status == 200
                out.append(msgpack.unpackb(await r.read()))
            return out
        finally:
            await client.close()

    want = asyncio.new_event_loop().run_until_complete(jax_side())
    s = Served(_engine(vocoder_impl="lax"))
    try:
        got = []
        for path, data in bodies:
            st_, _, body = s.request(
                "POST", path, msgpack.packb(data),
                {"Content-Type": "application/msgpack",
                 "Accept": "application/msgpack"})
            assert st_ == 200
            got.append(msgpack.unpackb(body))
    finally:
        s.close()
    assert len(got[0]["audios"]) == len(want[0]["audios"]) == 2
    for a, b in zip(got[0]["audios"], want[0]["audios"]):
        ga, wb = np.frombuffer(a, np.float16), np.frombuffer(b, np.float16)
        assert ga.shape == wb.shape
        np.testing.assert_allclose(ga.astype(np.float32),
                                   wb.astype(np.float32), atol=1e-3)
    assert got[1]["tokens"] == want[1]["tokens"]


def test_chunked_prefill_serving(tmp_path):
    """A long prompt over HTTP takes the chunked prefill while a
    concurrent stream keeps decoding between its chunks."""
    engine = _engine(1024, scheduler_slots=2, prefill_chunk=8)
    batcher = engine.scheduler.batcher
    s = Served(engine)
    try:
        st_, _, _ = s.request("POST", "/v1/tts", {
            "text": "warm", "max_new_tokens": 8, "streaming": True,
            "format": "pcm", "chunk_length": 200})
        assert st_ == 200
        st_, _, _ = s.request("POST", "/v1/tts", {
            "text": "word " * 80, "max_new_tokens": 8, "chunk_length": 1000})
        assert st_ == 200
        base_chunked = batcher.chunked_prefills
        base_ticks = batcher.ticks_while_prefilling
        assert base_chunked >= 1

        conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=120)
        conn.request("POST", "/v1/tts", json.dumps({
            "text": "keep talking", "max_new_tokens": 300,
            "temperature": 0.1, "top_p": 0.1, "streaming": True,
            "format": "pcm", "chunk_length": 200}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        chunk_times = []

        def reader():
            while resp.read(1 << 16):
                chunk_times.append(time.monotonic())

        rt = threading.Thread(target=reader)
        rt.start()
        deadline = time.monotonic() + 60
        while not batcher.active_h.any() and time.monotonic() < deadline:
            time.sleep(0.005)
        st_, _, body = s.request("POST", "/v1/tts", {
            "text": "word " * 80, "max_new_tokens": 8, "chunk_length": 1000})
        assert st_ == 200 and body[:4] == b"RIFF"
        assert batcher.chunked_prefills >= base_chunked + 1
        assert batcher.ticks_while_prefilling >= base_ticks + 1
        rt.join(timeout=120)
        assert not rt.is_alive() and chunk_times
        conn.close()
    finally:
        s.close()


def test_streaming_disconnect_cancels_slot(tmp_path):
    """A streaming client that goes away mid-generation frees its decode
    slot (the request cancelled), and the slot serves the next request."""
    engine = _engine(scheduler_slots=1)
    batcher = engine.scheduler.batcher
    batcher.im_end_id = 10 ** 9          # decode toward the whole budget
    orig_step = batcher.step

    def slow_step():
        time.sleep(0.01)
        orig_step()

    batcher.step = slow_step
    s = Served(engine)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=120)
        conn.request("POST", "/v1/tts", json.dumps({
            "text": "abandon me", "max_new_tokens": 400, "temperature": 0.1,
            "top_p": 0.1, "streaming": True, "format": "pcm",
            "chunk_length": 200}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.read(1 << 12)
        assert batcher.active_h.any()
        conn.sock.shutdown(2)
        conn.close()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if not batcher.active_h.any() and batcher.cancelled_requests >= 1:
                break
            time.sleep(0.02)
        assert batcher.cancelled_requests >= 1
        assert not batcher.active_h.any()
        st_, _, body = s.request("POST", "/v1/tts", {
            "text": "hi again", "max_new_tokens": 4, "chunk_length": 200})
        assert st_ == 200 and body[:4] == b"RIFF"
    finally:
        s.close()


# --- the CLI from a checkpoint on disk -------------------------------------


def _write_checkpoint(d: Path, seed: int = 0) -> dict:
    """A tiny fish_qwen3_omni checkpoint in two bf16 shards with its index
    and nested config.json; the vocabulary and codebooks are the byte
    tokenizer's (the fallback without tokenizer files), four codebooks as
    the demo codec has. Returns the drawn {reference name: bf16 tensor}."""
    from fish_speech_tpu_torch.utils.safetensors import save_file

    tok = ByteTokenizer()
    text = {"vocab_size": tok.vocab_size, "n_layer": 2, "n_head": 4,
            "n_local_heads": 2, "head_dim": 16, "dim": 64,
            "intermediate_size": 128, "rope_base": 1e6,
            "max_seq_len": 512, "attention_qk_norm": True}
    audio = {"vocab_size": 4096, "num_codebooks": 4, "n_layer": 1,
             "dim": 32, "n_head": 2, "n_local_heads": 2, "head_dim": 16,
             "intermediate_size": 64, "attention_qk_norm": False}
    (d / "config.json").write_text(json.dumps({
        "model_type": "fish_qwen3_omni", "text_config": text,
        "audio_decoder_config": audio,
        "semantic_start_token_id": tok.semantic_begin_id,
        "semantic_end_token_id": tok.semantic_end_id}))
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return (torch.randn(*shape, generator=g) * 0.05).to(torch.bfloat16)

    qkv = (4 + 2 * 2) * 16
    sd = {"text_model.model.embeddings.weight": r(tok.vocab_size, 64),
          "text_model.model.norm.weight": 1 + r(64),
          "audio_decoder.codebook_embeddings.weight": r(4096 * 4, 64),
          "audio_decoder.embeddings.weight": r(4096, 32),
          "audio_decoder.norm.weight": 1 + r(32),
          "audio_decoder.output.weight": r(4096, 32),
          "audio_decoder.project_in.weight": r(32, 64),
          "audio_decoder.project_in.bias": r(32)}
    for i in range(2):
        p = f"text_model.model.layers.{i}"
        sd.update({f"{p}.attention.wqkv.weight": r(qkv, 64),
                   f"{p}.attention.wo.weight": r(64, 64),
                   f"{p}.attention.q_norm.weight": 1 + r(16),
                   f"{p}.attention.k_norm.weight": 1 + r(16),
                   f"{p}.feed_forward.w1.weight": r(128, 64),
                   f"{p}.feed_forward.w2.weight": r(64, 128),
                   f"{p}.feed_forward.w3.weight": r(128, 64),
                   f"{p}.attention_norm.weight": 1 + r(64),
                   f"{p}.ffn_norm.weight": 1 + r(64)})
    p = "audio_decoder.layers.0"
    sd.update({f"{p}.attention.wqkv.weight": r(6 * 16, 32),
               f"{p}.attention.wo.weight": r(32, 32),
               f"{p}.feed_forward.w1.weight": r(64, 32),
               f"{p}.feed_forward.w2.weight": r(32, 64),
               f"{p}.feed_forward.w3.weight": r(64, 32),
               f"{p}.attention_norm.weight": 1 + r(32),
               f"{p}.ffn_norm.weight": 1 + r(32)})
    keys = sorted(sd)
    weight_map = {}
    for i, part in enumerate((keys[:len(keys) // 2], keys[len(keys) // 2:])):
        name = f"model-{i + 1:05d}-of-00002.safetensors"
        save_file({k: sd[k] for k in part}, d / name)
        weight_map.update({k: name for k in part})
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": weight_map}))
    return sd


@pytest.mark.parametrize("slots", [0, 2])
def test_cli_engine_from_checkpoint_serves(tmp_path, slots):
    """phase 8's engine at a tiny width: a sharded bf16 fish_qwen3_omni
    checkpoint through the CLI's build_engine with the serving flags (the
    position-major int8 cache read by the stream kernel's twin, the fused
    vocoder's twins), with and without the scheduler; the loaded leaves
    bit-equal to the drawn ones; a buffered and a streamed /v1/tts."""
    from fish_speech_tpu_torch.tools import api_server

    sd = _write_checkpoint(tmp_path)
    args = api_server.parse_args([
        "--checkpoint", str(tmp_path), "--kv-cache", "int8",
        "--pallas-attn", "stream", "--kv-layout", "pos",
        "--vocoder-impl", "pallas", "--scheduler-slots", str(slots),
        "--cache-len", "512", "--device", "cpu"])
    engine = api_server.build_engine(args)
    cfg = engine.cfg
    assert cfg.kv_cache_dtype == "int8" and cfg.kv_cache_layout == "pos"
    assert cfg.use_pallas_attention and cfg.pallas_attn_stream
    assert (engine.scheduler is not None) == (slots > 0)
    if slots:
        assert engine.scheduler.batcher.cache.k.dtype == torch.int8
    p = engine.params
    assert torch.equal(p["embeddings"],
                       sd["text_model.model.embeddings.weight"])
    assert torch.equal(p["layers"]["feed_forward"]["w2"][1],
                       sd["text_model.model.layers.1.feed_forward.w2.weight"])
    assert torch.equal(p["fast_project_in"]["w"],
                       sd["audio_decoder.project_in.weight"])
    assert torch.equal(p["codebook_embeddings"],
                       sd["audio_decoder.codebook_embeddings.weight"])
    api_server.warm_up(engine)
    s = Served(engine)
    try:
        st_, _, body = s.request("POST", "/v1/tts", {
            "text": "from disk", "max_new_tokens": 8, "chunk_length": 200})
        assert st_ == 200 and body[:4] == b"RIFF"
        st_, _, body = s.request("POST", "/v1/tts", {
            "text": "streamed", "max_new_tokens": 8, "streaming": True,
            "format": "pcm", "chunk_length": 200})
        assert st_ == 200 and len(body) % 2 == 0
    finally:
        s.close()


@pytest.mark.parametrize("flags,message", [
    (["--kv-layout", "pos"], "--kv-layout pos needs --pallas-attn stream"),
    (["--kv-layout", "pos", "--pallas-attn", "blocks16"],
     "--kv-layout pos needs --pallas-attn stream"),
    (["--fused-fast"], "--fused-fast needs an int8-quantized checkpoint"),
])
def test_cli_refuses_as_jax(flags, message):
    from fish_speech_tpu_torch.tools import api_server

    with pytest.raises(SystemExit, match=re.escape(message)):
        api_server.build_engine(api_server.parse_args(
            [*flags, "--device", "cpu"]))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_demo_clis_as_subprocesses(tmp_path):
    """`python -m fish_speech_tpu_torch.tools.api_server` in demo mode on
    the CPU answers health and one /v1/tts, then stops on SIGTERM;
    `tts_cli` writes a wav."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "fish_speech_tpu_torch.tools.api_server",
         "--device", "cpu", "--listen", "127.0.0.1:0",
         "--references-dir", str(tmp_path / "refs")],
        cwd=tmp_path, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"http://127\.0\.0\.1:(\d+), vocoder pallas$",
                      line.strip())
        assert m, line
        base = f"http://127.0.0.1:{m.group(1)}"
        with urllib.request.urlopen(base + "/v1/health", timeout=60) as r:
            assert json.loads(r.read())["status"] == "ok"
        req = urllib.request.Request(
            base + "/v1/tts", data=json.dumps({
                "text": "demo", "max_new_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read()
        assert body[:4] == b"RIFF"
        n = (len(body) - 44) // 2
        assert n > 0 and n % 128 == 0      # the demo codec's frame
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    out = tmp_path / "x.wav"
    cli = subprocess.run(
        [sys.executable, "-m", "fish_speech_tpu_torch.tools.tts_cli",
         "--device", "cpu", "--max-new-tokens", "4", "--output", str(out),
         "--output-dir", str(tmp_path / "codes")],
        cwd=tmp_path, env=_env(), check=True, timeout=120,
        capture_output=True, text=True)
    assert out.read_bytes()[:4] == b"RIFF"
    assert cli.stdout.splitlines()[0] == "vocoder pallas"
