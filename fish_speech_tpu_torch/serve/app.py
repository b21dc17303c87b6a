"""The HTTP server, on the standard library's ThreadingHTTPServer.

Counterpart of `fish_speech_tpu/serve/app.py` (aiohttp there), with the
same routes, status codes and bodies (ref tools/server/views.py:58-480):

  GET  /, /ui                     the web UI
  GET|POST /v1/health
  POST /v1/tts                    JSON or msgpack; wav, pcm, mp3, opus;
                                  buffered, or chunked (wav/pcm only)
  POST /v1/vqgan/encode           audio bytes -> RVQ codes (an LRU of 32)
  POST /v1/vqgan/decode           RVQ codes -> PCM f16 bytes
  POST /v1/references/add         save a voice reference
  GET  /v1/references/list
  POST /v1/references/update      rename one
  DELETE /v1/references/delete

Each connection has its own thread (HTTP/1.1, keep-alive). The device work
of a request runs on the app's executor: one worker without the
continuous-batching scheduler, so requests take turns on the device; four
with it, where the scheduler's thread interleaves their decode ticks. A body
is JSON unless its Content-Type is application/msgpack; a reply is msgpack
when the Accept header asks for it. Errors map as in the JAX app: 401 for a
missing or wrong Bearer token on /v1/*, 422 for a body that fails its
schema, 400 for a malformed body or a ValueError, 500 with the exception's
name for anything else, 413 above 256 MB. A streamed response is written
as Transfer-Encoding: chunked, the WAV header first; a client that goes
away (a write raising BrokenPipeError or ConnectionResetError) closes the
stream's generator, which cancels its decode slot.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import queue
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

import numpy as np

from ..engine.generate import GenerateLongRequest
from . import msgpack
from .references import ReferenceStore
from .schema import (
    AddReferenceRequest,
    ServeTTSRequest,
    ServeVQGANDecodeRequest,
    ServeVQGANEncodeRequest,
    UpdateReferenceRequest,
    ValidationError,
)
from .wav import decode_audio_bytes, encode_wav, float_to_pcm16, wav_chunk_header

log = logging.getLogger(__name__)

MAX_BODY = 256 * 1024 * 1024
_CLIENT_GONE = (BrokenPipeError, ConnectionResetError)


class HTTPError(Exception):
    """A plain-text error reply (aiohttp's HTTPException)."""

    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status, self.text = status, text


class Reply:
    def __init__(self, status: int = 200, body: bytes = b"",
                 content_type: str = "application/json; charset=utf-8",
                 headers: dict | None = None):
        self.status, self.body = status, body
        self.content_type = content_type
        self.headers = headers or {}


class Stream:
    """A chunked reply: `first` (the WAV header, or empty), then the bytes
    `chunks` yields; `on_gone()` is called when the client goes away or
    the stream fails."""

    def __init__(self, headers: dict, first: bytes, chunks, on_gone):
        self.headers, self.first = headers, first
        self.chunks, self.on_gone = chunks, on_gone


def _json_default(o):
    if isinstance(o, bytes):
        return base64.b64encode(o).decode()
    raise TypeError(f"unserializable: {type(o)}")


def json_reply(payload, status: int = 200) -> Reply:
    return Reply(status, json.dumps(payload, default=_json_default).encode())


class TTSApp:
    """The routes over a TTSEngine; transport-free (handle() takes the
    method, path, headers and body and returns a Reply or a Stream)."""

    def __init__(self, engine, ref_store: ReferenceStore | None = None,
                 api_key: str | None = None):
        self.engine = engine
        self.ref_store = ref_store
        self.api_key = api_key
        workers = 4 if getattr(engine, "scheduler", None) is not None else 1
        self.executor = ThreadPoolExecutor(max_workers=workers,
                                           thread_name_prefix="model-worker")
        # /v1/vqgan/encode LRU (audio-bytes sha256 -> tokens), shared by
        # the workers
        self._encode_cache: "OrderedDict[str, list]" = OrderedDict()
        self._encode_cache_cap = 32
        self._encode_cache_lock = threading.Lock()
        self.routes = {
            ("GET", "/"): self.webui, ("GET", "/ui"): self.webui,
            ("GET", "/v1/health"): self.health,
            ("POST", "/v1/health"): self.health,
            ("POST", "/v1/tts"): self.tts,
            ("POST", "/v1/vqgan/encode"): self.vqgan_encode,
            ("POST", "/v1/vqgan/decode"): self.vqgan_decode,
            ("POST", "/v1/references/add"): self.references_add,
            ("GET", "/v1/references/list"): self.references_list,
            ("POST", "/v1/references/update"): self.references_update,
            ("DELETE", "/v1/references/delete"): self.references_delete,
        }

    def close(self) -> None:
        self.executor.shutdown(wait=False, cancel_futures=True)

    def _run(self, fn, *args):
        return self.executor.submit(fn, *args).result()

    # -- dispatch ------------------------------------------------------------
    def handle(self, method: str, path: str, headers, body: bytes):
        if self.api_key is not None and path.startswith("/v1/"):
            if headers.get("Authorization", "") != f"Bearer {self.api_key}":
                return json_reply({"error": "Invalid token"}, 401)
        route = self.routes.get((method, path))
        if route is None:
            if any(p == path for _, p in self.routes):
                return Reply(405, b"405: Method Not Allowed",
                             "text/plain; charset=utf-8")
            return Reply(404, b"404: Not Found", "text/plain; charset=utf-8")
        try:
            return route(headers, body)
        except HTTPError as e:
            return Reply(e.status, e.text.encode(),
                         "text/plain; charset=utf-8")
        except ValidationError as e:
            return json_reply({"error": "validation error",
                               "detail": e.errors()}, 422)
        except ValueError as e:
            # json's, msgpack's and the engine's own ValueErrors alike
            return json_reply({"error": "malformed request body",
                               "detail": str(e)}, 400)
        except Exception as e:  # noqa: BLE001 - the server keeps serving
            log.exception("%s %s failed", method, path)
            return json_reply({"error": type(e).__name__, "detail": str(e)},
                              500)

    @staticmethod
    def _parse(headers, body: bytes, model_cls):
        ctype = headers.get("Content-Type", "").split(";")[0].strip().lower()
        data = (msgpack.unpackb(body) if ctype == "application/msgpack"
                else json.loads(body))
        return model_cls.from_dict(data)

    @staticmethod
    def _respond(headers, payload: dict) -> Reply:
        if "application/msgpack" in headers.get("Accept", "application/json"):
            return Reply(200, msgpack.packb(payload), "application/msgpack")
        return json_reply(payload)

    # -- routes --------------------------------------------------------------
    def health(self, headers, body) -> Reply:
        return self._respond(headers, {"status": "ok"})

    def webui(self, headers, body) -> Reply:
        from .webui import WEBUI_HTML

        return Reply(200, WEBUI_HTML.encode(), "text/html; charset=utf-8")

    def vqgan_encode(self, headers, body) -> Reply:
        req = self._parse(headers, body, ServeVQGANEncodeRequest)

        def work():
            # LRU on the raw audio bytes (ref tools/server/model_utils.py:
            # 51-66)
            tokens = []
            for audio in req.audios:
                key = hashlib.sha256(audio).hexdigest()
                with self._encode_cache_lock:
                    hit = self._encode_cache.get(key)
                    if hit is not None:
                        self._encode_cache.move_to_end(key)
                if hit is not None:
                    tokens.append(hit)
                    continue
                wav = decode_audio_bytes(audio,
                                         self.engine.codec_cfg.sample_rate)
                t = self.engine.encode_reference(wav).tolist()
                with self._encode_cache_lock:
                    self._encode_cache[key] = t
                    while len(self._encode_cache) > self._encode_cache_cap:
                        self._encode_cache.popitem(last=False)
                tokens.append(t)
            return tokens

        return self._respond(headers, {"tokens": self._run(work)})

    def vqgan_decode(self, headers, body) -> Reply:
        req = self._parse(headers, body, ServeVQGANDecodeRequest)

        def work():
            # groups of up to 8 sequences a vocoder call (ref
            # tools/server/model_utils.py:69-86 batch_vqgan_decode)
            codes = [np.asarray(c, dtype=np.int32) for c in req.tokens]
            wavs = self.engine.decode_codes_batch(codes)
            return [np.asarray(w, dtype=np.float16).tobytes() for w in wavs]

        return self._respond(headers, {"audios": self._run(work)})

    def _inline_encode(self, audio_bytes: bytes) -> np.ndarray:
        wav = decode_audio_bytes(audio_bytes,
                                 self.engine.codec_cfg.sample_rate)
        return self.engine.encode_reference(wav)

    def tts(self, headers, body):
        req = self._parse(headers, body, ServeTTSRequest)
        engine = self.engine
        sample_rate = (engine.codec_cfg.sample_rate if engine.codec_cfg
                       else 44100)
        prompt_text = prompt_tokens = None
        if req.reference_id and self.ref_store is not None:
            loaded = self._run(self.ref_store.load_by_id, req.reference_id,
                               req.use_memory_cache == "on")
            prompt_text, prompt_tokens = loaded.texts, loaded.codes_list
        elif req.references:
            prompt_text, prompt_tokens = [], []
            encode = (self.ref_store.encode_inline if self.ref_store
                      else self._inline_encode)
            for ref in req.references:
                prompt_text.append(ref.text)
                prompt_tokens.append(self._run(encode, ref.audio))
        text = req.text
        if req.normalize:
            from ..text.clean import clean_text

            text = clean_text(text)
        gen_req = GenerateLongRequest(
            text=text, max_new_tokens=req.max_new_tokens, top_p=req.top_p,
            temperature=req.temperature, chunk_length=req.chunk_length,
            prompt_text=prompt_text, prompt_tokens=prompt_tokens,
            seed=req.seed if req.seed is not None else 42)

        if req.streaming and req.format not in ("wav", "pcm"):
            # mp3/opus need whole-signal encoder state (ref views.py:167-171)
            raise HTTPError(400, "Streaming only supports wav/pcm formats")
        if req.streaming:
            return self._stream(gen_req, req.format, sample_rate)

        wav = self._run(engine.tts, gen_req)
        if req.format == "pcm":
            return Reply(200, float_to_pcm16(wav), "application/octet-stream")
        if req.format == "mp3":
            from .audio_codecs import encode_mp3, mp3_available

            if not mp3_available():
                raise HTTPError(400, "mp3 unavailable (libmp3lame not found)")
            return Reply(200, self._run(encode_mp3, wav, sample_rate),
                         "audio/mpeg")
        if req.format == "opus":
            from .audio_codecs import encode_opus, opus_available

            if not opus_available():
                raise HTTPError(400, "opus unavailable (libopus not found)")
            return Reply(200, self._run(encode_opus, wav, sample_rate),
                         "audio/ogg")
        return Reply(200, encode_wav(wav, sample_rate), "audio/wav")

    def _stream(self, gen_req: GenerateLongRequest, fmt: str,
                sample_rate: int) -> Stream:
        """The producer runs on the executor and hands PCM chunks over a
        queue: through `stream_tts` with the scheduler, else one chunk per
        `generate_long` segment. `on_gone` stops it at its next chunk, and
        its `finally` closes the generator (cancelling the decode slot)."""
        engine = self.engine
        out: queue.Queue = queue.Queue()
        client_gone = threading.Event()
        done = object()

        def produce():
            if engine.scheduler is not None:
                gen = engine.stream_tts(gen_req)
                emit = iter(gen)
            else:
                gen = engine.generate_long(gen_req)
                emit = (engine.decode_codes(r.codes) for r in gen
                        if r.action == "sample")
            try:
                for item in emit:
                    if client_gone.is_set():
                        return
                    out.put(float_to_pcm16(item))
                out.put(done)
            except Exception as e:  # noqa: BLE001 - raised by the reader
                out.put(e)
            finally:
                gen.close()

        self.executor.submit(produce)

        def chunks():
            while True:
                item = out.get()
                if item is done:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item

        return Stream(
            headers={"Content-Type": "audio/wav" if fmt == "wav"
                     else "application/octet-stream",
                     "Content-Disposition": "attachment; filename=audio.wav"},
            first=wav_chunk_header(sample_rate=sample_rate)
            if fmt == "wav" else b"",
            chunks=chunks(), on_gone=client_gone.set)

    def references_add(self, headers, body) -> Reply:
        req = self._parse(headers, body, AddReferenceRequest)
        if self.ref_store is None:
            return json_reply({"success": False,
                               "message": "no reference store"}, 500)
        self._run(self.ref_store.add, req.id, req.audio, req.text)
        return self._respond(headers, {"success": True,
                                       "message": "Reference added",
                                       "reference_id": req.id})

    def references_list(self, headers, body) -> Reply:
        ids = self.ref_store.list_ids() if self.ref_store else []
        return self._respond(headers, {"success": True,
                                       "reference_ids": ids,
                                       "message": "Success"})

    def references_update(self, headers, body) -> Reply:
        try:
            req = self._parse(headers, body, UpdateReferenceRequest)
        except Exception as e:  # noqa: BLE001 - the JAX app's 400 here
            return json_reply({"success": False,
                               "message": f"bad request: {e}"}, 400)
        old_id, new_id = req.old_reference_id, req.new_reference_id
        if self.ref_store is None:
            return json_reply({"success": False,
                               "message": "no reference store"}, 500)
        if not self.ref_store.rename(old_id, new_id):
            return self._respond(headers, {
                "success": False, "message": "Reference not found",
                "old_reference_id": old_id, "new_reference_id": new_id})
        return self._respond(headers, {
            "success": True, "message": "Reference renamed",
            "old_reference_id": old_id, "new_reference_id": new_id})

    def references_delete(self, headers, body) -> Reply:
        try:
            data = json.loads(body)
            ref_id = (data["reference_id"] if isinstance(data, dict)
                      else str(data))
        except Exception:  # noqa: BLE001 - a bare id in the body
            ref_id = body.decode(errors="replace").strip('"')
        ok = self.ref_store.delete(ref_id) if self.ref_store else False
        return self._respond(headers, {
            "success": ok,
            "message": "Reference deleted" if ok else "Reference not found",
            "reference_id": ref_id})


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    app: TTSApp          # set on the server's subclass

    def log_message(self, fmt, *args):
        log.info("%s - %s", self.address_string(), fmt % args)

    def _body(self) -> bytes | None:
        """The request body, or None after a 413 reply (too large) or a 400
        (a chunk size or Content-Length that is not a number)."""
        try:
            if self.headers.get("Transfer-Encoding", "").lower() == "chunked":
                parts, total = [], 0
                while True:
                    size = int(self.rfile.readline().split(b";")[0].strip(),
                               16)
                    if size == 0:
                        while self.rfile.readline() not in (b"\r\n", b"\n",
                                                            b""):
                            pass
                        return b"".join(parts)
                    total += size
                    if total > MAX_BODY:
                        break
                    parts.append(self.rfile.read(size))
                    self.rfile.readline()
            else:
                n = int(self.headers.get("Content-Length") or 0)
                if n <= MAX_BODY:
                    return self.rfile.read(n)
            reply = Reply(413, b"413: Request Entity Too Large",
                          "text/plain; charset=utf-8")
        except ValueError as e:
            reply = json_reply({"error": "malformed request body",
                                "detail": str(e)}, 400)
        self.close_connection = True
        self._send(reply)
        return None

    def _send(self, reply: Reply) -> None:
        self.send_response(reply.status)
        self.send_header("Content-Type", reply.content_type)
        self.send_header("Content-Length", str(len(reply.body)))
        for k, v in reply.headers.items():
            self.send_header(k, v)
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(reply.body)

    def _send_stream(self, s: Stream) -> None:
        self.send_response(200)
        for k, v in s.headers.items():
            self.send_header(k, v)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            if s.first:
                self._chunk(s.first)
            for c in s.chunks:
                if c:
                    self._chunk(c)
            self.wfile.write(b"0\r\n\r\n")
        except _CLIENT_GONE:
            s.on_gone()
            self.close_connection = True
        except Exception:  # noqa: BLE001 - headers are out: cut the stream
            log.exception("stream failed")
            s.on_gone()
            self.close_connection = True

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))

    def _dispatch(self, method: str) -> None:
        try:
            body = self._body()
            if body is None:
                return
            path = urlsplit(self.path).path
            reply = self.app.handle(method, path, self.headers, body)
            if isinstance(reply, Stream):
                self._send_stream(reply)
            else:
                self._send(reply)
        except _CLIENT_GONE:
            self.close_connection = True

    def do_GET(self):
        self._dispatch("GET")

    def do_HEAD(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")


def create_app(engine, ref_dir: str | None = None,
               api_key: str | None = None) -> TTSApp:
    store = None
    if ref_dir is not None and engine.codec_params is not None:
        store = ReferenceStore(ref_dir, engine.encode_reference,
                               engine.codec_cfg.sample_rate)
    return TTSApp(engine, store, api_key)


def create_server(engine, host: str = "127.0.0.1", port: int = 8080,
                  ref_dir: str | None = None,
                  api_key: str | None = None) -> ThreadingHTTPServer:
    """A bound server for `engine` (port 0: any free port, read it from
    `server.server_address`); run it with `serve_forever()`, stop it with
    `shutdown()` then `server_close()`. The app is `server.app`."""
    app = create_app(engine, ref_dir=ref_dir, api_key=api_key)
    handler = type("Handler", (_Handler,), {"app": app})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    server.app = app
    return server
