"""Long-text generation and the end-to-end TTS engine.

Counterpart of `fish_speech_tpu/engine/generate.py`: speaker-tag
splitting, byte/speaker-bounded batching, a system prompt carrying the
voice-cloning reference, per-batch conversation growth, the decode loop of
models/decode.py or the continuous-batching scheduler of
engine/scheduler.py, the fused vocoder of codec/fastpath.py (whole and
batched decodes), the streaming vocoder of codec/streaming.py
(`stream_tts`) and the codec's encoder (`encode_reference`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import queue
import re
import threading
import time
from dataclasses import dataclass
from typing import Iterator, Literal

import numpy as np
import torch

from ..codec.config import DACConfig, s2_pro_codec_config
from ..device import resolve_device
from ..models.config import DualARConfig, apply_pallas_attn_mode, s2_pro_lm_config
from ..models.decode import SamplingConfig, generate
from ..ops.sampling import semantic_logit_bias
from ..text.content import TextPart, VQPart
from ..text.conversation import Conversation, Message
from ..text.tokenizer import IM_END_TOKEN, ByteTokenizer


VOCODER_IMPLS = ("auto", "pallas", "lax", "mm")


def split_text_by_speaker(text: str) -> list[str]:
    """Split into turns on <|speaker:N|> tags."""
    pattern = r"(<\|speaker:\d+\|>)"
    parts = re.split(pattern, text)
    turns = []
    i = 0
    while i < len(parts):
        part = parts[i].strip()
        if re.match(pattern, part):
            if i + 1 < len(parts):
                turns.append((part + parts[i + 1]).strip())
                i += 2
            else:
                turns.append(part)
                i += 1
        else:
            i += 1
    return turns


def group_turns_into_batches(turns: list[str], max_speakers: int = 5,
                             max_bytes: int = 300) -> list[str]:
    """Group turns under byte/speaker limits."""
    batches, current, current_bytes = [], [], 0
    for turn in turns:
        turn_bytes = len(turn.encode("utf-8"))
        if len(current) >= max_speakers or (current_bytes + turn_bytes
                                            > max_bytes and current):
            batches.append("\n".join(current))
            current, current_bytes = [turn], turn_bytes
        else:
            current.append(turn)
            current_bytes += turn_bytes
    if current:
        batches.append("\n".join(current))
    return batches


@dataclass
class GenerateLongRequest:
    text: str
    max_new_tokens: int = 0          # 0 = up to the cache length
    top_p: float = 0.9
    top_k: int = 30
    temperature: float = 1.0
    chunk_length: int = 300          # max bytes per batch
    prompt_text: list[str] | None = None          # voice-clone reference text
    prompt_tokens: list[np.ndarray] | None = None  # (K, T) codes per reference
    seed: int = 42


@dataclass
class GenerateResponse:
    action: Literal["sample", "next"]
    codes: np.ndarray | None = None   # (K, T)
    text: str | None = None
    tokens_generated: int = 0
    wall_s: float = 0.0


def build_base_conversation(prompt_text: list[str] | None,
                            prompt_tokens: list[np.ndarray] | None
                            ) -> Conversation:
    """System message, optionally with the voice-cloning reference."""
    conv = Conversation()
    if prompt_text and prompt_tokens:
        tagged = []
        for i, t in enumerate(prompt_text):
            if not re.search(r"<\|speaker:\d+\|>", t):
                tagged.append(f"<|speaker:{i}|>{t}")
            else:
                tagged.append(t)
        parts = [
            TextPart(text="convert the provided text to speech reference to "
                          "the following:\n\nText:\n"),
            TextPart(text="\n".join(tagged)),
            TextPart(text="\n\nSpeech:\n"),
            VQPart(codes=np.concatenate(prompt_tokens, axis=1)),
        ]
    else:
        parts = [TextPart(text="convert the provided text to speech")]
    conv.append(Message(role="system", parts=parts, add_im_start=True,
                        add_im_end=True))
    return conv


class TTSEngine:
    """text -> codes -> waveform on one device.

    With `scheduler_slots > 0`, generation goes through the
    continuous-batching scheduler (engine/scheduler.py): calls from
    different threads share decode ticks instead of taking turns, each
    segment's system prompt is prefilled once and then copied from the
    prefix cache, prompts longer than `prefill_chunk` prefill a chunk at a
    time between ticks, and a tick runs `scheduler_chunk` decode steps per
    read-back while no request waits. `close()` stops the scheduler's
    thread. `vocoder_impl` selects the serving vocoder (`_vocode`): "pallas"
    (the fused kernels #3/#4, the default), "lax", "mm", or "auto" (the
    faster of "pallas" and "lax", probed at construction).

    multihost=True (with scheduler_slots, in a torch.distributed world of
    lockstep replicas, serve/multihost.py): on rank 0 the scheduler is a
    `MultihostSchedulerThread` that broadcasts its plans; on the other
    ranks the batcher is `follower_batcher`, for `run_follower_loop`.
    Chunked prefill is off there, as in JAX: plans do not carry it."""

    def __init__(self, params: dict, cfg: DualARConfig, tokenizer,
                 codec_params: dict | None = None,
                 codec_cfg: DACConfig | None = None,
                 cache_len: int | None = None, device=None,
                 voc_quant: bool | None = None, scheduler_slots: int = 0,
                 scheduler_chunk: int = 1, prefill_chunk: int | None = None,
                 vocoder_impl: str = "pallas", multihost: bool = False):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.codec_params = codec_params
        self.codec_cfg = codec_cfg
        self.cache_len = cache_len or cfg.max_seq_len
        self.im_end_id = tokenizer.get_token_id(IM_END_TOKEN)
        self._bias = semantic_logit_bias(
            cfg.vocab_size, cfg.semantic_begin_id, cfg.semantic_end_id,
            self.im_end_id, device=self.device)
        self.packed_decoder = None
        self.vocoder_impl = None
        # stream-step widths already run once in this engine (stream_tts
        # warms each width once, not per request)
        self._stream_warm_widths: set[int] = set()
        if codec_params is not None:
            if vocoder_impl not in VOCODER_IMPLS:
                raise ValueError(f"unknown vocoder impl: {vocoder_impl!r}")
            if vocoder_impl in ("pallas", "auto"):
                from ..codec.fastpath import pack_decoder

                dtype = (torch.bfloat16 if self.device.type == "cuda"
                         else torch.float32)
                self.packed_decoder = pack_decoder(codec_params["decoder"],
                                                    codec_cfg, dtype=dtype,
                                                    quant=voc_quant)
            self.vocoder_impl = (self._select_vocoder_impl()
                                 if vocoder_impl == "auto" else vocoder_impl)
        self.scheduler = None
        self._next_request_id = 0
        self._id_lock = threading.Lock()
        self.follower_batcher = None
        if multihost and scheduler_slots <= 0:
            raise ValueError("multihost serving needs scheduler_slots > 0")
        if scheduler_slots > 0:
            from .scheduler import ContinuousBatcher, SchedulerThread

            batcher = ContinuousBatcher(
                params, cfg, num_slots=scheduler_slots,
                cache_len=self.cache_len, im_end_id=self.im_end_id,
                bias=self._bias,
                prefill_chunk=None if multihost else prefill_chunk,
                device=self.device)
            if not multihost:
                self.scheduler = SchedulerThread(batcher,
                                                 chunk_steps=scheduler_chunk)
            else:
                import torch.distributed as dist

                if dist.get_rank() == 0:
                    from ..serve.multihost import MultihostSchedulerThread

                    self.scheduler = MultihostSchedulerThread(
                        batcher, chunk_steps=scheduler_chunk)
                else:
                    self.follower_batcher = batcher

    def close(self) -> None:
        """Stop the scheduler's thread (no-op without one)."""
        if self.scheduler is not None:
            self.scheduler.stop()

    def _vocode(self, codes: torch.Tensor, impl: str | None = None
                ) -> torch.Tensor:
        """Codes (B, K+1, T) -> waveform (B, T * frame_length) through the
        serving vocoder: "pallas" the fused kernels (#3/#4), "lax" the
        plain f32 decoder of codec/model.py, "mm" the matmul decoder of
        codec/fastpath.py (the JAX `--vocoder-impl` names)."""
        impl = impl or self.vocoder_impl
        if impl == "pallas":
            from ..codec.fastpath import dac_from_indices_fused

            return dac_from_indices_fused(
                self.codec_params, self.codec_cfg, codes,
                packed=self.packed_decoder, device=self.device)
        codes = codes.to(self.device)
        if impl == "mm":
            from ..codec.fastpath import dac_from_indices_mm

            return dac_from_indices_mm(self.codec_params, self.codec_cfg,
                                       codes)
        from ..codec.model import dac_from_indices

        return dac_from_indices(self.codec_params, self.codec_cfg, codes)

    def _select_vocoder_impl(self, probe_frames: int = 64) -> str:
        """"auto": the faster of "pallas" and "lax" in steady state
        (utils/probing.py), logged. A candidate that raises (a kernel that
        does not build or launch) fails the engine: the probe never falls
        back past an error. On the card "auto" serves the fused kernels or
        nothing: if the plain decoder wins, it raises and names the times,
        and the caller has to ask for "lax" by name."""
        from ..utils.probing import steady_state_winner

        n_q = self.codec_cfg.rvq.total_codebooks
        codes = torch.zeros((1, n_q, probe_frames), dtype=torch.int64)

        def candidate(impl):
            def call():
                try:
                    self._vocode(codes, impl)[0, -1].item()
                except Exception as e:
                    raise RuntimeError(f"vocoder impl {impl!r} failed while "
                                       "probing") from e
            return call

        winner, times = steady_state_winner(
            {impl: candidate(impl) for impl in ("pallas", "lax")})
        took = ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        if self.device.type == "cuda" and winner != "pallas":
            raise RuntimeError(
                f"vocoder_impl='auto': the plain decoder beat the fused "
                f"kernels #3/#4 at {probe_frames} frames (s a call: {took}); "
                "ask for vocoder_impl='lax' by name to serve it")
        logging.getLogger(__name__).info("vocoder impl %s (s a call: %s)",
                                         winner, took)
        return winner

    def _system_prefix(self, conversation: Conversation) -> tuple[str, int]:
        """(prefix_id, prefix_len) of the shared system prompt: the
        scheduler's prefix cache keys its rows by this hash."""
        sys_encoded = conversation.encode_for_inference(
            self.tokenizer, num_codebooks=self.cfg.num_codebooks)
        pid = hashlib.sha256(np.ascontiguousarray(
            sys_encoded).tobytes()).hexdigest()[:16]
        return pid, sys_encoded.shape[1]

    def _generate_codes(self, padded: np.ndarray, start: int, max_new: int,
                        req: GenerateLongRequest,
                        gen: torch.Generator, *, prefix_id: str | None = None,
                        prefix_len: int = 0) -> np.ndarray:
        """One segment: (K+1, Tpad) left-padded prompt -> (K+1, n) codes.
        On the scheduler path the request carries the prompt's unpadded
        columns and its own sampling parameters (the scheduler draws from
        its own generator)."""
        if self.scheduler is not None:
            from .scheduler import SlotRequest, stack_columns

            with self._id_lock:
                self._next_request_id += 1
                rid = self._next_request_id
            slot_req = SlotRequest(
                request_id=rid, prompt=padded[:, start:].astype(np.int32),
                max_new_tokens=max_new, temperature=req.temperature,
                top_p=req.top_p, top_k=req.top_k, prefix_id=prefix_id,
                prefix_len=prefix_len)
            self.scheduler.submit(slot_req)
            if not slot_req.done.wait(timeout=3600):
                raise TimeoutError("scheduler request timed out")
            if slot_req.error is not None:
                raise slot_req.error
            return stack_columns(slot_req.result, padded.shape[0])
        sampling = SamplingConfig.create(req.temperature, req.top_p)
        codes, lengths = generate(
            self.params, self.cfg, torch.from_numpy(padded)[None],
            torch.tensor([start], dtype=torch.int32), gen, sampling,
            self._bias, max_new_tokens=max_new, im_end_id=self.im_end_id,
            top_k=req.top_k, cache_len=self.cache_len, device=self.device)
        n_valid = int(lengths[0])
        return codes[0, :, :n_valid].cpu().numpy()

    def decode_codes(self, codes: np.ndarray) -> np.ndarray:
        """(K, n) codes -> (n * frame_length,) f32 waveform through the
        serving vocoder. The frame count is bucketed to a multiple of 64
        (at least 32), JAX's bucket rule. The bf16 decoder is causal, so
        the right padding never changes the prefix; the int8 decoder
        (VOC_QUANT) takes one activation scale per time tile, and a tile
        that straddles the padding sees the padded rows, so there the
        padding does change the prefix's last tiles, as it does in JAX
        with the same buckets and tiles."""
        if self.codec_params is None:
            raise RuntimeError("no codec attached")
        n = codes.shape[1]
        bucket = max(32, -(-n // 64) * 64)
        padded = np.zeros((codes.shape[0], bucket), dtype=np.int64)
        padded[:, :n] = codes
        wav = self._vocode(torch.from_numpy(padded)[None])
        fl = self.codec_cfg.frame_length
        return wav[0, :n * fl].float().cpu().numpy()

    def decode_codes_batch(self, codes_list: list[np.ndarray],
                           micro_batch: int = 8) -> list[np.ndarray]:
        """Many (K, T_i) code sequences -> their waveforms, in groups of
        `micro_batch` in submission order: a group is padded with zero
        codes to its longest item's frame bucket (`decode_codes`'s rule)
        and to a power-of-two batch, and decoded by one call of the serving
        vocoder."""
        if self.codec_params is None:
            raise RuntimeError("no codec attached")
        fl = self.codec_cfg.frame_length
        out: list[np.ndarray] = []
        for lo in range(0, len(codes_list), micro_batch):
            group = codes_list[lo:lo + micro_batch]
            lens = [c.shape[1] for c in group]
            bucket = max(32, -(-max(lens) // 64) * 64)
            bb = 1
            while bb < len(group):
                bb *= 2
            padded = np.zeros((bb, group[0].shape[0], bucket), np.int64)
            for i, c in enumerate(group):
                padded[i, :, :c.shape[1]] = c
            wav = self._vocode(torch.from_numpy(padded)).float().cpu().numpy()
            out.extend(wav[i, :n * fl] for i, n in enumerate(lens))
        return out

    def encode_reference(self, wav: np.ndarray) -> np.ndarray:
        """A reference waveform (n,) -> its (K, ceil(n / frame_length))
        codes. The samples are zero-padded to a bucket of max(32,
        ceil(frames / 64) * 64) frames, JAX's rule (the encoder is causal:
        the padding changes no earlier code)."""
        from ..codec.model import dac_encode

        if self.codec_params is None:
            raise RuntimeError("no codec attached")
        fl = self.codec_cfg.frame_length
        n_frames = -(-len(wav) // fl)
        bucket = max(32, -(-n_frames // 64) * 64)
        padded = np.zeros(bucket * fl, dtype=np.float32)
        padded[:len(wav)] = wav
        res = dac_encode(self.codec_params, self.codec_cfg,
                         torch.from_numpy(padded)[None], device=self.device)
        return res.codes[0, :, :n_frames].cpu().numpy()

    def warmup_vocoder(self, buckets=((1, 32), (8, 64)),
                       stream_widths=(4, 16)) -> None:
        """Run the serving vocoder twice on each (batch, frames) bucket and,
        with the scheduler, the stream step once at each width, so that no
        request pays the first use (the kernels' nvcc build, cuDNN's
        planning of the stream step's convs)."""
        from ..codec.streaming import StatefulVocoder, init_vocoder_state

        if self.codec_params is None:
            raise RuntimeError("no codec attached")
        n_q = self.codec_cfg.rvq.total_codebooks
        for bb, frames in buckets:
            codes = torch.zeros((bb, n_q, frames), dtype=torch.int64)
            for _ in range(2):
                self._vocode(codes)
        if self.scheduler is not None and stream_widths:
            voc = StatefulVocoder(self.codec_params, self.codec_cfg,
                                  chunk_frames=max(stream_widths),
                                  device=self.device)
            for w in sorted(set(stream_widths)):
                st = init_vocoder_state(self.codec_params, self.codec_cfg,
                                        device=self.device)
                voc.step(st, torch.zeros((1, n_q, w), dtype=torch.int64))
                self._stream_warm_widths.add(w)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate_long(self, req: GenerateLongRequest
                      ) -> Iterator[GenerateResponse]:
        cfg = self.cfg
        max_length = self.cache_len
        conversation = build_base_conversation(req.prompt_text,
                                               req.prompt_tokens)
        turns = split_text_by_speaker(req.text)
        batches = (group_turns_into_batches(turns, max_speakers=5,
                                            max_bytes=req.chunk_length)
                   if turns else [req.text])
        gen = torch.Generator(device=self.device).manual_seed(req.seed)
        # the system prompt is the same for every segment: on the scheduler
        # path it is marked as a prefix, prefilled once per reference
        prefix_id, prefix_len = (self._system_prefix(conversation)
                                 if self.scheduler is not None else (None, 0))

        for batch_text in batches:
            conversation.append(Message(
                role="user", parts=[TextPart(text=batch_text)],
                add_im_start=True, add_im_end=True))
            conv_gen = conversation.copy()
            conv_gen.append(Message(role="assistant", parts=[],
                                    modality="voice", add_im_start=True,
                                    add_im_end=False))
            encoded = conv_gen.encode_for_inference(
                self.tokenizer, num_codebooks=cfg.num_codebooks)
            prompt_len = encoded.shape[1]
            if prompt_len > max_length - 2048 and max_length > 4096:
                raise ValueError(
                    f"Prompt is too long: {prompt_len} > {max_length - 2048}")
            # left-pad to a bucket of 256 (at least 64), as the JAX engine
            # does to reuse its compiled programs
            bucket = max(64, -(-prompt_len // 256) * 256)
            bucket = min(bucket, max_length - 64)
            padded = np.zeros((encoded.shape[0], bucket), dtype=np.int64)
            padded[:, bucket - prompt_len:] = encoded[:, :prompt_len]
            start = bucket - prompt_len

            max_new = self.cache_len - bucket
            if req.max_new_tokens:
                max_new = min(max_new, req.max_new_tokens)
            t0 = time.perf_counter()
            full = self._generate_codes(padded, start, max_new, req, gen,
                                        prefix_id=prefix_id,
                                        prefix_len=prefix_len)
            n_valid = full.shape[1]
            wall = time.perf_counter() - t0

            codes = full[1:, :n_valid]
            if (codes < 0).any():
                raise RuntimeError("negative code generated")
            conversation.append(Message(
                role="assistant", parts=[VQPart(codes=codes)],
                modality="voice", add_im_start=True, add_im_end=True))
            yield GenerateResponse(action="sample", codes=codes,
                                   text=batch_text,
                                   tokens_generated=n_valid + 1, wall_s=wall)
        yield GenerateResponse(action="next")

    def tts(self, req: GenerateLongRequest) -> np.ndarray:
        """Full text -> waveform (concatenated over batches)."""
        return self.tts_with_codes(req)[0]

    def tts_with_codes(self, req: GenerateLongRequest
                       ) -> tuple[np.ndarray, np.ndarray, float]:
        """`tts` that also returns the (K, n) codes and the seconds spent
        generating them (the rest of the wall time is the vocoder)."""
        segs = [r for r in self.generate_long(req) if r.action == "sample"]
        codes = np.concatenate([r.codes for r in segs], axis=1)
        return self.decode_codes(codes), codes, sum(r.wall_s for r in segs)

    def stream_tts(self, req: GenerateLongRequest, chunk_frames: int = 16,
                   first_chunk_frames: int | None = 4
                   ) -> Iterator[np.ndarray]:
        """Yield waveform chunks while the codes are still being decoded.

        Needs the scheduler and a codec. Each segment goes to the scheduler
        as a request whose `on_token` hook hands its code columns over as
        they are sampled (the system prompt marked as a shared prefix, as
        in `generate_long`); every `chunk_frames` frames go to a vocoder
        thread that runs the stateful streaming vocoder, so the first audio
        comes after the prefill and one chunk of decoding. The first chunk
        is cut at `first_chunk_frames` (None, or not below chunk_frames:
        no smaller first cut). The chunks concatenate to the decode of the
        whole stream's codes. The vocoder thread first runs the stream step
        once at each width not yet run in this engine, while the prompt
        prefills; its errors, that warm start's too, reach the caller
        through this generator. Closing the generator early cancels the
        request's slot."""
        from ..codec.streaming import StatefulVocoder, init_vocoder_state
        from .scheduler import SlotRequest

        if self.scheduler is None:
            raise RuntimeError("stream_tts needs the scheduler "
                               "(scheduler_slots > 0)")
        if self.codec_params is None:
            raise RuntimeError("no codec attached")
        conversation = build_base_conversation(req.prompt_text,
                                               req.prompt_tokens)
        turns = split_text_by_speaker(req.text)
        batches = (group_turns_into_batches(turns, max_speakers=5,
                                            max_bytes=req.chunk_length)
                   if turns else [req.text])
        prefix_id, prefix_len = self._system_prefix(conversation)
        vocoder = StatefulVocoder(self.codec_params, self.codec_cfg,
                                  chunk_frames=chunk_frames,
                                  device=self.device)
        first = (first_chunk_frames if first_chunk_frames
                 and first_chunk_frames < chunk_frames else None)
        if first:
            vocoder.chunk = first          # back to chunk_frames after it
        done_mark = object()
        voc_in: queue.Queue = queue.Queue()
        voc_out: queue.Queue = queue.Queue()
        n_q = self.codec_cfg.rvq.total_codebooks

        def voc_worker():
            try:
                todo = [w for w in sorted({first or chunk_frames,
                                           chunk_frames})
                        if w not in self._stream_warm_widths]
                if todo:
                    st0 = init_vocoder_state(self.codec_params,
                                             self.codec_cfg,
                                             device=self.device)
                    for w in todo:
                        vocoder.step(st0, torch.zeros((1, n_q, w),
                                                      dtype=torch.int64))
                        self._stream_warm_widths.add(w)
                while True:
                    item = voc_in.get()
                    if item is None:
                        for w in vocoder.feed(final=True):
                            voc_out.put(w)
                        break
                    for w in vocoder.feed(item):
                        voc_out.put(w)
                        vocoder.chunk = chunk_frames   # the first cut is done
            except Exception as e:  # noqa: BLE001 - raised by the generator
                voc_out.put(e)
            voc_out.put(done_mark)

        def ready():
            """The audio the vocoder thread has ready, without waiting."""
            while True:
                try:
                    w = voc_out.get_nowait()
                except queue.Empty:
                    return
                if isinstance(w, Exception):
                    raise w
                yield w

        worker = threading.Thread(target=voc_worker, daemon=True)
        worker.start()
        slot_req = None
        try:
            for batch_text in batches:
                conversation.append(Message(
                    role="user", parts=[TextPart(text=batch_text)],
                    add_im_start=True, add_im_end=True))
                conv_gen = conversation.copy()
                conv_gen.append(Message(role="assistant", parts=[],
                                        modality="voice", add_im_start=True,
                                        add_im_end=False))
                encoded = conv_gen.encode_for_inference(
                    self.tokenizer, num_codebooks=self.cfg.num_codebooks)
                cols: queue.Queue = queue.Queue()
                with self._id_lock:
                    self._next_request_id += 1
                    rid = self._next_request_id
                max_new = req.max_new_tokens or (self.cache_len
                                                 - encoded.shape[1] - 1)
                slot_req = SlotRequest(
                    request_id=rid, prompt=encoded.astype(np.int32),
                    max_new_tokens=max_new, temperature=req.temperature,
                    top_p=req.top_p, top_k=req.top_k, prefix_id=prefix_id,
                    prefix_len=prefix_len,
                    on_token=lambda _rid, col: cols.put(col))
                self.scheduler.submit(slot_req)
                pending: list[np.ndarray] = []
                send_at = first or chunk_frames
                done = False
                while not done or not cols.empty():
                    try:
                        pending.append(cols.get(timeout=0.05)[1:])
                    except queue.Empty:
                        done = slot_req.done.is_set()
                    if len(pending) >= send_at:
                        voc_in.put(np.stack(pending, axis=1))
                        pending = []
                        send_at = chunk_frames
                    yield from ready()
                    done = done or slot_req.done.is_set()
                if slot_req.error is not None:
                    raise slot_req.error
                if pending:
                    voc_in.put(np.stack(pending, axis=1))
                # the segment's codes grow the conversation, as in
                # generate_long
                if slot_req.result:
                    seg = np.stack(slot_req.result, axis=1)[1:]
                    conversation.append(Message(
                        role="assistant", parts=[VQPart(codes=seg)],
                        modality="voice", add_im_start=True,
                        add_im_end=True))
            voc_in.put(None)                   # flush the vocoder's tail
            while True:
                w = voc_out.get()
                if w is done_mark:
                    break
                if isinstance(w, Exception):
                    raise w
                yield w
            worker.join(timeout=60)
        finally:
            if slot_req is not None and not slot_req.done.is_set():
                # an abandoned stream frees its decode slot at once
                slot_req.cancel()
            if worker.is_alive():
                voc_in.put(None)


def serving_config(cfg: DualARConfig, kv_fold: bool = False, *,
                   kv_layout: str = "pos", kv_cache: str = "int8",
                   attn: str = "stream",
                   stack_mode: str = "carry") -> DualARConfig:
    """The serving configuration: W8A8 (or W4A8) products and decode
    attention through a kernel. The options are the JAX serving CLIs'
    flags: kv_layout "pos" (L, S, B, Hkv, D) or "head" (L, B, Hkv, S, D);
    kv_cache "int8" or "native" (the weights' activation type, bf16), in
    either layout;
    attn a mode of `apply_pallas_attn_mode` ("stream[N]", "blocks[N][-bf16]",
    "rows"); stack_mode "carry", "scan" or "unrolled" (`run_stack`). The
    defaults are the position-major int8 cache read by the stream kernel;
    kv_fold=True lets that kernel also quantize and write each decode
    step's k/v rows (it needs that cache)."""
    if kv_layout not in ("pos", "head"):
        raise ValueError(f"kv_layout must be 'pos' or 'head', not "
                         f"{kv_layout!r}")
    if kv_cache not in ("int8", "native"):
        raise ValueError(f"kv_cache must be 'int8' or 'native', not "
                         f"{kv_cache!r}")
    if stack_mode not in ("", "carry", "scan", "unrolled"):
        raise ValueError(f"unknown stack_mode {stack_mode!r}")
    if attn in ("", "0"):
        raise ValueError("the serving configuration decodes through a "
                         "kernel: give an attention mode")
    if kv_fold and (kv_layout, kv_cache) != ("pos", "int8"):
        raise ValueError("kv_fold needs the position-major int8 cache")
    cfg = dataclasses.replace(cfg, w8a8_matmuls=True, kv_cache_dtype=kv_cache,
                              kv_cache_layout=kv_layout,
                              kv_fold_write=kv_fold,
                              decode_stack_mode=stack_mode)
    return apply_pallas_attn_mode(cfg, attn)


def build_engine(device=None, serving: bool = True, *, seed: int = 0,
                 lm_cfg: DualARConfig | None = None,
                 codec_cfg: DACConfig | None = None,
                 cache_len: int = 2048, quant: str = "int8",
                 groupsize: int = 128, kv_fold: bool = False,
                 kv_layout: str = "pos", kv_cache: str = "int8",
                 attn: str = "stream",
                 stack_mode: str = "carry",
                 voc_quant: bool | None = None, scheduler_slots: int = 0,
                 scheduler_chunk: int = 1,
                 prefill_chunk: int | None = None) -> TTSEngine:
    """An engine with seeded random weights drawn on `device` (CUDA by
    default): S2-Pro LM and codec unless configs are given, a byte
    tokenizer whose semantic ids span the codebook. serving=True applies
    the serving configuration: quantized weights (quant="int8": int8 with
    W8A8 products; "w4a8": the slow stack's matrices as packed int4 in
    groups of `groupsize` with W4A8 products, everything else int8), the
    position-major int8 KV cache with stream attention (kv_fold=True: the
    fold kernel writes the decode step's rows), and the fused fast head.
    kv_layout, kv_cache, attn and stack_mode select another cache and
    decode attention kernel (`serving_config`); a native KV cache keeps
    the quantized weights, whose activations are bf16. voc_quant=True packs
    the vocoder with int8 weights and per-tile activation scales (None:
    the VOC_QUANT environment variable, "1" for int8). scheduler_slots,
    scheduler_chunk and prefill_chunk go to `TTSEngine`
    (scheduler_slots > 0: the continuous-batching scheduler)."""
    from ..codec.init import init_dac_params
    from ..models.init import init_dual_ar_params
    from ..ops.fast_fused import enable_fused_fast_head
    from ..ops.quant import quantize_lm_params

    serving_kw = dict(kv_layout=kv_layout, kv_cache=kv_cache, attn=attn,
                      stack_mode=stack_mode)
    if not serving and (quant != "int8" or kv_fold or serving_kw != dict(
            kv_layout="pos", kv_cache="int8", attn="stream",
            stack_mode="carry")):
        raise ValueError("quant, kv_fold, kv_layout, kv_cache, attn and "
                         "stack_mode select serving configurations")
    device = resolve_device(device)
    cfg = lm_cfg or s2_pro_lm_config(max_seq_len=cache_len)
    tokenizer = ByteTokenizer(n_semantic=cfg.codebook_size)
    if tokenizer.vocab_size > cfg.vocab_size:
        raise ValueError("the LM vocabulary is smaller than the tokenizer's")
    cfg = cfg.with_semantic_range(tokenizer.semantic_begin_id,
                                  tokenizer.semantic_end_id)
    # refuse a configuration before drawing the weights
    served = (serving_config(cfg, kv_fold=kv_fold, **serving_kw) if serving
              else cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_dual_ar_params(gen, cfg, dtype=torch.bfloat16, device=device)
    if serving:
        params = enable_fused_fast_head(quantize_lm_params(
            params, mode=quant, groupsize=groupsize))
    codec_cfg = codec_cfg or s2_pro_codec_config()
    codec_params = init_dac_params(gen, codec_cfg, device=device)
    return TTSEngine(params, served, tokenizer, codec_params, codec_cfg,
                     cache_len=min(cache_len, cfg.max_seq_len), device=device,
                     voc_quant=voc_quant, scheduler_slots=scheduler_slots,
                     scheduler_chunk=scheduler_chunk,
                     prefill_chunk=prefill_chunk)
