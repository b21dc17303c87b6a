"""MP3 and Ogg/Opus encoding via ctypes over the system codecs.

A copy of `fish_speech_tpu/serve/audio_codecs.py` (stdlib, numpy, scipy).

The reference encodes non-WAV responses with libsndfile through soundfile
(tools/server/views.py:183-191 `sf.write(..., format=...)`)
and advertises content types in api_utils.py:83-93. Without
soundfile/pydub/ffmpeg, a host usually still ships the underlying codec libraries
(libmp3lame.so.0, libopus.so.0), so we bind them directly:

- MP3: libmp3lame's 4-call encode API (lame_init/encode_buffer/flush);
- Opus: libopus packets wrapped in a pure-python Ogg container (RFC 3533
  page framing + RFC 7845 OpusHead/OpusTags). Opus only runs at 48 kHz, so
  44.1 kHz model output is polyphase-resampled (scipy, 160/147) first; the
  OpusHead advertises the original input rate per RFC 7845 §5.1.

Both are buffered encoders, matching the reference's behavior (streaming
responses are WAV-only there too, views.py:167-171).
"""

from __future__ import annotations

import ctypes
import struct
from functools import lru_cache

import numpy as np


# ---------------------------------------------------------------------------
# library handles
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _lame():
    try:
        lib = ctypes.CDLL("libmp3lame.so.0")
    except OSError:
        return None
    lib.lame_init.restype = ctypes.c_void_p
    for name in ("lame_set_in_samplerate", "lame_set_num_channels",
                 "lame_set_brate", "lame_set_quality", "lame_init_params",
                 "lame_close"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] + (
            [ctypes.c_int] if "set_" in name else [])
        getattr(lib, name).restype = ctypes.c_int
    lib.lame_encode_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int]
    lib.lame_encode_buffer.restype = ctypes.c_int
    lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int]
    lib.lame_encode_flush.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _opus():
    try:
        lib = ctypes.CDLL("libopus.so.0")
    except OSError:
        return None
    lib.opus_encoder_create.restype = ctypes.c_void_p
    lib.opus_encoder_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
    # variadic: declare the fixed prefix so the handle stays 64-bit
    lib.opus_encoder_ctl.restype = ctypes.c_int
    lib.opus_encoder_ctl.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.opus_encode.restype = ctypes.c_int
    lib.opus_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
    lib.opus_decoder_create.restype = ctypes.c_void_p
    lib.opus_decoder_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
    lib.opus_decode.restype = ctypes.c_int
    lib.opus_decode.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int]
    lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
    return lib


def mp3_available() -> bool:
    return _lame() is not None


def opus_available() -> bool:
    return _opus() is not None


def _to_int16(pcm: np.ndarray) -> np.ndarray:
    if pcm.dtype == np.int16:
        return pcm
    return (np.clip(pcm.astype(np.float32), -1.0, 1.0) * 32767.0).astype(
        np.int16)


# ---------------------------------------------------------------------------
# MP3 (libmp3lame)
# ---------------------------------------------------------------------------


def encode_mp3(pcm: np.ndarray, sample_rate: int,
               bitrate_kbps: int = 128) -> bytes:
    """Mono float32 [-1,1] or int16 samples -> MP3 bytes."""
    lib = _lame()
    if lib is None:
        raise RuntimeError("libmp3lame not available")
    pcm16 = np.ascontiguousarray(_to_int16(pcm).reshape(-1))
    gfp = lib.lame_init()
    try:
        lib.lame_set_in_samplerate(gfp, sample_rate)
        lib.lame_set_num_channels(gfp, 1)
        lib.lame_set_brate(gfp, bitrate_kbps)
        lib.lame_set_quality(gfp, 2)
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError(f"lame_init_params failed (rate={sample_rate})")
        n = pcm16.size
        buf = ctypes.create_string_buffer(n + n // 4 + 7200)
        # mono: left channel only, right ignored (lame.h encode_buffer docs)
        written = lib.lame_encode_buffer(
            gfp, pcm16.ctypes.data_as(ctypes.c_void_p),
            pcm16.ctypes.data_as(ctypes.c_void_p), n, buf, len(buf))
        if written < 0:
            raise RuntimeError(f"lame_encode_buffer error {written}")
        out = bytes(buf[:written])
        tail = ctypes.create_string_buffer(7200)
        flushed = lib.lame_encode_flush(gfp, tail, len(tail))
        if flushed < 0:
            raise RuntimeError(f"lame_encode_flush error {flushed}")
        return out + bytes(tail[:flushed])
    finally:
        lib.lame_close(gfp)


# ---------------------------------------------------------------------------
# Ogg container (RFC 3533) — pure python
# ---------------------------------------------------------------------------

_OGG_CRC_TABLE = None


def _ogg_crc(data: bytes) -> int:
    """Ogg page CRC-32: poly 0x04C11DB7, init 0, not reflected, no xor."""
    global _OGG_CRC_TABLE
    if _OGG_CRC_TABLE is None:
        table = np.zeros(256, np.uint32)
        for i in range(256):
            r = np.uint32(i << 24)
            for _ in range(8):
                r = np.uint32((r << 1) ^ 0x04C11DB7) if r & 0x80000000 \
                    else np.uint32(r << 1)
            table[i] = r
        _OGG_CRC_TABLE = table
    crc = np.uint32(0)
    t = _OGG_CRC_TABLE
    for b in data:
        crc = np.uint32((crc << 8) & 0xFFFFFFFF) ^ t[((crc >> 24) ^ b) & 0xFF]
    return int(crc)


def _ogg_page(packet: bytes, serial: int, seq: int, granule: int,
              header_type: int) -> bytes:
    # one packet per page: lacing 255*k + final<255
    nfull, rem = divmod(len(packet), 255)
    lacing = bytes([255] * nfull + [rem])
    header = struct.pack("<4sBBqIII", b"OggS", 0, header_type,
                         granule, serial, seq, 0) + bytes([len(lacing)]) \
        + lacing
    crc = _ogg_crc(header + packet)
    header = header[:22] + struct.pack("<I", crc) + header[26:]
    return header + packet


# ---------------------------------------------------------------------------
# Ogg/Opus (RFC 7845)
# ---------------------------------------------------------------------------

_OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE = 4002
_OPUS_GET_LOOKAHEAD = 4027
_OPUS_FRAME = 960  # 20 ms @ 48 kHz


def _resample_48k(pcm: np.ndarray, sample_rate: int) -> np.ndarray:
    if sample_rate == 48000:
        return pcm.astype(np.float32)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(48000, sample_rate)
    return resample_poly(pcm.astype(np.float32), 48000 // g,
                         sample_rate // g).astype(np.float32)


def encode_opus(pcm: np.ndarray, sample_rate: int,
                bitrate: int = 64000) -> bytes:
    """Mono float32 [-1,1] or int16 samples -> Ogg/Opus bytes."""
    lib = _opus()
    if lib is None:
        raise RuntimeError("libopus not available")
    if pcm.dtype == np.int16:
        pcm = pcm.astype(np.float32) / 32768.0
    pcm48 = _resample_48k(np.asarray(pcm, np.float32).reshape(-1),
                          sample_rate)
    n_valid = pcm48.size

    err = ctypes.c_int(0)
    enc = lib.opus_encoder_create(48000, 1, _OPUS_APPLICATION_AUDIO,
                                  ctypes.byref(err))
    if err.value != 0:
        raise RuntimeError(f"opus_encoder_create error {err.value}")
    try:
        lib.opus_encoder_ctl(enc, _OPUS_SET_BITRATE, ctypes.c_int(bitrate))
        lookahead = ctypes.c_int(0)
        lib.opus_encoder_ctl(enc, _OPUS_GET_LOOKAHEAD,
                             ctypes.byref(lookahead))
        preskip = lookahead.value
        # pad so the decoder can produce preskip + n_valid samples (the
        # final granule must not exceed the decodable total, RFC 7845 §4)
        pad = (-(n_valid + preskip)) % _OPUS_FRAME + preskip
        pcm16 = np.ascontiguousarray(
            np.concatenate([_to_int16(pcm48), np.zeros(pad, np.int16)]))

        serial, seq = 0x5F15, 0
        # RFC 7845 §5.1: OpusHead (version 1, mono, preskip, INPUT rate)
        head = struct.pack("<8sBBHIhB", b"OpusHead", 1, 1, preskip,
                           sample_rate, 0, 0)
        out = [_ogg_page(head, serial, seq, 0, 0x02)]
        seq += 1
        vendor = b"fish-speech-tpu"
        tags = (b"OpusTags" + struct.pack("<I", len(vendor)) + vendor
                + struct.pack("<I", 0))
        out.append(_ogg_page(tags, serial, seq, 0, 0x00))
        seq += 1

        buf = ctypes.create_string_buffer(4000)
        n_frames = pcm16.size // _OPUS_FRAME
        for i in range(n_frames):
            frame = pcm16[i * _OPUS_FRAME:(i + 1) * _OPUS_FRAME]
            nb = lib.opus_encode(enc, frame.ctypes.data_as(ctypes.c_void_p),
                                 _OPUS_FRAME, buf, len(buf))
            if nb < 0:
                raise RuntimeError(f"opus_encode error {nb}")
            last = i == n_frames - 1
            # granule = decoded samples + preskip; the final page's granule
            # excludes the zero padding so decoders trim it (RFC 7845 §4)
            granule = (preskip + (n_valid if last
                                  else (i + 1) * _OPUS_FRAME))
            out.append(_ogg_page(bytes(buf[:nb]), serial, seq, granule,
                                 0x04 if last else 0x00))
            seq += 1
        return b"".join(out)
    finally:
        lib.opus_encoder_destroy(enc)


def decode_opus(data: bytes):
    """Minimal Ogg/Opus decoder for roundtrip tests: returns
    (float32 samples at 48 kHz with preskip trimmed, input_sample_rate)."""
    lib = _opus()
    if lib is None:
        raise RuntimeError("libopus not available")
    packets = []
    pos = 0
    granule_last = 0
    while pos < len(data):
        assert data[pos:pos + 4] == b"OggS", "bad ogg page"
        granule_last = struct.unpack("<q", data[pos + 6:pos + 14])[0]
        nseg = data[pos + 26]
        lacing = data[pos + 27:pos + 27 + nseg]
        body = pos + 27 + nseg
        packet = b""
        for lv in lacing:
            packet += data[body:body + lv]
            body += lv
            if lv < 255:
                packets.append(packet)
                packet = b""
        pos = body
    head = packets[0]
    assert head[:8] == b"OpusHead"
    preskip = struct.unpack("<H", head[10:12])[0]
    in_rate = struct.unpack("<I", head[12:16])[0]
    err = ctypes.c_int(0)
    dec = lib.opus_decoder_create(48000, 1, ctypes.byref(err))
    assert err.value == 0
    try:
        outbuf = np.zeros(5760, np.int16)
        samples = []
        for pkt in packets[2:]:
            n = lib.opus_decode(dec, pkt, len(pkt),
                                outbuf.ctypes.data_as(ctypes.c_void_p),
                                outbuf.size, 0)
            assert n >= 0, f"opus_decode error {n}"
            samples.append(outbuf[:n].copy())
        pcm = np.concatenate(samples).astype(np.float32) / 32768.0
        n_valid = granule_last  # includes preskip
        return pcm[preskip:n_valid], in_rate
    finally:
        lib.opus_decoder_destroy(dec)
