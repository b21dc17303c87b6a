"""WAV byte helpers (ref fish_speech/inference_engine/utils.py
and scipy-based file IO; no torchaudio). A copy of
`fish_speech_tpu/serve/wav.py`."""

from __future__ import annotations

import io
import wave

import numpy as np


def wav_chunk_header(sample_rate: int = 44100, bit_depth: int = 16,
                     channels: int = 1) -> bytes:
    """Streaming WAV header with unspecified length (ref utils.py:16-29)."""
    buffer = io.BytesIO()
    with wave.open(buffer, "wb") as wav_file:
        wav_file.setnchannels(channels)
        wav_file.setsampwidth(bit_depth // 8)
        wav_file.setframerate(sample_rate)
    return buffer.getvalue()


def float_to_pcm16(audio: np.ndarray) -> bytes:
    audio = np.clip(audio, -1.0, 1.0)
    return (audio * 32767.0).astype("<i2").tobytes()


def encode_wav(audio: np.ndarray, sample_rate: int) -> bytes:
    buffer = io.BytesIO()
    with wave.open(buffer, "wb") as wav_file:
        wav_file.setnchannels(1)
        wav_file.setsampwidth(2)
        wav_file.setframerate(sample_rate)
        wav_file.writeframes(float_to_pcm16(audio))
    return buffer.getvalue()


def decode_audio_bytes(data: bytes, target_sr: int) -> np.ndarray:
    """Decode WAV bytes -> mono float32 at target_sr (scipy-based).

    The reference accepts arbitrary formats via torchaudio/librosa; we support
    WAV natively and fall back to raw PCM16 interpretation otherwise.
    """
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    try:
        sr, wav = wavfile.read(io.BytesIO(data))
    except Exception:
        wav = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        sr = target_sr

    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    elif wav.dtype == np.int32:
        wav = wav.astype(np.float32) / 2147483648.0
    elif wav.dtype == np.uint8:
        wav = (wav.astype(np.float32) - 128.0) / 128.0
    else:
        wav = wav.astype(np.float32)

    if wav.ndim == 2:
        wav = wav.mean(axis=1)

    if sr != target_sr:
        from math import gcd

        g = gcd(int(sr), int(target_sr))
        wav = resample_poly(wav, target_sr // g, sr // g)
    return wav.astype(np.float32)
