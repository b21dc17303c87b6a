"""Log-mel spectrogram with the reference's parameters, on torch tensors.

Counterpart of `fish_speech_tpu/utils/spectrogram.py` (ref
fish_speech/utils/spectrogram.py): n_fft 2048, window 2048, hop 512, 128
mels, slaney scale and norm, no centring but a reflect pad of (win - hop)/2
on each side, magnitude sqrt(power + 1e-6), log with a 1e-5 floor. The
filterbank and the STFT are taken in float64, as the JAX package's numpy
does, and returned in float32. A waveform may be a tensor on any device or
an array; the result lies on the tensor's device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = 15.0
_LOGSTEP = math.log(6.4) / 27.0


def _hz_to_mel_slaney(f: torch.Tensor) -> torch.Tensor:
    log = _MIN_LOG_MEL + torch.log(
        torch.clamp(f, min=_MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP
    return torch.where(f >= _MIN_LOG_HZ, log, 3.0 * f / 200.0)


def _mel_to_hz_slaney(m: torch.Tensor) -> torch.Tensor:
    log = _MIN_LOG_HZ * torch.exp(
        _LOGSTEP * (torch.clamp(m, min=_MIN_LOG_MEL) - _MIN_LOG_MEL))
    return torch.where(m >= _MIN_LOG_MEL, log, 200.0 * m / 3.0)


def melscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                    sample_rate: int, device=None) -> torch.Tensor:
    """Slaney-scale, slaney-normalised filterbank (n_freqs, n_mels) f32
    (torchaudio's melscale_fbanks(norm='slaney', mel_scale='slaney'))."""
    f64 = dict(dtype=torch.float64, device=device)
    freqs = torch.linspace(0, sample_rate // 2, n_freqs, **f64)
    lo, hi = _hz_to_mel_slaney(torch.tensor([f_min, f_max], **f64))
    f_pts = _mel_to_hz_slaney(torch.linspace(float(lo), float(hi),
                                             n_mels + 2, **f64))
    f_diff = torch.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]          # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = torch.clamp(torch.minimum(down, up), min=0.0)
    fb = fb * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.float()


def linear_spectrogram(y, n_fft: int = 2048, win_length: int = 2048,
                       hop_length: int = 512) -> torch.Tensor:
    """Magnitude STFT with the reference's padding (spectrogram.py:30-58):
    y (T,) -> (n_fft//2+1, frames) f32."""
    y = torch.as_tensor(y).double()
    pad_l = (win_length - hop_length) // 2
    pad_r = (win_length - hop_length + 1) // 2
    y = F.pad(y[None, None], (pad_l, pad_r), mode="reflect")[0, 0]
    window = torch.hann_window(win_length, periodic=True,
                               dtype=torch.float64, device=y.device)
    frames = y.unfold(0, n_fft, hop_length) * window[None, :]
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6)
    return mag.T.float()


def log_mel_spectrogram(y, sample_rate: int = 44100, n_fft: int = 2048,
                        win_length: int = 2048, hop_length: int = 512,
                        n_mels: int = 128, f_min: float = 0.0,
                        f_max: float | None = None) -> torch.Tensor:
    """(T,) waveform -> (n_mels, frames) log-mel f32, the reference's
    parameters."""
    f_max = f_max or float(sample_rate // 2)
    linear = linear_spectrogram(y, n_fft, win_length, hop_length)
    fb = melscale_fbanks(n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate,
                         device=linear.device)
    return torch.log(torch.clamp(fb.T @ linear, min=1e-5))


def mel_similarity(wav_a, wav_b, sample_rate: int = 44100) -> float:
    """Fraction of log-mel bins within atol 1e-2 + rtol 1e-2: the 'mel
    allclose' score against the reference vocoder."""
    wav_a, wav_b = torch.as_tensor(wav_a), torch.as_tensor(wav_b)
    n = min(len(wav_a), len(wav_b))
    ma = log_mel_spectrogram(wav_a[:n], sample_rate)
    mb = log_mel_spectrogram(wav_b[:n], sample_rate)
    return float(torch.isclose(ma, mb, atol=1e-2, rtol=1e-2).double().mean())
