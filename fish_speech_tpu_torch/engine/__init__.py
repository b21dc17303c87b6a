"""Engine: text -> codes -> waveform."""

from .generate import GenerateLongRequest, TTSEngine, build_engine

__all__ = ["GenerateLongRequest", "TTSEngine", "build_engine"]
