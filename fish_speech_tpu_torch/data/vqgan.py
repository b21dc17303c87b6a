"""Raw-audio dataset for codec training and evaluation.

Counterpart of `fish_speech_tpu/data/vqgan.py` (ref fish_speech/datasets/
vqgan.py:16-147): filelist-driven clips, random crops, batch collation with
per-item lengths, on the host in numpy. An item that fails to load is None
and the collator drops it (the reference's fault tolerance).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from random import Random

import numpy as np


class VQGANDataset:
    def __init__(self, filelist: str | Path, sample_rate: int = 44100,
                 hop_length: int = 512, slice_frames: int | None = 512,
                 seed: int = 42):
        root = Path(filelist).parent
        self.files = [root / line for line in
                      Path(filelist).read_text().splitlines() if line.strip()]
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.slice_frames = slice_frames
        self.rng = Random(seed)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        from ..serve.wav import decode_audio_bytes

        try:
            wav = decode_audio_bytes(self.files[idx].read_bytes(),
                                     self.sample_rate)
        except (OSError, ValueError, EOFError):
            return None
        if len(wav) == 0:
            return None
        if self.slice_frames is not None:
            target = self.slice_frames * self.hop_length
            if len(wav) > target:
                start = self.rng.randint(0, len(wav) - target)
                wav = wav[start: start + target]
        # trim to a whole number of hops
        n = (len(wav) // self.hop_length) * self.hop_length
        if n == 0:
            return None
        return {"audio": wav[:n].astype(np.float32)}


@dataclass
class VQGANCollator:
    def __call__(self, examples: list) -> dict | None:
        examples = [e for e in examples if e is not None]
        if not examples:
            return None
        max_len = max(len(e["audio"]) for e in examples)
        audios = np.zeros((len(examples), max_len), np.float32)
        lengths = np.zeros(len(examples), np.int32)
        for i, e in enumerate(examples):
            audios[i, : len(e["audio"])] = e["audio"]
            lengths[i] = len(e["audio"])
        return {"audios": audios, "audio_lengths": lengths}
