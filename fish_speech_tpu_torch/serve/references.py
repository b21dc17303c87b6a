"""Voice-reference store: by-id directories + by-hash cache. A copy of
`fish_speech_tpu/serve/references.py`.

Mirrors the reference ReferenceLoader
(fish_speech/inference_engine/reference_loader.py:20-271):
`references/<id>/` holds audio files with matching `.lab` transcript files;
inline request references are cached by sha256 of the audio bytes.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

AUDIO_EXTENSIONS = {".wav", ".mp3", ".flac", ".ogg", ".m4a"}


@dataclass
class LoadedReference:
    codes_list: list[np.ndarray]  # list of (K, T)
    texts: list[str]


class ReferenceStore:
    def __init__(self, root: str | Path, encode_fn, sample_rate: int = 44100):
        """encode_fn: (np.float32 mono wav) -> (K, T) int codes."""
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.encode_fn = encode_fn
        self.sample_rate = sample_rate
        self._id_cache: dict[str, LoadedReference] = {}
        self._hash_cache: dict[str, np.ndarray] = {}

    # -- by id -------------------------------------------------------------
    def list_ids(self) -> list[str]:
        return sorted(p.name for p in self.root.iterdir() if p.is_dir())

    def add(self, ref_id: str, audio_bytes: bytes, text: str) -> None:
        from .wav import decode_audio_bytes, encode_wav

        ref_dir = self.root / ref_id
        ref_dir.mkdir(parents=True, exist_ok=True)
        wav = decode_audio_bytes(audio_bytes, self.sample_rate)
        (ref_dir / "sample.wav").write_bytes(encode_wav(wav, self.sample_rate))
        (ref_dir / "sample.lab").write_text(text, encoding="utf-8")
        self._id_cache.pop(ref_id, None)

    def delete(self, ref_id: str) -> bool:
        import shutil

        ref_dir = self.root / ref_id
        if not ref_dir.is_dir():
            return False
        shutil.rmtree(ref_dir)
        self._id_cache.pop(ref_id, None)
        return True

    def rename(self, old_id: str, new_id: str) -> bool:
        import shutil

        src = self.root / old_id
        if not src.is_dir():
            return False
        shutil.move(str(src), str(self.root / new_id))
        self._id_cache.pop(old_id, None)
        return True

    def load_by_id(self, ref_id: str, use_cache: bool = True) -> LoadedReference:
        from .wav import decode_audio_bytes

        if use_cache and ref_id in self._id_cache:
            return self._id_cache[ref_id]
        ref_dir = self.root / ref_id
        if not ref_dir.is_dir():
            raise FileNotFoundError(f"Reference {ref_id} not found")
        codes_list, texts = [], []
        for audio_file in sorted(ref_dir.iterdir()):
            if audio_file.suffix.lower() not in AUDIO_EXTENSIONS:
                continue
            lab = audio_file.with_suffix(".lab")
            if not lab.exists():
                continue
            wav = decode_audio_bytes(audio_file.read_bytes(), self.sample_rate)
            codes_list.append(self.encode_fn(wav))
            texts.append(lab.read_text(encoding="utf-8").strip())
        loaded = LoadedReference(codes_list=codes_list, texts=texts)
        self._id_cache[ref_id] = loaded
        return loaded

    # -- inline (by hash) --------------------------------------------------
    def encode_inline(self, audio_bytes: bytes, use_cache: bool = True) -> np.ndarray:
        from .wav import decode_audio_bytes

        digest = hashlib.sha256(audio_bytes).hexdigest()
        if use_cache and digest in self._hash_cache:
            return self._hash_cache[digest]
        wav = decode_audio_bytes(audio_bytes, self.sample_rate)
        codes = self.encode_fn(wav)
        self._hash_cache[digest] = codes
        return codes
