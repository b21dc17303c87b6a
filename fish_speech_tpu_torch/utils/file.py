"""File helpers. Counterpart of `fish_speech_tpu/utils/file.py` (ref
fish_speech/utils/file.py)."""

from __future__ import annotations

from pathlib import Path

AUDIO_EXTENSIONS = {".wav", ".mp3", ".flac", ".ogg", ".m4a", ".opus"}


def list_files(path: str | Path, extensions: set[str] | None = None,
               recursive: bool = True) -> list[Path]:
    path = Path(path)
    it = path.rglob("*") if recursive else path.glob("*")
    files = [f for f in it if f.is_file()]
    if extensions is not None:
        files = [f for f in files if f.suffix.lower() in extensions]
    return sorted(files)


def get_latest_checkpoint(path: str | Path, pattern: str = "*.ckpt") -> Path | None:
    """Newest checkpoint by mtime (ref utils/file.py:28-38) — auto-resume.
    Equal mtimes (the file system's clock is coarse) go to the later name,
    so that `step_N_final` wins over `step_N`."""
    path = Path(path)
    if not path.exists():
        return None
    ckpts = sorted(path.glob(pattern),
                   key=lambda p: (p.stat().st_mtime, p.name))
    return ckpts[-1] if ckpts else None
