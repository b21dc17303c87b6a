"""Write train / validation file lists of a corpus directory's audio
files, filtered by duration.

    python -m fish_speech_tpu_torch.tools.create_train_split ROOT
        [--val-count 8] [--min-duration S] [--max-duration S]

Counterpart of `tools/create_train_split.py` (ref
tools/vqgan/create_train_split.py).
"""

from __future__ import annotations

import argparse
import wave
from pathlib import Path
from random import Random

from ..utils.file import AUDIO_EXTENSIONS, list_files


def wav_duration(path: Path) -> float | None:
    try:
        with wave.open(str(path), "rb") as w:
            return w.getnframes() / w.getframerate()
    except (wave.Error, EOFError, OSError):
        return None


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("root", type=Path)
    p.add_argument("--val-count", type=int, default=8)
    p.add_argument("--min-duration", type=float, default=0.0)
    p.add_argument("--max-duration", type=float, default=None)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    files = list_files(args.root, AUDIO_EXTENSIONS, recursive=True)
    kept = []
    for f in files:
        if args.min_duration or args.max_duration:
            d = wav_duration(f)
            if d is not None:
                if d < args.min_duration:
                    continue
                if args.max_duration and d > args.max_duration:
                    continue
        kept.append(f.relative_to(args.root))

    Random(args.seed).shuffle(kept)
    val = kept[: args.val_count]
    train = kept[args.val_count:]
    (args.root / "vq_train_filelist.txt").write_text(
        "\n".join(str(f) for f in train))
    (args.root / "vq_val_filelist.txt").write_text(
        "\n".join(str(f) for f in val))
    print(f"{len(train)} train / {len(val)} val files "
          f"({len(files) - len(kept)} filtered)")


if __name__ == "__main__":
    main()
