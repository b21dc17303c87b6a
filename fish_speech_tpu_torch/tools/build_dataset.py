"""Build protobuf training shards from extracted .npy codes and transcript
.lab files, grouped by speaker directory: one TextData message a speaker,
shards of about --shard-size-mb.

    python -m fish_speech_tpu_torch.tools.build_dataset --input CORPUS
        --output PROTOS

Counterpart of `tools/build_dataset.py` (ref tools/llama/build_dataset.py),
on the port's own wire codec (data/protos.py).
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..data.protos import Sentence, TextData
from ..data.stream import pack_pb_stream
from ..utils.file import list_files


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--input", type=Path, required=True,
                   help="corpus root: <speaker>/<clip>.npy + .lab pairs")
    p.add_argument("--output", type=Path, required=True,
                   help="output dir for .protos shards")
    p.add_argument("--num-workers", type=int, default=1)  # kept for CLI parity
    p.add_argument("--text-extension", default=".lab")
    p.add_argument("--shard-size-mb", type=int, default=10)
    args = p.parse_args(argv)

    npy_files = list_files(args.input, {".npy"}, recursive=True)
    by_speaker: dict[str, list[Path]] = defaultdict(list)
    for f in npy_files:
        rel = f.relative_to(args.input)
        speaker = rel.parts[0] if len(rel.parts) > 1 else "default"
        by_speaker[speaker].append(f)

    args.output.mkdir(parents=True, exist_ok=True)
    shard_idx, shard_bytes = 0, 0
    shard_f = open(args.output / f"{shard_idx:05d}.protos", "wb")
    total_sentences = 0

    for speaker, files in sorted(by_speaker.items()):
        td = TextData(source=str(args.input), name=speaker)
        for f in sorted(files):
            lab = f.with_suffix(args.text_extension)
            if not lab.exists():
                continue
            text = lab.read_text(encoding="utf-8").strip()
            codes = np.load(f)  # (K, T)
            sent = Sentence()
            sent.texts.append(text)
            for row in codes:
                sem = sent.semantics.add()
                sem.values.extend(int(v) for v in row)
            td.sentences.append(sent)
            total_sentences += 1
        if not td.sentences:
            continue
        buf = pack_pb_stream(td)
        shard_f.write(buf)
        shard_bytes += len(buf)
        if shard_bytes > args.shard_size_mb * 1024 * 1024:
            shard_f.close()
            shard_idx += 1
            shard_bytes = 0
            shard_f = open(args.output / f"{shard_idx:05d}.protos", "wb")

    shard_f.close()
    print(f"wrote {total_sentences} sentences across {shard_idx + 1} shards "
          f"({len(by_speaker)} speakers) -> {args.output}")
    return total_sentences


if __name__ == "__main__":
    main()
