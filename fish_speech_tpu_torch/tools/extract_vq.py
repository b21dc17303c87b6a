"""Batch audio -> VQ codes: encode every audio file of a corpus with the
codec and write its codes next to it as .npy.

    python -m fish_speech_tpu_torch.tools.extract_vq FOLDER
        [--codec-checkpoint codec.pth] [--rank R --world-size N]
        [--filelist LIST] [--device cpu]

Counterpart of `tools/extract_vq.py` (ref tools/vqgan/extract_vq.py):
with --codec-checkpoint the S2-Pro codec from a reference codec.pth,
without it a tiny random codec (seed 0). Files are strided by rank, the
rank and world taken from --rank / --world-size or from SLURM_PROCID /
SLURM_NTASKS, as the reference launcher does; a file whose .npy exists is
skipped. Each file goes through `codec.model.encode_reference` (what
`TTSEngine.encode_reference` runs); the codes are saved as int32, as the
JAX tool saves them. Runs on the CUDA card unless given --device.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np


def load_codec(codec_checkpoint: Path | None, device):
    """(params, config): the S2-Pro codec from a reference codec.pth, or a
    tiny random one drawn from seed 0."""
    import torch

    from ..codec.config import s2_pro_codec_config, tiny_codec_config
    from ..codec.init import init_dac_params

    if codec_checkpoint:
        from ..codec.convert import convert_dac_state_dict
        from ..utils.checkpoint import load_torch_codec_checkpoint

        cfg = s2_pro_codec_config()
        return convert_dac_state_dict(
            load_torch_codec_checkpoint(codec_checkpoint), cfg,
            device=device), cfg
    cfg = tiny_codec_config()
    gen = torch.Generator(device=device).manual_seed(0)
    return init_dac_params(gen, cfg, device=device), cfg


def extract(files: list[Path], params: dict, cfg, device,
            rank: int = 0) -> int:
    """Encode each file without codes yet; returns the files written."""
    from ..codec.model import encode_reference
    from ..serve.wav import decode_audio_bytes

    t0 = time.perf_counter()
    done = 0
    total_sec = 0.0
    for f in files:
        out = f.with_suffix(".npy")
        if out.exists():
            continue
        wav = decode_audio_bytes(f.read_bytes(), cfg.sample_rate)
        total_sec += len(wav) / cfg.sample_rate
        np.save(out, encode_reference(params, cfg, wav,
                                      device=device).astype(np.int32))
        done += 1
        if done % 50 == 0:
            dt = time.perf_counter() - t0
            print(f"[rank {rank}] {done} files, "
                  f"{total_sec / dt:.1f} audio-s/s")
    print(f"[rank {rank}] done: {done} files in "
          f"{time.perf_counter() - t0:.1f}s")
    return done


def main(argv=None) -> int:
    """Extract this rank's files; returns the files written."""
    from ..device import resolve_device
    from ..utils.file import AUDIO_EXTENSIONS, list_files

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("folder", type=Path)
    p.add_argument("--codec-checkpoint", type=Path, default=None)
    p.add_argument("--rank", type=int,
                   default=int(os.environ.get("SLURM_PROCID", 0)))
    p.add_argument("--world-size", type=int,
                   default=int(os.environ.get("SLURM_NTASKS", 1)))
    p.add_argument("--batch-size", type=int, default=16,
                   help="accepted for the reference's command line; files "
                        "are encoded one at a time")
    p.add_argument("--filelist", type=Path, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    params, cfg = load_codec(args.codec_checkpoint, dev)
    if args.filelist:
        files = [Path(line) for line in
                 args.filelist.read_text().splitlines() if line.strip()]
    else:
        files = list_files(args.folder, AUDIO_EXTENSIONS, recursive=True)
    files = files[args.rank::args.world_size]
    print(f"[rank {args.rank}/{args.world_size}] {len(files)} files")
    return extract(files, params, cfg, dev, args.rank)


if __name__ == "__main__":
    main()
