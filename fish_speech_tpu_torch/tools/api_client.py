"""HTTP API client: a msgpack POST to /v1/tts, the audio saved to a file and
with --play played as it streams.

    python -m fish_speech_tpu_torch.tools.api_client --url
        http://127.0.0.1:8080/v1/tts --text "Hello" [-o out.wav]
        [--streaming] [--play] [-ra ref.wav -rt "its text"]

Counterpart of `tools/api_client.py` (ref tools/api_client.py), on the
port's own msgpack codec (serve/msgpack.py) and the standard library.
--play uses a fallback chain (pyaudio if installed, else an `aplay`,
`pw-play` or `paplay` subprocess); where no playback backend exists the
file is kept all the same. Needs no card.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

from ..serve.msgpack import packb

WAV_HEADER_BYTES = 44   # serve/wav.py's header before a streamed wav's PCM


class LivePlayer:
    """Incremental PCM-int16 playback sink. start() returns False if no
    playback backend exists in this environment."""

    def __init__(self, sample_rate: int):
        self.sample_rate = sample_rate
        self._pa_stream = None
        self._proc = None

    def start(self) -> bool:
        try:
            import pyaudio  # type: ignore

            pa = pyaudio.PyAudio()
            self._pa_stream = pa.open(format=pyaudio.paInt16, channels=1,
                                      rate=self.sample_rate, output=True)
            return True
        except (ImportError, OSError):
            pass
        for cmd in (["aplay", "-q", "-f", "S16_LE", "-c", "1",
                     "-r", str(self.sample_rate), "-t", "raw", "-"],
                    ["pw-play", "--format", "s16", "--channels", "1",
                     "--rate", str(self.sample_rate), "-"],
                    ["paplay", "--format=s16le", "--channels=1",
                     f"--rate={self.sample_rate}", "--raw", "/dev/stdin"]):
            if shutil.which(cmd[0]):
                try:
                    self._proc = subprocess.Popen(cmd,
                                                  stdin=subprocess.PIPE)
                    return True
                except OSError:
                    continue
        return False

    def write(self, pcm_bytes: bytes) -> None:
        if self._pa_stream is not None:
            self._pa_stream.write(pcm_bytes)
        elif self._proc is not None and self._proc.stdin:
            self._proc.stdin.write(pcm_bytes)
            self._proc.stdin.flush()

    def close(self) -> None:
        if self._pa_stream is not None:
            self._pa_stream.stop_stream()
            self._pa_stream.close()
        if self._proc is not None and self._proc.stdin:
            self._proc.stdin.close()
            self._proc.wait(timeout=10)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--url", default="http://127.0.0.1:8080/v1/tts")
    p.add_argument("--text", "-t", default="Hello from the client.")
    p.add_argument("--output", "-o", type=Path, default=Path("generated.wav"))
    p.add_argument("--reference-id", default=None)
    p.add_argument("--reference-audio", "-ra", action="append", type=Path)
    p.add_argument("--reference-text", "-rt", action="append")
    p.add_argument("--format", default="wav",
                   choices=["wav", "pcm", "mp3", "opus"])
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--play", action="store_true",
                   help="play streamed audio live (implies --streaming)")
    p.add_argument("--sample-rate", type=int, default=44100,
                   help="playback rate for --play (server codec rate)")
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--chunk-length", type=int, default=200)
    p.add_argument("--top-p", type=float, default=0.8)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--api-key", default=None)
    args = p.parse_args(argv)
    if args.play:
        args.streaming = True
        if args.format not in ("wav", "pcm"):
            p.error("--play needs --format wav|pcm (streaming formats)")
    return args


def request_body(args: argparse.Namespace) -> dict:
    """The /v1/tts payload of the command line."""
    references = []
    if args.reference_audio:
        texts = args.reference_text or [""] * len(args.reference_audio)
        for audio_path, text in zip(args.reference_audio, texts):
            references.append({"audio": audio_path.read_bytes(),
                               "text": text})
    payload = {
        "text": args.text,
        "format": args.format,
        "streaming": args.streaming,
        "max_new_tokens": args.max_new_tokens,
        "chunk_length": args.chunk_length,
        "top_p": args.top_p,
        "temperature": args.temperature,
        "references": references,
    }
    if args.reference_id:
        payload["reference_id"] = args.reference_id
    if args.seed is not None:
        payload["seed"] = args.seed
    return payload


def main(argv=None) -> int:
    """POST the request and save the audio; returns the bytes saved."""
    args = parse_args(argv)
    headers = {"Content-Type": "application/msgpack"}
    if args.api_key:
        headers["Authorization"] = f"Bearer {args.api_key}"
    req = urllib.request.Request(args.url, data=packb(request_body(args)),
                                 headers=headers)
    try:
        resp = urllib.request.urlopen(req, timeout=600)
    except urllib.error.HTTPError as e:
        print(f"HTTP {e.code}: {e.read().decode()[:500]}", file=sys.stderr)
        sys.exit(1)

    player = None
    if args.play:
        player = LivePlayer(args.sample_rate)
        if not player.start():
            print("no playback backend (pyaudio/aplay/pw-play/paplay); "
                  "saving only", file=sys.stderr)
            player = None

    # a streamed wav starts with its header: strip it before playback,
    # counting the header bytes across reads (a read may return fewer)
    header_left = WAV_HEADER_BYTES if args.format == "wav" else 0
    with resp, open(args.output, "wb") as f:
        while True:
            chunk = resp.read(65536)
            if not chunk:
                break
            f.write(chunk)
            if player is not None:
                if header_left:
                    skip = min(header_left, len(chunk))
                    chunk = chunk[skip:]
                    header_left -= skip
                if chunk:
                    player.write(chunk)
    if player is not None:
        player.close()
    size = args.output.stat().st_size
    print(f"saved {args.output} ({size} bytes)")
    return size


if __name__ == "__main__":
    main()
