"""audio_s_per_s: seconds of audio that reached the clients in the window,
per second of the window: every waveform chunk of a stream, and every
whole waveform a `tts` call returned, whose arrival lies in the window."""


def read(run: dict) -> float:
    c = run["config"]["codec"]
    t0, t1 = run["window"]
    samples = sum(n for r in run["records"] for t, n in r["chunks"]
                  if t0 <= t <= t1)
    return samples / c["sample_rate"] / run["window_s"]
