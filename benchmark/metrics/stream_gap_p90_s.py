"""stream_gap_p90_s: the 90th percentile of the seconds between two
consecutive chunks of one stream, pooled over the streams: gaps after
the first chunk that end in the window, a stream's shorter last chunk
left out, and a gap still open at the window's end counted up to it.
A per-layer metric: the host paces it, and its spread between runs is
wider than an end-to-end bound can hold."""

import numpy as np


def read(run: dict) -> float | None:
    mix = run["traffic"]
    if mix["entry"] != "stream_tts":
        return None
    t0, t1 = run["window"]
    full = mix["chunk"]["frames"] * run["config"]["codec"]["frame_length"]
    gaps = []
    for r in run["records"]:
        chunks = r["chunks"]
        ended = r["end"] is not None and r["end"] <= t1 and not r.get("cut")
        if ended and chunks and chunks[-1][1] < full:
            chunks = chunks[:-1]
        arrived = [t for t, _ in chunks if t <= t1]
        gaps += [b - a for a, b in zip(arrived, arrived[1:]) if b >= t0]
        if arrived and not ended:
            gaps.append(t1 - arrived[-1])
    return float(np.percentile(gaps, 90)) if gaps else None
