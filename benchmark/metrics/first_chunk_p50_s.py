"""first_chunk_p50_s: the median, over the stream requests sent in the
(traced) window, of the seconds from sending to the first waveform chunk;
a request still without audio at the window's end counts with its wait so
far."""

import statistics


def read(run: dict) -> float | None:
    if run["traffic"]["entry"] != "stream_tts":
        return None
    t0, t1 = run["window"]
    waits = []
    for r in run["records"]:
        if not t0 <= r["sent"] <= t1:
            continue
        first = r["chunks"][0][0] if r["chunks"] else None
        waits.append((first if first is not None and first <= t1 else t1)
                     - r["sent"])
    return statistics.median(waits) if waits else None
