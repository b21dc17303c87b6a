"""voc_step_p50_ms: the median host milliseconds of one streaming vocoder
step (the program's `stream.vocoder` spans, `StatefulVocoder.step`, in
the streams' vocoder threads) in the traced window."""

from benchmark.harness.spans import median, of_run


def read(run: dict) -> float | None:
    spans = of_run(run)
    if spans is None:
        return None
    return median([(s.end_ns - s.start_ns) / 1e6 for s in spans
                   if s.name == "stream.vocoder"])
