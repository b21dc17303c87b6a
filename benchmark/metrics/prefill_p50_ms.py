"""prefill_p50_ms: the median host milliseconds of a new request's whole
B = 1 prefill on the scheduler thread (the program's unchunked `prefill`
spans: the sampling install, the prefix copy, the prefill and first
column's decode step, and the first column's fetch and hand-off)."""

from benchmark.harness.spans import median, scheduler


def read(run: dict) -> float | None:
    spans = scheduler(run)
    if spans is None:
        return None
    return median([(s.end_ns - s.start_ns) / 1e6 for s in spans
                   if s.name == "prefill" and not s.attrs["chunked"]])
