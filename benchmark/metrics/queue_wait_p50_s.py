"""queue_wait_p50_s: the median, over the requests assigned a slot in the
traced window, of the seconds from the scheduler's `submit` to the start
of the request's assignment (the program's `queue` spans)."""

from benchmark.harness.spans import median, scheduler


def read(run: dict) -> float | None:
    spans = scheduler(run)
    if spans is None:
        return None
    return median([(s.end_ns - s.start_ns) / 1e9 for s in spans
                   if s.name == "queue"])
