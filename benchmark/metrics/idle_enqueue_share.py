"""idle_enqueue_share: of the device's idle time in the traced window (the
gaps between the union of its kernel, copy and memset intervals), the
share that falls inside one of the scheduler thread's `decode.slow` or
`decode.fast` spans (exact interval intersection), in percent: the idle
time spent while the host enqueues a decode step, which launching a step
as one graph would take away."""

from benchmark.harness.spans import idle_gaps, overlap_ns, scheduler
from benchmark.harness.trace import _union


def read(run: dict) -> float | None:
    spans = scheduler(run)
    if spans is None:
        return None
    gaps = idle_gaps(run)
    idle = sum(e - s for s, e in gaps)
    if not idle:
        return None
    dec = _union([(s.start_ns, s.end_ns) for s in spans
                  if s.name in ("decode.slow", "decode.fast")])
    return 100.0 * overlap_ns(gaps, dec) / idle
