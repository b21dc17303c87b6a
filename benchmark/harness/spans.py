"""The program's own spans (`fish_speech_tpu_torch.utils.profiling`) as
the per-layer readers of a traced run take them.

The program records spans while a profiler session is open: from the
traced window's opening until the profiler has finished stopping, which
takes seconds after the window closes, while the process's threads go on
(and wait for the stopping thread). The spans stay in the process's
memory, and the readers take them after the window. `of_run` gives those
that lie wholly inside the window (not an earlier run's in the same
process, nor what ran while the profiler stopped), and None where there
are none: a program without the recorder, as before its spans were added,
or an untraced run. The scheduler's spans are those of its thread, the
one that records `tick`s.
"""

from __future__ import annotations

import statistics
import time

from .clients import clock
from .trace import _union


def window_ns(run: dict) -> tuple[int, int]:
    """The run's window on the spans' clock (`time.time_ns()`)."""
    now_ns, now = time.time_ns(), clock()
    t0, t1 = run["window"]
    return now_ns - int((now - t0) * 1e9), now_ns - int((now - t1) * 1e9)


def of_run(run: dict) -> list | None:
    if run.get("trace") is None:
        return None
    try:
        from fish_speech_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    opened, closed = window_ns(run)
    spans = [s for s in recorded_spans()
             if opened <= s.start_ns and s.end_ns <= closed]
    return spans or None


def scheduler(run: dict) -> list | None:
    """The scheduler thread's spans of the run, None without a tick."""
    spans = of_run(run)
    if spans is None:
        return None
    log = run.get("tick_log") or {}
    thread = log.get("scheduler")
    if thread is None:
        thread = next((s.thread for s in spans if s.name == "tick"), None)
    mine = [s for s in spans if s.thread == thread]
    return mine if any(s.name == "tick" for s in mine) else None


def ticks(spans: list) -> int:
    """Decode ticks the `tick` spans ran (a chunked one runs n)."""
    return sum(s.attrs["n"] for s in spans if s.name == "tick")


def under(spans: list, name: str, ancestor: str) -> list:
    """The spans named `name` with a span named `ancestor` around them."""
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        if s.name != name:
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != ancestor:
            p = by_id.get(p.parent)
        if p is not None:
            out.append(s)
    return out


def wall_ns(spans: list) -> int:
    return sum(s.end_ns - s.start_ns for s in spans)


def per_tick_ms(run: dict, name: str) -> float | None:
    """Host ms a decode tick spent in the spans named `name` inside the
    scheduler's ticks."""
    spans = scheduler(run)
    if spans is None or not ticks(spans):
        return None
    return wall_ns(under(spans, name, "tick")) / 1e6 / ticks(spans)


def overlap_ns(a: list, b: list) -> int:
    """The length of the intersection of two sorted lists of disjoint
    (start, end) intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(run: dict) -> list:
    """The device's idle gaps: between the union of the trace's device
    intervals, as `trace.reduce` forms them, cut to the window."""
    opened, closed = window_ns(run)
    busy = _union([(s, s + d) for _, s, d in run["trace"]["device"]])
    return [(max(e0, opened), min(s1, closed))
            for (_, e0), (s1, _) in zip(busy, busy[1:])
            if min(s1, closed) > max(e0, opened)]


def median(values: list) -> float | None:
    return float(statistics.median(values)) if values else None
