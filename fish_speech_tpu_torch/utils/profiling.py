"""Profiling helpers: the program's spans, torch.profiler traces and the
device-time accounting of a profiled window.

Counterpart of `fish_speech_tpu/utils/profiling.py`. Spans: `span(name,
**attrs)` marks a block of the host's work (a tick, a decode step's two
halves, a fetch, a prefill, a vocoder step) while a torch.profiler session
is open, in any thread, and costs one flag read otherwise; the records
stay in memory (`recorded_spans`) on the profiler's clock, so a reader
can set them against the session's device events. Accounting: a
torch.profiler trace around a block, and what the port's tools and
`chip_smoke.py` read from it: the device's busy time, its idle share of
the window's wall time, and the kernels by self device time with their
counts. Every number it gives is read from a trace of the card; a trace
without device events gives none.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import NamedTuple

from torch.autograd import profiler as _autograd_profiler

# a chrome trace's device events: kernels, copies and memsets
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Span(NamedTuple):
    """One recorded span. `start_ns` / `end_ns` on the epoch clock
    (`time.time_ns()`), the one kineto stamps its events with; `cpu_ns`
    the thread's CPU time inside it (None for a span given its start,
    `span_since`); `parent` the id of the span open around it in the same
    thread, or None."""
    name: str
    id: int
    parent: int | None
    thread: int
    start_ns: int
    end_ns: int
    cpu_ns: int | None
    attrs: dict


# the records of every thread, oldest dropped past about a million
_SPANS: deque = deque(maxlen=1 << 20)
_IDS = itertools.count(1)
_OPEN = threading.local()        # .stack: the thread's open span ids


def _open_stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class _Off:
    """The shared span of a block run with no profiler session open."""
    __slots__ = ()
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _On:
    """A span being recorded; appended to the records when it closes."""
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "cpu0")
    recording = True

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _open_stack()
        self.id = next(_IDS)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.cpu0 = time.thread_time_ns()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        cpu = time.thread_time_ns() - self.cpu0
        _open_stack().pop()
        _SPANS.append(Span(self.name, self.id, self.parent,
                           threading.get_ident(), self.start_ns, end, cpu,
                           self.attrs))
        return None

    def set(self, **attrs) -> None:
        """Attributes known only inside the block (a tick's rows)."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """`with span("tick", n=1) as s:` records the block while a
    torch.profiler session is open, in any thread of the process (the
    flag torch.autograd.profiler keeps; it falls only once the session has
    finished stopping, so a reader cuts the spans to its own window);
    otherwise it returns one shared context that records nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, attrs)


def span_since(name: str, start_ns: int, **attrs) -> None:
    """Record a span that began at `start_ns` (`time.time_ns()`, stamped
    elsewhere, as a request's submission) and ends now, under the span
    open in this thread; nothing with no profiler session open."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _open_stack()
    _SPANS.append(Span(name, next(_IDS), stack[-1] if stack else None,
                       threading.get_ident(), start_ns, time.time_ns(), None,
                       attrs))


def recorded_spans() -> list[Span]:
    """A copy of the spans recorded so far, in the order they closed."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None, cuda: bool = True):
    """Profile a block: `with trace() as prof: step()`. CPU and (with
    `cuda`) device activity; with `log_dir`, the chrome trace is written to
    log_dir/trace.json on exit."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _union_length(intervals):
    """The length of the union of (start, end) intervals: overlapping
    device work counted once."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_table(rows, wall_s: float, covered_ms: float) -> dict:
    """The accounting of a profiled window of `wall_s` seconds from its
    device rows (name, self device ms, count) and the ms its device events
    cover (their union: overlapping events counted once): the busy ms (the
    rows' sum), the idle share of the wall time (the part no event covers;
    None where the window recorded no device time: a CPU run, or a session
    that kept no device event) and the rows by time, costliest first."""
    rows = sorted(((ms, n, name) for name, ms, n in rows if ms > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms": wall_s * 1e3, "busy_ms": busy,
            "idle_share": (1 - covered_ms / (wall_s * 1e3)
                           if rows and wall_s > 0 else None),
            "kernels": [{"name": name, "ms": ms, "count": n}
                        for ms, n, name in rows]}


def profile_table(prof, wall_s: float) -> dict:
    """`device_table` of a finished torch.profiler session: its device
    kernels, copies and memsets summed by name, read from the session's
    raw records. (Its `key_averages()` gives the same sums and counts,
    which tests/test_torch_cuda_profiling.py holds on the card, but first
    links every host op to its kernels in Python: minutes for 32 decode
    steps at the S2-Pro shape.)"""
    import torch

    ms, counts, intervals = defaultdict(float), defaultdict(int), []
    for e in prof.profiler.kineto_results.events():
        # a range annotation on the device is no device work (newer torch
        # marks it; no caller here annotates)
        annotation = getattr(e, "is_user_annotation", None)
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or (annotation is not None and annotation())):
            continue
        ms[e.name()] += e.duration_ns() / 1e6
        counts[e.name()] += 1
        intervals.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return device_table([(k, v, counts[k]) for k, v in ms.items()], wall_s,
                        _union_length(intervals) / 1e6)


def trace_table(path: str | Path, wall_s: float | None = None) -> dict:
    """`device_table` of a saved chrome trace (`trace(log_dir)`): its
    kernel, copy and memset events summed by name. The wall time is
    `wall_s`, else the one `save_wall` stored in the trace."""
    data = json.loads(Path(path).read_text())
    ms, counts, intervals = defaultdict(float), defaultdict(int), []
    for ev in data.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS:
            ms[ev["name"]] += ev.get("dur", 0) / 1e3     # us in the trace
            counts[ev["name"]] += 1
            intervals.append((ev["ts"], ev["ts"] + ev.get("dur", 0)))
    if wall_s is None:
        wall_s = data.get("fish_speech_tpu_torch", {}).get("wall_ms", 0) / 1e3
    return device_table([(k, v, counts[k]) for k, v in ms.items()], wall_s,
                        _union_length(intervals) / 1e3)


def save_wall(path: str | Path, wall_s: float) -> None:
    """Store the profiled window's wall time in its chrome trace."""
    path = Path(path)
    data = json.loads(path.read_text())
    data["fish_speech_tpu_torch"] = {"wall_ms": wall_s * 1e3}
    path.write_text(json.dumps(data))


def table_lines(table: dict, head: str, n_rows: int) -> list[str]:
    """A table as text: the head with the busy ms and idle share, then the
    n_rows costliest kernels (ms, share of busy, count, name)."""
    busy = table["busy_ms"]
    idle = table["idle_share"]
    lines = [f"{head}, device busy {busy:.1f} ms, idle share "
             + ("not measured" if idle is None else f"{idle:.3f}")]
    for k in table["kernels"][:n_rows]:
        lines.append(f"  {k['ms']:10.3f} ms {k['ms'] / busy:6.1%} "
                     f"{k['count']:7d}x  {k['name'][:90]}")
    return lines
