"""The traced run: spans around the calls into each layer, a profiler
session over the window, and its reduction to what the per-layer metrics
read.

Spans are the benchmark's own: in a `--trace 1` run, `install_spans`
wraps the scheduler's tick, prefill and assign calls, the serving
vocoder and the streaming vocoder's step (the program is not edited),
timing each on the host's epoch clock, the profiler's, and counts,
before every tick, the rows that decode and their lengths. The profiler
records the card's kernels, copies and memsets and the CUDA runtime calls
of every host thread; `reduce` gives the device's busy time as the union
of those intervals (overlapping work counted once), the sums by name, the
device events in time order, and the idle gaps labelled by the scheduler
thread's span and the runtime call open at each gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import threading
import time
from collections import defaultdict

import torch

def _wrap(obj, name: str, span: str, spans: list, before=None):
    orig = getattr(obj, name)

    @functools.wraps(orig)
    def call(*args, **kwargs):
        if before is not None:
            before()
        t = time.time_ns()
        try:
            return orig(*args, **kwargs)
        finally:
            spans.append((span, threading.get_ident(), t, time.time_ns()))

    setattr(obj, name, call)


def install_spans(engine) -> dict:
    """Wrap the engine's layers in spans; returns the log: `spans` (name,
    thread, start ns, end ns; the profiler's epoch clock), `scheduler`
    (the scheduler thread's id) and `ticks` (per tick, its host time and
    the decoding rows' sequence lengths: prompt + frames so far)."""
    from fish_speech_tpu_torch.codec import streaming

    b = engine.scheduler.batcher
    log = {"ticks": [], "spans": [],
           "scheduler": engine.scheduler.thread.ident}

    def before_tick():
        rows = []
        for slot, req in enumerate(b.slot_req):
            if req is not None and b.active_h[slot]:
                rows.append(req.prompt.shape[1] + len(req.result))
        log["ticks"].append((time.perf_counter(), rows))

    spans = log["spans"]
    _wrap(b, "step", "tick", spans, before_tick)
    _wrap(b, "_assign", "assign", spans)
    _wrap(b, "prefill_tick", "prefill", spans)
    _wrap(engine, "_vocode", "vocoder", spans)
    orig_step = streaming.StatefulVocoder.step
    _wrap(streaming.StatefulVocoder, "step", "stream_vocoder", spans)
    log["restore"] = lambda: setattr(streaming.StatefulVocoder, "step",
                                     orig_step)
    return log


@contextlib.contextmanager
def session():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def reduce(prof, window_s: float, log: dict) -> dict:
    """The profiled window as plain data: `device` [(name, start_ns,
    dur_ns)] in time order, `busy_s` (union of device intervals),
    `by_name` {name: seconds}, and `gaps` {label: idle seconds}: each gap
    between busy intervals labelled by the scheduler thread's span open at
    its middle (or "scheduler between calls") and the CUDA runtime call
    any host thread was in (or "no CUDA call")."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)
        is_ann = bool(annotation()) if annotation is not None else False
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not is_ann and e.duration_ns() > 0:
                device.append((e.name(), e.start_ns(), e.duration_ns()))
        elif e.duration_ns() > 0 and e.name().startswith("cu"):
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.name()))
    device.sort(key=lambda d: d[1])
    busy = _union([(s, s + d) for _, s, d in device])
    by_name: dict[str, float] = defaultdict(float)
    for name, _, d in device:
        by_name[name] += d / 1e9
    sched = sorted((s, e, n) for n, th, s, e in log["spans"]
                   if th == log["scheduler"])
    span_at = _Intervals(sched)
    op_at = _Intervals(sorted(host))
    gaps: dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) // 2
        label = (f"{span_at.open_at(mid) or 'scheduler between calls'} / "
                 f"{op_at.open_at(mid) or 'no CUDA call'}")
        gaps[label] += (s1 - e0) / 1e9
    return {"window_s": window_s, "device": device,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "by_name": dict(by_name), "gaps": dict(gaps)}


class _Intervals:
    """(start, end, name) sorted by start: the latest-starting one open at
    a time (looking back over at most 2000)."""

    def __init__(self, items):
        self.starts = [s for s, _, _ in items]
        self.items = items

    def open_at(self, t):
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(-1, i - 2001), -1):
            if self.items[j][1] >= t:
                return self.items[j][2]
        return None


def breakdown(summary: dict, n: int = 10) -> dict:
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
