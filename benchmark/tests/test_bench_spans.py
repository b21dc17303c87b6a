"""The readers of the program's spans on a synthetic traced run: each of
the nine against numbers worked out by hand, and None where the program
records no spans (an untraced run, an empty record, or a program without
the recorder, as the parent of the spans' commit)."""

import time

import pytest

from benchmark.harness import cell as cells
from benchmark.harness.clients import clock
from fish_speech_tpu_torch.utils import profiling
from fish_speech_tpu_torch.utils.profiling import Span

MS = 1_000_000
SCHED, VOC, OTHER = 11, 22, 33

READERS = ("tick_slow_ms", "tick_fast_ms", "tick_fetch_ms",
           "enqueue_cpu_share", "idle_enqueue_share", "slot_occupancy",
           "queue_wait_p50_s", "prefill_p50_ms", "voc_step_p50_ms")


def _spans(base: int) -> list:
    """(name, id, parent, thread, start ms, end ms, cpu ms, attrs)."""
    rows = [
        ("tick", 1, None, SCHED, 0, 100, 90, {"n": 1, "rows": 6}),
        ("decode.slow", 2, 1, SCHED, 5, 45, 30, {}),
        ("decode.fast", 3, 1, SCHED, 45, 80, 35, {}),
        ("tick.fetch", 4, 1, SCHED, 80, 95, 1, {}),
        ("tick", 5, None, SCHED, 100, 300, 150, {"n": 2, "rows": 12}),
        ("decode.slow", 6, 5, SCHED, 105, 145, 40, {}),
        ("decode.fast", 7, 5, SCHED, 145, 185, 20, {}),
        ("decode.slow", 8, 5, SCHED, 185, 225, 40, {}),
        ("decode.fast", 9, 5, SCHED, 225, 260, 35, {}),
        ("tick.fetch", 10, 5, SCHED, 260, 295, 2, {}),
        ("prefill", 12, None, SCHED, 300, 350, 40,
         {"request": 3, "tokens": 40, "chunked": False}),
        ("decode.slow", 13, 12, SCHED, 305, 330, 20, {}),
        ("decode.fast", 14, 12, SCHED, 330, 340, 10, {}),
        ("prefill", 15, None, SCHED, 350, 360, 9,
         {"request": 6, "tokens": 8, "chunked": True}),
        ("queue", 16, None, SCHED, -1000, 300, None, {"request": 3}),
        ("queue", 17, None, SCHED, 200, 350, None, {"request": 4}),
        ("queue", 18, None, SCHED, 0, 50, None, {"request": 5}),
        ("stream.vocoder", 19, None, VOC, 10, 30, 20, {"frames": 4}),
        ("stream.vocoder", 20, None, VOC, 40, 70, 30, {"frames": 16}),
        ("stream.vocoder", 21, None, VOC, 100, 110, 10, {"frames": 16}),
        # another thread's decode step: not the scheduler's
        ("decode.slow", 22, None, OTHER, 0, 1000, 1000, {}),
        # open when the window closed (at 1500): left out
        ("tick", 23, None, SCHED, 1400, 1700, 300, {"n": 1, "rows": 8}),
        ("tick.fetch", 24, 23, SCHED, 1450, 1460, 1, {}),
        ("stream.vocoder", 25, None, VOC, 1490, 1510, 20, {"frames": 16}),
    ]
    return [Span(n, i, p, th, base + s * MS, base + e * MS,
                 None if c is None else c * MS, a)
            for n, i, p, th, s, e, c, a in rows]


def _run(base: int, trace: bool = True) -> dict:
    """The window from -3000 to 1500 ms. Device intervals (ms): 0-5, 50-60
    and 55-58 (overlapping), 100-105, 290-400, 1600-1650; idle gaps 5-50,
    60-100, 105-290, and 400-1500 inside the window."""
    now_ns, now = time.time_ns(), clock()

    def at(ms):
        return now - (now_ns - base - ms * MS) / 1e9

    device = [("k", base + s * MS, d * MS)
              for s, d in ((0, 5), (50, 10), (55, 3), (100, 5), (290, 110),
                           (1600, 50))]
    return {"window": (at(-3000), at(1500)), "window_s": 4.5,
            "trace": {"device": device} if trace else None,
            "tick_log": {"scheduler": SCHED}, "traffic": {"slots": 8}}


@pytest.fixture
def recorded(monkeypatch):
    base = time.time_ns() - 2_000 * MS
    monkeypatch.setattr(profiling, "recorded_spans", lambda: _spans(base))
    return base


def test_readers_on_a_synthetic_run(recorded):
    run = _run(recorded)
    got = {name: cells.reader(name)(run) for name in READERS}
    want = {
        "tick_slow_ms": (40 + 40 + 40) / 3,
        "tick_fast_ms": (35 + 40 + 35) / 3,
        "tick_fetch_ms": (15 + 35) / 3,
        # the scheduler's decode spans, a prefill's included
        "enqueue_cpu_share": 100 * (30 + 35 + 40 + 20 + 40 + 35 + 20 + 10)
        / (40 + 35 + 40 + 40 + 40 + 35 + 25 + 10),
        # idle 45 + 40 + 185 + 1100 ms; under decode spans (5-80,
        # 105-260, 305-340): 45 + 20 + 155
        "idle_enqueue_share": 100 * (45 + 20 + 155) / (45 + 40 + 185
                                                       + 1100),
        "slot_occupancy": 100 * (6 + 12) / (3 * 8),
        "queue_wait_p50_s": 0.150,
        "prefill_p50_ms": 50.0,
        "voc_step_p50_ms": 20.0,
    }
    for name in READERS:
        assert isinstance(got[name], float), name
        # the window's edges move by the microseconds between the two
        # clocks' reads
        assert got[name] == pytest.approx(want[name], rel=1e-5), name


def test_readers_without_spans(recorded, monkeypatch):
    """None with no trace, no span in the window, an empty record, a
    record without the scheduler's ticks, or no recorder at all."""
    def all_none(run):
        return [name for name in READERS
                if cells.reader(name)(run) is not None]

    assert all_none(_run(recorded, trace=False)) == []
    stale = _run(recorded)
    stale["window"] = (clock() + 1.0, clock() + 6.0)   # opened after them
    assert all_none(stale) == []
    monkeypatch.setattr(profiling, "recorded_spans", lambda: [])
    assert all_none(_run(recorded)) == []
    vocoder_only = [s for s in _spans(recorded) if s.thread == VOC]
    monkeypatch.setattr(profiling, "recorded_spans", lambda: vocoder_only)
    assert all_none(_run(recorded)) == ["voc_step_p50_ms"]
    monkeypatch.delattr(profiling, "recorded_spans")
    assert all_none(_run(recorded)) == []
