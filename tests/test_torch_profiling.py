"""`utils/profiling`'s spans and device accounting on the CPU (one test on
the card): `span()` records nothing and allocates nothing without a
profiler session, and under one it records nested blocks of every thread
on the profiler's own clock; the scheduler's spans agree with its
counters; the idle share counts overlapping device events once."""

import json
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from fish_speech_tpu_torch.engine import scheduler as tsched
from fish_speech_tpu_torch.models.config import tiny_dual_ar_config
from fish_speech_tpu_torch.models.init import init_dual_ar_params
from fish_speech_tpu_torch.ops.sampling import semantic_logit_bias
from fish_speech_tpu_torch.utils import profiling

MS = 1_000_000
IM_END = 4


@pytest.fixture(autouse=True)
def _no_spans():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _cpu_session():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_off_records_nothing_and_allocates_nothing():
    """With no profiler session open, every call returns the same shared
    context, nothing is recorded, and a thousand spans leave no memory
    behind (at most the call's own keyword dict is live at a time)."""
    def loop(n):
        for i in range(n):
            with profiling.span("tick", n=1) as sp:
                sp.set(rows=3)
            profiling.span_since("queue", 5, request=i)

    assert profiling.span("a") is profiling.span("b", x=1)
    assert not profiling.span("a").recording
    loop(10)
    tracemalloc.start()
    try:
        loop(10)
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        loop(1000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after - before < 64
    assert peak - before < 1024          # a record each would be ~100 kB
    assert profiling.recorded_spans() == []


def test_spans_nest_and_share_the_profilers_clock():
    """Under a CPU-only session: the parent of a nested span is the span
    open around it in its thread; a span opened in another thread (the
    scheduler's, a vocoder's) records too, with no parent; the thread's
    CPU time is at most the wall time; and a `record_function` op's kineto
    interval lies inside the span around it, to 1 ms."""
    seen = []

    def other():
        with profiling.span("other"):
            seen.append(threading.get_ident())

    with _cpu_session() as prof:
        with profiling.span("outer", k=1) as outer:
            with profiling.span("inner"):
                with record_function("spans_clock_probe"):
                    a = torch.ones(64, 64)
                    for _ in range(20):
                        a = a @ a / 64
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            outer.set(rows=2)
        profiling.span_since("queue", time.time_ns() - 5 * MS, request=7)
    got = {s.name: s for s in profiling.recorded_spans()}
    assert set(got) == {"outer", "inner", "other", "queue"}
    assert got["inner"].parent == got["outer"].id
    assert got["outer"].parent is None and got["other"].parent is None
    assert got["other"].thread == seen[0] != got["outer"].thread
    assert got["outer"].attrs == {"k": 1, "rows": 2}
    assert got["queue"].attrs == {"request": 7}
    assert got["queue"].cpu_ns is None
    assert got["queue"].end_ns - got["queue"].start_ns >= 5 * MS
    for s in (got["outer"], got["inner"], got["other"]):
        assert s.start_ns <= s.end_ns
        assert 0 <= s.cpu_ns <= s.end_ns - s.start_ns + MS
    probe = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "spans_clock_probe"]
    assert len(probe) == 1
    p0 = probe[0].start_ns()
    p1 = p0 + probe[0].duration_ns()
    inner = got["inner"]
    assert inner.start_ns - MS <= p0 <= p1 <= inner.end_ns + MS
    # after the session: nothing more is recorded
    with profiling.span("late"):
        pass
    assert len(profiling.recorded_spans()) == 4


# --- the scheduler's spans --------------------------------------------------


@pytest.fixture(scope="module")
def tiny_lm():
    cfg = tiny_dual_ar_config()
    params = init_dual_ar_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    return cfg, params


def _batcher(tiny_lm, **kw):
    cfg, params = tiny_lm
    args = dict(num_slots=3, cache_len=64, im_end_id=IM_END,
                bias=semantic_logit_bias(cfg.vocab_size, cfg.semantic_begin_id,
                                         cfg.semantic_end_id, IM_END),
                greedy=False, seed=3, prompt_bucket=16, prefill_chunk=None,
                device="cpu")
    args.update(kw)
    return tsched.ContinuousBatcher(params, cfg, **args)


def _requests(cfg, lengths, budgets, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i, (t, m) in enumerate(zip(lengths, budgets)):
        prompt = np.zeros((cfg.num_codebooks + 1, t), np.int32)
        prompt[0] = rng.integers(cfg.semantic_end_id + 1, cfg.vocab_size, t)
        reqs.append(tsched.SlotRequest(request_id=i, prompt=prompt,
                                       max_new_tokens=m, temperature=1.0,
                                       top_p=0.9, top_k=8))
    return reqs


def _count_calls(obj, name, counter, value=lambda *a: 1):
    orig = getattr(obj, name)

    def call(*args):
        counter.append(value(*args))
        return orig(*args)

    setattr(obj, name, call)


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_scheduler_thread_spans_match_its_counters(tiny_lm):
    """Requests through a SchedulerThread under a profiler session: one
    `tick` span a decode tick (the `ticks` counter's delta), each
    `decode.*` span under a tick inside it, a `tick.fetch` in every tick,
    one `queue` and one `prefill` span per assigned request, and the ticks'
    `rows` summing to the columns they handed out (`_emit` calls)."""
    cfg, _ = tiny_lm
    b = _batcher(tiny_lm)
    emits = []
    _count_calls(b, "_emit", emits)
    reqs = _requests(cfg, (9, 14, 6, 11, 20), (6, 9, 4, 7, 5))
    with _cpu_session():
        ticks0 = b.ticks
        sched = tsched.SchedulerThread(b)
        try:
            for r in reqs:
                sched.submit(r)
            for r in reqs:
                assert r.done.wait(timeout=120)
        finally:
            sched.stop()
        assert not sched.thread.is_alive()
        ticks = b.ticks - ticks0
    assert all(r.error is None for r in reqs)
    spans = profiling.recorded_spans()
    assert {s.thread for s in spans} == {sched.thread.ident}
    by_id = {s.id: s for s in spans}
    tick = [s for s in spans if s.name == "tick"]
    assert ticks > 0 and len(tick) == sum(s.attrs["n"] for s in tick) == ticks
    assert sum(s.attrs["rows"] for s in tick) == len(emits)
    fetch = [s for s in spans if s.name == "tick.fetch"]
    assert sorted(by_id[s.parent].id for s in fetch) == sorted(
        s.id for s in tick)
    under_tick = [s for s in spans if s.name.startswith("decode.")
                  and by_id.get(s.parent, s).name == "tick"]
    assert len(under_tick) == 2 * ticks
    for s in under_tick + fetch:
        assert _inside(s, by_id[s.parent])
    for name in ("queue", "prefill"):
        got = sorted(s.attrs["request"] for s in spans if s.name == name)
        assert got == [r.request_id for r in reqs], name
    prefill = [s for s in spans if s.name == "prefill"]
    assert all(not s.attrs["chunked"] for s in prefill)
    assert sorted(s.attrs["tokens"] for s in prefill) == sorted(
        r.prompt.shape[1] for r in reqs)
    # a prefill's own decode step is its child
    assert sum(1 for s in spans if s.name == "decode.slow"
               and by_id.get(s.parent, s).name == "prefill") == len(reqs)


def test_chunked_ticks_count_rows_from_their_columns(tiny_lm):
    """`step_chunk` ticks and chunked prefills: each tick span holds n
    ticks, the `ticks` delta in all; its rows are the rows active on the
    device at each of its ticks (a row that samples im_end stops there);
    a long prompt's chunks are `prefill` spans marked chunked."""
    cfg, _ = tiny_lm
    b = _batcher(tiny_lm, prefill_chunk=8)
    active = []
    _count_calls(b, "_tick", active, lambda: int(b.active.sum()))
    reqs = _requests(cfg, (9, 20, 6, 11), (9, 13, 30, 7), seed=1)
    with _cpu_session():
        ticks0 = b.ticks
        b.run(reqs, chunk_steps=4)
        ticks = b.ticks - ticks0
    spans = profiling.recorded_spans()
    tick = [s for s in spans if s.name == "tick"]
    assert any(s.attrs["n"] == 4 for s in tick)
    assert sum(s.attrs["n"] for s in tick) == ticks == len(active)
    assert sum(s.attrs["rows"] for s in tick) == sum(active)
    chunked = [s for s in spans if s.name == "prefill" and s.attrs["chunked"]]
    assert {s.attrs["request"] for s in chunked} == {0, 1, 3}   # T > 8
    assert sum(s.attrs["tokens"] for s in chunked) == 9 + 20 + 11
    # no submit, so no queue span
    assert not any(s.name == "queue" for s in spans)


# --- the device accounting -------------------------------------------------


def test_trace_table_counts_overlapping_events_once(tmp_path):
    """Two streams' kernels that overlap: the busy ms is the per-name sum
    (1.0 ms), the idle share the part of the window no event covers (the
    union, 0.6 ms of 2 ms)."""
    events = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0,
               "dur": 400.0},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 100.0,
               "dur": 200.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 350.0,
               "dur": 150.0},
              {"ph": "X", "cat": "kernel", "name": "a", "ts": 900.0,
               "dur": 100.0},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 920.0,
               "dur": 50.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
               "dur": 2000.0}]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    t = profiling.trace_table(tmp_path / "t.json", wall_s=0.002)
    assert t["busy_ms"] == pytest.approx(0.9)
    assert t["idle_share"] == pytest.approx(1 - 0.6 / 2.0)
    assert [(k["name"], k["count"]) for k in t["kernels"]] == [
        ("a", 2), ("b", 2), ("c", 1)]
    assert profiling._union_length([(5, 9), (0, 2), (1, 3), (9, 10),
                                    (4, 6)]) == 9


# --- on the card ------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_kernel_runs_inside_its_span():
    """On the card: a kernel launched and synchronized inside a span has
    its profiler device interval inside the span (the spans and the
    device events share one clock)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    a = torch.randn(2048, 2048, device=dev)
    (a @ a).sum().item()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.002)
        with profiling.span("probe"):
            b = a @ a
            torch.cuda.synchronize()
        time.sleep(0.002)
        with profiling.span("later"):
            (b + 1).sum().item()
    probe = next(s for s in profiling.recorded_spans() if s.name == "probe")
    later = next(s for s in profiling.recorded_spans() if s.name == "later")
    device = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and e.duration_ns() > 0]
    assert device
    first = min(device, key=lambda d: d[1])
    print(f"probe span {probe.end_ns - probe.start_ns} ns; first kernel "
          f"{first[0][:60]} {first[2] - first[1]} ns, "
          f"{first[1] - probe.start_ns} ns after the span opened")
    assert probe.start_ns <= first[1] <= first[2] <= probe.end_ns
    for _, s, e in device:
        inside_probe = probe.start_ns <= s <= e <= probe.end_ns
        inside_later = later.start_ns <= s <= e <= later.end_ns
        assert inside_probe or inside_later
