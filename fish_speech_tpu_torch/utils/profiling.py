"""Profiling helpers: torch.profiler traces, the device-time accounting of
a profiled window, and throughput counters.

Counterpart of `fish_speech_tpu/utils/profiling.py`. The reference logs
tokens/s and model bandwidth per batch (ref inference.py:693-705); here the
same counters, a torch.profiler trace around a block, and the accounting
the port's tools and `chip_smoke.py` read from it: the device's busy time,
its idle share of the window's wall time, and the kernels by self device
time with their counts. Every number it gives is read from a trace of the
card; a trace without device events gives none.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

# a chrome trace's device events: kernels, copies and memsets
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


def device_table(rows, wall_s: float) -> dict:
    """The accounting of a profiled window of `wall_s` seconds from its
    device rows (name, self device ms, count): the busy ms, the idle share
    of the wall time (None where the window recorded no device time: a CPU
    run, or a session that kept no device event) and the rows by time,
    costliest first."""
    rows = sorted(((ms, n, name) for name, ms, n in rows if ms > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms": wall_s * 1e3, "busy_ms": busy,
            "idle_share": (1 - busy / (wall_s * 1e3)
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

    ms, counts = defaultdict(float), defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        # a range annotation on the device is no device work (newer torch
        # marks it; no caller here annotates)
        annotation = getattr(e, "is_user_annotation", None)
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or (annotation is not None and annotation())):
            continue
        ms[e.name()] += e.duration_ns() / 1e6
        counts[e.name()] += 1
    return device_table([(k, v, counts[k]) for k, v in ms.items()], wall_s)


def trace_table(path: str | Path, wall_s: float | None = None) -> dict:
    """`device_table` of a saved chrome trace (`trace(log_dir)`): its
    kernel, copy and memset events summed by name. The wall time is
    `wall_s`, else the one `save_wall` stored in the trace."""
    data = json.loads(Path(path).read_text())
    ms, counts = defaultdict(float), defaultdict(int)
    for ev in data.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS:
            ms[ev["name"]] += ev.get("dur", 0) / 1e3
            counts[ev["name"]] += 1
    if wall_s is None:
        wall_s = data.get("fish_speech_tpu_torch", {}).get("wall_ms", 0) / 1e3
    return device_table([(k, v, counts[k]) for k, v in ms.items()], wall_s)


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


class Throughput:
    """Rolling decode-throughput accounting (tokens/s, audio-s/s, weight
    bandwidth)."""

    def __init__(self, param_bytes: int = 0,
                 frame_rate: float = 44100 / 2048):
        self.param_bytes = param_bytes
        self.frame_rate = frame_rate
        self.reset()

    def reset(self):
        self.tokens = 0
        self.t0 = time.perf_counter()

    def add(self, n_tokens: int):
        self.tokens += n_tokens

    def report(self) -> dict:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        tok_s = self.tokens / dt
        return {
            "tokens_per_s": tok_s,
            "audio_s_per_s": tok_s / self.frame_rate,
            "bandwidth_gb_s": self.param_bytes * tok_s / 1e9,
            "wall_s": dt,
        }
