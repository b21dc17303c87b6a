"""What the host did in the window, for the run's log.

The port's decode loop runs on the host, so a run's rate follows the
host's speed. At the window's opening and closing this reads the
process's own CPU seconds; `describe` turns the two readings into one
line for standard error, beside the scheduler's ticks and the check's
sample: CPU seconds a tick that change from run to run, at the same
share of the cores, mean the cores ran at another speed. Nothing here
goes into a metric. (The whole machine's load is not read: the card's
machine reports none.)
"""

from __future__ import annotations

import time


def read() -> float:
    return time.process_time()


def describe(run: dict, cpu0: float, cpu1: float, readings: dict) -> str:
    wall, ticks = run["window_s"], run["ticks"]
    per_tick = f"{1e3 * (cpu1 - cpu0) / ticks:.1f}" if ticks else "-"
    return (f"host: window {wall:.1f} s, ticks {ticks}, this process's CPU "
            f"{(cpu1 - cpu0) / wall:.2f} cores, {per_tick} CPU ms a tick, "
            f"check sample {readings.get('sampled', 0)} requests, "
            f"{readings.get('frames', 0)} frames")
