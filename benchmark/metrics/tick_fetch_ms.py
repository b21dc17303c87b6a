"""tick_fetch_ms: host milliseconds a decode tick waits for its column
(the program's `tick.fetch` spans around the tick's one device-to-host
copy, the only sync), over the ticks: the device's time beyond what the
host took to enqueue the tick."""

from benchmark.harness.spans import per_tick_ms


def read(run: dict) -> float | None:
    return per_tick_ms(run, "tick.fetch")
