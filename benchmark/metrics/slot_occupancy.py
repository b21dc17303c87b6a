"""slot_occupancy: the rows the scheduler's ticks decoded (the `rows`
counts of its `tick` spans) over the ticks times the cell's slots, in
percent: how full the decode batch ran."""

from benchmark.harness.spans import scheduler, ticks


def read(run: dict) -> float | None:
    spans = scheduler(run)
    if spans is None or not ticks(spans):
        return None
    rows = sum(s.attrs["rows"] for s in spans if s.name == "tick")
    return 100.0 * rows / (ticks(spans) * run["traffic"]["slots"])
