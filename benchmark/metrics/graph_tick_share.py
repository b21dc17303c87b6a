"""graph_tick_share: of the scheduler thread's `decode.slow` spans inside
its `tick` spans, the share whose `graph` attribute is True (the tick's
slow forward replayed as one CUDA graph, `SlowStepGraph`), in percent.
None where no such span carries the attribute: a program without the
graph, as the parent of its commit."""

from benchmark.harness.spans import scheduler, under


def read(run: dict) -> float | None:
    spans = scheduler(run)
    if spans is None:
        return None
    slow = [s for s in under(spans, "decode.slow", "tick")
            if "graph" in s.attrs]
    if not slow:
        return None
    return 100.0 * sum(1 for s in slow if s.attrs["graph"]) / len(slow)
