"""tick_fast_ms: host milliseconds a decode tick spends from the slow
stack's return to the new column (the program's `decode.fast` spans: the
slow token's sampling and RAS, then the fast head's positions and their
sampling, inside the scheduler thread's `tick` spans), over the ticks
those spans ran."""

from benchmark.harness.spans import per_tick_ms


def read(run: dict) -> float | None:
    return per_tick_ms(run, "decode.fast")
