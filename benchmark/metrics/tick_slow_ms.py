"""tick_slow_ms: host milliseconds a decode tick spends in the slow
stack's eager launches (the program's `decode.slow` spans, the
`forward_generate` call of `decode_one_token`, inside the scheduler
thread's `tick` spans), over the ticks those spans ran."""

from benchmark.harness.spans import per_tick_ms


def read(run: dict) -> float | None:
    return per_tick_ms(run, "decode.slow")
