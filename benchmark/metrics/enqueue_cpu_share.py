"""enqueue_cpu_share: the scheduler thread's CPU time inside its
`decode.slow` and `decode.fast` spans over their wall time, in percent.
Below 100%, the thread was ready to launch but not running: waiting for
the interpreter lock (the vocoder and client threads hold it) or for a
core."""

from benchmark.harness.spans import scheduler, wall_ns


def read(run: dict) -> float | None:
    spans = scheduler(run)
    if spans is None:
        return None
    dec = [s for s in spans if s.name in ("decode.slow", "decode.fast")]
    wall = wall_ns(dec)
    if not wall:
        return None
    return 100.0 * sum(s.cpu_ns for s in dec) / wall
