"""Steady-state probe of candidate implementations.

After `fish_speech_tpu/utils/probing.py::steady_state_winner`: each
candidate runs two host-synced calls, then two timed ones; the fastest
wins. The serving engine's `vocoder_impl="auto"` uses it.
"""

from __future__ import annotations

import time
from typing import Callable


def steady_state_winner(candidates: "dict[str, Callable[[], object]]"):
    """Each candidate is a zero-arg callable performing ONE host-synced
    invocation (the call must not return until the device finished).
    Returns (winner_name, {name: seconds_per_call}). A candidate that
    raises fails the probe: no error is scored away."""
    results: dict[str, float] = {}
    for name, call in candidates.items():
        for _ in range(2):
            call()
        t0 = time.perf_counter()
        for _ in range(2):
            call()
        results[name] = (time.perf_counter() - t0) / 2
    return min(results, key=results.get), results
