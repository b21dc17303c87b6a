"""tick_ms.batch: milliseconds of the traced window per decode tick of
the scheduler (`ContinuousBatcher.ticks`), in the `tts` (batch) cells."""


def read(run: dict) -> float | None:
    if run["traffic"]["entry"] != "tts" or not run["ticks"]:
        return None
    return 1e3 * run["window_s"] / run["ticks"]
