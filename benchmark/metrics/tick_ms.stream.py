"""tick_ms.stream: milliseconds of the traced window per decode tick of
the scheduler (`ContinuousBatcher.ticks`), in the stream cells."""


def read(run: dict) -> float | None:
    if run["traffic"]["entry"] != "stream_tts" or not run["ticks"]:
        return None
    return 1e3 * run["window_s"] / run["ticks"]
