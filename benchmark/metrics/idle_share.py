"""idle_share: the share of the traced window in which no kernel, copy or
memset ran on the card (1 - the union of the device's busy intervals /
the window), in percent."""


def read(run: dict) -> float | None:
    tr = run["trace"]
    if tr is None or not tr["device"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
