"""decode_mfu: the int8 operations of the frames the scheduler's ticks
decoded in the traced window (each decoding row one frame at its own
sequence length: the slow stack's and fast head's products, the heads,
attention over the row's keys; from the configuration's shapes) over the
window's seconds times the card's int8 peak, in percent."""

from benchmark.roofline import PEAK_OPS_PER_S, frame_ops


def read(run: dict) -> float | None:
    log = run["tick_log"]
    if log is None or run["trace"] is None:
        return None
    t0, t1 = run["window"]
    shape = run["shape"]
    ops = sum(frame_ops(shape, n) for t, rows in log["ticks"]
              if t0 <= t <= t1 for n in rows)
    if not ops:
        return None
    return 100.0 * ops / (run["window_s"] * PEAK_OPS_PER_S["int8"])
