"""sweep_roofline: the fast-head sweep's (#2, `sweep_kernel`) share of its
roofline in the traced window: the sum of each launch's bound (its batch
from the kernel's instance, 1 for the one-row instance and the cell's
slots for the others, at the mean of the ten codebook positions) over the
sum of the launches' device time, in percent."""

import re

from benchmark.roofline import sweep_bound_s

_INSTANCE = {"0": 0, "1": 1, "2": 2, "ONE_ROW": 0, "ROWS": 1, "TILED": 2}


def instance(name: str) -> int | None:
    m = re.search(r"sweep_kernel<(?:\([A-Za-z_:]+\))?([A-Za-z_0-9]+)>", name)
    return _INSTANCE.get(m.group(1)) if m else None


def read(run: dict) -> float | None:
    tr = run["trace"]
    if tr is None:
        return None
    s = run["shape"]
    k = s["num_codebooks"]
    slots = run["traffic"]["slots"]
    bound = spent = 0.0
    for name, _, dur in tr["device"]:
        inst = instance(name) if "sweep_kernel" in name else None
        if inst is None:
            continue
        b = 1 if inst == 0 else slots
        bound += sum(sweep_bound_s(b, p, s["fast_dim"], s["n_fast_layer"])
                     for p in range(k)) / k
        spent += dur / 1e9
    return 100.0 * bound / spent if spent else None
