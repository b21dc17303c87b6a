"""w4a8_roofline: the W4A8 products' (#11, `w4a8_*` kernels) share of
their roofline over the decode ticks of the traced window: each tick's
slow stack launches its layers' five products (wqkv, wo, w1, w3, w2) in
that order at M = the cell's slots, before the tick's fast-head sweeps;
the sum of each product's bound (its int4 weights, scales, activations
and output) over the sum of their device time, in percent. A prefill's
products (followed by the one-row sweep) are left out."""

import re

from benchmark.roofline import slow_products, w4a8_bound_s


def read(run: dict) -> float | None:
    tr = run["trace"]
    if tr is None or run["config"]["serving"]["quant"] != "w4a8":
        return None
    s = run["shape"]
    group = run["config"]["serving"]["groupsize"]
    prods = slow_products(s)
    per_step = len(prods) * s["n_layer"]
    m = run["traffic"]["slots"]
    bound = spent = 0.0
    pending: list[int] = []
    for name, _, dur in tr["device"]:
        if re.search(r"\bw4a8_", name):
            pending.append(dur)
            continue
        hit = re.search(r"sweep_kernel<(?:\([A-Za-z_:]+\))?([A-Za-z_0-9]+)>",
                        name)
        if not hit:
            continue
        if pending and hit.group(1) not in ("0", "ONE_ROW") \
                and len(pending) >= per_step:
            for j, d in enumerate(pending[-per_step:]):
                _, n, k = prods[j % len(prods)]
                bound += w4a8_bound_s(m, n, k, group)
                spent += d / 1e9
        pending = []
    return 100.0 * bound / spent if spent else None
