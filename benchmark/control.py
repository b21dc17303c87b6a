"""The control of a cell's check, and the readings its limits are set
from.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--out FILE]

runs the cell once per seed in one process (the window as in a benchmark
run, on the card) and prints, per seed, one JSON line of the check's
readings of the program beside the control's: `token_gap` against
`control_lm` (the reference with the configuration's `control` precision
in the program's place, read by the gap of the token it puts first) and
`wave_err` against `control_wave` (the reference decoder in bfloat16).
The limits in the configuration file lie between the two, as PERF.md
sets out. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .run import _cache_dirs, log, run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    _cache_dirs()
    import time

    import torch

    from .harness import cell as cells

    if not torch.cuda.is_available():
        log("the control runs on the card")
        return 1
    cell = cells.load(args.workload, Path.cwd() / "BENCHMARK.json")
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(cell, seed, args.seconds, False, "cuda",
                       t_start=time.perf_counter(), control=True)
        row = {"workload": args.workload, "seed": seed,
               "correct": out["correct"], **out["_readings"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
