"""Run one cell of the benchmark once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. In order: build (first run) or load the program's CUDA kernels, draw
the cell's weights on the card from the seed, build the engine through
the program's public pieces, warm the shapes the cell's traffic uses,
start the clients and open the window once every client's first request
is in, measure for `--seconds`, close the window (cancel what is in
flight), free the program, hold a sample of what it served against the
plain reference, and print the result as the last line of standard
output. Everything before the window counts as `setup_s`. With
`--trace 1` the window runs under the profiler and the line carries the
per-layer metrics and a breakdown instead of the end-to-end ones.

Exits 1 without a result line when there is no card (or too few), when
the program cannot be imported, or when the process holds JAX or the JAX
package after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "fish_speech_tpu")
# a traced run's window (the profiler's records of a longer one take
# minutes to read)
TRACE_SECONDS = 15.0
OUT = Path(__file__).resolve().parent / "out"


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(OUT / "cache" / sub)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _request(req):
    from fish_speech_tpu_torch.engine.generate import GenerateLongRequest

    return GenerateLongRequest(text=req.text,
                               max_new_tokens=req.max_new_tokens,
                               top_p=req.top_p, top_k=req.top_k,
                               temperature=req.temperature)


def warm(engine, traffic: dict) -> None:
    """Run the cell's own shapes once: one request that fills the prefix
    cache, then requests at the mix's text lengths from its shortest to its
    longest together (every prompt bucket after a prefix hit, a tick at the
    cell's slots) through the cell's entry, and, for `tts`, the vocoder at
    every frame count the mix can ask for (multiples of 32), or, for
    streams, both chunk widths."""
    from .harness.traffic import Request

    dist = traffic["text_bytes"]
    lengths = list(range(dist["min"], dist["max"], 50)) + [dist["max"]]
    chunk = traffic.get("chunk") or {}
    frames = (chunk["first"] + chunk["frames"] + 1 if chunk
              else traffic["min_frames"])
    errors = []

    def one(i, n):
        req = _request(Request(i, 0, "a" * (n - 1) + ".", frames, True, 1.0,
                               1, 1.0))
        try:
            if traffic["entry"] == "tts":
                engine.tts(req)
            else:
                for _ in engine.stream_tts(req, chunk_frames=chunk["frames"],
                                           first_chunk_frames=chunk["first"]):
                    pass
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    one(0, lengths[0])
    threads = [threading.Thread(target=one, args=(i, n))
               for i, n in enumerate(lengths)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    if traffic["entry"] == "tts":
        most = -(-traffic["frames_per_byte"] * dist["max"] // 32) * 32
        engine.warmup_vocoder(
            buckets=[(1, f) for f in range(32, int(most) + 64, 32)],
            stream_widths=())
    if engine.device.type == "cuda":
        import torch

        torch.cuda.synchronize()


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float = T_START, root: Path | None = None,
             control: bool = False) -> dict:
    """One run of `cell`; the result line as a dict (with the check's
    readings and the run's record under private keys). `control` adds
    the control's readings (benchmark/control.py)."""
    import torch

    from .harness import cell as cells
    from .harness import check, clients, draws, hostload, traffic
    from .harness import trace as tracing
    from .reference.dual_ar import Precision

    dev = torch.device(device)
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    cfg, mix = cell.config, cell.traffic
    shape = cells.lm_shape(cfg, mix["cache_len"])
    phases = [("start", t_start)]
    if dev.type == "cuda":
        from fish_speech_tpu_torch.ops import _cuda

        _cuda.build_all()
    phases.append(("kernels", time.perf_counter()))
    params, codec_params = draws.draw(seed, shape, cfg["codec"], dev)
    engine = cells.build_engine(cfg, mix, params, codec_params, dev)
    del params
    gc.collect()
    phases.append(("engine", time.perf_counter()))
    warm(engine, mix)
    phases.append(("warm-up", time.perf_counter()))
    tick_log = tracing.install_spans(engine) if trace else None
    per_client = traffic.clients(mix, seed)
    cl = clients.Clients(engine, per_client, mix["entry"], mix.get("chunk"),
                         _request)
    batcher = engine.scheduler.batcher
    cl.start()
    deadline = clients.clock() + 300
    while not cl.admitted():
        if clients.clock() > deadline:
            raise RuntimeError("the clients' first requests were not "
                               "admitted within 300 s")
        time.sleep(0.005)
    prof = None
    if trace:
        prof = tracing.session()
        prof_obj = prof.__enter__()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    host0 = hostload.read()
    t0 = clients.clock()
    ticks0 = batcher.ticks
    setup_s = t0 - t_start
    phases.append(("admissions", t0))
    log("setup s: " + ", ".join(f"{b[0]} {b[1] - a[1]:.1f}"
                                for a, b in zip(phases, phases[1:])))
    time.sleep(max(0.0, t0 + seconds - clients.clock()))
    t1 = clients.clock()
    ticks1 = batcher.ticks
    host1 = hostload.read()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    summary = None
    if trace:
        prof.__exit__(None, None, None)
    cl.close()
    engine.close()
    if trace:
        summary = tracing.reduce(prof_obj, t1 - t0, tick_log)
        tick_log["restore"]()
    records = cl.records
    del engine, cl, batcher
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check, on a fresh draw of the same weights
    chk = cfg["check"]
    recs = check.sample(records, t1, seed, chk["requests"], chk["frames"])
    readings = {"failed": sum(1 for r in records if r["error"] is not None
                              and r["sent"] <= t1),
                "sampled": len(recs)}
    if recs:
        w, cw = draws.draw(seed, shape, cfg["codec"], dev)
        readings["prompt"] = check.prompt_mismatches(recs,
                                                     shape["num_codebooks"])
        prec = Precision(**cfg["reference"])
        low = prec.replace(**cfg["control"]["lm"]) if control else None
        readings.update(check.lm_readings(w, shape, recs, prec, low))
        del w
        readings.update(check.wave_readings(cw, cfg["codec"], recs,
                                            control))
        del cw
    limits = {"failed": 0, "prompt": 0,
              "token_gap": cfg["limits"]["token_gap"],
              "wave_err": cfg["limits"]["wave_err"]}
    checks = {k: {"value": readings.get(k), "limit": v}
              for k, v in limits.items()}
    # the sample has to hold as many frames as the control was read on
    checks["frames"] = {"value": readings.get("frames", 0),
                        "at_least": chk["min_frames"]}
    correct = (all(c["value"] is not None and c["value"] <= c["limit"]
                   for c in checks.values() if "limit" in c)
               and checks["frames"]["value"] >= chk["min_frames"])

    run = {"window": (t0, t1), "window_s": t1 - t0, "setup_s": setup_s,
           "records": records, "config": cfg, "traffic": mix,
           "shape": shape, "ticks": ticks1 - ticks0, "trace": summary,
           "tick_log": tick_log}
    log(hostload.describe(run, host0, host1, readings))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        kw = {} if root is None else {"root": root}
        value = cells.reader(m["name"], **kw)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {"correct": correct,
           "attempted": sum(1 for r in records if t0 <= r["sent"] <= t1),
           "failed": readings["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": kind, "count": 1, "memory_peak_bytes": peak}}
    if trace:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = tracing.breakdown(summary)
    out["checks"] = checks
    out["_readings"] = readings
    out["_run"] = run
    return out


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def result_line(out: dict) -> str:
    return json.dumps({k: v for k, v in out.items()
                       if not k.startswith("_")})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    os.environ.setdefault("USE_FLAX", "0")
    spec = Path.cwd() / "BENCHMARK.json"
    try:
        import torch

        import fish_speech_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program under test cannot be imported: {e}")
        return 1
    from .harness import cell as cells

    cell = cells.load(args.workload, spec)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    torch.cuda.set_device(0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = banned_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 1
    for name, c in out["checks"].items():
        bound = (f"limit {c['limit']}" if "limit" in c
                 else f"at least {c['at_least']}")
        log(f"check {name}: {c['value']} ({bound})")
    print(result_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
