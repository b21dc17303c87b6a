"""On the card: `utils/profiling.profile_table`, which reads the profiler's
raw records, against torch.profiler's public `key_averages()` on the same
profiled window. Both must give every device kernel, copy and memset the
same count and self device time, so that a torch release which changes the
raw records fails here instead of shifting the idle share that
`chip_smoke.py` and `tools/profile_decode.py` report. Two windows: a few
library ops with copies and a memset, and profile_decode's workload (the
full serving configuration at S2-Pro width, B = 64 over a 384 cache, 4
steps; `key_averages()` costs seconds a step there). Each prints both
busy times."""

import pytest
import torch

from fish_speech_tpu_torch.tools import profile_decode
from fish_speech_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _key_averages_rows(prof) -> dict:
    """name -> (self device ms, count) of the device rows of
    key_averages()."""
    rows = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.key] = (us / 1e3, e.count)
    return rows


def _assert_same(prof, wall: float, label: str) -> None:
    table = profiling.profile_table(prof, wall)
    mine = {k["name"]: (k["ms"], k["count"]) for k in table["kernels"]}
    public = _key_averages_rows(prof)
    busy = sum(ms for ms, _ in public.values())
    print(f"{label}: profile_table busy {table['busy_ms']:.6f} ms, "
          f"key_averages busy {busy:.6f} ms, {len(mine)} / {len(public)} "
          f"names, {sum(n for _, n in mine.values())} device events")
    assert mine, "no device event recorded"
    assert set(mine) == set(public)
    for name, (ms, n) in mine.items():
        assert n == public[name][1], name
        assert ms == pytest.approx(public[name][0], rel=1e-6, abs=1e-6), name
    assert table["busy_ms"] == pytest.approx(busy, rel=1e-9)


def test_profile_table_equals_key_averages_small(dev):
    a = torch.randn(512, 512, device=dev)
    host = torch.randn(1 << 16)
    torch.cuda.synchronize()
    with profiling.trace() as prof:
        for _ in range(3):
            b = (a @ a).relu_()
            a = b / b.norm()
        d = host.to(dev)
        d.zero_()
        back = a.sum().cpu()
        torch.cuda.synchronize()
    assert torch.isfinite(back)
    _assert_same(prof, 1.0, "small")


def test_profile_table_equals_key_averages_decode(dev, monkeypatch):
    seen = []
    table_of = profiling.profile_table

    def keep(prof, wall):
        seen.append((prof, wall))
        return table_of(prof, wall)

    monkeypatch.setattr(profiling, "profile_table", keep)
    args = profile_decode.parse_args([
        "--batch", "64", "--cache", "384", "--steps", "4", "--kv-int8",
        "--pallas", "stream", "--fused-fast", "--kv-layout", "pos"])
    profile_decode.run_workload(args)
    (prof, wall), = seen
    _assert_same(prof, wall, "profile_decode B=64 cache 384, 4 steps")
