"""The harness on the CPU at the tiny configuration: each cell's path
rehearsed end to end, discovery of cells, configurations, mixes and
metrics by name, the JAX check, and the refusals of the command."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import cell as cells
from benchmark.run import result_line, run_cell
from benchmark.tests import tiny

REPO = tiny.ROOT.parent
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS + list(tiny.LATER))
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_prints_a_well_formed_line(workload, trace):
    c = tiny.cell(workload)
    line = json.loads(result_line(run_cell(c, 2 ** 33 + 5, 2.0, bool(trace),
                                           "cpu")))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"]: m["unit"] for m in
             (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) <= set(names)
    for k, v in line["metrics"].items():
        assert v["unit"] == names[k] and isinstance(v["value"], float)
    if not trace:
        # on the CPU every end-to-end metric reads; the device's only on
        # the card
        assert set(line["metrics"]) == set(names)
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c_ in line["checks"].values():
        assert "value" in c_


def test_discovery_by_name(tmp_path):
    """A configuration, a mix and a metric added as files in a copy of the
    benchmark are found by their names, with no file edited."""
    root = tmp_path / "benchmark"
    shutil.copytree(tiny.ROOT, root, ignore=shutil.ignore_patterns(
        "out", "__pycache__"))
    (root / "configs" / "tiny-new.json").write_text(json.dumps(
        {**tiny.config("s2pro-int8"), "name": "tiny-new"}))
    (root / "traffic" / "trickle.json").write_text(json.dumps(
        {**tiny.traffic("stream8"), "name": "trickle", "clients": 1,
         "slots": 1}))
    (root / "metrics" / "requests_per_s.py").write_text(
        "def read(run):\n"
        "    t0, t1 = run['window']\n"
        "    return sum(1 for r in run['records']\n"
        "               if r['end'] and t0 <= r['end'] <= t1) / "
        "run['window_s']\n")
    spec = dict(SPEC)
    spec["workloads"] = SPEC["workloads"] + [
        {"name": "tiny-trickle", "config": "tiny-new", "traffic": "trickle",
         "chips": 1, "why": "discovery"}]
    spec["end_to_end"] = SPEC["end_to_end"] + [
        {"name": "requests_per_s", "unit": "1/s", "better": "higher",
         "bound": 0.1, "source": "host_clock", "workloads": ["tiny-trickle"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = cells.load("tiny-trickle", tmp_path / "BENCHMARK.json", root=root)
    assert c.config["name"] == "tiny-new" and c.traffic["clients"] == 1
    out = run_cell(c, 17, 2.0, False, "cpu", root=root)
    # the new metric reads; those listing other cells stay out
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s",
                                   "requests_per_s"}


def test_no_jax_after_a_rehearsal():
    """A fresh process that rehearses a stream cell and a batch cell holds
    no module of JAX or the JAX package (whole top-level names)."""
    code = (
        "from benchmark.tests import tiny\n"
        "from benchmark.run import run_cell, banned_modules\n"
        "import sys\n"
        "for w in ('w4a8-stream8', 'w4a8-f32voc-batch64'):\n"
        "    run_cell(tiny.cell(w), 3, 1.0, False, 'cpu')\n"
        "print(banned_modules())\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] == 'fish_speech_tpu_torch')[:1])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    got = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    lines = got.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1] == "['fish_speech_tpu_torch']"     # the port, loaded


def _cli(cwd: Path, pythonpath: str | None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if pythonpath:
        env["PYTHONPATH"] = pythonpath
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", WORKLOADS[0],
         "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_refuses_without_a_card():
    got = _cli(REPO, None)
    assert got.returncode != 0
    assert got.stdout.strip() == "" or not got.stdout.strip().splitlines()[
        -1].startswith("{")


def test_cli_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in SPEC["paths"]:
        shutil.copytree(REPO / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("out", "__pycache__"))
    got = _cli(tmp_path, None)
    assert got.returncode != 0
    assert "{" not in got.stdout
