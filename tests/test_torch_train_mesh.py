"""The training CLI on a (data, model) mesh, on the CPU over gloo.

`python -m fish_speech_tpu_torch.tools.train` as four ranks (torchrun's
environment: RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT) with `--model-parallel 2` and the data axis left to the CLI
(2), against the same CLI as one process at the same global batch: the
same logged losses, the LR-0 step's checkpoint bit for bit, the final
checkpoint within the Adam-step tolerance of tests/test_torch_tp.py,
one writer and one logger. The training steps themselves are held to the
single-device and JAX steps by tests/test_torch_tp.py; this file holds
the CLI's world, mesh, batch split and checkpoint gathering.
"""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.tools import build_dataset, train
from fish_speech_tpu_torch.train.step import tree_leaves
from fish_speech_tpu_torch.utils.checkpoint import load_params

ROOT = Path(__file__).resolve().parent.parent
RANKS, MODEL = 4, 2
LR = 1e-2
TIMEOUT = 240
STEP = re.compile(r"step (\d+): loss=(\S+) base=(\S+) sem=(\S+) top5=(\S+) "
                  r"gnorm=(\S+)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def protos(tmp_path_factory):
    """A two-speaker corpus of random codes through the port's
    build_dataset."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for spk in ("alice", "bob"):
        (root / "corpus" / spk).mkdir(parents=True)
        for i in range(3):
            np.save(root / "corpus" / spk / f"c{i}.npy",
                    rng.integers(0, 64, (4, int(rng.integers(5, 20)))))
            (root / "corpus" / spk / f"c{i}.lab").write_text(
                f"{spk} says {i}")
    assert build_dataset.main(["--input", str(root / "corpus"), "--output",
                               str(root / "protos")]) == 6
    return root / "protos"


def _common(protos: Path, out: Path) -> list:
    return ["--proto-dir", str(protos), "--output-dir", str(out),
            "--batch-size", "4", "--max-length", "128", "--log-every", "1",
            "--checkpoint-every", "1", "--warmup-steps", "1", "--lr",
            str(LR), "--max-steps", "2", "--device", "cpu"]


def _start_ranks(argv: list, cwd: Path) -> list:
    """The CLI as RANKS processes under torchrun's environment."""
    port = _free_port()
    base = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE=str(RANKS),
                LOCAL_WORLD_SIZE=str(RANKS), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port))
    base["PYTHONPATH"] = str(ROOT) + os.pathsep + base.get("PYTHONPATH", "")
    return [subprocess.Popen(
        [sys.executable, "-m", "fish_speech_tpu_torch.tools.train", *argv],
        cwd=cwd, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(RANKS)]


def _wait_ranks(procs: list) -> list:
    """Each rank's (stdout, stderr), once all have exited 0."""
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode]
    assert not bad, "\n".join(f"--- rank {r} (exit {procs[r].returncode})\n"
                              f"{outs[r][1][-3000:]}" for r in bad)
    return outs


@pytest.fixture(scope="module")
def cli_runs(protos, tmp_path_factory):
    """The CLI as four ranks and, meanwhile, as one process, from the same
    data."""
    d = tmp_path_factory.mktemp("cli")
    procs = _start_ranks(_common(protos, d / "four") + ["--model-parallel",
                                                        str(MODEL)], d)
    try:
        one = train.main(_common(protos, d / "one"))
    finally:
        outs = _wait_ranks(procs)
    return dict(dir=d, outs=outs, one=one)


def _leaves(path: Path) -> dict:
    tree, cfg = load_params(path, device="cpu")
    assert cfg is not None
    return dict(tree_leaves(tree))


def test_cli_four_ranks_log_once(cli_runs):
    """Rank 0 alone logs: its first line names the backend and the mesh
    (data 2, the CLI's auto split, x model 2), then each step and each
    checkpoint; the other ranks print nothing."""
    lines = cli_runs["outs"][0][0].splitlines()
    assert lines[0] == (f"mesh: data {RANKS // MODEL} x model {MODEL}, "
                        f"{RANKS} ranks over gloo, rank 0 on cpu")
    assert [int(m.group(1)) for m in map(STEP.match, lines) if m] == [1, 2]
    assert sum(x.startswith("saved") for x in lines) == 3
    assert all(out == "" for out, _ in cli_runs["outs"][1:])


def test_cli_four_ranks_match_one_process(cli_runs):
    """The four ranks' logged metrics equal the one process's to the
    printed digits; their step-1 checkpoint (LR 0) is the one process's
    bit for bit, gathered whole from the ranks' slices; the final one
    holds every entry within 1e-3 of LR, as tests/test_torch_tp.py holds
    its meshed steps, but for the entries whose Adam step turns on a
    gradient's last bits (a gradient near Adam's eps, 1e-8: its step
    LR * g / (|g| + eps) follows the f32 sum order). Those are at most
    1e-3 of a leaf's entries and within 3e-2 of LR (measured: 1.5e-2 at
    18 of w2's 131072 entries)."""
    got = [m.groups() for m in map(STEP.match,
                                   cli_runs["outs"][0][0].splitlines()) if m]
    want = [(str(h["step"]), f"{h['loss']:.4f}", f"{h['base_loss']:.4f}",
             f"{h['semantic_loss']:.4f}", f"{h['top_5_accuracy']:.3f}",
             f"{h['grad_norm']:.2f}") for h in cli_runs["one"]["history"]]
    assert got == want
    d = cli_runs["dir"]
    for name in ("step_000000001", "step_000000002", "step_000000002_final"):
        assert (d / "four" / name).is_dir(), name
    four, one = (_leaves(d / run / "step_000000001")
                 for run in ("four", "one"))
    assert four.keys() == one.keys()
    for k in one:
        assert torch.equal(four[k], one[k]), k
    four, one = (_leaves(d / run / "step_000000002_final")
                 for run in ("four", "one"))
    for k, w in one.items():
        diff = (four[k] - w).abs()
        far = int((diff > 1e-3 * LR).sum())
        assert far <= 1e-3 * w.numel(), f"{k}: {far} entries"
        assert float(diff.max()) <= 3e-2 * LR, k


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"),
                                            ("cpu:0", "gloo")])
def test_rank_device_on_the_cpu(device, backend):
    """The CPU's ranks run gloo, whatever the host's ranks."""
    env = {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
           "LOCAL_WORLD_SIZE": "2"}
    dev, got = train.rank_device(device, env)
    assert dev.type == "cpu" and got == backend
