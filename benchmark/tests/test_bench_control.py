"""The check's control and its faults.

On the CPU, at the tiny configuration: the control readings exist and the
bfloat16 decoder's reading lies far above the program's float32 one; and
a run whose timed path is broken underneath (a served token altered where
it is produced, a decode tick that hands back its input unchanged, a
waveform altered where it is produced) comes out not correct, as does a
run whose sample is smaller than the control was read on. On the
card (marked `cuda`, skipped elsewhere), the control at the cell's own
size on three seeds reads above each limit and the program below it.
"""

import json

import numpy as np
import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cell's size "
                    "runs on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("workload", ["w4a8-f32voc-batch64", "w4a8-stream8"])
def test_control_readings_tiny(workload):
    out = run_cell(tiny.cell(workload), 41, 2.0, False, "cpu", control=True)
    r = out["_readings"]
    assert out["correct"]
    assert r["control_lm"] >= 0.0 and r["token_gap"] <= 0.02
    assert r["control_wave"] > 100 * r["wave_err"]


def _alter_token(monkeypatch):
    from fish_speech_tpu_torch.engine import scheduler

    orig = scheduler.decode_one_token

    def altered(*args, **kwargs):
        col = orig(*args, **kwargs)
        col[:, 2] = (col[:, 2] + 17) % 64          # codebook 1's code
        return col

    monkeypatch.setattr(scheduler, "decode_one_token", altered)


def _unchanged_step(monkeypatch):
    from fish_speech_tpu_torch.engine import scheduler

    orig = scheduler.decode_one_token

    def unchanged(params, cfg, x, *args, **kwargs):
        if x.shape[-1] == 1:                        # a decode tick
            return x[:, :, -1].to(torch.int32)
        return orig(params, cfg, x, *args, **kwargs)

    monkeypatch.setattr(scheduler, "decode_one_token", unchanged)


def _alter_wave(monkeypatch):
    from fish_speech_tpu_torch.codec import model, streaming

    whole, step = model.dac_from_indices, streaming.vocoder_stream_step
    monkeypatch.setattr(model, "dac_from_indices",
                        lambda *a, **k: whole(*a, **k) * 0.9)

    def stream_step(*a, **k):
        wav, st = step(*a, **k)
        return wav * 0.9, st

    monkeypatch.setattr(streaming, "vocoder_stream_step", stream_step)


@pytest.mark.parametrize("fault", [_alter_token, _unchanged_step,
                                   _alter_wave])
@pytest.mark.parametrize("workload", ["w4a8-f32voc-batch64", "w4a8-stream8"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, workload):
    fault(monkeypatch)
    out = run_cell(tiny.cell(workload), 43, 2.0, False, "cpu")
    assert out["checks"]["frames"]["value"] >= 1
    assert not out["correct"]


def test_too_small_a_sample_is_not_correct():
    """A run whose sample holds fewer frames than the control was read on
    is not correct, however close its tokens and waveforms are."""
    c = tiny.cell("w4a8-stream8")
    c.config["check"]["min_frames"] = 10 ** 6
    out = run_cell(c, 47, 2.0, False, "cpu")
    assert out["checks"]["token_gap"]["value"] <= 0.02
    assert out["checks"]["frames"]["value"] < 10 ** 6
    assert not out["correct"]


@pytest.mark.cuda
def test_control_at_cell_size(card):
    """The control of w4a8-stream8 on three seeds, at the cell's size."""
    from benchmark.harness import cell as cells
    from benchmark.tests.tiny import ROOT

    cell = cells.load("w4a8-stream8", ROOT.parent / "BENCHMARK.json")
    limits = cell.config["limits"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        out = run_cell(cell, seed, 10.0, False, "cuda", control=True)
        r = out["_readings"]
        print(json.dumps({"seed": seed, **r}))
        assert out["correct"]
        assert r["control_lm"] > limits["token_gap"] or \
            r["control_wave"] > limits["wave_err"]
        assert np.isfinite(r["token_gap"])
