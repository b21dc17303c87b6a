"""The comparison that decides `correct`.

After the window has closed and the program's state is freed, a sample of
the greedy requests that the run finished (drawn from the seed, the
longest always in it) is held against the plain float32 reference
(benchmark/reference), which is given the same bf16 draws and the same
texts and derives everything else itself:

- `prompt`: the prompt columns the scheduler got equal the reference's
  encoding of the text (an exact comparison);
- `token_gap`: the widest gap, over every served token of the sample
  (the slow stack's token and the fast head's nine codes of each frame),
  by which the token's logit lies below the reference's best at that
  position, teacher-forced on the served frames;
- `wave_err`: the largest relative L2 error, over the sample, of the
  served waveform (a `tts` call's whole, the streaming vocoder's chunks
  joined in stream cells) against the reference decoder on the served
  codes;
- `failed`: requests that raised;
- `frames`: the sample's served frames, which have to be at least as
  many as the control was read on (the configuration's `min_frames`).

The control readings (`control_lm`, `control_wave`) put a lower precision
in the program's place on the same prompts and frames.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import codec as ref_codec
from ..reference import dual_ar as ref_lm
from ..reference import prompt as ref_prompt


def finished(records: list[dict], t_close: float) -> list[dict]:
    """Greedy requests that ended before the close, whole and unfailed."""
    return [r for r in records
            if r["greedy"] and r["end"] is not None and r["end"] <= t_close
            and r["error"] is None and not r.get("cut")
            and r.get("slot") is not None and r["slot"].result
            and not r["slot"].cancelled.is_set() and "wave" in r]


def sample(records: list[dict], t_close: float, seed: int, n: int,
           frames: int) -> list[dict]:
    """The longest finished greedy request, then others drawn from the
    seed, until `n` requests or `frames` frames."""
    pool = finished(records, t_close)
    if not pool:
        return []
    pool.sort(key=lambda r: -len(r["slot"].result))
    out, total = [pool[0]], len(pool[0]["slot"].result)
    rng = np.random.default_rng(seed)
    for i in rng.permutation(np.arange(1, len(pool))):
        if len(out) >= n or total >= frames:
            break
        out.append(pool[i])
        total += len(pool[i]["slot"].result)
    return out


def columns(rec: dict) -> tuple[torch.Tensor, int]:
    """(prompt + served columns (K+1, T_p + n), T_p) of a request."""
    slot = rec["slot"]
    served = np.stack(slot.result, axis=1)
    cols = np.concatenate([slot.prompt, served], axis=1)
    return torch.from_numpy(cols.astype(np.int64)), slot.prompt.shape[1]


def prompt_mismatches(recs: list[dict], num_codebooks: int) -> int:
    bad = 0
    for r in recs:
        want, _ = ref_prompt.encode(r["text"], num_codebooks)
        got = r["slot"].prompt
        bad += int(want.shape != got.shape or not np.array_equal(want, got))
    return bad


def lm_readings(w: dict, shape: dict, recs: list[dict],
                prec: ref_lm.Precision,
                control: ref_lm.Precision | None = None) -> dict:
    """token_gap of the served tokens; with `control`, the gap of the
    tokens that the control precision puts first (`control_lm`)."""
    seqs = [columns(r) for r in recs]
    ref = ref_lm.forward(w, shape, seqs, prec)
    gaps = [ref_lm.served_gaps(lg, c, tp, shape) for lg, (c, tp)
            in zip(ref, seqs)]
    out = {"token_gap": max(float(g.max()) for g in gaps),
           "token_gap_slow": max(float(g[:, 0].max()) for g in gaps),
           "frames": sum(g.shape[0] for g in gaps)}
    if control is not None:
        low = ref_lm.forward(w, shape, seqs, control)
        out["control_lm"] = max(float(ref_lm.argmax_gaps(a, b).max())
                                for a, b in zip(ref, low))
    return out


def served_codes(rec: dict) -> torch.Tensor:
    """The vocoder's input: the served frames' K codebook rows."""
    return torch.from_numpy(np.stack(rec["slot"].result, axis=1)[1:]
                            .astype(np.int64))


def served_wave(rec: dict) -> np.ndarray:
    w = rec["wave"]
    return np.concatenate(w) if isinstance(w, list) else w


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float("inf")
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def wave_readings(codec_w: dict, ccfg: dict, recs: list[dict],
                  control: bool = False) -> dict:
    """wave_err of the served waveforms; with `control`, `control_wave`:
    the reference decoder computed in bfloat16 on the same codes."""
    errs, ctrl = [], []
    for r in recs:
        codes = served_codes(r)
        want = ref_codec.decode(codec_w, ccfg, codes).cpu().numpy()
        errs.append(rel_l2(served_wave(r).astype(np.float32), want))
        if control:
            low = ref_codec.decode(codec_w, ccfg, codes, torch.bfloat16)
            ctrl.append(rel_l2(low.cpu().numpy(), want))
    out = {"wave_err": max(errs)}
    if control:
        out["control_wave"] = max(ctrl)
    return out
