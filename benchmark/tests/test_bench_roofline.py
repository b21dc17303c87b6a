"""The roofline functions reproduce the bound column of PERF.md's kernel
table from shapes, and the decode step's operations per frame."""

import json

import pytest

from benchmark import roofline as rl
from benchmark.tests.tiny import ROOT

S2 = json.loads((ROOT / "configs" / "s2pro-int8.json").read_text())
LM, CODEC = S2["lm"], S2["codec"]


def ms(s: float) -> float:
    return round(s * 1e3, 4)


def test_sweep_bound_b1():
    # #2 at B = 1, codebook position 9: 0.1146 ms (bytes)
    assert ms(rl.sweep_bound_s(1, 9, LM["fast_dim"], LM["n_fast_layer"])) \
        == 0.1146


def test_w4a8_bound_one_layer_m1():
    # #11, one slow layer's five products at M = 1: 0.0160 ms (bytes)
    total = sum(rl.w4a8_bound_s(1, n, k, 128)
                for _, n, k in rl.slow_products(LM))
    assert ms(total) == 0.0160


def test_vocoder_bounds_f128():
    # #3 (blocks 1-3) 0.6843 ms and #4 (block 0's units) 0.1173 ms at
    # F = 128 code frames (bf16 operations)
    ops = rl.vocoder_ops(128, CODEC)
    assert ms(ops["block"] / rl.PEAK_OPS_PER_S["bf16"]) == 0.6843
    assert ms(ops["res_stack"] / rl.PEAK_OPS_PER_S["bf16"]) == 0.1173


def test_attention_int8_bound():
    # #1 on the int8 cache, one layer at B = 1, S = 2048: 0.0013 ms (bytes)
    g = LM["n_head"] // LM["n_local_heads"]
    assert round(rl.attn_int8_bound_s(1, 2048, LM["n_local_heads"], g,
                                      LM["head_dim"]) * 1e3, 4) == 0.0013


@pytest.mark.parametrize("length", [0, 1000])
def test_frame_ops(length):
    # by hand: the slow stack's products 2 * 100,925,440 a layer x 36; the
    # token logits over 4097 rows; fast_project_in; ten sweeps of 28 fast
    # layers (13,631,488 MACs each) with attention over positions 0..p;
    # nine codebook heads; slow attention 4 * 32 * 128 * 36 a key
    fixed = (7_266_631_680 + 20_976_640 + 5_242_880 + 7_633_633_280
             + 6_307_840 + 75_497_472)
    assert rl.frame_ops(LM, length) == fixed + 589_824 * length
