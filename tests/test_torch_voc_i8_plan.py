"""The int8 vocoder kernels' plan (ops/voc_fused.py::voc_i8_plan) at S2-Pro
shapes, and the K-major int8 weights pack_decoder keeps for them. CPU only:
the plan is what the C entries (csrc/voc_fused_i8.cu) are handed."""

import pytest
import torch

from fish_speech_tpu_torch.codec import config as tcfg
from fish_speech_tpu_torch.codec import fastpath as tfast
from fish_speech_tpu_torch.codec.init import init_dac_params
from fish_speech_tpu_torch.ops import voc_fused as tv

N_SM = 132   # an H100 SXM


def _s2pro_calls(frames: int) -> list:
    """(label, plan kwargs) of every int8 kernel call of an S2-Pro decode of
    `frames` codec frames, in the decoder's tiles: block 0's three unit
    calls, then blocks 1-3 (the last with the final conv)."""
    cfg = tcfg.s2_pro_codec_config()
    t = frames * cfg.frame_length // 8 // 4 // 2
    c = cfg.decoder_dim // 2
    tt = tfast._tile_for(t, tfast.RES_STACK_TILE_CAP)
    calls = [(f"block 0 d{d}", dict(b=1, t=t, c=c, dilations=(d,), tt=tt))
             for d in tv.DILATIONS]
    for bi, stride in enumerate(cfg.decoder_rates[1:], 1):
        c_in, c, t = c, c // 2, t * stride
        tt = tfast._tile_for(t, tfast._tile_cap(c))
        final = bi == len(cfg.decoder_rates) - 1 and tt % 128 == 0
        calls.append((f"block {bi}", dict(b=1, t=t, c=c,
                                          dilations=tv.DILATIONS, tt=tt,
                                          tconv=(c_in, stride),
                                          final=final)))
    return calls


def test_s2pro_calls_follow_the_tile_rule():
    # the shapes the plan tests read: block 0 at C=768 and T=32 F, blocks
    # 1-3 at 384, 192, 96 channels, the last with the final conv
    calls = dict(_s2pro_calls(128))
    assert calls["block 0 d1"]["t"] == 4096
    assert calls["block 0 d1"]["c"] == 768
    assert [calls[f"block {i}"]["c"] for i in (1, 2, 3)] == [384, 192, 96]
    assert [calls[f"block {i}"]["tt"] for i in (1, 2, 3)] == [512, 1024, 2048]
    assert calls["block 3"]["t"] == 262144 and calls["block 3"]["final"]


@pytest.mark.parametrize("frames", [16, 128])
def test_voc_i8_plan_s2pro(frames):
    """Every pass has a tile whose BN divides its columns, a K step (32,
    64 or 128 bytes) that divides its K, shared memory under the 227 KB a
    CTA may hold and enough CTAs to fill the card's SMs; a block call runs
    17 device kernels, a unit call 7."""
    for label, kw in _s2pro_calls(frames):
        plan = tv.voc_i8_plan(**kw, n_sm=N_SM)
        block = "tconv" in kw
        assert len(plan["passes"]) == len(plan["tiles"]) == (
            7 if block else 2), label
        assert plan["device_kernels"] == (17 if block else 7), label
        assert plan["halo"] == tv.halo_for(kw["dilations"],
                                           6 if kw.get("final") else 0)
        assert plan["rows"] == plan["halo"] + kw["tt"]
        assert plan["n"] == kw["b"] * kw["t"] // kw["tt"]
        for q in plan["passes"]:
            bm, bn = tv.I8_TILES[q["tile"]]
            assert (q["bm"], q["bn"]) == (bm, bn), label
            assert q["n"] % bn == 0, (label, q["name"])
            assert q["bk"] in (32, 64, 128) and q["k"] % q["bk"] == 0, (
                label, q["name"])
            assert q["smem"] <= 227 * 1024, (label, q["name"])
            assert q["ctas"] >= N_SM, (label, q["name"], q["ctas"])


@pytest.mark.parametrize("c,bk", [(768, 128), (384, 128), (192, 64),
                                  (96, 32)])
def test_voc_i8_k_step(c, bk):
    # block 3's 96 channels take 32-byte steps (32-byte swizzle)
    assert tv.i8_k_step(c) == bk


def test_voc_i8_plan_passes_rows():
    """A block: the transposed conv over the slab's output rows, each
    unit's k7 and 1x1 pass over the rows it keeps; the codes' scratch holds
    a tile's state or its slab, whichever is larger (the slab at block
    3)."""
    plan = tv.voc_i8_plan(1, 262144, 96, tv.DILATIONS, 2048, (192, 2),
                          True, N_SM)
    rows = plan["rows"]
    assert rows == 96 + 2048
    spans = [(q["name"], q["m_lo"], q["m_hi"], q["taps"], q["k"])
             for q in plan["passes"]]
    assert spans == [("tconv", 0, rows // 2, 2, 192),
                     ("k7 d1", 6, rows, 7, 96), ("1x1 d1", 6, rows, 1, 96),
                     ("k7 d3", 24, rows, 7, 96), ("1x1 d3", 24, rows, 1, 96),
                     ("k7 d9", 78, rows, 7, 96), ("1x1 d9", 78, rows, 1, 96)]
    assert plan["q_bytes"] == plan["n"] * (rows // 2 + 1) * 192
    assert plan["q_bytes"] > plan["n"] * rows * 96


@pytest.mark.parametrize("bm,bn,k,smem", [(128, 128, 768, 99328),
                                          (128, 96, 192, 101376),
                                          (128, 96, 96, 58368),
                                          (64, 32, 768, 99328)])
def test_i8_tile_smem(bm, bn, k, smem):
    # the C launcher's rule: the most stages (<= 8) two CTAs an SM allow,
    # or the staged int32 tile where that is larger
    assert tv.i8_tile_smem(bm, bn, k) == smem


@pytest.mark.parametrize("kw", [dict(b=1, t=64, c=48, dilations=(1,), tt=32),
                                dict(b=1, t=64, c=64, dilations=(1,), tt=48),
                                dict(b=1, t=64, c=64, dilations=(1, 3, 9),
                                     tt=32, tconv=(80, 2)),
                                dict(b=1, t=96, c=64, dilations=(1, 3, 9),
                                     tt=48, tconv=(64, 32))])
def test_voc_i8_plan_refuses(kw):
    # channels off the 32-byte K grain, a tile not dividing T, the slab's
    # channels off the grain, a stride not dividing the tile
    with pytest.raises(ValueError):
        tv.voc_i8_plan(**kw, n_sm=N_SM)


@pytest.mark.parametrize("per_unit", [False, True])
def test_pack_decoder_keeps_int8_weights_t(monkeypatch, per_unit):
    """An int8 pack keeps the K-major tiles the int8 passes load, equal to
    the per-call transposes `block_weights_t` / `res_weights_t` make for a
    pack without them: fused blocks as "wt" (tconv phases, w7, w1), blocks
    run one unit a call as "w7t" and "w1t"."""
    cfg = tcfg.tiny_codec_config()
    params = init_dac_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    if per_unit:   # as S2-Pro's 768-wide block 0
        monkeypatch.setattr(tfast, "FUSED_BLOCK_MAX_C", 32)
    packed = tfast.pack_decoder(params["decoder"], cfg, quant=True)
    assert ("tconv_pw" in packed["blocks"][0]["res"]) is not per_unit
    for blk in packed["blocks"]:
        res = blk["res"]
        if "tconv_pw" not in res:
            assert "wt" not in res
            kept, keys = (res["w7t"], res["w1t"]), ("w7t", "w1t")
            bare = tv.res_weights_t({k: v for k, v in res.items()
                                     if k not in keys})
        else:
            assert "w7t" not in res
            kept = res["wt"]
            bare = tv.block_weights_t({k: v for k, v in res.items()
                                       if k != "wt"})
            assert torch.equal(kept[0], res["tconv_pw"].transpose(1, 2))
        assert torch.equal(kept[-2], res["w7"].transpose(2, 3))
        assert torch.equal(kept[-1], res["w1"].transpose(1, 2))
        for a, b in zip(kept, bare):
            assert a.dtype == torch.int8 and a.is_contiguous()
            assert torch.equal(a, b)
