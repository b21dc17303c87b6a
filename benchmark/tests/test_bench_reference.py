"""The benchmark's plain reference held against the port on the CPU at the
tiny configuration: the cache-less forward against the port's prefill and
cached decode (int8 and W4A8 serving paths), the decoder against the
port's plain decoder, and the streamed decoder against the whole one.
Only this test imports the port beside the reference."""

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import draws
from benchmark.reference import codec as ref_codec
from benchmark.reference import dual_ar as ref_lm
from benchmark.reference import prompt as ref_prompt
from benchmark.tests import tiny

CPU = torch.device("cpu")


def port_logits(config: dict, params: dict, shape: dict, cols: np.ndarray,
                t_p: int):
    """The port's slow logits over the semantic support and fast logits of
    codebooks 1..K-1 for each served frame: a prefill of the prompt, then
    one cached decode step a frame, teacher-forced on `cols`."""
    from fish_speech_tpu_torch.engine.generate import serving_config
    from fish_speech_tpu_torch.models.config import DualARConfig
    from fish_speech_tpu_torch.models.decode import new_fast_cache
    from fish_speech_tpu_torch.models.dual_ar import (
        KVCache, forward_generate, forward_generate_fast,
        precompute_freqs_cis)
    from fish_speech_tpu_torch.ops.fast_fused import enable_fused_fast_head
    from fish_speech_tpu_torch.ops.quant import (quantize_lm_params,
                                                 take_rows)

    srv, lm = config["serving"], config["lm"]
    s_len = 128
    cfg = serving_config(
        DualARConfig(**lm, max_seq_len=s_len).with_semantic_range(
            shape["semantic_begin_id"], shape["semantic_end_id"]),
        kv_fold=srv["kv_fold"])
    q = enable_fused_fast_head(quantize_lm_params(
        params, mode=srv["quant"], groupsize=srv["groupsize"]))
    cache = KVCache.create(cfg.n_layer, 1, s_len, cfg.n_local_heads,
                           cfg.head_dim, dtype=torch.int8, pos_major=True)
    freqs = precompute_freqs_cis(s_len, cfg.head_dim, cfg.rope_base)
    ffreqs = precompute_freqs_cis(cfg.num_codebooks, cfg.fast_head_dim,
                                  cfg.rope_base)
    support = (shape["semantic_begin_id"], shape["semantic_end_id"],
               shape["im_end_id"])
    zero = torch.zeros(1, dtype=torch.int32)
    x = torch.from_numpy(cols).long()
    out = forward_generate(q, cfg, x[None, :, :t_p], cache, 0, freqs,
                           rope_positions=torch.arange(t_p)[None],
                           key_valid_from=zero, logit_support=support)
    slow, fast = [], []
    for j in range(cols.shape[1] - t_p):
        if j:
            out = forward_generate(q, cfg, x[None, :, t_p + j - 1:t_p + j],
                                   cache, t_p + j - 1, freqs,
                                   key_valid_from=zero,
                                   logit_support=support)
        slow.append(out.logits[0, -1].float())
        fc = new_fast_cache(q, cfg, 1, CPU)
        forward_generate_fast(q, cfg, out.hidden[:, -1], fc, 0, ffreqs,
                              want_logits=False)
        row = []
        for idx in range(1, cfg.num_codebooks):
            emb = take_rows(q["fast_embeddings"], x[1 + idx - 1, t_p + j][None])
            row.append(forward_generate_fast(q, cfg, emb, fc, idx,
                                             ffreqs)[0].float())
        fast.append(torch.stack(row))
    return torch.stack(slow), torch.stack(fast)


def served_columns(shape: dict, text: str, n: int, seed: int):
    prompt, _ = ref_prompt.encode(text, shape["num_codebooks"])
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, shape["codebook_size"],
                         (shape["num_codebooks"], n))
    served = np.concatenate([codes[:1] + shape["semantic_begin_id"], codes])
    return np.concatenate([prompt, served], axis=1).astype(np.int64), \
        prompt.shape[1]


@pytest.mark.parametrize("name,control", [
    ("s2pro-int8", {"slow_weights": "int4_g32"}),
    ("s2pro-w4a8", {"slow_act_bits": 4})])
def test_forward_matches_port_prefill_and_decode(name, control):
    config = tiny.config(name)
    shape = cells.lm_shape(config, 128)
    params, _ = draws.draw(11, shape, config["codec"], CPU)
    cols, t_p = served_columns(shape, "a short line of text.", 6, 3)
    port = port_logits(config, params, shape, cols, t_p)
    prec = ref_lm.Precision(**config["reference"])
    seq = [(torch.from_numpy(cols), t_p)]
    ref = ref_lm.forward(params, shape, seq, prec)[0]
    low = ref_lm.forward(params, shape, seq, prec.replace(**control))[0]
    for got, want, lower in zip(port, ref, low):
        scale = want.abs().max()
        err = float((got - want).abs().max() / scale)
        # the port's bf16 activations against float32: a few bf16 ulps of
        # the logits' scale, and well inside the lower precision's gap
        assert err < 0.03
        assert err < float((lower - want).abs().max() / scale)


def test_decoder_matches_port_plain_decoder():
    from fish_speech_tpu_torch.codec.model import dac_from_indices

    config = tiny.config("s2pro-int8")
    c = config["codec"]
    shape = cells.lm_shape(config, 128)
    _, cw = draws.draw(5, shape, c, CPU)
    eng = cells.build_engine(config, {**tiny.traffic("batch64"), "slots": 0},
                             draws.draw(5, shape, c, CPU)[0], cw, CPU)
    codes = torch.from_numpy(np.random.default_rng(2).integers(
        0, 64, (c["n_codebooks"] + 1, 40)))
    want = ref_codec.decode(cw, c, codes)
    got = dac_from_indices(cw, eng.codec_cfg, codes[None])[0]
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_streamed_decoder_equals_whole():
    config = tiny.config("s2pro-int8")
    c = config["codec"]
    _, cw = draws.draw(6, cells.lm_shape(config, 128), c, CPU)
    codes = torch.from_numpy(np.random.default_rng(4).integers(
        0, 64, (c["n_codebooks"] + 1, 23)))
    whole = ref_codec.decode(cw, c, codes)
    parts = list(ref_codec.decode_stream(cw, c, codes, chunk=4, first=2))
    assert [len(p) for p in parts][:2] == [2 * c["frame_length"],
                                          4 * c["frame_length"]]
    joined = torch.cat(parts)
    assert joined.shape == whole.shape
    assert float((joined - whole).abs().max()) <= 1e-6 * float(
        whole.abs().max())
