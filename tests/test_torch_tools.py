"""The port's remaining tools and their utilities against the JAX package,
on the CPU at tiny sizes: utils/spectrogram.py, tools/quant_drift.py's
teacher-forced runs, extract_vq -> build_dataset -> train, api_client
against the demo server, eval_quality, eval_in_context, latency_bench and
profile_decode, data/vqgan.py, utils/logger.py and i18n/. The JAX tools
run in this process (their main under a patched argv)."""

import argparse
import dataclasses
import importlib.util
import json
import logging
import shutil
import sys
import threading
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.codec import tiny_codec_config as j_tiny_codec
from fish_speech_tpu.data import vqgan as jvqgan
from fish_speech_tpu.i18n import scan as jscan
from fish_speech_tpu.models.config import DualARConfig as JCfg
from fish_speech_tpu.models.config import apply_pallas_attn_mode
from fish_speech_tpu.models.init import init_dual_ar_params as j_init
from fish_speech_tpu.ops import quant as jq
from fish_speech_tpu.ops.fast_fused import enable_fused_fast_head as j_fused
from fish_speech_tpu.serve.wav import encode_wav
from fish_speech_tpu.utils import checkpoint as jckpt
from fish_speech_tpu.utils import logger as jlogger
from fish_speech_tpu.utils import spectrogram as jspec
from fish_speech_tpu_torch.codec import config as tcodec_cfg
from fish_speech_tpu_torch.codec.init import (codec_params_from_jax,
                                              init_dac_params)
from fish_speech_tpu_torch.data import vqgan as tvqgan
from fish_speech_tpu_torch.i18n import core as ti18n_core
from fish_speech_tpu_torch.i18n import scan as tscan
from fish_speech_tpu_torch.models.config import DualARConfig as TCfg
from fish_speech_tpu_torch.models.init import lm_params_from_jax
from fish_speech_tpu_torch.ops import quant as tq
from fish_speech_tpu_torch.ops.fast_fused import enable_fused_fast_head
from fish_speech_tpu_torch.tools import (api_client, api_server,
                                         build_dataset, eval_in_context,
                                         eval_quality, extract_vq,
                                         latency_bench, profile_decode,
                                         quant_drift, train)
from fish_speech_tpu_torch.utils import logger as tlogger
from fish_speech_tpu_torch.utils import profiling as tprof
from fish_speech_tpu_torch.utils import spectrogram as tspec

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "goldens" / "codec_tiny.npz"
LOGIT_TOL = 2e-2   # tests/test_torch_lm.py's logit tolerance


def _jax_tool(name: str, argv: list, monkeypatch):
    """Run the JAX package's tools/<name>.py main in this process."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        spec.loader.exec_module(mod)
    finally:       # some JAX tools set a compilation cache at import
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    if argv is None:
        return mod
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return mod.main()


# --- utils/spectrogram.py ----------------------------------------------------


def test_spectrogram_matches_jax():
    """The filterbank, the magnitude STFT, the log-mel and the mel
    similarity against JAX's numpy, within 1e-5 relative."""
    y = (0.3 * np.random.default_rng(0).standard_normal(30000)).astype(
        np.float32)
    np.testing.assert_allclose(
        tspec.melscale_fbanks(1025, 0.0, 22050.0, 128, 44100).numpy(),
        jspec.melscale_fbanks(1025, 0.0, 22050.0, 128, 44100),
        rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(
        tspec.linear_spectrogram(torch.from_numpy(y)).numpy(),
        jspec.linear_spectrogram(y), rtol=1e-5)
    np.testing.assert_allclose(
        tspec.log_mel_spectrogram(torch.from_numpy(y)).numpy(),
        jspec.log_mel_spectrogram(y), rtol=1e-5)
    z = y + 0.01 * np.sin(np.arange(len(y), dtype=np.float32))
    assert tspec.mel_similarity(y, z) == jspec.mel_similarity(y, z)
    assert tspec.mel_similarity(y, y) == 1.0


# --- tools/quant_drift.py ----------------------------------------------------


def _drift_base() -> JCfg:
    """The JAX tiny LM with a fast head in the fused sweep's 3x family."""
    return JCfg(vocab_size=160, n_layer=2, n_head=4, n_local_heads=2,
                dim=128, head_dim=32, intermediate_size=256, max_seq_len=64,
                rope_base=10000.0, codebook_size=32, num_codebooks=4,
                n_fast_layer=2, fast_dim=128, fast_n_head=2,
                fast_n_local_heads=2, fast_head_dim=64,
                fast_intermediate_size=384)


def _port_cfg(cfg) -> TCfg:
    return TCfg(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def jax_drift():
    mod = _jax_tool("quant_drift", None, None)
    base, support = quant_drift.drift_config(_port_cfg(_drift_base()))
    jbase = _drift_base().with_semantic_range(*support[:2])
    prompt, forced = quant_drift.make_teacher_forced_inputs(base, 2, 12, 3)
    jprompt, jforced = mod.make_teacher_forced_inputs(jbase, 2, 12, 3)
    np.testing.assert_array_equal(prompt, jprompt)
    np.testing.assert_array_equal(forced, jforced)
    params = j_init(jax.random.key(0), jbase, dtype=jnp.bfloat16)
    return mod, jbase, support, prompt, forced, params


@pytest.mark.parametrize("config", ["plain", "int8_w8a8", "fused"])
def test_run_teacher_forced_matches_jax(jax_drift, config):
    """run_teacher_forced on the port against JAX's on the same weights,
    prompt and forced columns: the prefill, the decode steps' slow logits
    and the fast head's codebook-1 logits, within the logit tolerance."""
    mod, jbase, support, prompt, forced, params = jax_drift
    jcfg, jp, fused = jbase, params, False
    if config != "plain":
        jp = jq.quantize_lm_params(params)
        jcfg = dataclasses.replace(jbase, w8a8_matmuls=True,
                                   kv_cache_dtype="int8")
    if config == "fused":
        jcfg = apply_pallas_attn_mode(dataclasses.replace(
            jcfg, kv_cache_layout="pos", unroll_fast_sweeps=True), "stream")
        jp, fused = j_fused(dict(jp)), True
    port = lm_params_from_jax(jax.tree.map(np.asarray, params),
                              device="cpu")
    if config != "plain":
        port = tq.quantize_lm_params(port)
    if fused:
        port = enable_fused_fast_head(port)
    want = mod.run_teacher_forced(jcfg, jp, prompt, forced, 64, fused=fused,
                                  support=support)
    got = quant_drift.run_teacher_forced(_port_cfg(jcfg), port, prompt,
                                         forced, 64, fused=fused,
                                         support=support, device="cpu")
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_drift_stats_match_jax(jax_drift, capsys):
    mod = jax_drift[0]
    rng = np.random.default_rng(1)
    ref = rng.standard_normal((3, 4, 50)).astype(np.float32)
    got = ref + 0.05 * rng.standard_normal(ref.shape).astype(np.float32)
    assert quant_drift.drift_stats("x", ref, got) == mod.drift_stats(
        "x", ref, got)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[0] == lines[1]
    # the rows outside the top 5, as drift_stats counts them
    stats = mod.drift_stats("x", ref, got)
    misses = quant_drift.top5_misses(ref, got)
    assert len(misses) == round((1 - stats["top1_in_ref_top5"]) * 12)
    assert all(m["ref_rank"] >= 4 and m["margin"] >= 0
               and m["row_max_abs_dlogit"] > 0 for m in misses)
    far = ref.copy()
    far[0, 0, 7] = -9.0
    pick = np.zeros_like(ref)
    pick[0, 0, 7] = 1.0
    fifth = float(np.sort(far[0, 0].astype(np.float64))[-5])
    assert quant_drift.top5_misses(far, pick)[0] == {
        "row": 0, "ref_rank": 49, "margin": round(fifth + 9.0, 4),
        "row_max_abs_dlogit": round(float(np.abs(
            far[0, 0].astype(np.float64) - pick[0, 0]).max()), 4)}


def test_run_all_tiny_cpu(capsys):
    """The comparisons on the tiny config on the CPU, twins included:
    every part of each, the serving configuration within the logit
    tolerance of the plain W8A8 + int8 KV run of the same weights and
    equal to its run on the plain versions (which the wrappers call on the
    CPU), a miss line for every part whose top-5 share is below 1, and
    --seed drawing other weights and tokens."""
    base = _port_cfg(_drift_base())
    got = quant_drift.run_all(base, 2, 12, 3, 64, 64, 0, "cpu", misses=True,
                              twins=True)
    assert set(got) == {*quant_drift.COMPARISONS, *quant_drift.WITNESSES}
    assert all(len(rs) == len(quant_drift.PARTS) for rs in got.values())
    assert all(r["max_abs_dlogit"] <= LOGIT_TOL
               for r in got["serving_vs_plain"])
    # on the CPU the wrappers already run the plain versions
    assert all(r["max_abs_dlogit"] == 0 for r in got["serving_vs_twins"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    listed = {x["top5_misses"] for x in lines if "top5_misses" in x}
    assert listed == {r["compare"] for rs in got.values() for r in rs
                      if r["top1_in_ref_top5"] < 1}
    other = quant_drift.run_all(base, 2, 12, 3, 64, 64, 1, "cpu")
    assert other["int8_weights"] != got["int8_weights"]


# --- extract_vq -> build_dataset -> train ------------------------------------


def _corpus(root: Path, clips: int = 1) -> Path:
    rng = np.random.default_rng(0)
    for spk in ("alice", "bob"):
        d = root / spk
        d.mkdir(parents=True)
        for i in range(clips):
            wav = (0.2 * rng.standard_normal(3000)).astype(np.float32)
            (d / f"clip{i}.wav").write_bytes(encode_wav(wav, 44100))
            (d / f"clip{i}.lab").write_text(f"{spk} says thing {i}")
    return root


def test_extract_vq_matches_jax_then_trains(tmp_path, monkeypatch, capsys):
    """JAX's tools/extract_vq.py and the port's `extract` with the same
    tiny codec write the same codes for every file (the JAX tool's tiny
    codec given the weights of the reference codec golden instead of its
    seed-0 draw, whose eager init takes ~20 s on the CPU); then the port's
    own pipeline, as tests/test_tools_pipeline.py runs the JAX one:
    extract_vq (its own tiny codec), build_dataset, three training steps,
    all with --device cpu."""
    import fish_speech_tpu.codec as jcodec

    golden = np.load(GOLDEN)
    jparams = jcodec.convert_dac_state_dict(
        {k[3:]: golden[k] for k in golden.files if k.startswith("sd:")},
        j_tiny_codec())
    monkeypatch.setattr(jcodec, "init_dac_params", lambda key, cfg: jparams)
    jdir = _corpus(tmp_path / "jax")
    tdir = tmp_path / "port"
    shutil.copytree(jdir, tdir)
    _jax_tool("extract_vq", [str(jdir)], monkeypatch)
    cfg = tcodec_cfg.tiny_codec_config()
    params = codec_params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    files = sorted(tdir.rglob("*.wav"))
    assert extract_vq.extract(files, params, cfg, torch.device("cpu")) == 2
    for f in files:
        want = np.load(jdir / f.relative_to(tdir).with_suffix(".npy"))
        got = np.load(f.with_suffix(".npy"))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    corpus = _corpus(tmp_path / "pipeline", clips=2)
    # rank 1 of 2 takes every other file; then rank 0 the rest
    assert extract_vq.main([str(corpus), "--rank", "1", "--world-size", "2",
                            "--device", "cpu"]) == 2
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_NTASKS", "2")
    assert extract_vq.main([str(corpus), "--device", "cpu"]) == 2
    assert "done: 2 files" in capsys.readouterr().out
    assert len(list(corpus.rglob("*.npy"))) == 4
    protos = tmp_path / "protos"
    assert build_dataset.main(["--input", str(corpus), "--output",
                               str(protos)]) == 4
    r = train.main(["--proto-dir", str(protos), "--output-dir",
                    str(tmp_path / "results"), "--max-steps", "3",
                    "--batch-size", "2", "--max-length", "128",
                    "--log-every", "1", "--checkpoint-every", "1000",
                    "--device", "cpu"])
    assert [h["step"] for h in r["history"]] == [1, 2, 3]
    assert all(np.isfinite(v) for h in r["history"] for v in h.values())
    assert list((tmp_path / "results").glob("step_*_final"))


# --- api_client against the demo server --------------------------------------


@pytest.fixture(scope="module")
def demo_server():
    from fish_speech_tpu_torch.serve.app import create_server

    engine = api_server.build_engine(api_server.parse_args(
        ["--device", "cpu"]))
    server = create_server(engine, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/v1/tts", engine
    server.shutdown()
    server.server_close()
    th.join(timeout=30)
    assert not th.is_alive()
    engine.close()


@pytest.mark.parametrize("streaming", [False, True])
def test_api_client_against_demo_server(tmp_path, demo_server, streaming,
                                        capsys, monkeypatch):
    """The client's msgpack request to the port's demo server: a wav of
    whole codec frames, buffered or streamed; with --play and no playback
    backend it keeps the file and says so."""
    url, engine = demo_server
    out = tmp_path / "x.wav"
    argv = ["--url", url, "--text", "hello there", "--max-new-tokens", "4",
            "--seed", "1", "-o", str(out)]
    if streaming:
        argv += ["--play", "--sample-rate",
                 str(engine.codec_cfg.sample_rate)]
        monkeypatch.setattr(api_client.LivePlayer, "start",
                            lambda self: False)
    size = api_client.main(argv)
    printed = capsys.readouterr()
    assert f"saved {out} ({size} bytes)" in printed.out
    assert ("saving only" in printed.err) == streaming
    assert size == out.stat().st_size > 44
    if not streaming:
        with wave.open(str(out)) as w:
            assert w.getframerate() == engine.codec_cfg.sample_rate
            assert w.getnframes() % engine.codec_cfg.frame_length == 0
            assert w.getnframes() > 0
    else:
        pcm = (size - 44) // 2
        assert pcm > 0 and pcm % engine.codec_cfg.frame_length == 0


def test_api_client_payload_matches_jax(tmp_path, monkeypatch):
    """The request body the port's client sends decodes to the JAX
    client's (references, seed and reference id included)."""
    import msgpack

    ref = tmp_path / "r.wav"
    ref.write_bytes(b"RIFF....")
    argv = ["--text", "hi", "-ra", str(ref), "-rt", "its text", "--seed",
            "3", "--reference-id", "voice", "--streaming"]
    args = api_client.parse_args(argv)
    body = msgpack.unpackb(api_client.packb(api_client.request_body(args)))
    sent = {}

    class Stop(Exception):
        pass

    def fake_urlopen(req, timeout=None):
        sent["body"] = msgpack.unpackb(req.data)
        sent["headers"] = dict(req.header_items())
        raise Stop

    import urllib.request

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    with pytest.raises(Stop):
        _jax_tool("api_client", argv, monkeypatch)
    assert body == sent["body"]
    assert sent["headers"]["Content-type"] == "application/msgpack"


# --- eval_quality ------------------------------------------------------------


def test_eval_quality_skips_without_checkpoint(capsys):
    assert eval_quality.main([]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 1 and "skip" in lines[0]


def test_eval_quality_stages(tmp_path, capsys):
    """The stages on a tiny reference-layout checkpoint (two bf16 shards,
    fish_qwen3_omni names) and a tiny codec.pth of weight-norm pairs, on
    the CPU: convert, the reference greedy stage skipped (not in the
    port), quant drift with the gate's mechanics (the go bounds are
    for the S2-Pro serving configs; tiny random weights' near-flat logits
    get JAX's test's relaxed bounds), the codec decode; summary ok."""
    import chip_smoke

    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_serve import _write_checkpoint

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    _write_checkpoint(ckpt)
    ccfg = tcodec_cfg.tiny_codec_config()
    cparams = init_dac_params(torch.Generator().manual_seed(2), ccfg,
                              device="cpu")
    torch.save(chip_smoke.codec_state_dict(cparams, ccfg),
               tmp_path / "codec.pth")
    rc = eval_quality.main([
        "--lm-checkpoint", str(ckpt), "--codec-checkpoint",
        str(tmp_path / "codec.pth"), "--codec-config", "tiny",
        "--batch", "2", "--prompt-len", "12", "--steps", "2",
        "--cache-len", "64", "--frames", "6",
        "--drift-max-dlogit", "50", "--drift-mean-dlogit", "50",
        "--drift-min-top5", "0.0", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    stages = {x.get("stage"): x for x in lines if "stage" in x}
    assert rc == 0, lines
    assert stages["convert"]["ok"] and stages["convert"]["n_layer"] == 2
    assert "skipped" in stages["reference_greedy"]
    assert stages["quant_drift"]["ok"]
    assert stages["quant_drift"]["configs"] == ["int8_weights",
                                                "w8a8_int8kv"]
    assert set(stages["quant_drift"]["bounds"]) == {"max", "mean", "top5"}
    assert stages["codec"]["ok"]
    assert stages["codec"]["wav_samples"] == 6 * ccfg.frame_length
    assert stages["summary"]["ok"]


# --- eval_in_context ---------------------------------------------------------


def _proto_shard(path: Path) -> Path:
    from fish_speech_tpu.data import protos as jpb
    from fish_speech_tpu.data import write_pb_stream

    rng = np.random.default_rng(0)
    with open(path, "wb") as f:
        td = jpb.TextData(source="test", name="spk")
        for s in range(3):
            sent = td.sentences.add()
            sent.texts.append(f"sentence {s}, with words")
            t = int(rng.integers(5, 12))
            for _ in range(4):
                sent.semantics.add().values.extend(
                    rng.integers(0, 64, t).tolist())
        write_pb_stream(f, td)
    return path


def test_eval_in_context_matches_jax(tmp_path, monkeypatch, capsys):
    """Two f32 checkpoints written by JAX; JAX's tool and the port's give
    the same TSV rows, the losses within 1e-4 (the TSV's 4 decimals: one
    rounding step)."""
    from fish_speech_tpu_torch.text.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    cfg = JCfg(vocab_size=tok.vocab_size, n_layer=1, n_head=4,
               n_local_heads=2, dim=64, head_dim=16, intermediate_size=128,
               max_seq_len=256, codebook_size=64, num_codebooks=4,
               semantic_begin_id=tok.semantic_begin_id,
               semantic_end_id=tok.semantic_end_id, n_fast_layer=1,
               fast_dim=64, fast_n_head=4, fast_n_local_heads=4,
               fast_head_dim=16, fast_intermediate_size=128)
    ckpts = []
    for seed in (0, 1):
        d = tmp_path / f"ckpt{seed}"
        jckpt.save_params(d, j_init(jax.random.key(seed), cfg,
                                    dtype=jnp.float32), config=cfg)
        ckpts.append(str(d))
    shard = _proto_shard(tmp_path / "s.protos")
    common = ["--checkpoints", *ckpts, "--proto", str(shard),
              "--max-length", "128"]
    _jax_tool("eval_in_context", common + ["--output",
                                           str(tmp_path / "j.tsv")],
              monkeypatch)
    curves = eval_in_context.main(common + ["--output",
                                            str(tmp_path / "t.tsv"),
                                            "--device", "cpu"])
    capsys.readouterr()

    def rows(p):
        lines = p.read_text().splitlines()
        assert lines[0] == "checkpoint\tframe\tloss"
        return {tuple(x.split("\t")[:2]): float(x.split("\t")[2])
                for x in lines[1:]}

    want, got = rows(tmp_path / "j.tsv"), rows(tmp_path / "t.tsv")
    assert got.keys() == want.keys() and len(got) > 10
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 + 1e-9, k
    assert set(curves) == {"ckpt0", "ckpt1"}


# --- latency_bench and profile_decode ----------------------------------------


def test_latency_bench_tiny_cpu(capsys):
    out = latency_bench.main(["--device", "cpu", "--max-new", "8",
                              "--cache-len", "256", "--quant", "--kv-int8",
                              "--w8a8", "--pallas-attn", "stream",
                              "--kv-layout", "pos"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert {"ttfa_s", "rtf", "audio_s", "device", "chunk_frames",
            "first_chunk_frames", "scheduler_chunk"} <= set(line)
    assert line["device"] == "cpu" and line["audio_s"] > 0
    assert np.isfinite(line["ttfa_s"]) and np.isfinite(line["rtf"])
    with pytest.raises(SystemExit):
        latency_bench.parse_args(["--fused-fast"])


def test_profile_decode_tiny_cpu(tmp_path, capsys):
    """The workload on a tiny LM with the fused fast head, its trace saved
    and summarised; on the CPU the device table is empty and its idle
    share not measured. A device table from a synthetic trace."""
    base = TCfg(**dataclasses.asdict(_drift_base()))
    args = profile_decode.parse_args([
        "--batch", "3", "--cache", "192", "--steps", "2", "--kv-int8",
        "--pallas", "stream", "--fused-fast", "--kv-layout", "pos",
        "--device", "cpu", "--logdir", str(tmp_path / "tr")])
    table = profile_decode.run_workload(args, base)
    again = profile_decode.main(["--summarize-only", "--logdir",
                                 str(args.logdir)])
    assert again == table and table["wall_ms"] > 0
    assert table["kernels"] == [] and table["idle_share"] is None
    assert "idle share not measured" in capsys.readouterr().out
    live = profile_decode.run_workload(argparse.Namespace(
        **{**vars(args), "logdir": None}), base)   # no trace written
    assert live["kernels"] == [] and live["idle_share"] is None
    # a device trace's accounting
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "a", "dur": 300.0},
        {"ph": "X", "cat": "kernel", "name": "b", "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "a", "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 900.0}]}
    (tmp_path / "t.json").write_text(json.dumps(trace))
    tprof.save_wall(tmp_path / "t.json", 0.002)
    t = tprof.trace_table(tmp_path / "t.json")
    assert t["busy_ms"] == pytest.approx(0.5)
    assert t["idle_share"] == pytest.approx(0.75)
    assert [(k["name"], k["count"]) for k in t["kernels"]] == [("a", 2),
                                                                ("b", 1)]
    lines = tprof.table_lines(t, "x", 1)
    assert lines[0] == "x, device busy 0.5 ms, idle share 0.750"
    assert len(lines) == 2 and lines[1].endswith("2x  a")
    with pytest.raises(SystemExit):
        profile_decode.parse_args(["--no-quant", "--fused-fast"])


# --- data/vqgan.py, utils/logger.py, i18n ------------------------------------


def test_vqgan_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    names = []
    for i, n in enumerate((3000, 700, 40, 100000)):
        wav = (0.3 * rng.standard_normal(n)).astype(np.float32)
        (tmp_path / f"a{i}.wav").write_bytes(encode_wav(wav, 44100))
        names.append(f"a{i}.wav")
    (tmp_path / "bad.wav").write_bytes(b"\x01")
    names += ["bad.wav", "missing.wav"]
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(names) + "\n")
    kw = dict(hop_length=512, slice_frames=64, seed=3)
    jds, tds = jvqgan.VQGANDataset(lst, **kw), tvqgan.VQGANDataset(lst, **kw)
    assert len(jds) == len(tds) == 6
    items = []
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        assert (a is None) == (b is None), i
        if a is not None:
            np.testing.assert_array_equal(b["audio"], a["audio"])
        items.append(b)
    assert items[2] is None and items[4] is None and items[5] is None
    assert len(items[3]["audio"]) == 64 * 512
    jb = jvqgan.VQGANCollator()(items)
    tb = tvqgan.VQGANCollator()(items)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    assert tvqgan.VQGANCollator()([None]) is None


def test_logger_matches_jax(tmp_path, caplog):
    """Rank 0 without a process group; rank-zero-only and one-rank
    emission; the metrics JSONL in JAX's format."""
    assert tlogger.process_rank() == 0
    log = tlogger.RankedLogger("port_logger_test", rank_zero_only=True)
    with caplog.at_level(logging.INFO, logger="port_logger_test"):
        log.info("hello %d", 3)
        log.info("elsewhere", rank=1)
    assert [r.getMessage() for r in caplog.records] == ["[rank 0] hello 3"]
    for mod, name in ((jlogger, "j.jsonl"), (tlogger, "t.jsonl")):
        m = mod.MetricsLogger(tmp_path / name)
        m.log(1, loss=np.float32(0.5), lr=1e-3)
        m.close()
    a = json.loads((tmp_path / "j.jsonl").read_text())
    b = json.loads((tmp_path / "t.jsonl").read_text())
    assert a.keys() == b.keys() and a["loss"] == b["loss"] == 0.5


def test_i18n_matches_jax(tmp_path):
    """Extraction and sync on the same files give JAX's strings, missing
    count and rewritten standard file; the port's own locales cover its
    i18n() calls and equal the JAX package's."""
    src = tmp_path / "code"
    src.mkdir()
    (src / "a.py").write_text(
        'def f():\n    x = i18n("Hello")\n    y = i18n("World")\n'
        '    z = other("nope")\n')
    (src / "b.py").write_text('v = i18n("Hello")\n')
    assert tscan.scan_roots([src]) == jscan.scan_roots([src])
    out = {}
    for name, mod in (("j", jscan), ("t", tscan)):
        loc = tmp_path / f"locale_{name}"
        loc.mkdir()
        (loc / "en_US.json").write_text(json.dumps({"Hello": "Hello",
                                                    "Stale": "Stale"}))
        (loc / "ja_JP.json").write_text(json.dumps({"Hello": "x"}))
        out[name] = (mod.sync_locales(mod.scan_roots([src]),
                                      locale_dir=loc),
                     (loc / "en_US.json").read_text())
    assert out["t"] == out["j"] and out["t"][0] == 2
    assert tscan.main(["--check"]) == 0
    jdir = REPO / "fish_speech_tpu" / "i18n" / "locale"
    for f in sorted(ti18n_core.I18N_FILE_PATH.glob("*.json")):
        assert json.loads(f.read_text()) == json.loads(
            (jdir / f.name).read_text())
    assert len(list(ti18n_core.I18N_FILE_PATH.glob("*.json"))) == 6
    t = ti18n_core.I18nAuto("ja_JP")
    assert t.language == "ja_JP" and t("no such key") == "no such key"
    assert ti18n_core.I18nAuto("xx_XX").language == "en_US"
    assert ti18n_core.i18n("Synthesize") == ti18n_core.default_i18n()(
        "Synthesize")


@pytest.mark.parametrize("tool,argv", [
    (quant_drift, []),
    (latency_bench, []),
    (profile_decode, []),
    (extract_vq, ["corpus"]),
    (eval_in_context, ["--checkpoints", "c", "--proto", "p"]),
    (eval_quality, ["--lm-checkpoint", "."]),
    ("quantize", ["--checkpoint", "c"]),
])
def test_tools_need_the_card_by_default(tool, argv, monkeypatch):
    """Without --device every tool runs on the CUDA card, and with no card
    it raises before any work, instead of running on the CPU."""
    if tool == "quantize":
        from fish_speech_tpu_torch.tools import quantize as tool
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)
