"""The port's corpus pipeline against the JAX package's: the proto3 wire
codec (data/protos.py) byte for byte against `google.protobuf` in both
directions, brace expansion, the stream files, the same samples and
batches from the same seed, and the training CLIs end to end on the CPU
(build_dataset, train full and LoRA, auto-resume, merge_lora) with their
checkpoints read by the other package."""

import random
import struct

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from fish_speech_tpu import data as jdata
from fish_speech_tpu.data import protos as jpb
from fish_speech_tpu.text import ByteTokenizer as JTok
from fish_speech_tpu.train import lora as jlora
from fish_speech_tpu.utils import checkpoint as jckpt
from fish_speech_tpu_torch import data as tdata
from fish_speech_tpu_torch.data import protos as tpb
from fish_speech_tpu_torch.text import ByteTokenizer as TTok
from fish_speech_tpu_torch.tools import build_dataset, merge_lora, train
from fish_speech_tpu_torch.train.lora import LoraConfig
from fish_speech_tpu_torch.train.lora import merge_lora as tmerge
from fish_speech_tpu_torch.utils import checkpoint as tckpt
from fish_speech_tpu_torch.utils.file import get_latest_checkpoint

U32 = st.integers(0, 2 ** 32 - 1)
SENTENCE = st.tuples(st.lists(st.text(max_size=12), max_size=3),
                     st.lists(st.lists(U32, max_size=6), max_size=3))
TEXT_DATA = st.tuples(st.text(max_size=12), st.text(max_size=12),
                      st.lists(SENTENCE, max_size=3))


def build(mod, spec, cls="TextData", field="sentences"):
    """The same TextData / SampledData in either package's classes."""
    source, name, sentences = spec
    td = getattr(mod, cls)(source=source, name=name)
    for texts, sems in sentences:
        sent = getattr(td, field).add()
        sent.texts.extend(texts)
        for values in sems:
            sent.semantics.add().values.extend(values)
    return td


def as_spec(td, field="sentences"):
    return (td.source, td.name,
            [(list(s.texts), [list(x.values) for x in s.semantics])
             for s in getattr(td, field)])


@settings(max_examples=150, deadline=None)
@given(TEXT_DATA, st.sampled_from([("TextData", "sentences"),
                                   ("SampledData", "samples")]))
def test_wire_codec_matches_protobuf(spec, kind):
    ours = build(tpb, spec, *kind)
    theirs = build(jpb, spec, *kind)
    raw = theirs.SerializeToString()
    assert ours.SerializeToString() == raw
    back = getattr(tpb, kind[0])()
    assert back.ParseFromString(raw) == len(raw)
    assert as_spec(back, kind[1]) == as_spec(theirs, kind[1])
    assert back == ours
    again = getattr(jpb, kind[0])()
    again.ParseFromString(ours.SerializeToString())
    assert again == theirs


def _varint(n):
    out = bytearray()
    while n > 0x7F:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    return bytes(out + bytes([n]))


@settings(max_examples=80, deadline=None)
@given(st.lists(U32, max_size=8), st.lists(U32, max_size=4),
       st.integers(0, 2 ** 64 - 1), st.binary(max_size=6))
def test_reads_unpacked_uint32_and_skips_unknown_fields(packed, loose, big,
                                                        blob):
    """Semantics with a packed run, then single unpacked values (one a
    10-byte varint truncated to 32 bits), between unknown fields of every
    wire type; both readers see the same values."""
    raw = bytearray()
    raw += _varint(9 << 3 | 0) + _varint(big)                 # unknown varint
    if packed:
        body = b"".join(_varint(v) for v in packed)
        raw += _varint(1 << 3 | 2) + _varint(len(body)) + body
    raw += _varint(10 << 3 | 1) + struct.pack("<Q", big)      # unknown i64
    for v in loose:
        raw += _varint(1 << 3 | 0) + _varint(v)
    raw += _varint(1 << 3 | 0) + _varint(big)
    raw += _varint(11 << 3 | 2) + _varint(len(blob)) + blob   # unknown bytes
    raw += _varint(12 << 3 | 5) + struct.pack("<I", big & 0xFFFFFFFF)
    theirs = jpb.Semantics()
    theirs.ParseFromString(bytes(raw))
    ours = tpb.Semantics()
    assert ours.ParseFromString(bytes(raw)) == len(raw)
    assert ours.values == list(theirs.values)
    assert ours.values[-1] == big & 0xFFFFFFFF


def test_codec_refuses_bad_input():
    with pytest.raises(ValueError):
        tpb.Semantics(values=[2 ** 32]).SerializeToString()
    with pytest.raises(tpb.DecodeError):
        tpb.Semantics().ParseFromString(b"\x0a\x05\x01")  # truncated
    with pytest.raises(tpb.DecodeError):
        tpb.Sentence().ParseFromString(b"\x0a\x01\xff")   # bad UTF-8


def test_braceexpand_matches_jax():
    cases = ["a{b,c}d", "x{0..3}", "s{01..03}.proto", "plain",
             "a{b,{c,d}}e", "{3..0}", "{0..10..3}", "{a}", "a{b", "a}b{c,d}",
             "{x,y}{1..2}", "{-2..1}", "p/{000..002}/{a,b}.protos", ""]
    for c in cases:
        assert list(tdata.braceexpand(c)) == list(jdata.braceexpand(c)), c


def write_corpus(path, n_groups=3, n_sentences=5, k=4, seed=0):
    """Written by JAX's stream writer (google.protobuf)."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for g in range(n_groups):
            td = jpb.TextData(source="test", name=f"spk{g}")
            for s in range(n_sentences + g):
                sent = td.sentences.add()
                sent.texts.append(f"sentence {g} {s}, with words")
                t = int(rng.integers(3, 9))
                for _ in range(k):
                    sent.semantics.add().values.extend(
                        rng.integers(0, 64, t).tolist())
            jdata.write_pb_stream(f, td)
    return path


def test_stream_functions_match_jax(tmp_path):
    p = write_corpus(tmp_path / "c.protos")
    with open(p, "rb") as f:
        ours = list(tdata.read_pb_stream(f))
    with open(p, "rb") as f:
        chunks = list(tdata.split_pb_stream(f))
    with open(p, "rb") as f:
        assert chunks == list(jdata.split_pb_stream(f))
    assert b"".join(tdata.pack_pb_stream(t) for t in ours) == p.read_bytes()
    q = tmp_path / "d.protos"
    with open(q, "wb") as f:
        for t in ours:
            tdata.write_pb_stream(f, t)
    assert q.read_bytes() == p.read_bytes()


@pytest.mark.parametrize("causal,skip", [(True, 0.0), (False, 0.3)])
def test_same_seed_same_samples_and_batches(tmp_path, causal, skip):
    """`random.seed(s)` before each package's dataset gives the same packed
    samples and the same collated batches; InterleaveDataset's numpy draws
    too."""
    p = str(write_corpus(tmp_path / "c.protos"))

    def run(mod, tok_cls):
        tok = tok_cls(n_semantic=64)
        kw = dict(seed=3, max_length=96, num_codebooks=4, causal=causal,
                  skip_text_prob=skip)
        random.seed(7)
        ds = mod.SemanticIterableDataset([p], tok, **kw)
        items = [next(iter(ds)) for _ in range(4)]
        loader = mod.data_loader(ds, mod.TextDataCollator(tok, 80), 3)
        batches = [next(loader) for _ in range(2)]
        mix = mod.InterleaveDataset(
            [ds, mod.SemanticIterableDataset([p], tok, **{**kw, "seed": 4})],
            [0.3, 0.7], seed=5)
        it = iter(mix)
        return items, batches, [next(it) for _ in range(3)]

    want = run(jdata, JTok)
    got = run(tdata, TTok)
    for w_items, g_items in zip(want, got):
        for w, g in zip(w_items, g_items):
            assert w.keys() == g.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], k)
                assert g[k].dtype == w[k].dtype, k
    assert got[1][0]["inputs"].shape[2] == 80


def test_split_by_rank_worker_matches_jax():
    files = [f"f{i}" for i in range(5)]
    for w in range(3):
        assert (tdata.split_by_rank_worker(files, w, 3)
                == jdata.split_by_rank_worker(files, w, 3))
    assert tdata.split_by_rank_worker(files[:1], 1, 2) == ["f0"]


def _as_np(tree):
    if isinstance(tree, dict):
        return {k: _as_np(v) for k, v in tree.items()}
    return np.asarray(tree.detach().float() if isinstance(tree, torch.Tensor)
                      else np.asarray(tree, np.float32))


def _assert_equal_trees(a, b, what):
    a, b = _as_np(a), _as_np(b)
    assert a.keys() == b.keys(), what
    for k in a:
        if isinstance(a[k], dict):
            _assert_equal_trees(a[k], b[k], f"{what}/{k}")
        else:
            np.testing.assert_array_equal(a[k], b[k], f"{what}/{k}")


def test_cli_pipeline(tmp_path):
    """build_dataset on a two-speaker corpus (read back by JAX's reader),
    two full steps and two LoRA steps, a resumed third of each, and
    merge_lora, all with --device cpu; each checkpoint read by JAX's
    load_params equal to the port's tensors, and JAX's merge of the port's
    factors equal to the port's merged checkpoint."""
    rng = np.random.default_rng(0)
    corpus, clips = tmp_path / "corpus", {}
    for spk in ("alice", "bob"):
        (corpus / spk).mkdir(parents=True)
        for i in range(3):
            codes = rng.integers(0, 64, (4, int(rng.integers(5, 20))))
            np.save(corpus / spk / f"c{i}.npy", codes)
            (corpus / spk / f"c{i}.lab").write_text(f"{spk} says {i}")
            clips[f"{spk} says {i}"] = codes
    protos = tmp_path / "protos"
    assert build_dataset.main(["--input", str(corpus), "--output",
                               str(protos)]) == 6
    with open(protos / "00000.protos", "rb") as f:
        groups = list(jdata.read_pb_stream(f))
    assert [g.name for g in groups] == ["alice", "bob"]
    for g in groups:
        for s in g.sentences:
            np.testing.assert_array_equal(
                [list(x.values) for x in s.semantics], clips[s.texts[0]])

    common = ["--proto-dir", str(protos), "--batch-size", "2",
              "--max-length", "128", "--log-every", "1",
              "--checkpoint-every", "1", "--warmup-steps", "1",
              "--device", "cpu"]
    out = {}
    for mode, extra in (("full", []), ("lora", ["--lora"])):
        d = tmp_path / mode
        for steps in (2, 3):   # the second run resumes from step 2
            r = train.main(common + extra + ["--output-dir", str(d),
                                             "--max-steps", str(steps)])
            assert [h["step"] for h in r["history"]] == (
                [1, 2] if steps == 2 else [3])
            for h in r["history"]:
                assert all(np.isfinite(v) for v in h.values()), h
        final = get_latest_checkpoint(d, "step_*")
        assert final.name == "step_000000003_final"
        jtree, jcfg = jckpt.load_params(final)
        _assert_equal_trees(r["state"], jtree, mode)
        assert (jcfg is None) == (mode == "lora")
        out[mode] = (r, final)

    # the LoRA run's base is the tiny model drawn from seed 0
    lora_run, lora_final = out["lora"]
    assert any(float(v["b"].detach().abs().sum()) > 0
               for v in lora_run["state"].values())
    base_dir = tmp_path / "base"
    tckpt.save_params(base_dir, lora_run["params"], lora_run["cfg"])
    merged_dir = tmp_path / "merged"
    diff = merge_lora.main(["--base", str(base_dir), "--lora",
                            str(lora_final), "--output", str(merged_dir),
                            "--device", "cpu"])
    assert diff > 0
    merged, mcfg = tckpt.load_params(merged_dir, device="cpu")
    assert mcfg == jckpt.load_params(base_dir)[1]
    want = jlora.merge_lora(
        jax.tree.map(jnp.asarray, jckpt.load_params(base_dir)[0]),
        jax.tree.map(jnp.asarray, jckpt.load_params(lora_final)[0]),
        jlora.LoraConfig())
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(_as_np(merged))[0],
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, want))[0]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))
    ours = tmerge(lora_run["params"], lora_run["state"], LoraConfig())
    _assert_equal_trees(ours, merged, "merged")

    # a checkpoint JAX wrote loads in the port
    jtree, jcfg = jckpt.load_params(out["full"][1])
    jdir = tmp_path / "jax_ckpt"
    jckpt.save_params(jdir, jtree, jcfg)
    back, cfg = tckpt.load_params(jdir, device="cpu")
    assert cfg == jcfg
    _assert_equal_trees(back, out["full"][0]["state"], "jax->port")


WORLD_ENV = {"RANK": "0", "WORLD_SIZE": "4", "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": "29500"}


def _world(monkeypatch, env: dict) -> None:
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def test_train_cli_multihost_needs_the_world(monkeypatch, capsys):
    """--multihost without torchrun's environment exits before anything
    runs, naming what is missing; with it, the mesh covers the world."""
    _world(monkeypatch, {})
    with pytest.raises(SystemExit):
        train.parse_args(["--proto-dir", "x", "--multihost"])
    err = capsys.readouterr().err
    assert "--multihost needs the world's environment" in err
    assert "RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT" in err
    _world(monkeypatch, WORLD_ENV)
    args = train.parse_args(["--proto-dir", "x", "--multihost",
                             "--model-parallel", "2"])
    assert (args.world, args.rank, args.mesh_shape) == (4, 0, (2, 2))


@pytest.mark.parametrize("env,flags", [
    ({}, ["--data-parallel", "2"]),                 # one process, data 2
    ({}, ["--model-parallel", "2"]),                # one process, model 2
    (WORLD_ENV, ["--model-parallel", "3"]),         # 4 ranks, model 3
    (WORLD_ENV, ["--data-parallel", "1", "--model-parallel", "2"]),
])
def test_train_cli_mesh_must_cover_the_world(monkeypatch, capsys, env,
                                             flags):
    """A mesh that does not cover WORLD_SIZE exits before anything trains:
    the CLI never trains on fewer devices instead."""
    _world(monkeypatch, env)
    with pytest.raises(SystemExit):
        train.parse_args(["--proto-dir", "x", "--batch-size", "4", *flags])
    assert "does not cover the world" in capsys.readouterr().err


def test_train_cli_batch_must_split_over_data(monkeypatch, capsys):
    """A batch size that the data axis does not divide exits; one that it
    divides gives the mesh."""
    _world(monkeypatch, WORLD_ENV)
    with pytest.raises(SystemExit):
        train.parse_args(["--proto-dir", "x", "--batch-size", "6"])
    assert "does not split over the data axis of 4" in \
        capsys.readouterr().err
    args = train.parse_args(["--proto-dir", "x", "--batch-size", "8"])
    assert args.mesh_shape == (4, 1)


def test_create_train_split_matches_jax(tmp_path, monkeypatch):
    """The same train and validation lists as JAX's script, durations
    filtered."""
    import importlib.util
    import sys
    import wave
    from pathlib import Path

    from fish_speech_tpu_torch.tools import create_train_split

    for i in range(7):
        d = tmp_path / f"spk{i % 2}"
        d.mkdir(exist_ok=True)
        with wave.open(str(d / f"x{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(np.zeros(800 * (i + 1), np.int16).tobytes())
    args = [str(tmp_path), "--val-count", "2", "--min-duration", "0.15",
            "--max-duration", "0.65"]
    names = ("vq_train_filelist.txt", "vq_val_filelist.txt")
    create_train_split.main(args)
    ours = [(tmp_path / n).read_text() for n in names]
    path = Path(__file__).resolve().parent.parent / "tools" / \
        "create_train_split.py"
    spec = importlib.util.spec_from_file_location("jax_split", path)
    jax_split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_split)
    monkeypatch.setattr(sys, "argv", ["create_train_split.py", *args])
    jax_split.main()
    assert [(tmp_path / n).read_text() for n in names] == ours
    assert len(ours[0].splitlines()) == 3 and len(ours[1].splitlines()) == 2
