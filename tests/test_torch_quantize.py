"""The port's quantization (ops/quant.py: int8, int4, w4a8 and the
incremental form) and its quantize CLI (tools/quantize.py) against the JAX
package's, at the tiny config. Integer leaves and f32 scales are equal
(both sides take the same f32 steps, and the division rounds once), but
against JAX's jitted per-leaf form (see the incremental test)."""

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fish_speech_tpu.models.config import tiny_dual_ar_config
from fish_speech_tpu.models.init import init_dual_ar_params as j_init
from fish_speech_tpu.ops import quant as jq
from fish_speech_tpu.utils import checkpoint as jckpt
from fish_speech_tpu_torch.models.config import DualARConfig as TCfg
from fish_speech_tpu_torch.models.init import lm_params_from_jax
from fish_speech_tpu_torch.ops import quant as tq
from fish_speech_tpu_torch.tools import quantize as tquantize
from fish_speech_tpu_torch.utils import checkpoint as tckpt

REPO = Path(__file__).resolve().parent.parent
GROUPSIZE = 32
MODES = ("int8", "int4", "w4a8")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    if str(a.dtype) == "int4":
        return a.astype(np.int8)
    return a.astype(np.float32) if str(a.dtype) == "bfloat16" else a


def _assert_equal(port: dict, want: dict) -> int:
    """Leaf for leaf, bit for bit; returns the int4 leaves seen."""
    got, exp = dict(_leaves(port)), dict(_leaves(want))
    assert got.keys() == exp.keys()
    n_int4 = 0
    for path, a in exp.items():
        b = got[path]
        a_np, b_np = _np(a), _np(b)
        assert b_np.shape == a_np.shape, path
        if path[-1] == "q" and str(np.asarray(a).dtype) == "int4":
            n_int4 += 1
            assert b.dtype == torch.int8, path
        np.testing.assert_array_equal(b_np, a_np, str(path))
    return n_int4


@pytest.fixture(scope="module")
def jax_tree():
    cfg = tiny_dual_ar_config()
    return cfg, j_init(jax.random.key(3), cfg, dtype=jnp.bfloat16)


def _port_tree(jax_params):
    return lm_params_from_jax(jax.tree.map(np.asarray, jax_params),
                              device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_quantize_lm_params_matches_jax(jax_tree, mode):
    """Every mode, leaf for leaf: the int8 and int4 values and their f32
    scales equal JAX's; in int4 mode JAX's native int4 leaves are the
    port's int8-carried {"q", "gs"} (the slow stack's five matrices)."""
    _, params = jax_tree
    want = jq.quantize_lm_params(params, mode=mode, groupsize=GROUPSIZE)
    got = tq.quantize_lm_params(_port_tree(params), mode=mode,
                                groupsize=GROUPSIZE)
    if mode == "w4a8":
        # the packed form: compare the packed bytes
        assert set(got["layers"]["attention"]["wqkv"]) == {"q4", "gs"}
    n_int4 = _assert_equal(got, want)
    assert n_int4 == (5 if mode == "int4" else 0)


@pytest.mark.parametrize("mode", MODES)
def test_incremental_matches_jax_and_whole_tree(jax_tree, mode):
    """The incremental form empties its input and gives the whole-tree
    function's tree bit for bit (so JAX's quantize_lm_params's, above).
    Against JAX's incremental form: that one jits each leaf, and XLA
    compiles the division by 127 (or 7) as a product with the reciprocal,
    so its scales are one f32 ulp off for some rows and a q value then one
    step off for a few elements; held to that (one ulp, one step, on at
    most 1% of the values)."""
    _, params = jax_tree
    port = _port_tree(params)
    whole = tq.quantize_lm_params(port, mode=mode, groupsize=GROUPSIZE)
    inc = tq.quantize_lm_params_incremental(port, mode=mode,
                                            groupsize=GROUPSIZE)
    assert port == {}
    for (pa, a), (pb, b) in zip(_leaves(whole), _leaves(inc)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa
    want = dict(_leaves(jq.quantize_lm_params_incremental(
        jax.tree.map(jnp.array, params), mode=mode, groupsize=GROUPSIZE)))
    got = dict(_leaves(inc))
    assert got.keys() == want.keys()
    for path, a in want.items():
        a_np, b_np = _np(a), _np(got[path])
        assert a_np.shape == b_np.shape, path
        if path[-1] in ("s", "gs"):
            np.testing.assert_allclose(b_np, a_np, rtol=2 ** -23, atol=0,
                                       err_msg=str(path))
        elif path[-1] in ("q", "q4"):
            if path[-1] == "q4":      # compare the unpacked values
                a_np = _np(tq.unpack_int4(torch.from_numpy(a_np.copy())))
                b_np = _np(tq.unpack_int4(torch.from_numpy(b_np)))
            diff = np.abs(a_np.astype(np.int32) - b_np.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-2, path
        else:
            np.testing.assert_array_equal(b_np, a_np, str(path))


def test_quantize_mode_refused():
    with pytest.raises(ValueError):
        tq.quantize_lm_params({}, mode="int3")
    with pytest.raises(ValueError):
        tq.quantize_lm_params_incremental({}, mode="fp8")


def test_by_layer_equals_whole_leaf():
    """A layer-stacked leaf quantized a layer at a time equals the whole
    leaf's quantization (every quantizer works row by row)."""
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 40, 64)).astype(np.float32)).to(torch.bfloat16)
    for fn in (tq.quantize_weight,
               lambda v: tq.quantize_weight_int4(v, GROUPSIZE),
               lambda v: tq.quantize_weight_int4_packed(v, GROUPSIZE)):
        whole, per = fn(w), tq._by_layer(fn, w)
        for k in whole:
            assert torch.equal(whole[k], per[k]), k


def _bf16_checkpoint(tmp_path, jax_tree) -> Path:
    """The tiny bf16 tree as a native checkpoint, written by the port."""
    cfg, params = jax_tree
    d = tmp_path / "bf16"
    tckpt.save_params(d, _port_tree(params), config=dataclasses.asdict(
        TCfg(**dataclasses.asdict(cfg))))
    return d


@pytest.mark.parametrize("mode", MODES)
def test_port_cli_output_reads_in_jax(tmp_path, jax_tree, mode, capsys):
    """tools.quantize on the CPU; JAX's load_params reads the result (int4
    leaves through quant_meta.json) equal to JAX's quantize_lm_params of
    the same tree, and the CLI prints the sizes."""
    _, params = jax_tree
    src = _bf16_checkpoint(tmp_path, jax_tree)
    out = tquantize.main(["--checkpoint", str(src), "--mode", mode,
                          "--groupsize", str(GROUPSIZE), "--device", "cpu"])
    assert out == src.with_name(f"bf16-{mode}")
    assert " GB -> " in capsys.readouterr().out
    meta = out / "quant_meta.json"
    assert meta.exists() == (mode == "int4")
    loaded, cfg = jckpt.load_params(out)
    assert cfg["vocab_size"] == tiny_dual_ar_config().vocab_size
    want = jq.quantize_lm_params(params, mode=mode, groupsize=GROUPSIZE)
    if mode == "int4":
        assert sorted(json.loads(meta.read_text())["int4_keys"]) == sorted(
            k for k, v in jckpt._flatten(want).items()
            if str(np.asarray(v).dtype) == "int4")
    n = 0
    for (pa, a), (pb, b) in zip(sorted(_leaves(want)),
                                sorted(_leaves(loaded))):
        assert pa == pb
        assert np.asarray(a).dtype == np.asarray(b).dtype, pa
        np.testing.assert_array_equal(_np(b), _np(a), str(pa))
        n += 1
    assert n == len(dict(_leaves(want)))


def _jax_quantize_cli(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_quantize_cli", REPO / "tools" / "quantize.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["quantize.py", *argv])
    mod.main()


@pytest.mark.parametrize("mode", MODES)
def test_jax_cli_output_reads_in_port(tmp_path, jax_tree, mode,
                                      monkeypatch, capsys):
    """JAX's tools/quantize.py on a JAX-written bf16 checkpoint; the
    port's load_params reads it equal to the port's own tools.quantize
    output of the same checkpoint (JAX's int4 leaves packed on load, as
    the port's own)."""
    cfg, params = jax_tree
    src = tmp_path / "jsrc"
    jckpt.save_params(src, params, config=cfg)
    _jax_quantize_cli(["--checkpoint", str(src), "--output",
                       str(tmp_path / "jq"), "--mode", mode,
                       "--groupsize", str(GROUPSIZE)], monkeypatch)
    tquantize.main(["--checkpoint", str(src), "--output",
                    str(tmp_path / "tq"), "--mode", mode,
                    "--groupsize", str(GROUPSIZE), "--device", "cpu"])
    capsys.readouterr()
    a, acfg = tckpt.load_params(tmp_path / "jq", device="cpu")
    b, bcfg = tckpt.load_params(tmp_path / "tq", device="cpu")
    assert acfg == bcfg
    for (pa, x), (pb, y) in zip(sorted(_leaves(a)), sorted(_leaves(b))):
        assert pa == pb and x.dtype == y.dtype and torch.equal(x, y), pa
    if mode != "int8":
        assert set(a["layers"]["attention"]["wqkv"]) == {"q4", "gs"}
