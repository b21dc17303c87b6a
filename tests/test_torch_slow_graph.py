"""The scheduler tick's slow forward through `SlowStepGraph` against the
plain `decode_one_token` tick, bit for bit.

On the CPU the runner never captures: its `forward` (the function a CUDA
graph would hold) runs eagerly on the tensors it closed over when it was
built, so a slot-state tensor that the batcher rebinds instead of writing
in place would part the two runs. On the card (marked `cuda`) the same script
runs at S2-Pro's widths, the slow stack cut to two layers, with the graph
captured at the second tick and replayed after. The file imports neither
JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_slow_graph.py -q
"""

import threading
import types

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.engine import scheduler as tsched
from fish_speech_tpu_torch.engine.generate import serving_config
from fish_speech_tpu_torch.models.config import DualARConfig
from fish_speech_tpu_torch.models.init import init_dual_ar_params
from fish_speech_tpu_torch.ops import _cuda
from fish_speech_tpu_torch.ops.fast_fused import enable_fused_fast_head
from fish_speech_tpu_torch.ops.quant import quantize_lm_params
from fish_speech_tpu_torch.ops.sampling import semantic_logit_bias

IM_END = 4

# (slow stack, fast head) sizes: a tiny model in the fused sweep's 3x
# family, and S2-Pro's widths with each stack cut to two layers (the byte
# tokenizer's 4096 semantic ids, as the benchmark's)
WIDTHS = {
    "tiny": dict(vocab_size=160, n_head=4, n_local_heads=2, dim=128,
                 head_dim=32, intermediate_size=256, codebook_size=32,
                 num_codebooks=4, fast_dim=128, fast_n_head=2,
                 fast_n_local_heads=2, fast_head_dim=64,
                 fast_intermediate_size=384, semantic_begin_id=64,
                 semantic_end_id=95),
    "s2pro": dict(vocab_size=151936, n_head=32, n_local_heads=8, dim=2560,
                  head_dim=128, intermediate_size=9728, codebook_size=4096,
                  num_codebooks=10, fast_dim=1024, fast_n_head=16,
                  fast_n_local_heads=16, fast_head_dim=64,
                  fast_intermediate_size=3072, semantic_begin_id=284,
                  semantic_end_id=284 + 4095),
}


# routes: the slow stack's weights, and the cache with its decode kernel
ROUTES = {
    # the benchmark cell's: W4A8, the position-major int8 cache read by #1
    # (#5's fold, which a per-row tick never takes)
    "w4a8": ("w4a8", dict(kv_fold=True)),
    # the default serving path: W8A8 through torch._int_mm, #1
    "int8": ("int8", {}),
    # the head-major int8 cache read by #6 (another scatter write)
    "int8-head": ("int8", dict(kv_layout="head", attn="blocks16")),
}


def _model(widths: str, route: str, cache_len: int, device):
    """Drawn weights in the serving form (the route's slow stack, int8
    fast head through the fused sweep) and the route's serving
    configuration."""
    quant, serving = ROUTES[route]
    cfg = DualARConfig(n_layer=2, n_fast_layer=2, max_seq_len=cache_len,
                       rope_base=1e6, attention_qk_norm=True,
                       scale_codebook_embeddings=True,
                       norm_fastlayer_input=True, **WIDTHS[widths])
    cfg = serving_config(cfg, **serving)
    gen = torch.Generator(device=device).manual_seed(3)
    params = init_dual_ar_params(gen, cfg, dtype=torch.bfloat16,
                                 device=device)
    groupsize = 32 if widths == "tiny" else 128
    return cfg, enable_fused_fast_head(quantize_lm_params(
        params, mode=quant, groupsize=groupsize))


def _batcher(cfg, params, slots: int, cache_len: int, device):
    bias = semantic_logit_bias(cfg.vocab_size, cfg.semantic_begin_id,
                               cfg.semantic_end_id, IM_END)
    bias[IM_END] = 2.0      # im_end likelier: slots end inside chunks too
    return tsched.ContinuousBatcher(
        params, cfg, num_slots=slots, cache_len=cache_len, im_end_id=IM_END,
        bias=bias, greedy=False, seed=7, top_k=16, prompt_bucket=16,
        prefill_chunk=8, device=device)


def _prompt(cfg, t: int, rng) -> np.ndarray:
    tokens = rng.integers(5, cfg.vocab_size, size=t)
    tokens[t // 2:] = rng.integers(cfg.semantic_begin_id,
                                   cfg.semantic_end_id + 1, size=t - t // 2)
    codes = rng.integers(0, cfg.codebook_size, size=(cfg.num_codebooks, t))
    return np.concatenate([tokens[None], codes]).astype(np.int32)


def _drive(b, cfg, n_ticks: int) -> tuple[list, dict, int]:
    """A fixed script of assigns, a chunked prefill, a budget that runs
    out, a cancel and chunked ticks; every tick's raw column (before the
    inactive rows are masked), each request's codes, and the rows that
    emitted im_end in a tick of a `step_chunk` (which deactivates them on
    the device)."""
    cols, ends = [], []
    tick = b._tick

    def recorded():
        col, finished = tick()
        cols.append(col.clone())
        ends.append(finished.clone())
        return col, finished

    b._tick = recorded
    rng = np.random.default_rng(5)

    def req(i, t, new):
        return tsched.SlotRequest(request_id=i, prompt=_prompt(cfg, t, rng),
                                  max_new_tokens=new, top_k=10 + i,
                                  temperature=0.6 + 0.1 * i)

    reqs = [req(0, 7, 40), req(1, 12, 40), req(2, 5, 3)]
    for slot, r in enumerate(reqs):
        b._assign(r, slot)
    b.step()
    b.step()
    # a prompt longer than the chunk: three chunks between ticks, the last
    # activating its slot
    reqs.append(req(3, 20, 40))
    b._assign(reqs[-1], 3)
    while b.prefill_pending():
        b.prefill_tick()
        b.step()
    assert reqs[2].done.is_set()         # its budget ran out
    reqs[1].cancel()
    b.step()
    assert reqs[1].done.is_set() and not b.active_h[1]
    reqs.append(req(4, 9, 40))
    b._assign(reqs[-1], b.free_slots()[0])
    before = len(ends)
    b.step_chunk(3)
    chunk_ends = int(sum(int(e.sum()) for e in ends[before:]))
    while len(cols) < n_ticks:
        b.step()
    b._tick = tick
    return cols, {r.request_id: tsched.stack_columns(
        r.result, cfg.num_codebooks + 1) for r in reqs}, chunk_ends


def _assert_same(a, b, cols_a, cols_b, out_a, out_b):
    assert len(cols_a) == len(cols_b)
    for i, (x, y) in enumerate(zip(cols_a, cols_b)):
        assert torch.equal(x, y), f"tick {i}"
    for rid in out_a:
        np.testing.assert_array_equal(out_a[rid], out_b[rid])
    for name in ("k", "v", "ks", "vs"):
        assert torch.equal(getattr(a.cache, name), getattr(b.cache, name))
    for name in ("cur", "pos", "prev_win", "active"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("route", list(ROUTES))
def test_runner_tick_equals_plain_tick(route):
    """The runner run eagerly on the CPU (`forward` called as is, on the
    tensors it was built over) gives the plain tick's columns, codes,
    cache and slot state, over 12 ticks of the script."""
    cfg, params = _model("tiny", route, 64, "cpu")
    plain = _batcher(cfg, params, 4, 64, "cpu")
    assert not plain.graph_tick and plain.slow_graph is None
    runner = _batcher(cfg, params, 4, 64, "cpu")
    runner.slow_graph = tsched.SlowStepGraph(runner.slow_forward(),
                                             runner.device)
    cols_p, out_p, ends = _drive(plain, cfg, 12)
    cols_r, out_r, _ = _drive(runner, cfg, 12)
    assert ends > 0          # a row went inactive inside the chunk
    assert plain.slow_graph is None
    assert runner.slow_graph.calls == 12 and runner.slow_graph.graph is None
    _assert_same(plain, runner, cols_p, cols_r, out_p, out_r)


def test_cpu_tick_stays_eager_in_its_spans():
    """On the CPU no graph engages: a traced tick's `decode.slow` span,
    plain or through the eager runner, carries graph=False."""
    from fish_speech_tpu_torch.utils import profiling

    cfg, params = _model("tiny", "int8", 64, "cpu")
    rng = np.random.default_rng(2)
    for with_runner in (False, True):
        b = _batcher(cfg, params, 2, 64, "cpu")
        if with_runner:
            b.slow_graph = tsched.SlowStepGraph(b.slow_forward(), b.device)
        b._assign(tsched.SlotRequest(request_id=0, prompt=_prompt(cfg, 6, rng),
                                     max_new_tokens=8), 0)
        profiling.clear_spans()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            b.step()
            b.step_chunk(2)
        spans = profiling.recorded_spans()
        ticks = {s.id for s in spans if s.name == "tick"}
        slow = [s for s in spans
                if s.name == "decode.slow" and s.parent in ticks]
        assert len(slow) == 3
        assert all(s.attrs == {"graph": False} for s in slow)
        assert b.graph_tick is False


def test_capture_counts_replays_not_the_capture(monkeypatch):
    """A kernel called while this thread captures a graph is counted into
    the capture's counts, not into `launches` (the capture launches
    nothing); `replayed` adds them once a replay; another thread's calls
    meanwhile count as launched."""
    monkeypatch.setattr(_cuda, "lib", lambda source: types.SimpleNamespace(
        w4a8_matmul=lambda *args: 0, fast_sweep=lambda *args: 0))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    mm, sweep = _cuda.Kernel("w4a8_matmul"), _cuda.Kernel("fast_sweep")
    mm()
    with _cuda.capturing() as counts:
        mm()
        mm()
        sweep()
        other = threading.Thread(target=sweep)
        other.start()
        other.join()
    assert counts == {mm: 2, sweep: 1}
    assert (mm.launches, sweep.launches) == (1, 1)
    for _ in range(3):
        _cuda.replayed(counts)
    mm()
    assert (mm.launches, sweep.launches) == (8, 4)


# --- on the card --------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is captured on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module", params=list(ROUTES))
def s2pro(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph is captured on the card")
    return request.param, *_model("s2pro", request.param, 256,
                                  torch.device("cuda"))


def _launched(fn):
    """fn's result, and the hand-written kernels' launch counts it added
    ({C entry: count}, those that rose)."""
    from fish_speech_tpu_torch.ops import attention, fast_fused, w4a8

    kernels = [k for m in (attention, fast_fused, w4a8)
               for k in vars(m).values() if isinstance(k, _cuda.Kernel)]
    before = [k.launches for k in kernels]
    out = fn()
    return out, {k.name: k.launches - n for k, n in zip(kernels, before)
                 if k.launches > n}


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [8, 64])
def test_captured_tick_equals_eager_tick(dev, s2pro, slots):
    """At S2-Pro's widths: 20 ticks through the captured slow forward
    equal 20 eager ticks bit for bit (columns, codes, cache, slot state);
    the graph engaged from the second tick."""
    _, cfg, params = s2pro
    eager = _batcher(cfg, params, slots, 256, dev)
    eager.graph_tick = False
    graph = _batcher(cfg, params, slots, 256, dev)
    assert graph.graph_tick
    (cols_e, out_e, _), launched_e = _launched(lambda: _drive(eager, cfg, 20))
    (cols_g, out_g, _), launched_g = _launched(lambda: _drive(graph, cfg, 20))
    torch.cuda.synchronize()
    assert eager.slow_graph is None
    assert graph.slow_graph.graph is not None
    assert graph.slow_graph.calls == 20
    _assert_same(eager, graph, cols_e, cols_g, out_e, out_g)
    # the kernels' counts follow the launches made: the replays counted,
    # the capture not
    assert launched_e and launched_g == launched_e


@pytest.mark.cuda
def test_capture_beside_another_thread(dev, s2pro):
    """The capture succeeds while another thread allocates and launches on
    the card (thread-local capture), and the replays equal the eager
    ticks. The thread draws from its own generator: capture puts the
    default one in graph mode."""
    _, cfg, params = s2pro
    stop = threading.Event()
    errors = []

    def busy():
        n = 1 << 16
        gen = torch.Generator(device=dev).manual_seed(1)
        try:
            while not stop.is_set():
                x = torch.randn(n, device=dev, generator=gen)
                (x * 2).sum()
                n = n * 2 if n < 1 << 24 else 1 << 16
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    eager = _batcher(cfg, params, 8, 256, dev)
    eager.graph_tick = False
    cols_e, out_e, _ = _drive(eager, cfg, 12)
    graph = _batcher(cfg, params, 8, 256, dev)
    t = threading.Thread(target=busy)
    t.start()
    try:
        cols_g, out_g, _ = _drive(graph, cfg, 12)
    finally:
        stop.set()
        t.join(timeout=60)
    torch.cuda.synchronize()
    assert not t.is_alive() and not errors
    assert graph.slow_graph.graph is not None
    _assert_same(eager, graph, cols_e, cols_g, out_e, out_g)
