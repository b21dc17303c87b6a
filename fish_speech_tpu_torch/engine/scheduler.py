"""Continuous-batching decode scheduler.

Counterpart of `fish_speech_tpu/engine/scheduler.py`. Requests share one
batch of decode *slots* on the device:

- a (B, K+1) slot bank decodes one step per tick for every active slot,
  each slot at its own sequence position (`forward_generate` takes a (B,)
  `input_pos` and scatters each row's KV at its own column);
- a new request prefills at batch 1 into a free slot between ticks,
  through a view of that slot's rows of the shared cache, so the prefill
  writes the cache in place (the JAX package's `write_slot_cache`, which
  copies the slot back, has no counterpart);
- a finished slot (im_end or budget) frees at once and its codes go to the
  caller, so utterances of different lengths never wait for each other.

The JAX package runs each of these as a jitted program; here each is an
eager sequence of launches with the same shapes every tick, except a
tick's slow forward, which on a CUDA device without a decode mesh is
captured once as a CUDA graph and replayed (`SlowStepGraph`). The slot
state (last column, position, left-pad offset, active flags, RAS window,
per-slot sampling parameters) stays on the device; the host keeps a mirror
of the active flags and the token budgets, so scheduling decisions need no
device read. A tick's column is read back once per `step()`, or once per
`step_chunk(n)` for n ticks. Uniforms come from the batcher's own
`torch.Generator`, drawn in the same order whether ticks run one by one or
in chunks.

Under a decode mesh (`parallel.tp.decode_mesh`), the batcher ticks on the
rank's parameter slices: the cache holds the rank's Hkv / tp heads, and
the slots split over the data axis, data rank d owning the contiguous
block of num_slots / data. Every rank keeps the same host bookkeeping of
all slots: a prefill runs on the owning data rank's model group only, and
each fetched column (a tick's, or a prefill's first) is gathered over the
data group before the host reads it.
"""

from __future__ import annotations

import hashlib
import logging
import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import DualARConfig
from ..models.decode import (
    SamplingConfig,
    decode_fast,
    decode_one_token,
    new_fast_cache,
)
from ..models.dual_ar import (
    KVCache,
    SlowOut,
    forward_generate,
    param_dtype,
    precompute_freqs_cis,
)
from ..ops import _cuda
from ..ops.sampling import RAS_WIN_SIZE, push_window
from ..parallel.collectives import all_gather
from ..parallel.tp import active_mesh
from ..utils.profiling import span, span_since


def slice_slot_cache(cache: KVCache, slot: int) -> KVCache:
    """One slot's (B=1) view of the stacked cache: writes through it land
    in `cache`. The batch axis is 2 for position-major k/v (L, S, B, H, D),
    1 for everything else."""
    def sl(a, axis):
        return None if a is None else a.narrow(axis, slot, 1)

    kv_axis = 2 if cache.pos_major else 1
    return KVCache(sl(cache.k, kv_axis), sl(cache.v, kv_axis),
                   sl(cache.ks, 1), sl(cache.vs, 1), cache.pos_major)


class SlowStepGraph:
    """A tick's slow-stack forward replayed as one CUDA graph: `forward`
    (`forward_generate` at T = 1 over every slot, with the arithmetic of
    its per-row write positions and RoPE rows) takes ~140 small launches a
    layer, which cost the host far more than the device's work behind
    them.

    `forward` takes no arguments: it reads fixed tensors (the batcher's
    slot state, cache, RoPE table and parameters), which the batcher
    writes in place and never rebinds. The first call runs it eagerly
    (one-time work: libraries loaded, shared-memory attributes set, the SM
    count cached); the second captures it, then every call replays. Its
    outputs live in the graph's memory pool: the fast half reads them on
    the same stream before the next replay rewrites them. Capture puts
    the process's default CUDA generator in graph mode, so no other thread
    may draw from it meanwhile (the engine's threads draw from their own
    generators). The hand-written kernels' launch counts follow the
    launches made: the capture's calls are left out and added at each
    replay (`_cuda.capturing`). A capture that raises is logged once and
    the runner stays eager. Off CUDA it never captures: `forward` runs as
    is."""

    def __init__(self, forward: Callable[[], SlowOut], device: torch.device):
        self.forward = forward
        self.capturable = device.type == "cuda"
        self.calls = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: SlowOut | None = None
        self.launches: dict = {}

    def _capture(self) -> None:
        try:
            graph = torch.cuda.CUDAGraph()
            # thread_local: the engine's vocoder and client threads go on
            # allocating and launching while this thread captures
            with _cuda.capturing() as launches, torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                out = self.forward()
        except Exception:  # noqa: BLE001 - the eager forward stays
            logging.getLogger(__name__).exception(
                "capturing the tick's slow forward failed; it stays eager")
            self.capturable = False
            return
        self.graph, self.out, self.launches = graph, out, launches

    def __call__(self) -> SlowOut:
        if self.graph is None and self.capturable and self.calls > 0:
            self._capture()
        self.calls += 1
        if self.graph is None:
            return self.forward()
        self.graph.replay()
        _cuda.replayed(self.launches)
        return self.out


def tick_positions(active: torch.Tensor, pos: torch.Tensor,
                   start: torch.Tensor, cache_len: int):
    """A tick's (B,) write positions and (B, 1) RoPE positions: an
    inactive slot, or one past the cache's end, writes row cache_len - 1
    (`ContinuousBatcher._tick`)."""
    write_pos = torch.where(active & (pos < cache_len), pos,
                            torch.full_like(pos, cache_len - 1))
    return write_pos, (write_pos - start)[:, None]


@dataclass
class SlotRequest:
    request_id: int
    prompt: np.ndarray            # (K+1, T)
    max_new_tokens: int
    temperature: float = 0.7
    top_p: float = 0.7
    on_token: Callable | None = None   # streaming hook: (request_id, column)
    # prefix caching: the first `prefix_len` prompt columns are a shared,
    # immutable prefix (e.g. the voice-clone system prompt). Requests with
    # the same `prefix_id` must share those exact columns; the scheduler
    # prefills them once and copies the cached KV rows on later assigns.
    prefix_id: str | None = None
    prefix_len: int = 0
    # per-request top-k, masked inside the batcher's static roof of
    # `ContinuousBatcher.top_k` candidates (exact for any k <= roof)
    top_k: int = 30
    result: list = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    error: Exception | None = None
    cancelled: threading.Event = field(default_factory=threading.Event)
    # time.time_ns() at the scheduler's `submit`: the start of its `queue`
    # span, which ends when the request is assigned a slot
    submitted_ns: int | None = None

    def cancel(self) -> None:
        """Abandon the request: the scheduler frees its slot on the next
        tick (or drops it from the intake queue or the in-flight chunked
        prefills)."""
        self.cancelled.set()


class ContinuousBatcher:
    def __init__(self, params: dict, cfg: DualARConfig, *, num_slots: int,
                 cache_len: int, im_end_id: int, bias: torch.Tensor,
                 sampling: SamplingConfig | None = None, top_k: int = 30,
                 greedy: bool = False, seed: int = 0,
                 prompt_bucket: int = 128,
                 prefill_chunk: int | None = None, device=None):
        """`device`: CUDA unless the caller names another (the parameters
        must already be there). Prompts are bucketed to multiples of
        `prompt_bucket`; prompts longer than `prefill_chunk` (None: never)
        prefill one chunk per `prefill_tick()`, between decode ticks.
        Under a decode mesh, `params` are the rank's slices and num_slots
        must divide by the data axis."""
        if prompt_bucket < 2 or (prefill_chunk is not None
                                 and prefill_chunk < 2):
            # a slot's prefill reads the cache through a strided view,
            # which only the T > 1 (einsum) attention path takes
            raise ValueError("prompt_bucket and prefill_chunk must be at "
                             "least 2")
        self.device = dev = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.cache_len = cache_len
        self.im_end_id = im_end_id
        self.bias = bias.to(dev)
        self.sampling = sampling or SamplingConfig.create()
        self.top_k = top_k
        self.greedy = greedy
        self.prompt_bucket = prompt_bucket
        self.prefill_chunk = prefill_chunk
        self._inflight: list[dict] = []  # FIFO of chunked assigns
        # observability: prompts that took the chunked path, decode ticks
        # run while a chunked prefill was in flight, decode ticks in all
        # and those run inside step_chunk
        self.chunked_prefills = 0
        self.ticks_while_prefilling = 0
        self.cancelled_requests = 0
        self.ticks = 0
        self.chunked_ticks = 0
        # single-host mode sweeps cancelled requests at every tick entry;
        # multihost serving sets this False, so that cancellations apply
        # only through the broadcast TickPlan (a leader-local sweep would
        # free a slot that followers still hold active)
        self.local_sweep = True

        # the slots this rank holds: [slot0, slot0 + local_slots)
        self.mesh = active_mesh(cfg.tp_shards)
        data = self.mesh.data if self.mesh is not None else 1
        if num_slots % data:
            raise ValueError(f"num_slots={num_slots} does not split over "
                             f"{data} data ranks")
        self.local_slots = num_slots // data
        self.slot0 = (self.mesh.data_index * self.local_slots
                      if self.mesh is not None else 0)
        self.kv_heads = cfg.n_local_heads // cfg.tp_shards
        self.kv_dtype = (torch.int8 if cfg.kv_cache_dtype == "int8"
                         else param_dtype(params))
        self.pos_major = cfg.kv_cache_layout == "pos"
        self.cache = KVCache.create(cfg.n_layer, self.local_slots, cache_len,
                                    self.kv_heads, cfg.head_dim,
                                    dtype=self.kv_dtype,
                                    pos_major=self.pos_major, device=dev)
        self.freqs = precompute_freqs_cis(cache_len, cfg.head_dim,
                                          cfg.rope_base, dev)
        self.fast_freqs = precompute_freqs_cis(cfg.num_codebooks,
                                               cfg.fast_head_dim,
                                               cfg.rope_base, dev)
        # each batch size has its own fast-head cache (a fused one also
        # holds its sweep's scratch): the rank's slots for ticks, 1 for
        # prefills
        act = param_dtype(params)
        self.fast_cache = new_fast_cache(params, cfg, self.local_slots, dev,
                                         act)
        self.fast_cache_1 = new_fast_cache(params, cfg, 1, dev, act)

        # device state of the rank's slots; temperature, top_p and top_k
        # are per slot (top_k masked inside the static roof, so one tick
        # serves any k <= roof)
        def full(v, dtype):
            return torch.full((self.local_slots,), v, dtype=dtype,
                              device=dev)

        self.temp = full(float(self.sampling.temperature), torch.float32)
        self.top_p = full(float(self.sampling.top_p), torch.float32)
        self.top_k_row = full(top_k, torch.int32)
        self.cur = torch.zeros((self.local_slots, cfg.num_codebooks + 1),
                               dtype=torch.int32, device=dev)
        self.pos = full(0, torch.int32)       # next write slot
        self.start = full(0, torch.int32)     # left-pad offset
        self.active = full(False, torch.bool)
        self.prev_win = torch.zeros((self.local_slots, RAS_WIN_SIZE),
                                    dtype=torch.int32, device=dev)
        self.gen = torch.Generator(device=dev).manual_seed(seed)

        # host-side slot metadata; `active_h` mirrors the device flags (the
        # host sees every (de)activation: assign, budget, im_end in the
        # fetched columns), so scheduling never reads the device
        self.slot_req: list[SlotRequest | None] = [None] * num_slots
        self.slot_budget = np.zeros(num_slots, dtype=np.int64)
        self.active_h = np.zeros(num_slots, dtype=bool)
        # constrained decoding samples only semantic ids and im_end, so the
        # logits are computed over just that support
        self.support = None
        if (cfg.semantic_begin_id is not None
                and cfg.semantic_end_id is not None):
            self.support = (cfg.semantic_begin_id, cfg.semantic_end_id,
                            im_end_id)
        # prefix KV cache: prefix_id -> (1-slot KVCache of a bucketed
        # length, prefix length, token hash); LRU-bounded. A hit copies the
        # cached rows instead of prefilling the shared prefix again.
        self.prefix_store: "OrderedDict[str, tuple]" = OrderedDict()
        self.prefix_store_cap = 8
        self.prefix_hits = 0
        self.prefix_misses = 0
        # a tick's slow forward replays as one CUDA graph (`SlowStepGraph`
        # over `slow_forward`, built at the first tick) on a CUDA device
        # with no decode mesh: a mesh's collectives cannot be captured.
        # Multihost replicas turn it off, as they turn off local_sweep, and
        # tick eagerly. The graph reads cur, pos, start and active, so
        # those are only ever written in place.
        self.graph_tick = dev.type == "cuda" and self.mesh is None
        self.slow_graph: SlowStepGraph | None = None

    # ------------------------------------------------------------------
    def _local(self, slot: int) -> int | None:
        """The slot's index on this rank, None if another data rank holds
        it."""
        i = slot - self.slot0
        return i if 0 <= i < self.local_slots else None

    def _gather_slots(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The rank's slot rows of `t` (along `dim`) gathered over the data
        group into every slot's."""
        if self.local_slots == self.num_slots:
            return t
        return all_gather(t, self.mesh.data_group, dim=dim)

    def _step_kw(self) -> dict:
        return dict(top_k=self.top_k, greedy=self.greedy, gen=self.gen,
                    sample_support=self.support)

    def slow_forward(self) -> Callable[[], SlowOut]:
        """A tick's slow forward as a function of no arguments over the
        batcher's tensors as they are now (the function a `SlowStepGraph`
        captures): the tick's positions, then `forward_generate` at T = 1
        over every slot."""
        params, cfg, cache, freqs = (self.params, self.cfg, self.cache,
                                     self.freqs)
        cur, pos, start, active = self.cur, self.pos, self.start, self.active
        cache_len, support = self.cache_len, self.support

        def forward() -> SlowOut:
            write_pos, rope_pos = tick_positions(active, pos, start,
                                                 cache_len)
            return forward_generate(params, cfg, cur[:, :, None], cache,
                                    write_pos, freqs,
                                    rope_positions=rope_pos,
                                    key_valid_from=start,
                                    logit_support=support)

        return forward

    def _tick(self):
        """One decode step of every slot. Inactive slots (free, or in the
        middle of a chunked prefill) write their KV at row cache_len - 1
        instead of their stale position, which a chunk may already have
        filled: that row is attended only at a step with pos == cache_len -
        1, whose own write lands before the read. Their state is frozen.
        So does an active slot whose position has passed the cache's end (a
        budget spent inside a `step_chunk`: the host drops those columns),
        so no write or RoPE row falls outside the cache
        (`tick_positions`). With `graph_tick`, the slow forward goes
        through `slow_graph` (eager at the first tick, a replay from the
        second), then `decode_fast`: the launches `decode_one_token`
        makes, in order.
        Returns (column (B, K+1), finished (B,)), both on the device."""
        active = self.active
        sampling = SamplingConfig(self.temp, self.top_p, self.top_k_row)
        if self.slow_graph is None and self.graph_tick:
            self.slow_graph = SlowStepGraph(self.slow_forward(), self.device)
        if self.slow_graph is None:
            write_pos, rope_pos = tick_positions(active, self.pos,
                                                 self.start, self.cache_len)
            col = decode_one_token(
                self.params, self.cfg, self.cur[:, :, None], self.cache,
                write_pos, self.freqs, self.fast_freqs, self.bias, sampling,
                self.prev_win, rope_positions=rope_pos,
                key_valid_from=self.start, fast_cache=self.fast_cache,
                **self._step_kw())
        else:
            with span("decode.slow") as sp:
                out = self.slow_graph()
                sp.set(graph=self.slow_graph.graph is not None)
            col = decode_fast(self.params, self.cfg, out, self.fast_freqs,
                              self.bias, sampling, self.prev_win,
                              fast_cache=self.fast_cache, **self._step_kw())
        col = torch.where(active[:, None], col, self.cur)
        self.pos += active
        self.prev_win = torch.where(active[:, None],
                                    push_window(self.prev_win, col[:, 0]),
                                    self.prev_win)
        self.cur.copy_(col)
        self.ticks += 1
        return col, active & (col[:, 0] == self.im_end_id)

    def _prefill(self, slot: int, block: np.ndarray, input_pos: int,
                 rope_pos: torch.Tensor, key_valid_from: int,
                 req: SlotRequest | None, sample_at: int | None = None):
        """Prefill `block` ((K+1, T) host tokens) at batch 1 into the slot's
        rows [input_pos, input_pos + T), through a view of the shared cache.
        With `req`, sample the request's first column (at `sample_at`, else
        the last) and return it (K+1,) on the device; without, only write
        the cache (a chunk whose column would be discarded). On a rank that
        does not hold the slot: nothing, None."""
        if self._local(slot) is None:
            return None
        view = slice_slot_cache(self.cache, self._local(slot))
        x = torch.from_numpy(np.ascontiguousarray(block)).to(
            self.device)[None]
        kvf = torch.full((1,), key_valid_from, dtype=torch.int32,
                         device=self.device)
        if req is None:
            forward_generate(self.params, self.cfg, x, view, input_pos,
                             self.freqs, rope_positions=rope_pos,
                             key_valid_from=kvf, logit_support=self.support)
            return None
        sampling = SamplingConfig(float(req.temperature), float(req.top_p),
                                  self._clamped_top_k(req))
        col = decode_one_token(
            self.params, self.cfg, x, view, input_pos, self.freqs,
            self.fast_freqs, self.bias, sampling, None,
            rope_positions=rope_pos, key_valid_from=kvf,
            sample_at=sample_at, fast_cache=self.fast_cache_1,
            **self._step_kw())
        return col[0]

    def _arange(self, t: int) -> torch.Tensor:
        return torch.arange(t, dtype=torch.int32, device=self.device)

    def _prefix_prefill(self, block: np.ndarray) -> KVCache:
        """Prefill a RIGHT-padded prefix block into a fresh 1-slot cache of
        the block's length. KV rows are position-independent (RoPE
        position = row index), so the cached rows can later be copied into
        any slot; the pad rows are overwritten by the suffix or decode
        writes before any read."""
        cfg, t = self.cfg, block.shape[1]
        pre = KVCache.create(cfg.n_layer, 1, t, self.kv_heads,
                             cfg.head_dim, dtype=self.kv_dtype,
                             pos_major=self.pos_major, device=self.device)
        x = torch.from_numpy(np.ascontiguousarray(block)).to(
            self.device)[None]
        forward_generate(self.params, cfg, x, pre, 0, self.freqs[:t],
                         rope_positions=self._arange(t)[None],
                         key_valid_from=torch.zeros(1, dtype=torch.int32,
                                                    device=self.device),
                         logit_support=self.support)
        return pre

    def _copy_prefix(self, slot: int, pre: KVCache) -> None:
        """Copy a cached 1-slot prefix cache into the head of the slot's
        rows, in place (both at the rank's heads: a position-major flat
        [b, s*Hkv_local + h] copies as one span)."""
        view = slice_slot_cache(self.cache, self._local(slot))
        tpb = pre.seq_len
        if self.pos_major:
            view.k[:, :tpb] = pre.k
            view.v[:, :tpb] = pre.v
            if pre.ks is not None:
                n = pre.ks.shape[2]             # tpb * Hkv_local
                view.ks[:, :, :n] = pre.ks
                view.vs[:, :, :n] = pre.vs
            return
        view.k[:, :, :, :tpb] = pre.k
        view.v[:, :, :, :tpb] = pre.v
        if pre.ks is not None:
            view.ks[:, :, :, :tpb] = pre.ks
            view.vs[:, :, :, :tpb] = pre.vs

    # ------------------------------------------------------------------
    def _clamped_top_k(self, req: SlotRequest) -> int:
        k = max(1, min(req.top_k, self.top_k))
        if k != req.top_k:
            # the candidate set is sized by the roof (self.top_k); a larger
            # request k cannot be honoured, and is said so
            logging.getLogger(__name__).warning(
                "request %s top_k=%d clamped to the scheduler's static "
                "roof %d (set ContinuousBatcher top_k to raise it)",
                req.request_id, req.top_k, self.top_k)
        return k

    def _install_sampling(self, req: SlotRequest, slot: int) -> None:
        """The request's per-slot sampling parameters for decode ticks."""
        k = self._clamped_top_k(req)
        i = self._local(slot)
        if i is None:
            return
        self.temp[i] = float(req.temperature)
        self.top_p[i] = float(req.top_p)
        self.top_k_row[i] = k

    def sweep_cancelled(self) -> None:
        """Free the resources of cancelled requests: in-flight chunked
        prefills are dropped (their reserved slot returns to the pool) and
        active slots are deactivated on the host and the device, so an
        abandoned request stops taking tick capacity within one tick."""
        kept = []
        for inf in self._inflight:
            if inf["req"].cancelled.is_set():
                self.slot_req[inf["slot"]] = None
                self.cancelled_requests += 1
                inf["req"].done.set()
            else:
                kept.append(inf)
        self._inflight = kept
        dead = [s for s in range(self.num_slots)
                if self.active_h[s] and self.slot_req[s] is not None
                and self.slot_req[s].cancelled.is_set()]
        for s in dead:
            self.cancelled_requests += 1
            self._finish_slot(s)

    def fail_all(self, err: Exception) -> None:
        """Hand `err` to every request that holds a slot or an in-flight
        prefill, and free them all (after a failed tick the device state
        of every slot is suspect)."""
        reqs = [inf["req"] for inf in self._inflight]
        reqs += [r for r in self.slot_req if r is not None]
        self._inflight = []
        # the error first: freeing a slot sets its request's `done`, and a
        # waiter woken by it reads `error` at once
        for r in reqs:
            r.error = err
        for s in range(self.num_slots):
            self._finish_slot(s)
        for r in reqs:
            r.done.set()

    def _bucket(self, t: int) -> int:
        return min(max(self.prompt_bucket,
                       -(-t // self.prompt_bucket) * self.prompt_bucket),
                   self.cache_len)

    def _get_prefix_entry(self, req: SlotRequest) -> KVCache:
        """The cached 1-slot cache of req's prefix, prefilled on a miss."""
        tp = req.prefix_len
        prefix_tokens = np.ascontiguousarray(req.prompt[:, :tp])
        th = hashlib.sha256(prefix_tokens.tobytes()).hexdigest()[:16]
        entry = self.prefix_store.get(req.prefix_id)
        if entry is not None and entry[1] == tp and entry[2] == th:
            self.prefix_store.move_to_end(req.prefix_id)
            self.prefix_hits += 1
            return entry[0]
        self.prefix_misses += 1
        block = np.zeros((req.prompt.shape[0], self._bucket(tp)), np.int32)
        block[:, :tp] = prefix_tokens  # RIGHT padding
        pre = self._prefix_prefill(block)
        self.prefix_store[req.prefix_id] = (pre, tp, th)
        while len(self.prefix_store) > self.prefix_store_cap:
            self.prefix_store.popitem(last=False)
        return pre

    def _assign_with_prefix(self, req: SlotRequest, slot: int) -> bool:
        """Prefix-cached assign: copy the cached prefix rows into the slot,
        then prefill the RIGHT-padded suffix block at [tp, tp + SB) and
        sample at its last real column. Pad rows land where decode writes
        next, so they are overwritten before any read (the causal mask
        hides keys after the query). Prefix-cached slots take start = 0.
        Returns False to fall back to another assign."""
        tp = req.prefix_len
        t_total = req.prompt.shape[1]
        t_sfx = t_total - tp
        if req.prefix_id is None or tp <= 0 or t_sfx < 1:
            return False
        if self.prefill_chunk is not None and t_sfx > self.prefill_chunk:
            # a long suffix goes to the prefix-aware chunked path
            return False
        sb = self._bucket(t_sfx)
        if tp + sb > self.cache_len or self._bucket(tp) > self.cache_len:
            return False  # no room for the padded layout; full prefill
        block = np.zeros((req.prompt.shape[0], sb), np.int32)
        block[:, :t_sfx] = req.prompt[:, tp:]  # RIGHT padding
        with span("prefill", request=req.request_id, tokens=t_sfx,
                  chunked=False):
            self._install_sampling(req, slot)
            if self._local(slot) is not None:
                self._copy_prefix(slot, self._get_prefix_entry(req))
            col = self._prefill(slot, block, tp, tp + self._arange(sb)[None],
                                0, req, sample_at=t_sfx - 1)
            self._activate_slot(req, slot, col, tp + t_sfx, 0)
        return True

    def _activate_slot(self, req: SlotRequest, slot: int, col: torch.Tensor,
                       end: int, start: int) -> None:
        """Shared assign tail: install the decode state, emit the first
        column (`col` None on a rank that does not hold the slot: it gets
        the column through the data group)."""
        i = self._local(slot)
        if i is not None:
            self.cur[i] = col
            self.pos[i] = end
            self.start[i] = start
            self.prev_win[i] = 0
            self.prev_win[i, -1] = col[0]
            self.active[i] = True
        else:
            col = torch.zeros_like(self.cur[0])
        self.active_h[slot] = True
        self.slot_req[slot] = req
        self.slot_budget[slot] = min(req.max_new_tokens,
                                     self.cache_len - end) - 1
        first = _host(self._gather_slots(col[None]))[
            slot // self.local_slots]
        if first[0] == self.im_end_id:
            self._finish_slot(slot)
        else:
            req.result.append(first)
            if req.on_token:
                req.on_token(req.request_id, first)

    def _start_chunked(self, req: SlotRequest, slot: int) -> bool:
        """Reserve `slot` and queue the prompt as fixed-size prefill chunks
        (advanced by prefill_tick, between decode ticks). When the request
        carries a cacheable prefix, the cached prefix rows are copied in
        first and only the suffix is chunked."""
        cs = self.prefill_chunk
        t_total = req.prompt.shape[1]
        if cs is None or t_total <= cs:
            return False
        tp = 0
        if (req.prefix_id is not None and 0 < req.prefix_len < t_total
                and self._bucket(req.prefix_len) <= self.cache_len):
            tp = req.prefix_len
        t_sfx = t_total - tp
        if t_sfx <= cs and tp > 0:
            return False  # short suffix: the prefix path takes it
        n_chunks = -(-t_sfx // cs)
        if tp + n_chunks * cs > self.cache_len:
            tp = 0
            t_sfx = t_total
            n_chunks = -(-t_total // cs)
            if n_chunks * cs > self.cache_len:
                return False  # no room for the padded layout; monolithic
        padded = np.zeros((req.prompt.shape[0], n_chunks * cs), np.int32)
        padded[:, :t_sfx] = req.prompt[:, tp:]
        blocks = [padded[:, c * cs:(c + 1) * cs] for c in range(n_chunks)]
        self.slot_req[slot] = req  # reserve: free_slots() skips this slot
        if tp > 0 and self._local(slot) is not None:
            self._copy_prefix(slot, self._get_prefix_entry(req))
        self._inflight.append({"req": req, "slot": slot, "blocks": blocks,
                               "next": 0, "t_total": t_total, "tp": tp})
        self.chunked_prefills += 1
        return True

    def prefill_pending(self) -> bool:
        return bool(self._inflight)

    def prefill_tick(self) -> None:
        """Run ONE prefill chunk of the oldest in-flight chunked assign,
        at positions [tp + c*cs, tp + (c+1)*cs); its queries attend to the
        slot's rows already written. The final chunk is right-padded,
        samples at the last real column and activates the slot."""
        if self.local_sweep:
            self.sweep_cancelled()
        if not self._inflight:
            return
        inf = self._inflight[0]
        cs = self.prefill_chunk
        req, slot, c, tp = inf["req"], inf["slot"], inf["next"], inf["tp"]
        final = c == len(inf["blocks"]) - 1
        t0 = tp + c * cs
        with span("prefill", request=req.request_id,
                  tokens=min(cs, inf["t_total"] - t0), chunked=True):
            if final:
                self._install_sampling(req, slot)
            col = self._prefill(slot, inf["blocks"][c], t0,
                                t0 + self._arange(cs)[None], 0,
                                req if final else None,
                                sample_at=inf["t_total"] - t0 - 1)
            inf["next"] = c + 1
            if final:
                self._inflight.pop(0)
                self._activate_slot(req, slot, col, inf["t_total"], 0)

    # ------------------------------------------------------------------
    def _assign(self, req: SlotRequest, slot: int):
        if req.submitted_ns is not None:
            span_since("queue", req.submitted_ns, request=req.request_id)
        if self._assign_with_prefix(req, slot):
            return
        if self._start_chunked(req, slot):
            return
        t_real = req.prompt.shape[1]
        bucket = self._bucket(t_real)
        if t_real > bucket:
            raise ValueError(f"prompt too long: {t_real} > {bucket}")
        padded = np.zeros((req.prompt.shape[0], bucket), np.int32)
        padded[:, bucket - t_real:] = req.prompt   # LEFT padding
        start = bucket - t_real
        with span("prefill", request=req.request_id, tokens=t_real,
                  chunked=False):
            self._install_sampling(req, slot)
            rope = (self._arange(bucket)[None] - start).clamp_min(0)
            col = self._prefill(slot, padded, 0, rope, start, req)
            self._activate_slot(req, slot, col, bucket, start)

    def _finish_slot(self, slot: int) -> None:
        req = self.slot_req[slot]
        if self._local(slot) is not None:
            self.active[self._local(slot)] = False
        self.active_h[slot] = False
        self.slot_req[slot] = None
        if req is not None:
            req.done.set()

    def _emit(self, slot: int, tok: np.ndarray) -> bool:
        """Hand one fetched column to the slot's request; True if the slot
        finished (im_end, or its budget spent)."""
        if tok[0] == self.im_end_id:
            self._finish_slot(slot)
            return True
        req = self.slot_req[slot]
        req.result.append(tok)
        if req.on_token:
            req.on_token(req.request_id, tok)
        self.slot_budget[slot] -= 1
        if self.slot_budget[slot] <= 0:
            self._finish_slot(slot)
            return True
        return False

    def step(self) -> None:
        """One decode tick for all active slots, then the host's
        bookkeeping on one fetch of the tick's column. Its `tick` span
        counts the rows it decoded."""
        with span("tick", n=1) as sp:
            if self.local_sweep:
                self.sweep_cancelled()
            if self._inflight:
                self.ticks_while_prefilling += 1
            col, _ = self._tick()
            with span("tick.fetch"):
                col_h = _host(self._gather_slots(col))      # one fetch
            slots = np.flatnonzero(self.active_h).tolist()
            sp.set(rows=len(slots))
            for slot in slots:
                self._emit(slot, col_h[slot])

    def step_chunk(self, n: int) -> None:
        """n decode ticks and one fetch. The same launches and uniforms, in
        the same order, as n step() calls: a slot that emits im_end goes
        inactive on the device within the chunk, as step() would make it.
        A slot whose budget runs out inside the chunk decodes on to the
        chunk's end and the host drops those columns (at most n - 1 wasted
        steps a request); past the cache's end those steps write its row
        cache_len - 1 (`_tick`)."""
        if n <= 1:
            return self.step()
        with span("tick", n=n) as sp:
            if self.local_sweep:
                self.sweep_cancelled()
            active_before = self.active_h.copy()
            cols = []
            for _ in range(n):
                col, finished = self._tick()
                self.active &= ~finished
                cols.append(col)
            self.chunked_ticks += n
            with span("tick.fetch"):
                out_h = _host(self._gather_slots(torch.stack(cols),
                                                 dim=1))       # n, B, K+1
            if sp.recording:
                # a row decodes on the device up to its im_end column
                ended = out_h[:, active_before, 0] == self.im_end_id
                sp.set(rows=int(np.where(ended.any(0), ended.argmax(0) + 1,
                                         n).sum()))
            for slot in np.flatnonzero(active_before).tolist():
                for j in range(n):
                    if self._emit(slot, out_h[j, slot]):
                        break

    def free_slots(self) -> list[int]:
        return [i for i in range(self.num_slots) if not self.active_h[i]
                and self.slot_req[i] is None]

    def has_active(self) -> bool:
        return bool(self.active_h.any())

    # ------------------------------------------------------------------
    def run(self, requests: list[SlotRequest],
            chunk_steps: int = 1) -> dict[int, np.ndarray]:
        """Schedule all requests to the end; codes (K+1, T) per id."""
        pending = list(requests)
        while pending or self.has_active() or self.prefill_pending():
            for slot in self.free_slots():
                if not pending:
                    break
                self._assign(pending.pop(0), slot)
            if self.prefill_pending():
                # one chunk, then one decode tick: active slots wait at
                # most one chunk a tick
                self.prefill_tick()
            if self.has_active():
                if self.prefill_pending():
                    self.step()
                else:
                    self.step_chunk(chunk_steps)
        return {req.request_id: stack_columns(req.result,
                                              self.cfg.num_codebooks + 1)
                for req in requests}


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t`. Never a view: on the CPU, `.numpy()` would share
    memory with slot state that later ticks and assigns overwrite."""
    return np.array(t.cpu())


def stack_columns(result: list, rows: int) -> np.ndarray:
    """A request's emitted columns as one (K+1, T) array."""
    if not result:
        return np.zeros((rows, 0), np.int32)
    return np.stack(result, axis=1)


class SchedulerThread:
    """The model-owner thread: a ContinuousBatcher behind a queue. Only
    this thread launches work on the batcher's state. An exception in a
    tick or a prefill fails the requests it touched (`SlotRequest.error`)
    and the thread goes on serving."""

    def __init__(self, batcher: ContinuousBatcher, poll_s: float = 0.002,
                 chunk_steps: int = 1):
        self.batcher = batcher
        self.queue: "queue.Queue[SlotRequest]" = queue.Queue()
        self.poll_s = poll_s
        self.chunk_steps = max(1, chunk_steps)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, req: SlotRequest) -> SlotRequest:
        req.submitted_ns = time.time_ns()
        self.queue.put(req)
        return req

    def _run(self):
        dev = self.batcher.device
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        while not self._stop.is_set():
            try:
                moved = self._once()
            except Exception as e:  # noqa: BLE001 - handed to the requests
                logging.getLogger(__name__).exception(
                    "scheduler tick failed; failing its requests")
                self.batcher.fail_all(e)
                moved = True
            if not moved:
                time.sleep(self.poll_s)

    def _once(self) -> bool:
        b = self.batcher
        moved = False
        for slot in b.free_slots():
            req = None
            while req is None:
                try:
                    req = self.queue.get_nowait()
                except queue.Empty:
                    break
                if req.cancelled.is_set():
                    # cancelled before it reached the device
                    b.cancelled_requests += 1
                    req.done.set()
                    req = None
            if req is None:
                break
            try:
                b._assign(req, slot)
                moved = True
            except Exception as e:  # noqa: BLE001 - handed to the request
                if b.slot_req[slot] is req:
                    b._finish_slot(slot)
                b._inflight = [i for i in b._inflight if i["req"] is not req]
                req.error = e
                req.done.set()
        if b.prefill_pending():
            # one chunk of the in-flight long prompt, then one decode tick
            b.prefill_tick()
            moved = True
        if b.has_active():
            # chunked ticks only while the queue is drained: a waiting
            # prefill should not wait chunk_steps ticks for its turn
            if (self.chunk_steps > 1 and self.queue.empty()
                    and not b.prefill_pending()):
                b.step_chunk(self.chunk_steps)
            else:
                b.step()
            moved = True
        return moved

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=30)
