"""Multi-process serving: lockstep replicas driven by the leader's plans.

Counterpart of `fish_speech_tpu/serve/multihost.py`. Every process holds
the same model and the same batcher (no mesh: each is a whole replica);
what must be shared is the host-side plan, so that every process runs
the same launches in the same order:

  1. the leader (rank 0) drains its intake queue and builds a `TickPlan`:
     which requests land in which slots, which slots were cancelled, and
     how many decode ticks to run before the next plan;
  2. the plan goes to every process as pickle bytes in a uint8 CPU tensor
     through `dist.broadcast` (size first, then the payload) on a gloo
     process group;
  3. every process applies it (`apply_plan`): the same assigns, sweeps and
     ticks. The leader serves HTTP and owns the responses; a follower
     (`run_follower_loop`) mirrors the plans until a shutdown plan.

`init_multihost` joins the world: gloo, the coordinator's TCP address and
an explicit timeout, so that a lost process fails its peers within a
minute instead of hanging them.
"""

from __future__ import annotations

import logging
import pickle
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..parallel.mesh import TIMEOUT


@dataclass
class SlotAssignment:
    slot: int
    request_id: int
    prompt: np.ndarray          # (K+1, T), as the leader's request holds it
    max_new_tokens: int
    temperature: float
    top_p: float
    # the whole request surface, so that every process takes the same
    # assign path (per-slot top-k; prefix-cached or full prefill)
    top_k: int = 30
    prefix_id: str | None = None
    prefix_len: int = 0


@dataclass
class TickPlan:
    assignments: list[SlotAssignment] = field(default_factory=list)
    n_ticks: int = 1            # decode ticks to run before the next plan
    # slots whose requests the leader saw cancelled: in the plan, so that
    # every process frees the same slots at the same tick
    cancels: list[int] = field(default_factory=list)
    shutdown: bool = False      # the leader is stopping: followers return

    def to_bytes(self) -> bytes:
        return pickle.dumps(self)

    @staticmethod
    def from_bytes(data: bytes) -> "TickPlan":
        return pickle.loads(data)


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Join the serving world: gloo over TCP at `coordinator` (host:port),
    with an explicit timeout."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def broadcast_plan(plan: TickPlan | None) -> TickPlan:
    """The leader's plan on every process (a follower passes None); with
    one process, the plan itself. The default process group must be
    gloo: the plan is a CPU tensor."""
    rank, world = _world()
    if world == 1:
        return plan if plan is not None else TickPlan()
    import torch.distributed as dist

    payload = plan.to_bytes() if rank == 0 else b""
    # two phases: the size, so that followers allocate exactly, then the
    # payload (no cap on plans with many or long prompts)
    size = torch.tensor([len(payload)], dtype=torch.int64)
    dist.broadcast(size, src=0)
    buf = torch.zeros(int(size), dtype=torch.uint8)
    if rank == 0:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    dist.broadcast(buf, src=0)
    return TickPlan.from_bytes(buf.numpy().tobytes())


def apply_plan(batcher, plan: TickPlan,
               request_registry: dict | None = None) -> None:
    """Apply a plan, the same way on every process.

    request_registry: request_id -> SlotRequest (the leader's, so that the
    emitted columns reach the right response); a process without one runs
    the same launches with throwaway requests."""
    from ..engine.scheduler import SlotRequest

    for a in plan.assignments:
        req = None
        if request_registry is not None:
            req = request_registry.get(a.request_id)
        if req is None:
            req = SlotRequest(request_id=a.request_id, prompt=a.prompt,
                              max_new_tokens=a.max_new_tokens,
                              temperature=a.temperature, top_p=a.top_p,
                              top_k=a.top_k, prefix_id=a.prefix_id,
                              prefix_len=a.prefix_len)
            if request_registry is not None:
                request_registry[a.request_id] = req
        try:
            batcher._assign(req, a.slot)
        except Exception as e:  # noqa: BLE001 - handed to the request
            # a bad request (say, a prompt over the largest bucket) fails
            # the same way on every process, which all skip it alike
            if batcher.slot_req[a.slot] is req:
                batcher._finish_slot(a.slot)
            req.error = e
            req.done.set()
    # the leader's cancellations: every process marks the same slots'
    # requests cancelled, and the sweep frees them
    for slot in plan.cancels:
        req = batcher.slot_req[slot]
        if req is not None:
            req.cancelled.set()
    if plan.cancels:
        batcher.sweep_cancelled()
    if plan.n_ticks > 0 and batcher.has_active():
        batcher.step_chunk(plan.n_ticks)


def _apply_or_fail(batcher, plan: TickPlan, registry: dict) -> None:
    """apply_plan; a failed tick fails the requests it touched, the same
    way on every process, and the loop goes on."""
    try:
        apply_plan(batcher, plan, registry)
    except Exception as e:  # noqa: BLE001 - handed to the requests
        logging.getLogger(__name__).exception(
            "multihost tick failed; failing its requests")
        batcher.fail_all(e)


def _report_done(registry: dict, on_done: Callable | None) -> None:
    """Drop finished requests from the registry, handing each to
    on_done first."""
    for rid in [r for r, q in registry.items() if q.done.is_set()]:
        req = registry.pop(rid)
        if on_done is not None:
            on_done(req)


def run_follower_loop(batcher, stop: threading.Event | None = None,
                      on_done: Callable | None = None) -> None:
    """A follower: receive plans and mirror the leader until a shutdown
    plan (or `stop`). on_done(request) is called with each request once
    it finishes."""
    batcher.local_sweep = False   # cancellations come through the plan
    batcher.graph_tick = False    # replicas tick eagerly
    registry: dict = {}
    while stop is None or not stop.is_set():
        plan = broadcast_plan(None)
        _apply_or_fail(batcher, plan, registry)
        _report_done(registry, on_done)
        if plan.shutdown:
            return


class MultihostSchedulerThread:
    """The leader's model-owner thread: `SchedulerThread`'s counterpart,
    whose every device action goes through a broadcast `TickPlan`, so that
    followers (in `run_follower_loop`) run the same launches in lockstep.

    Heartbeats: followers wait inside the broadcast between plans, so an
    idle leader keeps broadcasting empty plans every `heartbeat_s`, which
    bounds both the followers' wait (well inside the group's timeout) and
    a new request's latency. on_done(request) is called with each request
    once it finishes."""

    def __init__(self, batcher, poll_s: float = 0.002, chunk_steps: int = 8,
                 heartbeat_s: float = 0.2,
                 on_done: Callable | None = None):
        if batcher.prefill_chunk is not None:
            raise ValueError("multihost serving does not carry chunked "
                             "prefill state in its plans")
        self.batcher = batcher
        batcher.local_sweep = False   # cancellations go through the plan
        batcher.graph_tick = False    # replicas tick eagerly
        self.queue: "queue.Queue" = queue.Queue()
        self.registry: dict = {}
        self.poll_s = poll_s
        self.chunk_steps = max(1, chunk_steps)
        self.heartbeat_s = heartbeat_s
        self.on_done = on_done
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, req):
        req.submitted_ns = time.time_ns()
        self.queue.put(req)
        return req

    def _build_plan(self) -> TickPlan:
        b = self.batcher
        assignments = []
        for slot in b.free_slots():
            req = None
            while req is None:
                try:
                    req = self.queue.get_nowait()
                except queue.Empty:
                    break
                if req.cancelled.is_set():
                    b.cancelled_requests += 1
                    req.done.set()
                    req = None
            if req is None:
                break
            self.registry[req.request_id] = req
            assignments.append(SlotAssignment(
                slot=slot, request_id=req.request_id, prompt=req.prompt,
                max_new_tokens=req.max_new_tokens,
                temperature=req.temperature, top_p=req.top_p,
                top_k=req.top_k, prefix_id=req.prefix_id,
                prefix_len=req.prefix_len))
        cancels = [s for s in range(b.num_slots)
                   if b.slot_req[s] is not None
                   and b.slot_req[s].cancelled.is_set()]
        active = b.has_active() or bool(assignments)
        return TickPlan(assignments=assignments,
                        n_ticks=self.chunk_steps if active else 0,
                        cancels=cancels)

    def _loop(self):
        dev = self.batcher.device
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        last = 0.0
        while not self._stop.is_set():
            plan = self._build_plan()
            busy = plan.assignments or plan.cancels or plan.n_ticks
            now = time.monotonic()
            if busy or now - last >= self.heartbeat_s:
                broadcast_plan(plan)
                _apply_or_fail(self.batcher, plan, self.registry)
                last = now
                _report_done(self.registry, self.on_done)
            if not busy:
                time.sleep(self.poll_s)

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=10)
        if self.thread.is_alive():
            # the loop is still inside a broadcast (a follower died in a
            # collective): the size-then-payload channel is not
            # thread-safe, so a shutdown plan from here could pair one
            # plan's size with another's payload. Leave it.
            return
        try:
            broadcast_plan(TickPlan(n_ticks=0, shutdown=True))
        except RuntimeError as e:      # a follower already gone
            logging.getLogger(__name__).warning(
                "multihost shutdown plan not delivered: %s", e)
