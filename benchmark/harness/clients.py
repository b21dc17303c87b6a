"""Closed-loop clients of the engine and the record of what they got.

Each client is a thread that sends its requests one after another, the
next when the last has returned (`tts`) or finished streaming
(`stream_tts`). Every request's times come from the host's monotonic
clock: when it was sent, when each audio chunk (or the whole waveform)
came back, and when it ended. The engine's scheduler is the program's;
the only thing added to it is a spy on `submit` that keeps each request's
scheduler record (its prompt columns and its emitted frames), which the
correctness check reads and which lets the run cancel what is still in
flight when the window closes.
"""

from __future__ import annotations

import itertools
import threading
import time

from .traffic import Request

clock = time.perf_counter


class Spy:
    """Wraps the scheduler's `submit`: the scheduler request that each
    client thread sent last, and every one sent."""

    def __init__(self, scheduler):
        self.local = threading.local()
        self.sent: list = []
        self.lock = threading.Lock()
        orig = scheduler.submit

        def submit(req):
            self.local.req = req
            with self.lock:
                self.sent.append(req)
            return orig(req)

        scheduler.submit = submit

    def last(self):
        return getattr(self.local, "req", None)

    def cancel_open(self) -> int:
        with self.lock:
            open_ = [r for r in self.sent if not r.done.is_set()]
        for r in open_:
            r.cancel()
        return len(open_)


class Clients:
    """The cell's clients on one engine. `records` holds one dict per
    request sent: client, greedy, text, sent, end, chunks [(t, samples)],
    error, and for the check the scheduler request and, of a greedy
    request, the waveform."""

    def __init__(self, engine, per_client: list[list[Request]], entry: str,
                 chunk: dict | None, make_request):
        self.engine = engine
        self.entry = entry
        self.chunk = chunk or {}
        self.make_request = make_request
        self.spy = Spy(engine.scheduler)
        self.stop = threading.Event()
        self.records: list[dict] = []
        self.lock = threading.Lock()
        self.threads = [threading.Thread(target=self._run, args=(reqs,),
                                         daemon=True)
                        for reqs in per_client]

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def _run(self, reqs: list[Request]) -> None:
        for req in itertools.cycle(reqs):
            if self.stop.is_set():
                return
            rec = {"client": req.client, "index": req.index,
                   "greedy": req.greedy, "text": req.text,
                   "max_new_tokens": req.max_new_tokens, "sent": clock(),
                   "chunks": [], "end": None, "error": None}
            with self.lock:
                self.records.append(rec)
            self.spy.local.req = None
            try:
                if self.entry == "tts":
                    self._tts(req, rec)
                else:
                    self._stream(req, rec)
            except Exception as e:  # noqa: BLE001 - recorded as a failure
                rec["error"] = repr(e)
            rec["end"] = clock()
            rec["slot"] = self.spy.last()

    def _tts(self, req: Request, rec: dict) -> None:
        wav = self.engine.tts(self.make_request(req))
        rec["chunks"].append((clock(), len(wav)))
        if rec["greedy"]:
            rec["wave"] = wav

    def _stream(self, req: Request, rec: dict) -> None:
        gen = self.engine.stream_tts(
            self.make_request(req), chunk_frames=self.chunk["frames"],
            first_chunk_frames=self.chunk["first"])
        parts = []
        try:
            for wav in gen:
                rec["chunks"].append((clock(), len(wav)))
                if rec["greedy"]:
                    parts.append(wav)
                if self.stop.is_set():
                    rec["cut"] = True
                    break
        finally:
            gen.close()
        if parts:
            rec["wave"] = parts

    def admitted(self) -> bool:
        """Every client's first request has its first frame."""
        with self.spy.lock:
            sent = list(self.spy.sent)
        return (len(sent) >= len(self.threads)
                and all(r.result or r.done.is_set()
                        for r in sent[:len(self.threads)]))

    def close(self, timeout: float = 120.0) -> None:
        """Stop sending, cancel what is in flight, wait for every client."""
        self.stop.set()
        deadline = clock() + timeout
        for t in self.threads:
            while t.is_alive() and clock() < deadline:
                self.spy.cancel_open()
                t.join(timeout=0.2)
        if any(t.is_alive() for t in self.threads):
            raise RuntimeError("a client did not stop")
