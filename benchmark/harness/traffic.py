"""The one traffic generator: a mix's parameters and a seed -> requests.

The work is the same for every seed: the text lengths are the mix's
distribution at fixed quantiles (a pool of `pool` requests), a fixed
share of them greedy, dealt to the clients in one fixed shuffled order,
and each client's first request cut to a fixed share of its frames (so
completions are spread from the start). The seed draws the texts' letters
(and, elsewhere, the weights): two seeds differ by wording, not by the
sizes or the order in which they arrive.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass

import numpy as np

LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ,.", np.uint8)


@dataclass
class Request:
    index: int          # position in the client's sequence
    client: int
    text: str
    max_new_tokens: int
    greedy: bool
    top_p: float
    top_k: int
    temperature: float


def lengths(mix: dict) -> list[int]:
    """The pool's text lengths in bytes: the distribution's quantiles."""
    dist = mix["text_bytes"]
    n = mix["pool"]
    nd = statistics.NormalDist(math.log(dist["median"]), dist["sigma"])
    return [int(min(dist["max"], max(dist["min"],
                                     round(math.exp(nd.inv_cdf((i + 0.5) / n))))))
            for i in range(n)]


def _text(rng: np.random.Generator, n: int) -> str:
    body = LETTERS[rng.integers(0, len(LETTERS), n)].tobytes().decode()
    return ("a" + body[1:-1] + ".")[:n] if n >= 2 else "a"


def clients(mix: dict, seed: int) -> list[list[Request]]:
    """Each client's requests, in the order it sends them."""
    fixed = np.random.default_rng(0)
    rng = np.random.default_rng(seed)
    n_clients = mix["clients"]
    pool = lengths(mix)
    every = mix["greedy_every"]
    greedy = [i % every == 0 for i in range(len(pool))]
    order = fixed.permutation(len(pool))
    # the first request served is greedy, so every run has one to check
    first_greedy = next(j for j, i in enumerate(order) if greedy[i])
    order[[0, first_greedy]] = order[[first_greedy, 0]]
    cut = fixed.permutation(n_clients)
    # ... and the shortest first request, so it finishes in every run
    cut[[0, int(np.argmin(cut))]] = cut[[int(np.argmin(cut)), 0]]
    s = mix["sampling"]
    out: list[list[Request]] = [[] for _ in range(n_clients)]
    for j, i in enumerate(order):
        c = j % n_clients
        frames = math.ceil(mix["frames_per_byte"] * pool[i])
        if j < n_clients:       # the first request: a fixed share of it
            frames = max(mix["min_frames"],
                         round(frames * (cut[c] + 0.5) / n_clients))
        out[c].append(Request(
            index=len(out[c]), client=c, text=_text(rng, pool[i]),
            max_new_tokens=frames, greedy=greedy[i], top_p=s["top_p"],
            top_k=1 if greedy[i] else s["top_k"],
            temperature=s["temperature"]))
    return out
