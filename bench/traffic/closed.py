"""Closed loop of ``clients`` callers: each sends its next request the
moment its previous one is answered.

Client c's first request is due at ``c * stagger_s / clients``, so the
clients start spread over about one request's life and the window sees
no wave of synchronised starts and finishes. Client c's k-th request is
request ``c + k * clients`` of the seed's set (its lengths stratified
over the whole set).
"""
from __future__ import annotations

import math
from typing import List, Tuple

from bench.traffic.prompts import Requests


class Closed:
    def __init__(self, workload: dict, vocab: int, seed: int,
                 horizon_s: float):
        arr = workload["arrivals"]
        self.clients = int(arr["clients"])
        self.stagger = float(arr["stagger_s"])
        # a request lives longer than a second (hundreds of decode
        # steps): this bounds what a client can send within the horizon
        per_client = max(8, int(math.ceil(horizon_s)))
        self.requests = Requests(workload["prompts"], vocab, seed,
                                 self.clients * per_client)

    def first(self) -> List[Tuple[float, int]]:
        return [(c * self.stagger / self.clients, c)
                for c in range(self.clients)]

    def answered(self, index: int, t: float) -> List[Tuple[float, int]]:
        nxt = index + self.clients
        if nxt >= len(self.requests):
            raise RuntimeError(
                f"closed loop: client {index % self.clients} ran out of "
                f"requests after {index // self.clients + 1}")
        return [(t, nxt)]


def make(workload: dict, vocab: int, seed: int, horizon_s: float):
    return Closed(workload, vocab, seed, horizon_s)
