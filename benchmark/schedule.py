"""The one traffic generator: a closed loop of requests read from a
traffic mix's parameters.

A mix (``traffic/<name>.json``) gives a ``rotation`` of ops, each with a
``weight`` and its ``params``.  Every cycle holds each op ``weight``
times, in an order drawn from the seed, so every seed asks for the same
work in another order.  Ops that start from a source take the next of
the cell's ``sources`` (drawn by the configuration's generator), which
are dealt out in a new seeded order each pass.  ``sample`` answers of
each kind are kept for the check, drawn from the seed among those the
window completed, with the longest request of each kind among them.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    op_name: str
    op: object
    params: dict
    source: Optional[int] = None


def requests(traffic: dict, ops: dict, sources: list,
             rng: random.Random) -> Iterator[Request]:
    """The endless stream of a mix's requests."""
    slots = [entry for entry in traffic["rotation"]
             for _ in range(int(entry.get("weight", 1)))]
    deck: list = []
    index = 0
    while True:
        order = list(slots)
        rng.shuffle(order)
        for entry in order:
            op = ops[entry["op"]]
            source = None
            if op.SOURCE:
                if not deck:
                    deck = list(sources)
                    rng.shuffle(deck)
                source = deck.pop()
            yield Request(index, entry["op"], op, dict(entry.get("params", {})),
                          source)
            index += 1


class Sample:
    """A seeded reservoir of ``size`` answers per kind, beside the
    answer of the longest request of each kind.

    Answers are copied into buffers that :meth:`reserve` allocates and
    writes once, in set-up: no array the program returned outlives its
    request, so keeping the sample changes nothing in how the program's
    host memory is reused from one request to the next."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng = size, rng
        self.seen: dict = {}
        self.longest_s: dict = {}
        #: per kind, ``size`` reservoir slots and then the longest's slot
        self.slots: dict = {}
        self.reqs: dict = {}

    def reserve(self, kind: str, like: np.ndarray) -> None:
        if kind not in self.slots:
            self.slots[kind] = [np.full_like(like, 0)
                                for _ in range(self.size + 1)]
            self.reqs[kind] = [None] * (self.size + 1)

    def _keep(self, kind: str, slot: int, req, value) -> None:
        np.copyto(self.slots[kind][slot], value)
        self.reqs[kind][slot] = req

    def offer(self, kind: str, latency_s: float, req, value) -> None:
        seen = self.seen[kind] = self.seen.get(kind, 0) + 1
        if seen <= self.size:
            self._keep(kind, seen - 1, req, value)
        else:
            j = self.rng.randrange(seen)
            if j < self.size:
                self._keep(kind, j, req, value)
        if latency_s > self.longest_s.get(kind, -1.0):
            self.longest_s[kind] = latency_s
            self._keep(kind, self.size, req, value)

    def items(self) -> list:
        """``(request, answer)`` of every kept answer."""
        return [(req, value) for kind in self.slots
                for req, value in zip(self.reqs[kind], self.slots[kind])
                if req is not None]
