"""Kinds of request, one module per op, found by the ``op`` names of a
traffic mix.

An op module has:

* ``KIND``: the kind of answer, the name of a file under ``kinds/``
  (``page_rank``, ``wcc``, ``sssp``), which picks the comparison, the
  reference's precision and the control's, and the limits;
* ``GRAPH``: a builder of :mod:`benchmark.ops.graphs`, run once in set-up;
* ``SOURCE``: whether a request starts from a source node;
* ``call(cell, req, mark) -> Answer``: the request through the port's
  public entries, ending in a host numpy array; ``mark("call")`` is
  called when the entry has returned, before the copy to the host;
* ``nodes(cell)``: the node count of the request's input graph;
* ``ref_key(req)`` and ``reference(cell, req, dtype)``: the plain
  reference's answer to the request, computed in ``dtype``, and a key
  under which requests share it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Answer:
    """What a request gave the caller, and what the program said of it."""

    value: np.ndarray
    #: the result's own ``micros`` and iteration (or round) count
    micros: Optional[int] = None
    iterations: Optional[int] = None
    #: host seconds of the op's own phases (``build_s``, ``first_run_s``)
    extra: dict = dataclasses.field(default_factory=dict)
