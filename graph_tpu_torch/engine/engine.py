"""EdgeEngine — apply a compiled EdgePlan on its device.

Counterpart of ``graph_tpu.engine.engine``.  ``engine.apply`` computes
the semiring edge-map-reduce ``y[d] = reduce over edges (s -> d) of
combine(x[s], w)`` through the K1 and K2 kernels
(:mod:`graph_tpu_torch.engine.kernels`), in the same number formats as the
JAX engine, so the two agree bit for bit:

* ``reduce="sum"``: int32 fixed point, ``round(v * 2**30)`` per slot,
  wraparound sums, ``acc / 2**30``;
* ``reduce="min"``: the f32 values' int32 bit patterns, integer min
  (IEEE order for the nonnegative values the contract allows), empty
  rows 3e38;
* ``smin_int``: int32 min, empty rows 2**31-1.

On a GPU a node permutation is an index gather, so the JAX engine's
sort-based and gather-plan permutes become ``x[iperm]`` and ``y[perm]``.

Per plan, the engine fixes what shapes the kernels' work: K2's tile cuts,
computed once, and K1's shared-memory window, ``K1_WINDOW`` sources for a
degree-relabeled plan (its hottest sources have the lowest ids) and 0
for a plan on node ids (rectangular plans among them).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from graph_tpu_torch import profile
from graph_tpu_torch.engine.kernels import (
    FIXED_BITS, K1_WINDOW, k1_gather, k1_gather_weighted, k2_reduce,
    k2_reduce_min, k2_tile_cuts)
from graph_tpu_torch.engine.plan import EdgePlan, load_or_build_plan


class EdgeEngine:
    """A compiled edge-traversal plan, resident on one device.

    If the plan was built with ``relabel="degree"``, the kernels run in
    an internal node order; the public ops permute in and out per call,
    and iterative drivers pass ``internal=True`` with vectors already in
    that order (see :meth:`to_internal`) to pay the permutes once per run.

    >>> import numpy as np, torch
    >>> from graph_tpu_torch.engine.engine import EdgeEngine
    >>> eng = EdgeEngine.build(np.array([0, 1, 2]), np.array([2, 2, 0]), 3,
    ...                        device="cpu")
    >>> x = torch.tensor([0.25, 0.5, 0.125])
    >>> eng.spmv(x).tolist()  # y[d] = sum of x[s] over s->d
    [0.125, 0.0, 0.75]
    """

    def __init__(self, plan: EdgePlan):
        self.plan = plan
        self.device = plan.device
        self.perm = self.iperm = None
        self.window = 0
        if plan.perm is not None:
            self.perm = plan.perm.long()
            self.iperm = torch.empty_like(self.perm)
            self.iperm[self.perm] = torch.arange(plan.n, device=self.device)
            self.window = K1_WINDOW
        self.k2_cuts = k2_tile_cuts(plan.indptr, plan.m)
        #: device loops captured over this engine
        #: (:func:`graph_tpu_torch.engine.loop.device_while`), by driver
        self.loops = {}

    @classmethod
    def build(cls, src, dst, n, *, values=None, relabel=None, cache_dir=None,
              device=None) -> "EdgeEngine":
        """Build (or load from the plan cache — ``cache_dir`` or
        $GRAPH_TPU_TORCH_PLAN_CACHE) the engine for an edge list, with
        optional edge ``values``: an ``engine.build`` span whose counter
        ``plan_cache`` is ``hit``, ``miss`` or ``off``."""
        with profile.span("engine.build"):
            return cls(load_or_build_plan(src, dst, n, cache_dir=cache_dir,
                                          relabel=relabel, device=device,
                                          values=values))

    def to_internal(self, x: torch.Tensor) -> torch.Tensor:
        """x in API node order -> the plan's internal order."""
        return x if self.iperm is None else x[self.iperm]

    def to_public(self, y: torch.Tensor) -> torch.Tensor:
        """y in the plan's internal order -> API node order."""
        return y if self.perm is None else y[self.perm]

    def _check_x(self, x: torch.Tensor, dtype: torch.dtype) -> None:
        nx = self.plan.nx  # n_src on a rectangular plan
        if x.shape != (nx,) or x.dtype != dtype:
            raise ValueError(f"x must be ({nx},) {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")

    def spmv(self, x: torch.Tensor, bound: float = 1.0,
             internal: bool = False) -> torch.Tensor:
        """y[d] = sum_{(s,d) in E} x[s]; x: (n,) f32 -> y: (n,) f32.

        Contributions are accumulated in int32 fixed point, so each
        per-destination sum must stay below 2**(31-FIXED_BITS) = 2 in
        magnitude or it wraps mod 2**32.  ``bound`` is the caller's
        promise of the largest per-destination |sum|: inputs are scaled
        by 1/bound and the result rescaled, trading one bit of precision
        per doubling.  ``internal=True`` skips the relabel permutes.
        """
        return self.apply(x, bound=bound, internal=internal)

    def apply(self, x: torch.Tensor, *, combine: str = "none",
              reduce: str = "sum", bound: float = 1.0,
              internal: bool = False) -> torch.Tensor:
        """Semiring edge-map-reduce ``y[d] = reduce_{s->d} combine(x[s], w)``.

        combine: "none" (x[s]), "mul" (x[s] * w), "add" (x[s] + w, the
        tropical combine); reduce: "sum" or "min".  Named instances:
        (none, sum) = :meth:`spmv`, (add, min) = :meth:`relax`, (none,
        min) = :meth:`smin`.  x: (n,) f32 -> y: (n,) f32.

        reduce="sum" accumulates in int32 fixed point; see :meth:`spmv`
        for the ``bound`` contract, which only linear reductions take.
        reduce="min" requires values exact in f32 and nonnegative (IEEE
        order == integer order); empty rows get 3e38.  ``internal=True``
        skips the relabel permutes.
        """
        if combine not in ("none", "add", "mul"):
            raise ValueError(f"combine must be none|add|mul, got {combine!r}")
        if reduce not in ("sum", "min"):
            raise ValueError(f"reduce must be sum|min, got {reduce!r}")
        if combine != "none" and self.plan.slot_w is None:
            raise ValueError(
                f"combine={combine!r} needs a plan built with edge values")
        if bound != 1.0:
            if reduce != "sum" or combine == "add":
                raise ValueError(
                    "bound rescaling is only valid for linear reductions "
                    "(reduce='sum' with combine 'none'/'mul')")
            return self.apply(x * float(np.float32(1.0 / bound)),
                              combine=combine, reduce=reduce,
                              internal=internal) * bound
        self._check_x(x, torch.float32)
        if not internal:
            x = self.to_internal(x)
        p, h = self.plan, self.window
        if reduce == "sum":
            if combine == "none":
                # round(x * 2**30) commutes with the gather: quantize at n
                xq = torch.round(x * float(1 << FIXED_BITS)).to(torch.int32)
                contrib = k1_gather(xq, p.slot_src, h)
            else:  # quantized per slot, after the f32 combine
                contrib = k1_gather_weighted(x, p.slot_src, p.slot_w,
                                             combine, quantize=True, window=h)
            y = k2_reduce(contrib, p.indptr, self.k2_cuts).to(
                torch.float32) / float(1 << FIXED_BITS)
        else:
            if combine == "none":  # a 4-byte gather of the f32 bits
                contrib = k1_gather(x.view(torch.int32), p.slot_src, h)
            else:
                contrib = k1_gather_weighted(
                    x, p.slot_src, p.slot_w, combine, quantize=False,
                    window=h).view(torch.int32)
            y = k2_reduce_min(contrib, p.indptr, "min",
                              self.k2_cuts).view(torch.float32)
        return y if internal else self.to_public(y)

    def sum_quanta(self, xq: torch.Tensor) -> torch.Tensor:
        """acc[d] = sum over edges (s -> d) of xq[s], int32 with
        wraparound: K1 and K2 over int32 quanta already in the plan's
        internal order, the spmv's sum path without its quantize and
        rescale (PageRank's Jacobi body runs those in its own kernels)."""
        self._check_x(xq, torch.int32)
        p = self.plan
        return k2_reduce(k1_gather(xq, p.slot_src, self.window), p.indptr,
                         self.k2_cuts)

    def relax(self, dist: torch.Tensor,
              internal: bool = False) -> torch.Tensor:
        """y[d] = min over weighted edges (s -> d) of dist[s] + w.

        The tropical-semiring SpMV: one Bellman-Ford relaxation round.
        Requires a plan built with edge values.
        """
        return self.apply(dist, combine="add", reduce="min",
                          internal=internal)

    def smin(self, x: torch.Tensor, internal: bool = False) -> torch.Tensor:
        """y[d] = min over edges (s -> d) of x[s]; empty rows get 3e38.

        Values must be nonnegative and exact in f32.
        """
        return self.apply(x, reduce="min", internal=internal)

    def smin_int(self, x: torch.Tensor,
                 internal: bool = False) -> torch.Tensor:
        """y[d] = min over edges (s -> d) of int32 x[s]; empty rows get
        2**31-1.  Exact for any int32 values: the WCC label path."""
        self._check_x(x, torch.int32)
        if not internal:
            x = self.to_internal(x)
        y = k2_reduce_min(k1_gather(x, self.plan.slot_src, self.window),
                          self.plan.indptr, "imin", self.k2_cuts)
        return y if internal else self.to_public(y)


# ---------------------------------------------------------------------------
# Per-graph engine cache.  Graphs hold tensors (unhashable by value), so
# key by object identity and evict via weakref finalizers.

_GRAPH_ENGINES = {}


def engine_for(graph, kind: str, build_fn):
    """Return a cached engine for (graph, kind), building on first use."""
    key = (id(graph), kind)
    eng = _GRAPH_ENGINES.get(key)
    if eng is None:
        eng = build_fn()
        try:
            weakref.finalize(graph, _GRAPH_ENGINES.pop, key, None)
        except TypeError:
            # Not weakref-able: don't cache — an id-keyed entry with no
            # eviction could later serve a different graph reusing the id.
            return eng
        _GRAPH_ENGINES[key] = eng
    return eng
