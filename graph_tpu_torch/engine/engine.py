"""EdgeEngine — apply a compiled EdgePlan on its device.

Counterpart of ``graph_tpu.engine.engine``.  ``engine.spmv(x)`` computes
``y[d] = sum over edges (s -> d) of x[s]`` through the K1 and K2 kernels
(:mod:`graph_tpu_torch.engine.kernels`), in the same int32 fixed point as
the JAX engine, so the two agree bit for bit.

On a GPU a node permutation is an index gather, so the JAX engine's
sort-based and gather-plan permutes become ``x[iperm]`` and ``y[perm]``.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from graph_tpu_torch.engine.kernels import FIXED_BITS, k1_gather, k2_reduce
from graph_tpu_torch.engine.plan import EdgePlan, load_or_build_plan

_NOT_PORTED = ("{} is not ported yet: the min, relax and weighted paths "
               "come with ROADMAP queue 1, item 5")


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
        if plan.perm is not None:
            self.perm = plan.perm.long()
            self.iperm = torch.empty_like(self.perm)
            self.iperm[self.perm] = torch.arange(plan.n, device=self.device)

    @classmethod
    def build(cls, src, dst, n, *, relabel=None, cache_dir=None,
              device=None) -> "EdgeEngine":
        """Build (or load from the plan cache — ``cache_dir`` or
        $GRAPH_TPU_TORCH_PLAN_CACHE) the engine for an edge list."""
        return cls(load_or_build_plan(src, dst, n, cache_dir=cache_dir,
                                      relabel=relabel, device=device))

    def to_internal(self, x: torch.Tensor) -> torch.Tensor:
        """x in API node order -> the plan's internal order."""
        return x if self.iperm is None else x[self.iperm]

    def to_public(self, y: torch.Tensor) -> torch.Tensor:
        """y in the plan's internal order -> API node order."""
        return y if self.perm is None else y[self.perm]

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

        Only (combine="none", reduce="sum") — :meth:`spmv` — is ported.
        """
        if combine not in ("none", "add", "mul"):
            raise ValueError(f"combine must be none|add|mul, got {combine!r}")
        if reduce not in ("sum", "min"):
            raise ValueError(f"reduce must be sum|min, got {reduce!r}")
        if combine != "none" or reduce != "sum":
            raise NotImplementedError(_NOT_PORTED.format(
                f"apply(combine={combine!r}, reduce={reduce!r})"))
        if x.shape != (self.plan.n,) or x.dtype != torch.float32:
            raise ValueError(f"x must be ({self.plan.n},) float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if bound != 1.0:
            return self.apply(x * float(np.float32(1.0 / bound)),
                              internal=internal) * bound
        if not internal:
            x = self.to_internal(x)
        # round(x * 2**30) commutes with the gather: quantize at n, not m
        xq = torch.round(x * float(1 << FIXED_BITS)).to(torch.int32)
        acc = k2_reduce(k1_gather(xq, self.plan.slot_src), self.plan.indptr)
        y = acc.to(torch.float32) / float(1 << FIXED_BITS)
        return y if internal else self.to_public(y)

    def relax(self, dist):
        raise NotImplementedError(_NOT_PORTED.format("relax"))

    def smin(self, x):
        raise NotImplementedError(_NOT_PORTED.format("smin"))

    def smin_int(self, x):
        raise NotImplementedError(_NOT_PORTED.format("smin_int"))


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
