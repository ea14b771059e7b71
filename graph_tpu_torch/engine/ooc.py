"""Out-of-core EdgeEngine: destination slabs streamed from pinned host memory.

Counterpart of ``graph_tpu.engine.ooc``.  The edge list is split into
destination-contiguous slabs, each compiled as a rectangular EdgePlan
(``n`` = the slab's destination rows, ``n_src`` = all nodes) whose
arrays live in host memory.  Every call streams the slabs to the card
and runs K1 and K2 on each, so the graph's size is bounded by host
memory, not by the card's.

On a card the slab plans are pinned.  Slab i+1 is copied on a copy
stream while K1 and K2 run on slab i; two device buffers, each as large
as the largest slab, take turns, and events keep a buffer from being
refilled before the kernels reading it have finished.  So at most two
slabs are on the card at once.  The slab plans are built one at a time
on the card and then moved to pinned memory: the build never holds the
whole graph's plan on the card.

Results, and the drivers' state between rounds, stay on the host as
CPU tensors, as in ``graph_tpu``; with a card, x goes up and y comes
down through pinned memory.  ``spmv``, ``relax`` and ``smin_int``
are bit-exact against the resident :class:`EdgeEngine` on the same
edges: the same kernels reduce the same slots per destination row, and
slabs touch disjoint rows.

Cost: each call copies every slab plan to the card (4 B per slot, 8 B
with edge values, 8 B per row and per K2 tile), so a call runs at the
host-to-card copy rate: out-of-core is for capacity, not speed.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional

import numpy as np
import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.dtypes import check_node_count_fits
from graph_tpu_torch.engine.kernels import (
    FIXED_BITS, INF, INF_BITS, IMAX, k1_gather, k1_gather_weighted,
    k2_num_tiles, k2_reduce, k2_reduce_min, k2_tile_cuts)
from graph_tpu_torch.engine.loop import Flag, host_while
from graph_tpu_torch.engine.plan import EdgePlan, build_plan

logger = logging.getLogger(__name__)

#: Slab bounds are multiples of MID destination rows, as in graph_tpu
#: (there, K2 reduces whole blocks of MID rows).
MID = 65536
#: Default budget for one slab's plan on the card.
DEFAULT_MAX_BYTES = 2 << 30


def plan_bytes(m: int, rows: int, weighted: bool) -> int:
    """Bytes of a slab plan's arrays on the card: ``slot_src`` (4 B per
    slot), ``slot_w`` (4 B per slot, with edge values), ``indptr`` (8 B
    per row, and one more) and K2's tile cuts (8 B per tile, and one
    more)."""
    return (m * (8 if weighted else 4) + 8 * (rows + 1)
            + 8 * (k2_num_tiles(rows, m) + 1))


@dataclasses.dataclass
class _Slab:
    d0: int            # first destination row of this slab
    rows: int          # destination rows (reduce domain)
    plan: EdgePlan     # n=rows, n_src=n; host memory (pinned with a card)
    cuts: torch.Tensor  # K2's tile cuts of the plan, beside it

    def arrays(self) -> List[torch.Tensor]:
        """What a call streams to the card, in a fixed order."""
        out = [self.plan.slot_src, self.plan.indptr, self.cuts]
        if self.plan.slot_w is not None:
            out.append(self.plan.slot_w)
        return out


def _pinned(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


class OocEdgeEngine:
    """Destination-slab engine whose plans live on the host.

    ``spmv(x)``, ``relax(dist)`` and ``smin_int(x)`` take (n,) vectors
    (CPU tensors or numpy) and return CPU tensors, equal bit for bit to
    the resident EdgeEngine's results on the same edges.
    """

    def __init__(self, slabs: List[_Slab], n: int, m: int,
                 device: torch.device):
        self.slabs = slabs
        self.n = n
        self.m = m
        self.device = device
        self.weighted = bool(slabs) and slabs[0].plan.slot_w is not None
        #: bytes one call copies to the card (the slab plans)
        self.bytes_per_call = sum(a.numel() * a.element_size()
                                  for sl in slabs for a in sl.arrays())

    @classmethod
    def build(cls, src, dst, n: int, values=None,
              max_bytes: Optional[int] = None,
              n_slabs: Optional[int] = None,
              device=None) -> "OocEdgeEngine":
        """Partition edges into destination slabs sized for the budget.

        ``max_bytes``: budget for one slab's plan on the card
        (:func:`plan_bytes`; default ``DEFAULT_MAX_BYTES``); ``n_slabs``
        overrides the computed slab count.  Slab bounds are multiples of
        ``MID`` rows with about equal edge counts, as ``graph_tpu`` cuts
        them.  ``values``: optional (m,) edge weights, for :meth:`relax`.
        """
        device = resolve_device(device)
        t0 = time.perf_counter()
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        n, m = int(n), src.size
        nmid = max(1, -(-n // MID))
        if n_slabs is None:
            budget = max_bytes or DEFAULT_MAX_BYTES
            n_slabs = max(1, -(-plan_bytes(m, n, values is not None)
                               // budget))
        n_slabs = min(n_slabs, nmid)
        # destination-contiguous, MID-aligned slab bounds with ~equal edge
        # counts (power-law destinations skew; equal MID counts would not)
        mid_of = dst // MID
        per_mid = np.bincount(mid_of, minlength=nmid)
        target = m / n_slabs
        cuts, acc = [0], 0
        for mi in range(nmid):
            acc += per_mid[mi]
            if acc >= target and len(cuts) < n_slabs:
                cuts.append(mi + 1)
                acc = 0
        cuts.append(nmid)
        # a stable order by slab keeps each slab's edges in input order,
        # as graph_tpu's stable order by destination does
        slab_of_mid = np.repeat(np.arange(len(cuts) - 1, dtype=np.uint16),
                                np.diff(cuts))
        order = np.argsort(slab_of_mid[mid_of], kind="stable")
        src_s, dst_s = src[order], dst[order]
        val_s = (None if values is None
                 else np.asarray(values, np.float32)[order])
        mid_bounds = np.concatenate([[0], np.cumsum(per_mid)])
        slabs = []
        for mlo, mhi in zip(cuts[:-1], cuts[1:]):
            if mlo == mhi:
                continue
            elo, ehi = int(mid_bounds[mlo]), int(mid_bounds[mhi])
            d0 = mlo * MID
            rows = min(mhi * MID, n) - d0
            plan = build_plan(src_s[elo:ehi], dst_s[elo:ehi] - d0, rows,
                              values=None if val_s is None
                              else val_s[elo:ehi],
                              n_src=n, device=device)
            cut = k2_tile_cuts(plan.indptr, plan.m)
            if device.type == "cuda":  # to pinned host memory, slab by slab
                plan = dataclasses.replace(
                    plan, indptr=_pinned(plan.indptr),
                    slot_src=_pinned(plan.slot_src),
                    slot_w=None if plan.slot_w is None
                    else _pinned(plan.slot_w))
                cut = _pinned(cut)
            slabs.append(_Slab(d0=d0, rows=rows, plan=plan, cuts=cut))
        eng = cls(slabs, n=n, m=m, device=device)
        logger.info("OocEdgeEngine: m=%d rows=%d slabs=%d (largest %.0f MB)"
                    " in %.1fs", m, n, len(slabs),
                    max(plan_bytes(s.plan.m, s.rows, eng.weighted)
                        for s in slabs) / 1e6, time.perf_counter() - t0)
        return eng

    def _on_device(self):
        """Yield each slab with its arrays on the engine's device.

        On a card: two buffers take turns; slab i+1's copy is queued on a
        copy stream before slab i is yielded, and waits for the event
        that slab i-1's kernels (on the current stream) have finished
        with its buffer.  The caller launches slab i's kernels before
        asking for the next slab.
        """
        if self.device.type != "cuda":
            for sl in self.slabs:
                yield sl, sl.arrays()
            return
        compute = torch.cuda.current_stream(self.device)
        copy = torch.cuda.Stream(self.device)
        sizes = [max(sl.arrays()[k].numel() for sl in self.slabs)
                 for k in range(len(self.slabs[0].arrays()))]
        bufs = [[torch.empty(s, dtype=a.dtype, device=self.device)
                 for s, a in zip(sizes, self.slabs[0].arrays())]
                for _ in range(2)]
        freed = [None, None]

        def upload(i):
            with torch.cuda.stream(copy):
                if freed[i % 2] is not None:
                    copy.wait_event(freed[i % 2])
                views = [buf[: a.numel()].copy_(a, non_blocking=True)
                         for buf, a in zip(bufs[i % 2],
                                           self.slabs[i].arrays())]
                ready = torch.cuda.Event()
                ready.record(copy)
            return views, ready

        staged = upload(0)
        for i, sl in enumerate(self.slabs):
            views, ready = staged
            if i + 1 < len(self.slabs):
                staged = upload(i + 1)
            compute.wait_event(ready)
            yield sl, views
            freed[i % 2] = torch.cuda.Event()
            freed[i % 2].record(compute)

    def _vector(self, x, dtype: torch.dtype) -> torch.Tensor:
        """x on the engine's device; on a card through pinned memory (a
        copy from pageable memory runs at a fraction of the pinned rate)."""
        x = torch.as_tensor(x)
        if x.shape != (self.n,) or x.dtype != dtype:
            raise ValueError(f"x must be ({self.n},) {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if self.device.type != "cuda":
            return x
        return _pinned(x).to(self.device, non_blocking=True)

    def _host(self, y: torch.Tensor) -> torch.Tensor:
        """y in host memory: on a card, copied into pinned memory."""
        if self.device.type != "cuda":
            return y
        out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        out.copy_(y, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return out

    def _reduce(self, x: torch.Tensor, fill: int, slab_op) -> torch.Tensor:
        """y (int32, on the device) from ``slab_op(x, arrays) -> rows``,
        slab by slab; rows of no slab keep ``fill``."""
        y = torch.full((self.n,), fill, dtype=torch.int32,
                       device=self.device)
        for sl, arrays in self._on_device():
            y[sl.d0: sl.d0 + sl.rows] = slab_op(x, arrays)
        return y

    def spmv(self, x, bound: float = 1.0) -> torch.Tensor:
        """y[d] = sum over edges (s -> d) of x[s], slab-streamed.

        x: (n,) f32.  Returns a CPU tensor, bit-exact against
        EdgeEngine.spmv on the same edges (``bound`` as there)."""
        if bound != 1.0:
            x = torch.as_tensor(x) * float(np.float32(1.0 / bound))
            return self.spmv(x) * float(np.float32(bound))
        x = self._vector(x, torch.float32)
        xq = torch.round(x * float(1 << FIXED_BITS)).to(torch.int32)
        yq = self._reduce(xq, 0, lambda xq, a: k2_reduce(
            k1_gather(xq, a[0]), a[1], a[2]))
        return self._host(yq.to(torch.float32) / float(1 << FIXED_BITS))

    def relax(self, dist) -> torch.Tensor:
        """y[d] = min over weighted edges (s -> d) of dist[s] + w,
        slab-streamed (one Bellman-Ford round); rows without edges get
        3e38.  Requires an engine built with edge ``values``."""
        if not self.weighted:
            raise ValueError("relax needs an engine built with values")
        x = self._vector(dist, torch.float32)
        y = self._reduce(x, INF_BITS, lambda x, a: k2_reduce_min(
            k1_gather_weighted(x, a[0], a[3], "add", quantize=False)
            .view(torch.int32), a[1], "min", a[2]))
        return self._host(y.view(torch.float32))

    def smin_int(self, x) -> torch.Tensor:
        """y[d] = min over edges (s -> d) of int32 x[s], slab-streamed;
        rows without edges get 2**31-1.  Bit-exact against
        EdgeEngine.smin_int."""
        x = self._vector(x, torch.int32)
        return self._host(self._reduce(x, IMAX, lambda x, a: k2_reduce_min(
            k1_gather(x, a[0]), a[1], "imin", a[2])))


def wcc_ooc(src, dst, n: int, *, max_bytes: Optional[int] = None,
            n_slabs: Optional[int] = None, device=None) -> torch.Tensor:
    """Weakly connected components of an out-of-core graph.

    Min-label propagation with pointer jumping (the plan path of
    algos/wcc.py) over slab-streamed symmetrized edges; labels are int32
    node ids, on the host between rounds (``host_while``: one read a
    round).  Returns the (n,) labels, a CPU tensor.
    """
    check_node_count_fits(n, np.int32)
    src, dst = np.asarray(src), np.asarray(dst)
    eng = OocEdgeEngine.build(np.concatenate([src, dst]),
                              np.concatenate([dst, src]), n,
                              max_bytes=max_bytes, n_slabs=n_slabs,
                              device=device)

    def body(state):
        comp, _ = state
        new = torch.minimum(comp, eng.smin_int(comp))
        new = new[new.long()]  # pointer jump (squares chains)
        new = new[new.long()]
        return new, (new != comp).any()

    comp = torch.arange(n, dtype=torch.int32)
    return host_while(body, (comp, 1), Flag(1)).state[0]


def sssp_ooc(src, dst, values, n: int, start_node: int = 0, *,
             max_bytes: Optional[int] = None,
             n_slabs: Optional[int] = None, device=None) -> torch.Tensor:
    """Single-source shortest paths on an out-of-core weighted graph.

    Bellman-Ford to the fixpoint with slab-streamed relaxation rounds
    (distances on the host between rounds, ``host_while``: one read a
    round; the plan path's semantics).  Returns the (n,) f32 distances,
    a CPU tensor, unreached nodes at the engine's +inf stand-in (3e38).
    """
    eng = OocEdgeEngine.build(src, dst, n, values=values,
                              max_bytes=max_bytes, n_slabs=n_slabs,
                              device=device)

    def body(state):
        dist, _ = state
        new = torch.minimum(dist, eng.relax(dist))
        return new, (new != dist).any()

    dist = torch.full((n,), INF, dtype=torch.float32)
    dist[start_node] = 0.0
    return host_while(body, (dist, 1), Flag(1)).state[0]


def page_rank_ooc(src, dst, n: int, *, max_iterations: int = 20,
                  damping: float = 0.85, tolerance: float = 1e-4,
                  max_bytes: Optional[int] = None,
                  n_slabs: Optional[int] = None, device=None):
    """Jacobi PageRank on an out-of-core graph (edge arrays on the host).

    The in-core ``page_rank``'s loop and arithmetic, on CPU tensors, with
    the slab-streamed spmv: its scores equal ``page_rank``'s bit for bit.
    (``graph_tpu``'s driver rounds ``base + d*y`` twice and its scalars
    from float64, in numpy, where its in-core path does as the port
    does.)  Returns (scores, iterations, err).
    """
    from graph_tpu_torch.algos.pagerank import _inv_outdeg, _jacobi

    eng = OocEdgeEngine.build(src, dst, n, max_bytes=max_bytes,
                              n_slabs=n_slabs, device=device)
    outdeg = torch.bincount(torch.as_tensor(np.asarray(src)).long(),
                            minlength=n)
    scores, it, err, _ = _jacobi(eng.spmv, _inv_outdeg(outdeg),
                                 max_iterations, tolerance, damping)
    return scores, it, err
