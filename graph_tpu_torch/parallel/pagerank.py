"""Multi-device PageRank: row-block sharded pull SpMV over a 1-D mesh.

Counterpart of ``graph_tpu.parallel.pagerank``.  The in-CSR is cut into
destination row blocks: shard p owns ``rows_per = ceil(n/P)`` rows and
the in-edges into them.  Each iteration exchanges only the ragged
boundary sets (:mod:`graph_tpu_torch.parallel.halo`), computes its
block's gather and segment sum, and ``psum``-reduces the L1 residual.

* :func:`page_rank_sharded` runs the segment-op shards of
  :func:`shard_graph`: blocking (one ``all_to_all`` then the sums) or,
  by default, the ``ppermute`` ring, where hop t delivers the segment of
  owner (p - t) mod P and its owner group's partial sum follows.  Both
  sum int32 quanta, so they give the same bits.
* :func:`page_rank_rowblock` runs a
  :class:`~graph_tpu_torch.engine.shard.RowBlockEdgeEngine`: K1 and K2
  on every shard, each destination's sum the single-device engine's.

The Jacobi update and its f32 scalars are the single-device loop's
(:mod:`graph_tpu_torch.algos.pagerank`), and so is its loop:
:func:`~graph_tpu_torch.engine.loop.host_while` with a ``Residual``.
With ``tolerance <= 0`` the residual cannot stop the loop and is read
once at the end; otherwise once an iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from graph_tpu_torch.algos.pagerank import (
    ITERATION, PageRankConfig, PageRankResult, _inv_outdeg, _scalars,
    _update)
from graph_tpu_torch.device import synchronize
from graph_tpu_torch.engine.loop import Residual, host_while
from graph_tpu_torch.graph.csr import DirectedCsrGraph
from graph_tpu_torch.ops.segment import (
    segment_sum_fixedpoint, segment_sum_quanta)
from graph_tpu_torch.parallel.collectives import ppermute, psum
from graph_tpu_torch.parallel.halo import exchange
from graph_tpu_torch.parallel.mesh import NODES_AXIS, Mesh, run_meshed
from graph_tpu_torch.parallel.wcc import _block_csr, _placed, _sends
from graph_tpu_torch.profile import annotate


@dataclasses.dataclass(frozen=True)
class ShardedPullGraph:
    """Row-block sharded in-CSR for pull iterations; one entry per
    shard, on its device.

    The ring layout regroups each shard's edges by the hop t = (p -
    owner) mod P that delivers their source segment (stably, so row
    order survives within a group)."""

    in_targets: List[torch.Tensor]   # (m_p,) int32 halo-buffer positions
    in_offsets: List[torch.Tensor]   # (rows_per+1,) int64 local offsets
    out_degrees: List[torch.Tensor]  # (rows_per,) f32, 0 on padded rows
    send_idx: List[torch.Tensor]     # (P, H) int32 halo send lists
    values: Optional[List[torch.Tensor]]  # (m_p,) f32 edge weights (SSSP)
    node_count: int
    edge_count: int
    halo_bytes: int = 0
    gather_bytes: int = 0
    #: per shard, per hop t: segment-local gather positions (int32)
    ring_targets: Optional[List[List[torch.Tensor]]] = None
    #: per shard: (P, rows_per+1) int64 per-hop row offsets
    ring_offsets: Optional[List[torch.Tensor]] = None
    #: per shard: (P, H) int32 send rows, row t = what it sends at hop t
    ring_send: Optional[List[torch.Tensor]] = None

    @property
    def num_shards(self) -> int:
        return len(self.in_targets)

    @property
    def rows_per_shard(self) -> int:
        return self.out_degrees[0].numel()


def _ring_layout(targets, offsets, send_idx, H: int, P_: int,
                 rows_per: int):
    """Each shard's ring regrouping: (per-hop positions, per-hop
    offsets, rotated send rows), on the shard arrays' device."""
    out = []
    for p, (tgt, off) in enumerate(zip(targets, offsets)):
        remap = tgt.long()
        owner = torch.div(remap, H, rounding_mode="floor")
        # hop t's ppermute (p -> (p+t) mod P) delivers this shard the
        # segment of owner (p - t) mod P, so group t is that owner's edges
        t_step = torch.remainder(p - owner, P_)
        rows = torch.repeat_interleave(
            torch.arange(rows_per, device=off.device), torch.diff(off))
        t_s, o2 = torch.sort(t_step, stable=True)
        local_s, rows_s = (remap % H)[o2], rows[o2]
        bounds = torch.searchsorted(
            t_s, torch.arange(P_ + 1, device=off.device)).tolist()
        grid = torch.arange(rows_per + 1, device=off.device)
        rt = [local_s[bounds[t]:bounds[t + 1]].to(torch.int32)
              for t in range(P_)]
        ro = torch.stack([torch.searchsorted(
            rows_s[bounds[t]:bounds[t + 1]], grid) for t in range(P_)])
        send = torch.stack([send_idx[p, (p + t) % P_] for t in range(P_)])
        out.append((rt, ro, send))
    return out


def shard_graph(graph: DirectedCsrGraph, mesh: Mesh, axis: str = NODES_AXIS,
                weighted: bool = False) -> ShardedPullGraph:
    """Partition a directed graph's in-CSR into row blocks on ``mesh``
    and compile its ragged halo exchange and ring layout, on the graph's
    device; each shard's arrays then move to its device."""
    P_ = mesh.shape[axis]
    n = graph.node_count
    rows_per = -(-n // P_)
    csr = graph.csr_in
    targets, offsets, halo = _block_csr(csr.offsets, csr.targets, n, P_,
                                        rows_per)
    vals = None
    if weighted and csr.values is not None:
        counts = [int(o[-1]) for o in offsets]
        lo = np.concatenate([[0], np.cumsum(counts)]).tolist()
        v = csr.values.to(torch.float32)
        vals = _placed([v[lo[p]:lo[p + 1]] for p in range(P_)], mesh)
    outdeg = torch.zeros(rows_per * P_, dtype=torch.float32,
                         device=graph.device)
    outdeg[:n] = graph.out_degrees().to(torch.float32)
    ring = _ring_layout(targets, offsets, halo.send_idx, halo.H, P_,
                        rows_per)
    return ShardedPullGraph(
        in_targets=_placed(targets, mesh), in_offsets=_placed(offsets, mesh),
        out_degrees=_placed(outdeg.split(rows_per), mesh),
        send_idx=_sends(halo, mesh), values=vals, node_count=n,
        edge_count=graph.edge_count, halo_bytes=halo.halo_bytes,
        gather_bytes=halo.gather_bytes,
        ring_targets=[[t.to(d) for t in r[0]]
                      for r, d in zip(ring, mesh.devices)],
        ring_offsets=[r[1].to(d) for r, d in zip(ring, mesh.devices)],
        ring_send=[r[2].to(d) for r, d in zip(ring, mesh.devices)])


def _jacobi_sharded(sums: Callable, inv_outdeg: Sequence[torch.Tensor],
                    valid: Optional[Sequence[torch.Tensor]], n: int,
                    max_iterations: int, tolerance: float,
                    damping_factor: float):
    """The Jacobi loop over per-shard blocks, its state each shard's
    scores and then the residual.

    ``sums(out_scores)`` -> per shard its rows' spmv.  ``valid`` masks
    the padded rows to 0 (the row-block engine's loop); without it they
    start at 1/n and update like any row, as in ``graph_tpu``'s segment
    loops, and their change counts in the residual.  Returns (scores
    per shard, iterations, error, host reads)."""
    init, base, d = _scalars(n, damping_factor)
    scores = [torch.full_like(inv, init) for inv in inv_outdeg]
    if valid is not None:
        scores = [torch.where(v, s, 0.0) for s, v in zip(scores, valid)]

    def body(state):
        scores = state[:-1]
        with annotate(ITERATION):
            out = [s * inv for s, inv in zip(scores, inv_outdeg)]
            new = [_update(y, base, d) for y in sums(out)]
            if valid is not None:
                new = [torch.where(v, x, 0.0) for x, v in zip(new, valid)]
            err = psum([torch.sum(torch.abs(x - s))
                        for x, s in zip(new, scores)])[0]
            return (*new, err)

    run = host_while(body, (*scores, float("inf")),
                     Residual(len(scores), max_iterations, tolerance))
    return (list(run.state[:-1]), run.iterations, float(run.value),
            run.host_reads)


def _result(scores, mesh: Mesh, n: int, it: int, err: float, reads: int,
            start: float) -> PageRankResult:
    dev = mesh.devices[0]
    scores = torch.cat([s.to(dev) for s in scores])[:n]
    synchronize(dev)
    return PageRankResult(scores=scores, ran_iterations=it, error=err,
                          micros=int((time.perf_counter() - start) * 1e6),
                          host_reads=reads)


def shard_graph_plan(graph: DirectedCsrGraph, mesh: Mesh,
                     axis: str = NODES_AXIS):
    """Row-block sharded EdgeEngine over the forward edges, with each
    shard's out-degrees attached (``rbe.outdeg``, padded rows 0): the
    plan-kernel counterpart of :func:`shard_graph`."""
    from graph_tpu_torch.engine.shard import RowBlockEdgeEngine

    rbe = RowBlockEdgeEngine.build(graph.csr_out.sources,
                                   graph.csr_out.targets, graph.node_count,
                                   mesh, axis=axis)
    rbe.outdeg = rbe.split(graph.out_degrees().to(torch.float32), 0.0)
    return rbe


def page_rank_rowblock(rbe, config: Optional[PageRankConfig] = None
                       ) -> PageRankResult:
    """PageRank on the row-block sharded EdgeEngine: K1 and K2 on every
    shard an iteration, each destination's fixed-point sum wholly on its
    shard, so every iteration's scores are the single-device plan
    engine's bit for bit (the residual's f32 psum may round otherwise).

    The per-shard constants of a run (1/out-degree, the row masks) are
    kept in ``rbe._pr_runs``, keyed by ``max_iterations`` as
    ``graph_tpu`` keys its compiled loops."""
    config = config or PageRankConfig()
    max_iterations = int(config.max_iterations)
    n, rows_per = rbe.node_count, rbe.rows_per
    runs = rbe.__dict__.setdefault("_pr_runs", {})
    run = runs.get(max_iterations)
    if run is None:
        inv = [_inv_outdeg(o) for o in rbe.outdeg]
        valid = [p * rows_per + torch.arange(rows_per, device=d) < n
                 for p, d in enumerate(rbe.mesh.devices)]

        def sums(out):
            halos = exchange(out, rbe.send_idx)
            return [e.spmv(h, internal=True)
                    for e, h in zip(rbe.engines, halos)]

        def run(tolerance, damping):
            return _jacobi_sharded(sums, inv, valid, n, max_iterations,
                                   tolerance, damping)

        runs[max_iterations] = run
    start = time.perf_counter()
    scores, it, err, reads = run(config.tolerance, config.damping_factor)
    return _result(scores, rbe.mesh, n, it, err, reads, start)


def _blocking_sums(sg: ShardedPullGraph):
    """The blocking exchange: one all_to_all, then each shard's gather
    and fixed-point segment sum."""
    def sums(out):
        halos = exchange(out, sg.send_idx)
        return [segment_sum_fixedpoint(h[t.long()], o, bound=1.0)
                for h, t, o in zip(halos, sg.in_targets, sg.in_offsets)]
    return sums


def _ring_sums(sg: ShardedPullGraph):
    """The ring: hop t ppermutes row t of every shard's send rows one
    step t around the mesh, and each shard adds the quanta of that
    owner group's edges; int32 adds, so the blocking exchange's bits."""
    P_ = sg.num_shards
    perms = [[(p, (p + t) % P_) for p in range(P_)] for t in range(P_)]

    def sums(out):
        send = [o[s.long()] for o, s in zip(out, sg.ring_send)]  # (P, H)
        acc = [torch.zeros_like(o, dtype=torch.int32) for o in out]
        for t in range(P_):
            rows = [s[t] for s in send]
            seg = rows if t == 0 else ppermute(rows, perms[t])
            acc = [a + segment_sum_quanta(g[rt[t].long()], ro[t])
                   for a, g, rt, ro in zip(acc, seg, sg.ring_targets,
                                           sg.ring_offsets)]
        return [a.to(torch.float32) / float(1 << 30) for a in acc]
    return sums


def page_rank_sharded(sg: ShardedPullGraph, mesh: Mesh,
                      config: Optional[PageRankConfig] = None,
                      axis: str = NODES_AXIS,
                      ring: bool = True) -> PageRankResult:
    """PageRank on a sharded graph; returns the global scores (n,) on the
    mesh's first device.

    ``ring=True`` (the default, when the shard carries the ring layout)
    sums group by group as the ring delivers; the results are the
    blocking exchange's bit for bit."""
    del axis
    config = config or PageRankConfig()
    sums = (_ring_sums(sg) if ring and sg.ring_targets is not None
            else _blocking_sums(sg))
    inv = [_inv_outdeg(o) for o in sg.out_degrees]
    start = time.perf_counter()
    scores, it, err, reads = _jacobi_sharded(
        sums, inv, None, sg.node_count, int(config.max_iterations),
        config.tolerance, config.damping_factor)
    return _result(scores, mesh, sg.node_count, it, err, reads, start)


def page_rank_meshed(graph: DirectedCsrGraph, mesh: Mesh,
                     config: Optional[PageRankConfig] = None
                     ) -> PageRankResult:
    """``page_rank``'s default-mesh route: :func:`page_rank_rowblock` or
    :func:`page_rank_sharded`, as
    :func:`~graph_tpu_torch.parallel.mesh.run_meshed` picks."""
    return run_meshed(
        graph, mesh,
        ("rowblock", shard_graph_plan,
         lambda rbe: page_rank_rowblock(rbe, config)),
        ("sharded-pull", shard_graph,
         lambda sg: page_rank_sharded(sg, mesh, config)))
