"""Multi-device SSSP: row-block sharded Bellman-Ford relaxation.

Counterpart of ``graph_tpu.parallel.sssp``.  Sharding mirrors
:mod:`graph_tpu_torch.parallel.pagerank`: each shard owns a row block of
the in-CSR and the weights of the edges into it; every round exchanges
the ragged distance halo and relaxes all local in-edges; the loop
(:func:`~graph_tpu_torch.engine.loop.host_while` on a ``Flag``) stops
when the psum of the shards' change flags is 0 (one host read a round).

* :func:`sssp_sharded`: a gather and a segment-min a round;
* :func:`sssp_rowblock`: the row-block EdgeEngine's ``relax``, K1
  weighted and K2 ``min`` on every shard, each destination's min the
  single-device engine's.

Plain Bellman-Ford converges to the same exact distances as
delta-stepping (both are the least fixpoint of the f32 path sums).
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from graph_tpu_torch.algos.sssp import INF, DeltaSteppingConfig, SsspResult
from graph_tpu_torch.device import synchronize
from graph_tpu_torch.engine.kernels import INF as _PLAN_INF
from graph_tpu_torch.engine.loop import Flag, host_while
from graph_tpu_torch.graph.csr import DirectedCsrGraph
from graph_tpu_torch.parallel.collectives import psum
from graph_tpu_torch.parallel.halo import exchange
from graph_tpu_torch.parallel.mesh import NODES_AXIS, Mesh, run_meshed
from graph_tpu_torch.parallel.pagerank import ShardedPullGraph, shard_graph
from graph_tpu_torch.parallel.wcc import _segment_min_by_offsets


def shard_weighted_graph(graph: DirectedCsrGraph, mesh: Mesh,
                         axis: str = NODES_AXIS) -> ShardedPullGraph:
    """Row-block shard with the per-edge weights (for SSSP)."""
    if graph.csr_in.values is None:
        raise ValueError("sssp_sharded needs a weighted graph")
    return shard_graph(graph, mesh, axis=axis, weighted=True)


def _bellman_ford(relax: Callable, mesh: Mesh, rows_per: int, n: int,
                  start_node: int):
    """``dist <- min(dist, relax(dist))`` over per-shard blocks until no
    distance falls, the state each shard's distances and the psum of the
    change flags.  Returns (distances (n,) on the first device, rounds,
    host reads)."""
    dist = [torch.where(p * rows_per + torch.arange(rows_per, device=d)
                        == start_node, 0.0, float(INF)).to(torch.float32)
            for p, d in enumerate(mesh.devices)]

    def body(state):
        dist = state[:-1]
        new = [torch.minimum(x, r) for x, r in zip(dist, relax(dist))]
        flags = psum([(x < y).any().to(torch.int32)
                      for x, y in zip(new, dist)])
        return (*new, flags[0])

    run = host_while(body, (*dist, 1), Flag(len(dist)))
    dev = mesh.devices[0]
    return (torch.cat([x.to(dev) for x in run.state[:-1]])[:n],
            run.iterations, run.host_reads)


def sssp_sharded(sg: ShardedPullGraph, mesh: Mesh,
                 config: DeltaSteppingConfig,
                 axis: str = NODES_AXIS) -> SsspResult:
    """SSSP on a sharded weighted graph; returns the global distances
    (unreached = f32::MAX) on the mesh's first device."""
    del axis
    rows_per = sg.rows_per_shard

    def relax(dist):
        halos = exchange(dist, sg.send_idx)
        return [_segment_min_by_offsets(h[t.long()] + w, o, rows_per)
                for h, t, w, o in zip(halos, sg.in_targets, sg.values,
                                      sg.in_offsets)]

    start = time.perf_counter()
    dist, it, reads = _bellman_ford(relax, mesh, rows_per, sg.node_count,
                                    int(config.start_node))
    synchronize(dist.device)
    return SsspResult(distances=dist,
                      micros=int((time.perf_counter() - start) * 1e6),
                      ran_iterations=it, host_reads=reads)


def shard_weighted_graph_plan(graph: DirectedCsrGraph, mesh: Mesh,
                              axis: str = NODES_AXIS):
    """Row-block sharded EdgeEngine over the weighted forward edges: the
    plan-kernel counterpart of :func:`shard_weighted_graph`."""
    from graph_tpu_torch.engine.shard import RowBlockEdgeEngine

    if graph.csr_out.values is None:
        raise ValueError("sssp needs a weighted graph")
    return RowBlockEdgeEngine.build(
        graph.csr_out.sources, graph.csr_out.targets, graph.node_count,
        mesh, values=graph.csr_out.values.to(torch.float32), axis=axis)


def sssp_rowblock(rbe, config: DeltaSteppingConfig) -> SsspResult:
    """Bellman-Ford on the row-block sharded EdgeEngine; bit-identical
    to the single-device plan engine (each destination's tropical min
    lies on its shard).  The engine's +inf (3e38) ends as f32::MAX."""
    def relax(dist):
        halos = exchange(dist, rbe.send_idx)
        return [e.relax(h, internal=True)
                for e, h in zip(rbe.engines, halos)]

    start = time.perf_counter()
    dist, it, reads = _bellman_ford(relax, rbe.mesh, rbe.rows_per,
                                    rbe.node_count, int(config.start_node))
    synchronize(dist.device)
    micros = int((time.perf_counter() - start) * 1e6)
    dist = dist.masked_fill(dist >= _PLAN_INF, float(INF))
    return SsspResult(distances=dist, micros=micros, ran_iterations=it,
                      host_reads=reads)


def sssp_meshed(graph: DirectedCsrGraph, mesh: Mesh,
                config: DeltaSteppingConfig) -> SsspResult:
    """``delta_stepping``'s default-mesh route: :func:`sssp_rowblock` or
    :func:`sssp_sharded`, as
    :func:`~graph_tpu_torch.parallel.mesh.run_meshed` picks."""
    return run_meshed(
        graph, mesh,
        ("rowblock-w", shard_weighted_graph_plan,
         lambda rbe: sssp_rowblock(rbe, config)),
        ("sharded-weighted", shard_weighted_graph,
         lambda sg: sssp_sharded(sg, mesh, config)))
