"""Single-source shortest paths: Bellman-Ford on the EdgeEngine.

Counterpart of ``graph_tpu.algos.sssp`` (reference analog:
``delta_stepping``, crates/algos/src/sssp.rs:38-204).  The plan engine
relaxes every edge each round, ``dist <- min(dist, relax(dist))`` with
``relax`` the tropical edge-map-reduce ``min over s->d of dist[s] + w``
(K1 weighted gather with ``combine="add"`` + K2 ``min``), until nothing
changes; rounds = the weighted hop diameter.  Distances are exact f32
path sums, so they match the reference golden ``[0, 4, 2, 9, 5, 20]``
(sssp.rs:283-313).  The host reads one "changed" flag per round, since
it decides the loop.

Only the plan engine is ported: ``engine="auto"`` and ``"plan"`` run it;
the dense-mask delta-stepping ("xla") and compacted-frontier
("frontier") engines are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from graph_tpu_torch.device import synchronize
from graph_tpu_torch.engine.engine import EdgeEngine, engine_for
from graph_tpu_torch.engine.kernels import INF as _PLAN_INF
from graph_tpu_torch.errors import not_ported
from graph_tpu_torch.graph.csr import DirectedCsrGraph

INF = np.float32(np.finfo(np.float32).max)  # f32::MAX, sssp.rs:12


@dataclasses.dataclass(frozen=True)
class DeltaSteppingConfig:
    """Reference analog: ``DeltaSteppingConfig`` (sssp.rs:21-36).

    ``engine``: "plan" (EdgeEngine Bellman-Ford) and "auto" run the
    ported path; "xla" and "frontier" are not ported yet.  ``delta`` is
    accepted for parity; Bellman-Ford has no buckets, and the distances
    do not depend on it.
    """

    start_node: int
    delta: float
    engine: str = "auto"


@dataclasses.dataclass(frozen=True)
class SsspResult:
    distances: torch.Tensor  # (n,) f32; unreached = f32::MAX
    micros: int
    #: relaxation rounds the plan engine ran (graph_tpu does not report it)
    ran_iterations: int = 0

    def distances_np(self) -> np.ndarray:
        return self.distances.cpu().numpy()


def delta_stepping(graph: DirectedCsrGraph,
                   config: DeltaSteppingConfig) -> SsspResult:
    """SSSP distances from ``config.start_node``, on the graph's device.

    Mirrors ``delta_stepping(&g, DeltaSteppingConfig) -> Vec<AtomicF32>``
    (sssp.rs:38).  Requires an edge-weighted directed graph; weights must
    be nonnegative.
    """
    if graph.csr_in.values is None:
        raise ValueError("delta_stepping requires edge weights (values)")
    if config.engine in ("xla", "frontier"):
        raise not_ported(f"engine={config.engine!r}")
    if config.engine not in ("auto", "plan"):
        raise ValueError(f"unknown SSSP engine {config.engine!r}")
    return _sssp_plan(graph, config)


def _weighted_engine(graph: DirectedCsrGraph) -> EdgeEngine:
    """Forward-edge EdgeEngine with the edge weights and the degree
    relabel, on the graph's device (cached per graph identity)."""
    return engine_for(graph, "fwd_weighted", lambda: EdgeEngine.build(
        graph.csr_out.sources, graph.csr_out.targets, graph.node_count,
        values=graph.csr_out.values, relabel="degree", device=graph.device))


def _sssp_plan(graph: DirectedCsrGraph, config) -> SsspResult:
    """Bellman-Ford on the EdgeEngine's tropical relaxation, in the
    plan's internal node order; 3e38 (the engine's +inf) becomes
    f32::MAX at the end."""
    n = graph.node_count
    s = int(config.start_node)
    if not 0 <= s < n:
        raise ValueError(f"start_node {s} is not a node of a graph of {n}")
    eng = _weighted_engine(graph)
    start = time.perf_counter()
    if eng.perm is not None:  # iterate in the plan's internal order
        s = eng.perm[s : s + 1]
    dist = torch.full((n,), _PLAN_INF, dtype=torch.float32, device=eng.device)
    dist[s] = 0.0
    iters = 0
    while True:
        nd = torch.minimum(dist, eng.relax(dist, internal=True))
        iters += 1
        changed = bool((nd != dist).any())  # host read: decides the loop
        dist = nd
        if not changed:
            break
    dist = eng.to_public(dist)
    synchronize(dist.device)
    micros = int((time.perf_counter() - start) * 1e6)
    # unreached sentinel: the reference keeps f32::MAX (sssp.rs:12)
    dist = dist.masked_fill(dist >= _PLAN_INF, float(INF))
    return SsspResult(distances=dist, micros=micros, ran_iterations=iters)
