"""Single-source shortest paths: Bellman-Ford and delta-stepping.

Counterpart of ``graph_tpu.algos.sssp`` (reference analog:
``delta_stepping``, crates/algos/src/sssp.rs:38-204).  Three engines:

* ``"plan"``: Bellman-Ford on the EdgeEngine.  Each round relaxes every
  edge, ``dist <- min(dist, relax(dist))`` with ``relax`` the tropical
  edge-map-reduce ``min over s->d of dist[s] + w`` (K1 weighted gather
  with ``combine="add"`` + K2 ``min``), until nothing changes; rounds =
  the weighted hop diameter.
* ``"xla"``: delta-stepping with dense bucket masks over the in-CSR:
  the frontier is the pending nodes of the current bucket, relaxed by a
  gather and a segment-min over all edges.
* ``"frontier"``: delta-stepping that relaxes only the out-arcs of the
  current bucket's pending nodes.  On the card it runs over on-card
  near/far queues (:func:`_sssp_near_far`: each settle step one launch
  of ``kernels.sssp_frontier_relax`` over the out-CSR, each bucket one of
  ``kernels.sssp_frontier_advance``; no step touches an n-sized array).
  On the CPU it is ``graph_tpu``'s op chain: a degree-padded adjacency
  matrix, up to ``_FRONTIER_CAP`` compacted frontier nodes a step.

Every engine's loops are ``graph_tpu``'s ``while_loop``s
(:func:`graph_tpu_torch.engine.loop.device_while`): on the card one CUDA
graph with a conditional WHILE node (delta-stepping: a WHILE node over
buckets whose body holds the settle WHILE node), captured once per graph
and read once after the loop; on the CPU host loops, which read the
changed flag each round, or whether the bucket is empty each settle step
and the next bucket each bucket.  Every engine's distances are exact f32
path sums, the least fixpoint, so the engines agree bit for bit and
match the reference golden ``[0, 4, 2, 9, 5, 20]`` (sssp.rs:283-313).
``"auto"`` runs ``"frontier"`` on the card, whose work is the arcs of the
nodes each bucket settles where the plan engine relaxes every arc each
round (a high-diameter graph takes some 1,400 rounds of the plan engine
and about one sweep of the graph on the near/far queues, PERF.md), and
the plan engine on the CPU; under a default mesh of more than one shard
(:func:`graph_tpu_torch.parallel.use_mesh`) it runs the sharded
Bellman-Ford of :mod:`graph_tpu_torch.parallel.sssp` instead
(:func:`~graph_tpu_torch.parallel.sssp.sssp_meshed`).

Each single-device run is an ``sssp.run`` span
(:mod:`graph_tpu_torch.profile`) with the counters ``rounds`` (the
result's ``ran_iterations``: relaxation rounds or settle steps) and
``relaxed``: on the card's ``"frontier"`` the arcs its settle steps
relaxed, no pads, counted on the card and read back once after the loop
(a host read the result's ``host_reads`` counts), beside ``buckets``, the
buckets it settled; elsewhere the arc slots the relaxations read, pads
included, worked out on the host from counts the run already has
(``plan``: rounds × m; ``xla``: settle steps × m; ``frontier`` on the
CPU: settle steps × ``_FRONTIER_CAP`` × the padded adjacency's width).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from graph_tpu_torch import profile
from graph_tpu_torch.device import synchronize, to_host
from graph_tpu_torch.engine import kernels
from graph_tpu_torch.engine.engine import EdgeEngine, engine_for
from graph_tpu_torch.engine.kernels import INF as _PLAN_INF
from graph_tpu_torch.engine.loop import Flag, While, device_while, into
from graph_tpu_torch.graph.csr import DirectedCsrGraph
from graph_tpu_torch.ops.segment import segment_min_sorted

INF = np.float32(kernels.F32_MAX)  # f32::MAX, sssp.rs:12
#: Frontier nodes relaxed per settle step (the reference claims 64-node
#: batches per thread, sssp.rs:14).
_FRONTIER_CAP = 8192


@dataclasses.dataclass(frozen=True)
class DeltaSteppingConfig:
    """Reference analog: ``DeltaSteppingConfig`` (sssp.rs:21-36).

    ``engine``: "plan" (EdgeEngine Bellman-Ford), "xla" (delta-stepping
    with dense masks), "frontier" (delta-stepping over a compacted
    frontier: near/far queues on the card) or "auto" ("frontier" on the
    card, "plan" on the CPU).  ``delta`` is the bucket width of the
    delta-stepping engines; the distances do not depend on it.
    """

    start_node: int
    delta: float
    engine: str = "auto"


@dataclasses.dataclass(frozen=True)
class SsspResult:
    distances: torch.Tensor  # (n,) f32; unreached = f32::MAX
    micros: int
    #: relaxation rounds (plan) or settle steps (xla, frontier) the run
    #: took; graph_tpu does not report it
    ran_iterations: int = 0
    #: values the host read back from the device during the run
    host_reads: int = 0

    def distances_np(self) -> np.ndarray:
        return to_host(self.distances)


def delta_stepping(graph: DirectedCsrGraph,
                   config: DeltaSteppingConfig) -> SsspResult:
    """SSSP distances from ``config.start_node``, on the graph's device.

    Mirrors ``delta_stepping(&g, DeltaSteppingConfig) -> Vec<AtomicF32>``
    (sssp.rs:38).  Requires an edge-weighted directed graph; weights must
    be nonnegative.
    """
    if graph.csr_in.values is None:
        raise ValueError("delta_stepping requires edge weights (values)")
    if config.engine not in ("auto", "plan", "xla", "frontier"):
        raise ValueError(f"unknown SSSP engine {config.engine!r}")
    s = int(config.start_node)
    if not 0 <= s < graph.node_count:
        raise ValueError(f"start_node {s} is not a node of a graph of "
                         f"{graph.node_count}")
    from graph_tpu_torch.parallel.mesh import _default_mesh

    engine = config.engine
    if engine == "auto":
        mesh = _default_mesh()
        if mesh is not None:
            from graph_tpu_torch.parallel.sssp import sssp_meshed

            return sssp_meshed(graph, mesh, config)
        engine = _auto_engine(graph)
    if engine == "frontier":
        if graph.device.type == "cuda":
            return _sssp_near_far(graph, config)
        return _sssp_frontier(graph, config)
    if engine == "xla":
        with profile.span("sssp.run") as sp:
            start = time.perf_counter()
            dist, steps, reads = _delta_stepping_device(
                graph.csr_in.sources, graph.csr_in.targets,
                graph.csr_in.values.to(torch.float32), s, config.delta,
                graph.node_count, cache=engine_for(graph, "loops", dict))
            synchronize(dist.device)
            micros = int((time.perf_counter() - start) * 1e6)
            if sp:
                sp.count(rounds=steps,
                         relaxed=steps * graph.csr_in.targets.numel())
        return SsspResult(distances=dist, micros=micros,
                          ran_iterations=steps, host_reads=reads)
    return _sssp_plan(graph, config)


def _auto_engine(graph: DirectedCsrGraph) -> str:
    """``"auto"``'s engine on one device: ``"frontier"`` (the near/far
    queues) on the card where its queues can count the arcs, else
    ``"plan"``."""
    if graph.device.type == "cuda" and \
            graph.edge_count < kernels.NEAR_FAR_MAX_ARCS:
        return "frontier"
    return "plan"


#: Held while a graph's near/far state is looked up or built, so that
#: threads whose first calls race share one state, and so its lock.
_STATE_LOCK = threading.Lock()


def _near_far_state(graph: DirectedCsrGraph) -> kernels.NearFar:
    """The graph's near/far state over its out-CSR, cached per graph: one
    state a graph, whichever thread builds it."""
    csr = graph.csr_out
    with _STATE_LOCK:
        return engine_for(graph, "near_far", lambda: kernels.near_far_state(
            csr.offsets, csr.targets, csr.values))


def _sssp_near_far(graph: DirectedCsrGraph, config) -> SsspResult:
    """Delta-stepping over the near/far queues of a :class:`NearFar`
    state (``engine="frontier"`` on the card): one reset, then a loop over
    buckets whose body is a settle loop of relax steps and one advance.
    The steps work in place on the state and return their state, the two
    loop flags, as they got it, so the device loop copies nothing.  The
    distances are cloned out and the relaxed arcs read back once after
    the loop; one run at a time holds the state's lock."""
    st = _near_far_state(graph)
    delta = float(np.float32(config.delta))

    def relax(state):
        kernels.sssp_frontier_relax(st, delta, state[0])
        return state

    def advance(state):
        kernels.sssp_frontier_advance(st, delta, state[0], state[1])
        return state

    with st.lock, profile.span("sssp.run") as sp:
        start = time.perf_counter()
        kernels.sssp_frontier_reset(st, int(config.start_node))
        run = device_while((While(relax, Flag(0)), advance),
                           (st.flags[0], st.flags[1]), Flag(1),
                           cache=engine_for(graph, "loops", dict),
                           key=("near_far", delta))
        dist = st.dist.clone()
        relaxed = int(st.ctrl[kernels.RELAXED])  # the one read after
        micros = int((time.perf_counter() - start) * 1e6)
        steps = run.inner[0]
        if sp:
            sp.count(rounds=steps, buckets=run.iterations, relaxed=relaxed)
    return SsspResult(distances=dist, micros=micros, ran_iterations=steps,
                      host_reads=run.host_reads + 1)


def _settle(dist: torch.Tensor, pending: torch.Tensor, delta: float,
            step, *, cache: Optional[dict] = None, key=None
            ) -> Tuple[torch.Tensor, int, int]:
    """The delta-stepping schedule both bucketed engines share, as
    ``graph_tpu``'s two nested ``while_loop``s: walk buckets in ascending
    order; in each, ``step`` relaxes the frontier (the pending nodes of
    the bucket) until it is empty.

    ``step(dist, pending, frontier) -> (dist, pending)``.  On the card
    both loops run in one CUDA graph, a WHILE node over buckets whose
    body holds the settle WHILE node
    (:func:`~graph_tpu_torch.engine.loop.device_while`, captured once per
    ``cache[key]``); on the CPU they are host loops that read whether the
    bucket is empty each settle step and the next bucket each bucket.
    Returns (dist, settle steps, host reads).
    """
    delta = float(np.float32(delta))

    def in_bucket(dist, pending, curr_bin):
        return pending & (kernels.bucket_of(dist, delta) == curr_bin)

    def settle_step(state):
        dist, pending, curr_bin, _, more = state
        dist, pending = step(dist, pending, in_bucket(dist, pending,
                                                      curr_bin))
        return (dist, pending, curr_bin,
                in_bucket(dist, pending, curr_bin).any(), more)

    def next_bucket(state):
        dist, pending, _, _, _ = state
        # the next bucket: the least over the pending nodes
        curr_bin = torch.where(pending, kernels.bucket_of(dist, delta),
                               kernels.IMAX).min()
        return (dist, pending, curr_bin,
                in_bucket(dist, pending, curr_bin).any(),
                curr_bin != kernels.IMAX)

    curr_bin = torch.zeros((), dtype=torch.int32, device=dist.device)
    state = (dist, pending, curr_bin,
             in_bucket(dist, pending, curr_bin).any(), True)
    run = device_while((While(settle_step, Flag(3)), next_bucket), state,
                       Flag(4), cache=cache, key=key)
    return run.state[0], run.inner[0], run.host_reads


def _delta_stepping_device(in_sources: torch.Tensor,
                           in_targets: torch.Tensor,
                           in_weights: torch.Tensor, start_node: int,
                           delta: float, n: int, *,
                           cache: Optional[dict] = None
                           ) -> Tuple[torch.Tensor, int, int]:
    """Delta-stepping with dense bucket masks (``engine="xla"``).

    Each settle step relaxes all out-edges of the frontier with one
    gather and a segment-min over the in-CSR (in_sources: (m,) dst row
    ids, ascending; in_targets: (m,) sources; in_weights: (m,) f32).
    Returns (dist, settle steps, host reads); unreached = f32::MAX.
    """
    device = in_targets.device
    targets = in_targets.long()
    dist = torch.full((n,), float(INF), dtype=torch.float32, device=device)
    dist[start_node] = 0.0
    pending = torch.zeros(n, dtype=torch.bool, device=device)
    pending[start_node] = True

    def step(dist, pending, frontier):
        pending = pending & ~frontier
        cand = torch.where(frontier[targets], dist[targets] + in_weights,
                           float(INF))
        new_dist = torch.minimum(dist, segment_min_sorted(cand, in_sources,
                                                          n))
        return new_dist, pending | (new_dist < dist)

    return _settle(dist, pending, delta, step, cache=cache,
                   key=("xla", float(np.float32(delta))))


def _sssp_frontier_device(adj_t: torch.Tensor, adj_w: torch.Tensor,
                          start_node: int, delta: float,
                          cap: int = _FRONTIER_CAP, *,
                          cache: Optional[dict] = None
                          ) -> Tuple[torch.Tensor, int, int]:
    """Compacted-frontier delta-stepping (``engine="frontier"``).

    adj_t: (n+1, D) int32 out-targets, pad rows and slots = n; adj_w:
    (n+1, D) f32 weights, pad = f32::MAX.  Each settle step takes the
    first ``cap`` frontier ids in ascending order, padded with n
    (``torch.nonzero_static``, ``graph_tpu``'s ``jnp.nonzero(size=cap,
    fill_value=n)``: no host read), gathers their adjacency rows and
    scatter-mins the relaxations; pad slots target row n with f32::MAX,
    never an improvement.  Returns (dist[:n], settle steps, host reads).
    """
    n = adj_t.shape[0] - 1
    device = adj_t.device
    dist = torch.full((n + 1,), float(INF), dtype=torch.float32,
                      device=device)
    dist[start_node] = 0.0
    pending = torch.zeros(n + 1, dtype=torch.bool, device=device)
    pending[start_node] = True

    def step(dist, pending, frontier):
        ids = torch.nonzero_static(frontier, size=cap,
                                   fill_value=n).flatten()
        pending = pending.index_fill(0, ids, False)
        cand = (dist[ids][:, None] + adj_w[ids]).reshape(-1)
        new_dist = dist.scatter_reduce(0, adj_t[ids].reshape(-1).long(),
                                       cand, "amin")
        return new_dist, pending | (new_dist < dist)

    dist, steps, reads = _settle(dist, pending, delta, step, cache=cache,
                                 key=("frontier", float(np.float32(delta)),
                                      cap))
    return dist[:n], steps, reads


def _max_out_degree(graph: DirectedCsrGraph) -> int:
    """Max out-degree as a host int (one read, cached per graph)."""
    return engine_for(graph, "max_out_degree", lambda: int(
        graph.out_degrees().max()) if graph.edge_count else 0)


def _frontier_adjacency(graph: DirectedCsrGraph):
    """The out-CSR packed into a degree-padded (n+1, D) adjacency: targets
    (pad = n) and f32 weights (pad = f32::MAX), cached per graph."""
    n = graph.node_count
    d_max = max(1, _max_out_degree(graph))
    if (n + 1) * d_max >= (1 << 31):
        raise ValueError(
            f"frontier engine needs (n+1)*max_degree < 2^31, got "
            f"{n + 1} * {d_max}; use engine='plan' or 'xla'")

    def build():
        csr = graph.csr_out
        srcs = csr.sources.long()
        pos = torch.arange(srcs.numel(), device=srcs.device) - \
            csr.offsets.long()[srcs]
        flat = srcs * d_max + pos
        adj_t = torch.full(((n + 1) * d_max,), n, dtype=torch.int32,
                           device=srcs.device)
        adj_t[flat] = csr.targets.to(torch.int32)
        adj_w = torch.full(((n + 1) * d_max,), float(INF),
                           dtype=torch.float32, device=srcs.device)
        adj_w[flat] = csr.values.to(torch.float32)
        return adj_t.view(n + 1, d_max), adj_w.view(n + 1, d_max)

    return engine_for(graph, "frontier_adj", build)


def _sssp_frontier(graph: DirectedCsrGraph, config) -> SsspResult:
    """:func:`_sssp_frontier_device` over the graph's padded adjacency
    (``engine="frontier"`` on the CPU)."""
    adj_t, adj_w = _frontier_adjacency(graph)
    with profile.span("sssp.run") as sp:
        start = time.perf_counter()
        dist, steps, reads = _sssp_frontier_device(
            adj_t, adj_w, int(config.start_node), config.delta,
            cap=_FRONTIER_CAP, cache=engine_for(graph, "loops", dict))
        synchronize(dist.device)
        micros = int((time.perf_counter() - start) * 1e6)
        if sp:
            sp.count(rounds=steps,
                     relaxed=steps * _FRONTIER_CAP * adj_t.shape[1])
    return SsspResult(distances=dist, micros=micros, ran_iterations=steps,
                      host_reads=reads)


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
    eng = _weighted_engine(graph)

    def body(state, out=None):
        dist, _ = state
        nd = torch.minimum(dist, eng.relax(dist, internal=True),
                           out=into(out, 0))
        return nd, (nd != dist).any()

    with profile.span("sssp.run") as sp:
        start = time.perf_counter()
        if eng.perm is not None:  # iterate in the plan's internal order
            s = eng.perm[s : s + 1]
        dist = torch.full((n,), _PLAN_INF, dtype=torch.float32,
                          device=eng.device)
        dist[s] = 0.0
        run = device_while(body, (dist, True), Flag(1), cache=eng.loops,
                           key="sssp")
        dist = eng.to_public(run.state[0])
        synchronize(dist.device)
        micros = int((time.perf_counter() - start) * 1e6)
        if sp:
            sp.count(rounds=run.iterations,
                     relaxed=run.iterations * eng.plan.m)
    # unreached sentinel: the reference keeps f32::MAX (sssp.rs:12)
    dist = dist.masked_fill(dist >= _PLAN_INF, float(INF))
    return SsspResult(distances=dist, micros=micros,
                      ran_iterations=run.iterations,
                      host_reads=run.host_reads)
