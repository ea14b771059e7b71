"""Weakly connected components: min-label propagation with pointer jumps.

Counterpart of ``graph_tpu.algos.wcc`` (reference analog: ``wcc_baseline``
/ ``wcc_afforest`` / ``wcc_afforest_dss``, crates/algos/src/wcc.rs:103-183).
Connectivity is a min-label fixed point over the symmetrized edges:

    comp[u] <- min(comp[u], min over neighbors v of comp[v])   (hook)
    comp <- comp[comp], twice                                  (jump)

repeated until nothing changes.  At the fixed point ``comp[u]`` is the
smallest node id in u's component.  Two engines hook:

* ``"plan"``: one EdgeEngine ``smin_int`` pass (K1 gather + K2 ``imin``)
  over the symmetrized edges, int32 labels;
* ``"xla"``: two segment-mins (``scatter_reduce_``), one per CSR
  direction (an undirected graph's one CSR serves both), labels in the
  graph's id dtype.

Jumps are n-sized index gathers.  The rounds run until a "changed" flag
is false: on the card inside one CUDA graph with a conditional WHILE
node (:func:`graph_tpu_torch.engine.loop.device_while`), the host reading
the round count once at the end; on the CPU a host loop that reads the
flag every round.  Both engines give the same labels in
the same rounds; ``"auto"`` runs the plan engine, on the card the faster
from RMAT 14 up and within launch noise below (PERF.md).
The three reference variants compute the same fully specified partition
and all map onto it, as in graph_tpu.

Under a default mesh of more than one shard
(:func:`graph_tpu_torch.parallel.use_mesh`) ``"auto"`` runs the sharded
WCC of :mod:`graph_tpu_torch.parallel.wcc` instead
(:func:`~graph_tpu_torch.parallel.wcc.wcc_meshed`); a pinned engine or
a given ``device`` keeps the single-device path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from graph_tpu_torch import profile
from graph_tpu_torch.device import run_device, synchronize, to_host
from graph_tpu_torch.dtypes import check_node_count_fits
from graph_tpu_torch.engine.engine import EdgeEngine, engine_for
from graph_tpu_torch.engine.loop import Flag, device_while, into
from graph_tpu_torch.graph.csr import DirectedCsrGraph, UndirectedCsrGraph
from graph_tpu_torch.ops.segment import segment_min_sorted


@dataclasses.dataclass(frozen=True)
class WccConfig:
    """Reference analog: ``WccConfig`` (wcc.rs:43-79).

    The fields are accepted for parity with the reference API; the
    min-label algorithm has no chunking or sampling phase, so they do
    not change the result.  ``engine``: "plan" (the EdgeEngine), "xla"
    (segment-mins over both CSR directions) or "auto" (the plan engine).
    """

    chunk_size: int = 16384
    neighbor_rounds: int = 2
    sampling_size: int = 1024
    engine: str = "auto"

    DEFAULT_CHUNK_SIZE = 16384
    DEFAULT_NEIGHBOR_ROUNDS = 2
    DEFAULT_SAMPLING_SIZE = 1024


@dataclasses.dataclass(frozen=True)
class WccResult:
    """Reference analog: the ``Components`` trait (wcc.rs:95-99) + mate's
    ``WccResult`` (crates/mate/src/wcc.rs:43-88)."""

    components: torch.Tensor  # (n,) id dtype — component = min node id
    ran_iterations: int
    micros: int
    #: values the host read back from the device during the run
    host_reads: int = 0

    def component(self, node: int) -> int:
        return int(self.components[node])

    def components_np(self) -> np.ndarray:
        return to_host(self.components)


def wcc(graph: Union[DirectedCsrGraph, UndirectedCsrGraph],
        config: Optional[WccConfig] = None, *, device=None) -> WccResult:
    """Weakly connected components of a directed or undirected graph, on
    ``device`` (by default the graph's own; see
    :func:`graph_tpu_torch.device.run_device`).

    Mirrors ``wcc_afforest_dss(&g, WccConfig) -> impl Components``
    (wcc.rs:144).

    >>> from graph_tpu_torch import build_directed, wcc
    >>> g = build_directed([0, 2], [1, 3], device="cpu")
    >>> wcc(g).components_np().tolist()
    [0, 0, 2, 2]
    """
    from graph_tpu_torch.parallel.mesh import _default_mesh

    config = config or WccConfig()
    mesh = _default_mesh()
    if mesh is not None and config.engine == "auto" and device is None:
        from graph_tpu_torch.parallel.wcc import wcc_meshed

        return wcc_meshed(graph, mesh, config)
    if config.engine == "xla":
        return _wcc_xla(graph, device)
    if config.engine not in ("auto", "plan"):
        raise ValueError(f"unknown WCC engine {config.engine!r}")
    return _wcc_plan(graph, device)


def wcc_components(graph, config: Optional[WccConfig] = None, *,
                   device=None) -> torch.Tensor:
    """Convenience: just the component-id array."""
    return wcc(graph, config, device=device).components


def wcc_baseline(graph, config: Optional[WccConfig] = None, *,
                 device=None) -> WccResult:
    """Reference analog: ``wcc_baseline`` (wcc.rs:103) — link every edge.

    All three reference variants compute the same fully specified
    partition; they differ only in CPU work-skipping heuristics, so each
    maps onto the same min-label fixed point here.
    """
    return wcc(graph, config, device=device)


def wcc_afforest(graph, config: Optional[WccConfig] = None, *,
                 device=None) -> WccResult:
    """Reference analog: ``wcc_afforest`` (wcc.rs:127); see
    :func:`wcc_baseline`."""
    return wcc(graph, config, device=device)


def wcc_afforest_dss(graph, config: Optional[WccConfig] = None, *,
                     device=None) -> WccResult:
    """Reference analog: ``wcc_afforest_dss`` (wcc.rs:144); see
    :func:`wcc_baseline`."""
    return wcc(graph, config, device=device)


def _sym_engine(graph, device=None) -> EdgeEngine:
    """EdgeEngine over the symmetrized edge list (weakly connected),
    where the graph runs.  No relabel: labels are public node ids."""
    device = run_device(graph, device)

    def build():
        if isinstance(graph, UndirectedCsrGraph):
            src, dst = graph.csr.sources, graph.csr.targets
        else:
            s0, t0 = graph.csr_out.sources, graph.csr_out.targets
            src, dst = torch.cat([s0, t0]), torch.cat([t0, s0])
        return EdgeEngine.build(src, dst, graph.node_count, device=device)

    return engine_for(graph, ("sym", device), build)


def _wcc_plan(graph, device=None) -> WccResult:
    """Min-label propagation with the EdgeEngine's integer segment-min.

    Labels are int32 node ids end to end; each round is one hook over
    the symmetrized edges and two pointer jumps, and the loop is
    ``graph_tpu``'s ``while_loop`` on a changed flag
    (:func:`~graph_tpu_torch.engine.loop.device_while`, cached on the
    engine).
    """
    n = graph.node_count
    check_node_count_fits(n, np.int32)  # labels are int32 node ids
    eng = _sym_engine(graph, device)

    def body(state, out=None):
        comp, _ = state
        new = torch.minimum(comp, eng.smin_int(comp, internal=True))
        new = new[new]          # jump (squares pointer chains)
        new = torch.index_select(new, 0, new, out=into(out, 0))
        return new, (new != comp).any()

    with profile.span("wcc.run") as sp:
        start = time.perf_counter()
        comp = torch.arange(n, dtype=torch.int32, device=eng.device)
        run = device_while(body, (comp, True), Flag(1), cache=eng.loops,
                           key="wcc")
        comp = run.state[0]
        synchronize(comp.device)
        micros = int((time.perf_counter() - start) * 1e6)
        if sp:
            sp.count(rounds=run.iterations)
    ids = (graph.csr.targets if isinstance(graph, UndirectedCsrGraph)
           else graph.csr_out.targets)
    return WccResult(components=comp.to(ids.dtype),
                     ran_iterations=run.iterations, micros=micros,
                     host_reads=run.host_reads)


def _wcc_device(fwd_sources: torch.Tensor, fwd_targets: torch.Tensor,
                bwd_sources: torch.Tensor, bwd_targets: torch.Tensor,
                n: int, *, cache: Optional[dict] = None
                ) -> Tuple[torch.Tensor, int, int]:
    """Min-label propagation with two sorted segment-mins per round, one
    per CSR direction, on the arrays' device.

    Labels take the targets' id dtype; an empty segment's min is the
    dtype's max, so it never lowers a label.  The loop is
    :func:`~graph_tpu_torch.engine.loop.device_while` on a changed flag,
    its capture kept in ``cache``.  Returns (labels, rounds, host reads).
    """
    comp = torch.arange(n, dtype=fwd_targets.dtype,
                        device=fwd_targets.device)
    fwd_t, bwd_t = fwd_targets.long(), bwd_targets.long()

    def body(state, out=None):
        comp, _ = state
        # hook: pull the minimum label across both edge directions
        m_out = segment_min_sorted(comp[fwd_t], fwd_sources, n)
        m_in = segment_min_sorted(comp[bwd_t], bwd_sources, n)
        new = torch.minimum(comp, torch.minimum(m_out, m_in))
        new = new[new.long()]  # jump: two squarings per round
        new = torch.index_select(new, 0, new.long(), out=into(out, 0))
        return new, (new != comp).any()

    run = device_while(body, (comp, True), Flag(1), cache=cache,
                       key=("wcc_xla", comp.device))
    return run.state[0], run.iterations, run.host_reads


def _wcc_xla(graph, device=None) -> WccResult:
    """``engine="xla"``: :func:`_wcc_device` over the graph's CSRs, where
    the graph runs (:func:`~graph_tpu_torch.device.run_device`)."""
    device = run_device(graph, device)
    if isinstance(graph, UndirectedCsrGraph):
        fwd = bwd = graph.csr  # both directions already in the one CSR
    else:
        fwd, bwd = graph.csr_out, graph.csr_in
    arrays = [a.to(device) for a in (fwd.sources, fwd.targets,
                                     bwd.sources, bwd.targets)]
    with profile.span("wcc.run") as sp:
        start = time.perf_counter()
        comp, iters, reads = _wcc_device(
            *arrays, graph.node_count,
            cache=engine_for(graph, "loops", dict))
        synchronize(comp.device)
        micros = int((time.perf_counter() - start) * 1e6)
        if sp:
            sp.count(rounds=iters)
    return WccResult(components=comp, ran_iterations=iters, micros=micros,
                     host_reads=reads)
