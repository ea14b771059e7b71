"""PageRank as a pull-mode SpMV iteration on the EdgeEngine.

Counterpart of ``graph_tpu.algos.pagerank`` (reference analog:
``page_rank``, crates/algos/src/page_rank.rs:58-168; defaults
max_iterations=20, tolerance=1e-4, damping=0.85).  Strict Jacobi:
``scores = (1-d)/n + d * spmv(scores / outdeg)`` with an L1 residual,
run in the plan's internal node order and permuted back once at the end.

Only the plan engine is ported.  The loop stops on the JAX
``while_loop``'s condition, ``it < max_iterations and err >= tolerance``;
with ``tolerance <= 0`` the residual cannot stop it, so the host reads
the residual once at the end instead of once per iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from graph_tpu_torch.device import synchronize
from graph_tpu_torch.engine.engine import EdgeEngine, engine_for
from graph_tpu_torch.errors import not_ported
from graph_tpu_torch.graph.csr import DirectedCsrGraph


@dataclasses.dataclass(frozen=True)
class PageRankConfig:
    """Reference analog: ``PageRankConfig`` (page_rank.rs:17-56).

    ``engine``: "plan" (the EdgeEngine) and "auto" run the ported plan
    path; "cumsum" and "scatter" are not ported yet.
    """

    max_iterations: int = 20
    tolerance: float = 1e-4
    damping_factor: float = 0.85
    engine: str = "auto"
    #: Per-iteration logging like the reference app (not ported yet).
    log_progress: bool = False

    DEFAULT_MAX_ITERATIONS = 20
    DEFAULT_TOLERANCE = 1e-4
    DEFAULT_DAMPING_FACTOR = 0.85


@dataclasses.dataclass(frozen=True)
class PageRankResult:
    """Reference analog: ``(Vec<f32>, usize, f64)`` + mate's
    ``PageRankResult`` (crates/mate/src/page_rank.rs:42-74)."""

    scores: torch.Tensor  # (n,) f32, on the graph's device
    ran_iterations: int
    error: float
    micros: int

    def scores_np(self) -> np.ndarray:
        return self.scores.cpu().numpy()


def page_rank(graph: DirectedCsrGraph,
              config: Optional[PageRankConfig] = None) -> PageRankResult:
    """PageRank scores of a directed graph, on the graph's device.

    Returns scores, the number of iterations ran and the final L1 error,
    mirroring ``page_rank(&g, PageRankConfig) -> (Vec<f32>, usize, f64)``
    (page_rank.rs:58).
    """
    config = config or PageRankConfig()
    if config.log_progress:
        raise not_ported("log_progress=True")
    if config.engine in ("cumsum", "scatter"):
        raise not_ported(f"engine={config.engine!r}")
    if config.engine not in ("auto", "plan"):
        raise ValueError(f"unknown PageRank engine {config.engine!r}")
    return _page_rank_plan(graph, config)


def _graph_engine(graph: DirectedCsrGraph) -> EdgeEngine:
    """Build (and cache per graph identity) the forward-edge EdgeEngine,
    with the degree relabel, on the graph's device."""
    return engine_for(graph, "fwd", lambda: EdgeEngine.build(
        graph.csr_out.sources, graph.csr_out.targets, graph.node_count,
        relabel="degree", device=graph.device))


def _page_rank_plan(graph: DirectedCsrGraph,
                    config: PageRankConfig) -> PageRankResult:
    """PageRank via the EdgeEngine's SpMV kernels.

    Per-edge sums carry 2**-30 fixed-point quantization (bounded by
    sum(scores) = 1), far inside the reference's 1e-4 tolerance regime.
    """
    eng = _graph_engine(graph)
    n = graph.node_count
    # f32 scalars as the JAX driver computes them
    damping = np.float32(config.damping_factor)
    nf = np.float32(n)
    init = float(np.float32(1.0) / nf)
    base = float((np.float32(1.0) - damping) / nf)
    d = float(damping)
    tolerance = float(np.float32(config.tolerance))
    max_iterations = int(config.max_iterations)

    start = time.perf_counter()
    outdeg = eng.to_internal(graph.out_degrees().to(torch.float32))
    inv_outdeg = torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1.0), 0.0)
    scores = torch.full((n,), init, dtype=torch.float32, device=eng.device)
    out_scores = scores * inv_outdeg
    it, err, err_t = 0, float("inf"), None
    while it < max_iterations and err >= tolerance:
        y = eng.spmv(out_scores, internal=True)
        new_scores = base + d * y
        err_t = torch.sum(torch.abs(new_scores - scores))
        scores, out_scores = new_scores, new_scores * inv_outdeg
        it += 1
        if tolerance > 0:
            err = err_t.item()  # host sync: the residual decides the loop
    if err_t is not None:
        err = err_t.item()
    scores = eng.to_public(scores)
    synchronize(scores.device)
    micros = int((time.perf_counter() - start) * 1e6)
    return PageRankResult(scores=scores, ran_iterations=it, error=err,
                          micros=micros)
