"""PageRank as a pull-mode SpMV iteration.

Counterpart of ``graph_tpu.algos.pagerank`` (reference analog:
``page_rank``, crates/algos/src/page_rank.rs:58-168; defaults
max_iterations=20, tolerance=1e-4, damping=0.85).  Strict Jacobi:
``scores = (1-d)/n + d * spmv(scores / outdeg)`` with an L1 residual.
Three engines compute the spmv:

* ``"plan"``: the EdgeEngine (K1 + K2), in the plan's internal node
  order, permuted back once at the end; the rest of an iteration runs
  in two kernels of its own, one before K1 and one after K2
  (``jacobi_quantize``, ``jacobi_update``), except with ``log_progress``;
* ``"cumsum"``: a gather over the in-CSR and
  :func:`~graph_tpu_torch.ops.segment.segment_sum_fixedpoint`, the same
  int32 quanta as the plan, so the same scores bit for bit;
* ``"scatter"``: the gather and an f32 ``index_add_``
  (:func:`~graph_tpu_torch.ops.segment.segment_sum_sorted`), whose order
  of additions on a card is not fixed.

``"auto"`` runs the plan engine, on the card the fastest of the engines
that give ``graph_tpu``'s numbers (plan and cumsum) at every size
chip_smoke times; ``"scatter"`` is faster on small graphs but its f32
sums are other numbers, so ``"auto"`` never picks it (PERF.md).

The loop stops on the JAX ``while_loop``'s condition, ``it <
max_iterations and err >= tolerance``.  On the card it runs on the
device (:func:`graph_tpu_torch.engine.loop.device_while`: one CUDA graph
with a conditional WHILE node, captured once per engine and damping
factor), and the host reads the iteration count and the residual once,
after the loop.  On the CPU it is a host loop that reads the residual
every iteration; with ``tolerance <= 0`` the residual cannot stop it, so
it reads it once at the end.  ``log_progress=True`` reads and logs it
every iteration, in a host loop on any device.

Under a default mesh of more than one shard
(:func:`graph_tpu_torch.parallel.use_mesh`) ``"auto"`` runs the sharded
paths of :mod:`graph_tpu_torch.parallel.pagerank` instead
(:func:`~graph_tpu_torch.parallel.pagerank.page_rank_meshed`); a pinned
engine keeps the single-device path.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from graph_tpu_torch import profile
from graph_tpu_torch.device import synchronize, to_host
from graph_tpu_torch.engine.engine import EdgeEngine, engine_for
from graph_tpu_torch.engine.kernels import (
    jacobi_quantize, jacobi_update, jacobi_work)
from graph_tpu_torch.engine.loop import (
    Residual, device_while, host_while, into)
from graph_tpu_torch.graph.csr import DirectedCsrGraph
from graph_tpu_torch.ops.segment import (
    segment_sum_fixedpoint, segment_sum_sorted)

logger = logging.getLogger(__name__)

ENGINES = ("auto", "plan", "cumsum", "scatter")
#: The name of each Jacobi iteration's region in a profiler trace.
ITERATION = "page_rank.iteration"


@dataclasses.dataclass(frozen=True)
class PageRankConfig:
    """Reference analog: ``PageRankConfig`` (page_rank.rs:17-56).

    ``engine``: "plan" (the EdgeEngine), "cumsum" (int32 fixed-point
    prefix sums over the in-CSR), "scatter" (f32 ``index_add_``), or
    "auto" (the plan engine).
    """

    max_iterations: int = 20
    tolerance: float = 1e-4
    damping_factor: float = 0.85
    engine: str = "auto"
    #: Log error and time per iteration like the reference app
    #: (page_rank.rs:98-103), at one host read per iteration.
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
    #: values the host read back from the device during the run
    host_reads: int = 0

    def scores_np(self) -> np.ndarray:
        return to_host(self.scores)


def page_rank(graph: DirectedCsrGraph,
              config: Optional[PageRankConfig] = None) -> PageRankResult:
    """PageRank scores of a directed graph, on the graph's device.

    Returns scores, the number of iterations ran and the final L1 error,
    mirroring ``page_rank(&g, PageRankConfig) -> (Vec<f32>, usize, f64)``
    (page_rank.rs:58).
    """
    config = config or PageRankConfig()
    if config.engine not in ENGINES:
        raise ValueError(f"unknown PageRank engine {config.engine!r}")
    from graph_tpu_torch.parallel.mesh import _default_mesh

    mesh = _default_mesh()
    if mesh is not None and config.engine != "auto":
        # an explicit engine pin wins over the installed default mesh
        # (the sharded paths have no "plan"/"cumsum"/"scatter" engines)
        logger.info("page_rank: explicit engine=%r pins the single-device "
                    "path; default mesh ignored", config.engine)
        mesh = None
    if mesh is not None:
        if config.log_progress:
            logger.info("page_rank: log_progress is not supported on the "
                        "meshed path; running without per-iteration logs")
        from graph_tpu_torch.parallel.pagerank import page_rank_meshed

        return page_rank_meshed(graph, mesh, config)
    engine = "plan" if config.engine == "auto" else config.engine
    return _run(graph, config, engine, config.log_progress)


def _inv_outdeg(outdeg: torch.Tensor) -> torch.Tensor:
    """1 / out-degree in f32, 0 where a node has no out-edge (its score is
    never gathered; the reference divides by zero, page_rank.rs:75-79)."""
    outdeg = outdeg.to(torch.float32)
    return torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1.0), 0.0)


def _scalars(n: int, damping_factor: float) -> Tuple[float, float, float]:
    """(init, base, d): the Jacobi loop's f32 scalars as XLA compiles
    graph_tpu's, where a division by the constant n becomes a product
    with its f32 reciprocal: init = 1/n, base = (1-d)·init."""
    damping = np.float32(damping_factor)
    init = np.float32(1.0) / np.float32(n)
    return float(init), float((np.float32(1.0) - damping) * init), \
        float(damping)


def _update(y: torch.Tensor, base: float, d: float,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``base + d * y`` with one rounding (a fused multiply-add), as XLA
    compiles graph_tpu's update; into ``out`` when given."""
    out = torch.full_like(y, base) if out is None else out.fill_(base)
    return out.add_(y, alpha=d)


def _jacobi(sums: Callable[[torch.Tensor], torch.Tensor],
            inv_outdeg: torch.Tensor, max_iterations: int, tolerance: float,
            damping_factor: float, log: bool = False, *,
            cache: Optional[dict] = None, key=None,
            quanta: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, int, float, int]:
    """The Jacobi loop every engine runs: ``sums(out_scores)`` is its
    spmv.  Returns (scores, iterations, error, host reads).

    ``quanta`` (the plan engine's :meth:`EdgeEngine.sum_quanta`, K1 and
    K2 over int32 quanta) gives the body of :func:`_tails_body`, unless
    ``log``: the same scores, its n-sized work in two kernels.

    ``graph_tpu``'s ``while_loop``
    (:func:`~graph_tpu_torch.engine.loop.device_while`): on the card one
    conditional CUDA graph, captured once per ``cache[key]``, and one
    host read after the loop; on the CPU the
    host loop, which reads the residual every iteration when it can stop
    the loop, else once at the end.  ``log`` reads and logs it every
    iteration, in a host loop on any device.
    """
    n = inv_outdeg.numel()
    init, base, d = _scalars(n, damping_factor)
    scores = torch.full((n,), init, dtype=torch.float32,
                        device=inv_outdeg.device)

    def body(state, out=None):
        # out-scores are the scores times 1/outdeg, taken at the top of
        # the body: the same bits as graph_tpu's carried out_scores, and
        # no second vector carried from round to round
        scores, _, inv = state
        with profile.annotate(ITERATION):
            new_scores = _update(sums(scores * inv), base, d, into(out, 0))
            err = torch.sum(torch.abs(new_scores - scores))
            return new_scores, err, inv

    state = (scores, float("inf"), inv_outdeg)
    cond = Residual(1, max_iterations, tolerance)
    if log:
        run = host_while(_logged(body), state, cond)
        # one read an iteration, the logged residual's
        return run.state[0], run.iterations, run.value, run.iterations
    if quanta is not None:
        body = _tails_body(quanta, base, d, n, inv_outdeg.device)
    run = device_while(body, state, cond, cache=cache, key=key)
    return run.state[0], run.iterations, float(run.value), run.host_reads


def _tails_body(quanta: Callable[[torch.Tensor], torch.Tensor], base: float,
                d: float, n: int, device: torch.device) -> Callable:
    """The plan engine's Jacobi body: ``jacobi_quantize``, K1 and K2
    (``quanta``), then ``jacobi_update`` with the residual, into the
    loop's buffers when it gives them.  Each kernel's plain version is
    the op chain of :func:`_jacobi`'s body, so on the CPU the two bodies
    are one computation; on the card the scores have the same bits and
    the residual is summed in another order."""
    work = None if device.type == "cpu" else jacobi_work(n, device)

    def body(state, out=None):
        scores, _, inv = state
        with profile.annotate(ITERATION):
            new_scores, err = jacobi_update(
                quanta(jacobi_quantize(scores, inv)), scores, base, d,
                into(out, 0), into(out, 1), work)
            return new_scores, err, inv

    return body


def _logged(body):
    """``body`` reading its residual back and logging it with the
    iteration's seconds (``graph_tpu``'s ``_page_rank_logged``)."""
    it = 0

    def logged(state):
        nonlocal it
        t0 = time.perf_counter()
        scores, err, inv = body(state)
        err = err.item()  # host read: the residual, logged
        it += 1
        logger.info("PageRank iteration %d finished with an error of "
                    "%.3e in %.3fs", it, err, time.perf_counter() - t0)
        return scores, err, inv

    return logged


def _csr_sums(in_sources, in_targets, in_offsets, engine: str):
    """The spmv of the ``"cumsum"`` or ``"scatter"`` engine over the
    in-CSR: gather ``out_scores[in_targets]``, then segment-sum."""
    n = in_offsets.numel() - 1
    targets = in_targets.long()
    if engine == "cumsum":
        # row sums are bounded by sum(out_scores) <= sum(scores) = 1
        return lambda x: segment_sum_fixedpoint(x[targets], in_offsets,
                                                bound=1.0)
    if engine == "scatter":
        return lambda x: segment_sum_sorted(x[targets], in_sources, n)
    raise ValueError(f"engine must be cumsum|scatter, got {engine!r}")


def _page_rank_device(in_sources: torch.Tensor, in_targets: torch.Tensor,
                      in_offsets: torch.Tensor, out_degrees: torch.Tensor,
                      *, max_iterations: int, tolerance: float,
                      damping_factor: float, engine: str = "cumsum"
                      ) -> Tuple[torch.Tensor, int, float, int]:
    """PageRank over the in-CSR with the ``"cumsum"`` or ``"scatter"``
    engine, on the arrays' device.

    in_sources: (m,) destination row of each in-edge, ascending;
    in_targets: (m,) its source; in_offsets: (n+1,) the in-CSR offsets;
    out_degrees: (n,).  Returns (scores, iterations, error, host reads).
    """
    return _jacobi(_csr_sums(in_sources, in_targets, in_offsets, engine),
                   _inv_outdeg(out_degrees), max_iterations, tolerance,
                   damping_factor)


def page_rank_reference(out_neighbors_by_node, node_count: int,
                        config: Optional[PageRankConfig] = None
                        ) -> Tuple[np.ndarray, int, float]:
    """Host model of the reference's exact schedule, for test parity.

    For graphs below the reference's CHUNK_SIZE (16384 nodes) the Rust
    implementation degenerates to a deterministic *sequential
    Gauss-Seidel* sweep in node order (one chunk, in-place ``out_scores``
    updates, page_rank.rs:127-165).  This numpy model reproduces its
    pinned golden floats exactly and supplies expected values for
    arbitrary small test graphs.
    """
    config = config or PageRankConfig()
    n = node_count
    in_nbrs = [[] for _ in range(n)]
    out_deg = np.zeros(n, dtype=np.int64)
    for u, nbrs in enumerate(out_neighbors_by_node):
        for v in nbrs:
            out_deg[u] += 1
            in_nbrs[v].append(u)

    d = np.float32(config.damping_factor)
    base = (np.float32(1.0) - d) / np.float32(n)
    init = np.float32(1.0) / np.float32(n)
    scores = np.full(n, init, dtype=np.float32)
    with np.errstate(divide="ignore"):
        out_scores = np.where(
            out_deg > 0, init / out_deg.astype(np.float32), np.float32(np.inf)
        ).astype(np.float32)

    iteration = 0
    while True:
        err = 0.0
        for u in range(n):
            s = np.float32(0.0)
            for v in in_nbrs[u]:
                s += out_scores[v]
            new = base + d * s
            err += abs(float(new) - float(scores[u]))
            scores[u] = new
            if out_deg[u] > 0:
                out_scores[u] = new / np.float32(out_deg[u])
        iteration += 1
        if err < config.tolerance or iteration == config.max_iterations:
            return scores, iteration, err


def _graph_engine(graph: DirectedCsrGraph) -> EdgeEngine:
    """Build (and cache per graph identity) the forward-edge EdgeEngine,
    with the degree relabel, on the graph's device."""
    return engine_for(graph, "fwd", lambda: EdgeEngine.build(
        graph.csr_out.sources, graph.csr_out.targets, graph.node_count,
        relabel="degree", device=graph.device))


def _run(graph: DirectedCsrGraph, config: PageRankConfig, engine: str,
         log: bool) -> PageRankResult:
    """One engine's Jacobi loop on the graph, timed.

    The plan engine iterates in its internal node order; its per-edge
    sums, like ``"cumsum"``'s, carry 2**-30 fixed-point quantization
    (bounded by sum(scores) = 1), far inside the reference's 1e-4
    tolerance regime.  ``log`` (``config.log_progress``) logs error and
    time each iteration like the reference app (page_rank.rs:98-103), at
    one host read per iteration; the scores are the unlogged run's.
    """
    quanta = None
    if engine == "plan":
        eng = _graph_engine(graph)
        sums = lambda x: eng.spmv(x, internal=True)  # noqa: E731
        quanta = eng.sum_quanta
        to_internal, to_public = eng.to_internal, eng.to_public
        loops = eng.loops
    else:
        sums = _csr_sums(graph.csr_in.sources, graph.csr_in.targets,
                         graph.csr_in.offsets, engine)
        to_internal = to_public = lambda v: v  # noqa: E731
        loops = engine_for(graph, "loops", dict)
    with profile.span("page_rank.run") as sp:
        start = time.perf_counter()
        # the captured loop bakes in the damping factor; limits are per run
        scores, it, err, reads = _jacobi(
            sums, to_internal(_inv_outdeg(graph.out_degrees())),
            int(config.max_iterations), config.tolerance,
            config.damping_factor, log, cache=loops,
            key=("page_rank", engine,
                 float(np.float32(config.damping_factor))), quanta=quanta)
        scores = to_public(scores)
        synchronize(scores.device)
        micros = int((time.perf_counter() - start) * 1e6)
        if sp:
            sp.count(rounds=it)
    return PageRankResult(scores=scores, ran_iterations=it, error=err,
                          micros=micros, host_reads=reads)
