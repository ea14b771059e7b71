"""Benchmark CLI: the algorithms run on a graph file, timed.

Counterpart of ``graph_tpu.cli`` (reference analog: the ``app`` binary,
crates/app/src/app.rs:41-153):

    python -m graph_tpu_torch.cli <page-rank|sssp|triangle-count|wcc|
        loading|serialize> -p <path> [-f edge-list|graph500]
        [--use-32-bit] [-r runs] [-w warmup-runs] [--platform default|cuda|cpu]

Differences from the reference: warm-up runs also build the kernels and
the EdgePlans the measured runs use; ``-g adjacency-list`` maps to the
edge-buffer graph.  ``--platform`` picks the device: ``default`` and
``cuda`` are the card (``default`` raises without one), ``cpu`` the CPU.
Ids are 64-bit unless ``--use-32-bit`` is given, as in the reference
(usize, app.rs:60-66); PyTorch has int64 natively, so unlike
``graph_tpu``'s CLI no 64-bit mode gates it.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time

import numpy as np

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.engine.plan import PLAN_CACHE_ENV

log = logging.getLogger("graph_tpu_torch.app")


def _common(parser):
    parser.add_argument("-p", "--path", required=True)
    parser.add_argument(
        "-f", "--format", choices=["edge-list", "graph500"], default="edge-list"
    )
    parser.add_argument(
        "-g",
        "--graph",
        choices=["csr", "adjacency-list"],
        default="csr",
        help="graph storage (adjacency-list = mutable edge buffer)",
    )
    parser.add_argument("--use-32-bit", action="store_true")
    parser.add_argument(
        "--plan-cache",
        default=None,
        metavar="DIR",
        help=f"persist compiled EdgePlans here (also ${PLAN_CACHE_ENV}); "
        "a second run on the same graph skips the plan build",
    )
    parser.add_argument("-r", "--runs", type=int, default=1)
    parser.add_argument("-w", "--warmup-runs", type=int, default=5)
    parser.add_argument("-v", "--verbose", action="count", default=1)
    parser.add_argument(
        "--platform",
        choices=["default", "cuda", "cpu"],
        default="default",
        help="where to run: default and cuda are the card (default raises "
        "without one), cpu the CPU",
    )
    parser.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="capture a torch.profiler trace of the timed runs to DIR "
        "(view in Perfetto or chrome://tracing)",
    )


def build_parser():
    p = argparse.ArgumentParser(prog="graph-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="algorithm", required=True)

    pr = sub.add_parser("page-rank")
    _common(pr)
    pr.add_argument("--max-iterations", type=int, default=20)
    pr.add_argument("--tolerance", type=float, default=1e-4)
    pr.add_argument("--damping-factor", type=float, default=0.85)

    ss = sub.add_parser("sssp")
    _common(ss)
    ss.add_argument("--start-node", type=int, required=True)
    ss.add_argument("--delta", type=float, required=True)

    tc = sub.add_parser("triangle-count")
    _common(tc)
    tc.add_argument("--relabel", action="store_true")

    wc = sub.add_parser("wcc")
    _common(wc)
    wc.add_argument("--chunk-size", type=int, default=16384)
    wc.add_argument("--neighbor-rounds", type=int, default=2)
    wc.add_argument("--sampling-size", type=int, default=1024)

    ld = sub.add_parser("loading")
    _common(ld)
    ld.add_argument("--undirected", action="store_true")
    ld.add_argument("--weighted", action="store_true")

    se = sub.add_parser("serialize")
    _common(se)
    se.add_argument("-o", "--output", required=True)
    se.add_argument("--undirected", action="store_true")

    return p


def timed_runs(runs: int, warmup_runs: int, f, profile_dir=None):
    """Reference ``time()`` analog (app.rs:124-153); optionally wraps
    the measured runs in a torch.profiler trace capture.  ``f`` returns
    once its work on the device is done (the algorithms synchronize)."""
    for run in range(1, warmup_runs + 1):
        t0 = time.perf_counter()
        f()
        log.info(
            "Warm-up run %d of %d finished in %.6fs",
            run,
            warmup_runs,
            time.perf_counter() - t0,
        )
    if profile_dir:
        from graph_tpu_torch.profile import trace

        ctx = trace(profile_dir)
    else:
        ctx = contextlib.nullcontext()
    durations = []
    with ctx:
        for run in range(1, runs + 1):
            t0 = time.perf_counter()
            f()
            took = time.perf_counter() - t0
            durations.append(took)
            log.info("Run %d of %d finished in %.6fs", run, runs, took)
    if durations:
        log.info("Average runtime: %.6fs", sum(durations) / len(durations))
    return durations


def _id_dtype(args):
    """Reference parity: the app defaults to 64-bit ids (usize) and
    ``--use-32-bit`` switches to u32 (app.rs:60-66).  PyTorch has int64
    natively, so 64-bit ids need no switch (``graph_tpu``'s CLI gates
    them on JAX's x64 mode)."""
    return np.int32 if args.use_32_bit else np.int64


def _device(args):
    """``--platform`` as a device: the card for ``default`` (raising
    without one) and ``cuda``, the CPU for ``cpu``."""
    return resolve_device(None if args.platform == "default"
                          else args.platform)


def _load(args, undirected=False, weighted=False):
    from graph_tpu_torch.builder import GraphBuilder
    from graph_tpu_torch.graph.csr import CsrLayout
    from graph_tpu_torch.io.edgelist import EdgeListInput
    from graph_tpu_torch.io.graph500 import Graph500Input

    device = _device(args)
    id_dtype = _id_dtype(args)
    fmt = (
        Graph500Input()
        if args.format == "graph500"
        else EdgeListInput(weighted=weighted or None)
    )
    undirected = getattr(args, "algorithm", "") == "triangle-count" or undirected
    layout = CsrLayout.DEDUPLICATED if undirected else CsrLayout.UNSORTED
    if args.graph == "adjacency-list":
        # `-g adjacency-list` benchmarks the mutable edge-buffer storage
        # (app.rs:71-76 analog): bulk-load into the AL graph, snapshot.
        from graph_tpu_torch.graph.adj import (
            DirectedALGraph, UndirectedALGraph)

        src, dst, values, node_count = fmt.read(args.path)
        if node_count is None:
            node_count = int(max(src.max(), dst.max())) + 1 if len(src) else 0
        cls = UndirectedALGraph if undirected else DirectedALGraph
        al = cls(node_count, edges=list(zip(src.tolist(), dst.tolist())),
                 values=values, layout=layout, id_dtype=id_dtype,
                 device=device)
        return al.snapshot()
    b = (GraphBuilder(device=device).id_dtype(id_dtype).file_format(fmt)
         .path(args.path))
    if undirected:
        return b.csr_layout(layout).build_undirected()
    return b.build_directed()


def main(argv=None):
    args = build_parser().parse_args(argv)
    if getattr(args, "plan_cache", None):
        os.environ[PLAN_CACHE_ENV] = args.plan_cache
    device = _device(args)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s - %(message)s",
    )
    log.info("Reading graph (%d bit) from: %s",
             np.dtype(_id_dtype(args)).itemsize * 8, args.path)

    if args.algorithm == "page-rank":
        from graph_tpu_torch.algos.pagerank import PageRankConfig, page_rank

        g = _load(args)
        # -v -v: per-iteration error/time lines, like the reference app
        # (page_rank.rs:98-103 logs each iteration at info level).
        # verbose counts from 1 (info is the default level), so two -v
        # flags reach 3 — a single -v must NOT trade the loop that reads
        # the residual only when it decides for a host read per iteration.
        cfg = PageRankConfig(args.max_iterations, args.tolerance,
                             args.damping_factor,
                             log_progress=args.verbose >= 3)

        def run():
            res = page_rank(g, cfg)
            log.info(
                "PageRank ran %d iterations with error %e",
                res.ran_iterations,
                res.error,
            )

        timed_runs(args.runs, args.warmup_runs, run, args.profile)

    elif args.algorithm == "sssp":
        from graph_tpu_torch.algos.sssp import (
            DeltaSteppingConfig, delta_stepping)

        g = _load(args, weighted=True)
        cfg = DeltaSteppingConfig(args.start_node, args.delta)
        timed_runs(args.runs, args.warmup_runs,
                   lambda: delta_stepping(g, cfg), args.profile)

    elif args.algorithm == "triangle-count":
        from graph_tpu_torch.algos.triangle_count import global_triangle_count
        from graph_tpu_torch.graph.ops import make_degree_ordered

        g = _load(args, undirected=True)
        if args.relabel:
            t0 = time.perf_counter()
            g = make_degree_ordered(g)
            log.info("Relabeled graph in %.3fs", time.perf_counter() - t0)

        def run():
            res = global_triangle_count(g, device=device)
            log.info("Computed %s triangles", f"{res.triangles:,}")

        timed_runs(args.runs, args.warmup_runs, run, args.profile)

    elif args.algorithm == "wcc":
        from graph_tpu_torch.algos.wcc import WccConfig, wcc

        g = _load(args)
        cfg = WccConfig(args.chunk_size, args.neighbor_rounds, args.sampling_size)
        timed_runs(args.runs, args.warmup_runs, lambda: wcc(g, cfg),
                   args.profile)

    elif args.algorithm == "loading":
        # parse benchmark (app/src/loading.rs:11-75 analog)
        def run():
            g = _load(args, undirected=args.undirected, weighted=args.weighted)
            log.info(
                "Loaded %d nodes and %d edges", g.node_count, g.edge_count
            )

        timed_runs(args.runs, args.warmup_runs, run)

    elif args.algorithm == "serialize":
        # el -> binary -> reload -> verify (app/src/serialize.rs:14-109)
        from graph_tpu_torch.io.binary import load_graph, save_graph

        g = _load(args, undirected=args.undirected)
        t0 = time.perf_counter()
        save_graph(args.output, g)
        log.info("Serialized graph in %.3fs", time.perf_counter() - t0)
        t0 = time.perf_counter()
        g2 = load_graph(args.output, id_dtype=_id_dtype(args), device=device)
        log.info("Deserialized graph in %.3fs", time.perf_counter() - t0)
        if (g2.node_count, g2.edge_count) != (g.node_count, g.edge_count):
            raise RuntimeError(
                f"serialization roundtrip: {g2.node_count} nodes and "
                f"{g2.edge_count} edges read back, {g.node_count} and "
                f"{g.edge_count} written")
        log.info("Serialization roundtrip verified")

    return 0


if __name__ == "__main__":
    sys.exit(main())
