#!/usr/bin/env python3
"""On-card check of graph_tpu_torch: PageRank, WCC, SSSP and triangle count
at RMAT scale 22 on every engine, in core and out of core, the same graph
loaded from files through the builder, and the K1 gather probes.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``graph_tpu_torch/csrc`` (one nvcc per
source, all started together), holds each kernel against its plain
PyTorch version bit for bit (edge cases, then the main paths' shapes),
checks the three algorithms on small graphs against the port's own CPU
path, and drives the port's three engine paths through their public
entry points on one Graph500 RMAT graph of scale 22 (n = 4,194,304,
m = 67,108,864, seed 42):

* ``page_rank`` (20 iterations), with spmv held to a host model of the
  int32 quanta on every row;
* ``wcc`` over the symmetrized edges, every label held to scipy's weak
  components (the least node id of each);
* ``delta_stepping`` with bench.py's weights (``default_rng(3).random(m)
  * 4``) from the node of largest out-degree (node 0, bench.py's start,
  has no out-edge in this graph), every edge held to the f32
  shortest-path certificate and the unreached set to scipy's BFS;
* the builder: the same edges written as a packed Graph500 file, loaded
  with ``GraphBuilder`` and held to ``build_directed``'s CSRs and to the
  ``page_rank`` scores bit for bit; written as the LDBC text layout
  (``graph-500-22/graph500-22.e``), parsed by the native parser through
  ``load_graph500`` and held to the ``wcc`` labels; built in host memory
  by the native radix builder and held to the card's SORTED build;
  relabeled by degree on the card (its invariants checked); and written
  and read back as a binary snapshot.  Its set-up seconds are printed
  with the card's name and power limit;
* ``global_triangle_count`` on the same edges built DEDUPLICATED on the
  card (distinct triangles), unchanged by ``make_degree_ordered``, with
  its host preparation, card seconds and one slab of each join design
  timed; at scale 16 the distinct count against scipy and the SORTED
  multiset count against a host model; the native orientation must load;
* the segment-op engines (PageRank ``cumsum``/``scatter``, the logged
  plan PageRank, WCC ``xla``, SSSP ``xla``), each held to the plan
  path's result, and SSSP ``plan``/``frontier``/``xla`` on bench.py's
  1024 x 1024 grid; every engine's seconds and host reads, there and on
  RMAT 12 to 18, from which the ``auto`` rules are decided;
* the out-of-core engine with 8 slabs: ``spmv``, ``smin_int`` and
  ``relax`` bit-exact against resident engines, the three drivers
  against the phases above, ms and bytes per call beside a plain pinned
  copy of the same bytes, and the card memory one call takes.

Each path runs with the launch counts set to 0 just before and read just
after, and fails unless each of its kernels launched at least once per
iteration (per slab, out of core); the kernel rows add up every path's
runs.  A window probe then times K1 at the PageRank and SSSP shapes
with several shared-memory windows (0 among them) in this one process.
The K1 gather probes (``graph_tpu_torch.probes``: the four kernels of
``scripts/perf_k1_{lanemap,rowmatch,sublane}.py``) run through their
entry points at the scripts' windows and seeds, at 4,194,304 and
67,108,864 slots, each exact against its plain version, beside K1's own
rate.  The K2 stream probes (the two kernels of the eight sites of
``scripts/perf_k2_{io,io2,io3,io4,io5,streams}.py``) run their edge cases,
then all six entry points at the scripts' sizes (the RMAT ones on the
section layout of the scale-22 plan), each variant exact against its
plain version, beside K2's own ns a slot and a 1 GB copy.  The K2 stage
probes (the two kernels of the seven sites of
``scripts/perf_k2_{stages,route_ops,sec128}.py``, ``perf_k2v2_stages.py``
and ``perf_transpose.py``: the TPU's K2 section program, stage by stage)
run their edge cases and the three entry points that need no graph while
RMAT is generated, then the two on a stand-in for the TPU plan's routed
sections of the scale-22 plan (routed on the host by a thread of its own
while the other paths run); each variant exact against its plain
version, ``full`` equal to the port's K2 on every destination.  One
``graph_tpu_torch.profile`` trace of the PageRank run gives the device's
busy share and the kernels that took the most time.
It prints one JSON line per phase; the line before the last lists the
kernels, with each design's facts (K2's tile, K1's window and the share
of slots it serves, a probe's window or depth), and the last line is
``{"ok": true, "device": {...}}``.
Any failed check exits non-zero without that line, as does a machine
without a CUDA device.
"""

import dataclasses
import gc
import json
import multiprocessing
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SCALE = 22
ITERS = 20
#: H100 SXM data sheet: HBM3 rate, and the float32 rate outside the
#: tensor cores (the table's entry for scalar arithmetic; the kernels'
#: int32 additions and compares are counted against it).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
#: bench.py's traffic model of one pull iteration: 4 B source id + 4 B
#: gathered score + amortized index and score writes, per edge.
BYTES_PER_EDGE = 12.0
#: K1 windows the probe times (sources kept in shared memory per block).
PROBE_WINDOWS = (0, 16384, 32768, 40960, 49152, 58112)
#: Every window of the K1 gather probe scripts (scripts/perf_k1_*.py).
PROBE_SCRIPT_WINDOWS = (1024, 2048, 4096, 8192, 16384)
#: Scale of the triangle phase's host checks (scale 22 has about 51e9
#: multiset wedges); side of bench.py's SSSP grid; out-of-core slabs.
TC_CHECK_SCALE = 16
GRID_SIDE = 1024
OOC_SLABS = 8
#: Smaller RMAT scales the engines phase times every engine on.
SWEEP_SCALES = (12, 14, 16, 18)
#: PageRank "scatter" against a float64 Jacobi, per node:
#: |scatter - f64| <= SCATTER_RTOL * |f64| + SCATTER_ATOL.
SCATTER_RTOL = 1e-4
SCATTER_ATOL = 1e-9
#: Timed calls a variant of the stage probes on the RMAT stand-in (their
#: scripts' own count, 17 at scale 22, cut for the command's time).
STAGE_RMAT_REPS = 5
#: The kernels each path must launch at least once per iteration.
PATH_KERNELS = {"pagerank": ("k1_gather", "k2_reduce"),
                "wcc": ("k1_gather", "k2_reduce_min"),
                "sssp": ("k1_gather_weighted", "k2_reduce_min"),
                "builder_pagerank": ("k1_gather", "k2_reduce"),
                "builder_wcc": ("k1_gather", "k2_reduce_min"),
                "engines_pagerank_logged": ("k1_gather", "k2_reduce"),
                "engines_sssp_grid": ("k1_gather_weighted", "k2_reduce_min"),
                "ooc_pagerank": ("k1_gather", "k2_reduce"),
                "ooc_wcc": ("k1_gather", "k2_reduce_min"),
                "ooc_sssp": ("k1_gather_weighted", "k2_reduce_min")}
WIKI = np.array([(1, 2), (2, 1), (4, 0), (4, 1), (5, 4), (5, 1), (5, 6),
                 (6, 1), (6, 5), (7, 1), (7, 5), (8, 1), (8, 5), (9, 1),
                 (9, 5), (10, 1), (10, 5), (11, 5), (12, 5)])
#: The port's host C++ (the edge-list parser, the host CSR builder, the
#: K2 stage probes' section router).
HOST_SOURCES = ("edgelist_parser.cpp", "host_csr.cpp", "edge_plan.cpp")
#: The reference's SSSP golden (tests/test_sssp.py): a..f = 0..5.
GOLDEN_EDGES = np.array([(0, 1, 4.0), (0, 2, 2.0), (1, 2, 5.0), (1, 3, 10.0),
                         (2, 4, 3.0), (3, 5, 11.0), (4, 3, 4.0)])
GOLDEN = [0.0, 4.0, 2.0, 9.0, 5.0, 20.0]
#: The same graph in GDL, as tests/test_sssp.py builds it.
GOLDEN_GDL = """(a:A) (b:B) (c:C) (d:D) (e:E) (f:F)
                (a)-[{cost:  4.0 }]->(b) (a)-[{cost:  2.0 }]->(c)
                (b)-[{cost:  5.0 }]->(c) (b)-[{cost: 10.0 }]->(d)
                (c)-[{cost:  3.0 }]->(e) (d)-[{cost: 11.0 }]->(f)
                (e)-[{cost:  4.0 }]->(d)"""


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def _sync():
    import torch

    torch.cuda.synchronize()


def time_ms(fn, reps=20):
    """Mean ms per call over ``reps`` calls, by CUDA events, after a warm-up."""
    import torch

    fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps




def bits_diff(a, b):
    """max |a - b| over the 4-byte patterns (0 iff bit-identical)."""
    import torch

    a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def hold(errs, name, got, want):
    """Kernel output against its plain version: recorded, then checked."""
    _sync()
    e = bits_diff(got, want)
    errs[name] = max(errs.get(name, 0), e)
    check(e == 0, f"{name} disagrees with its plain version (max {e})")


def edge_cases(dev, seed):
    """Inputs with empty rows, a 300,001-slot hub row (over 150 K2 tiles),
    sums that wrap int32, negative int32 (for imin), and m not a multiple
    of 4; f32 inputs for the weighted gather and the f32 min; and copies
    one element into their storage, so not 16-byte aligned."""
    import torch

    g = np.random.default_rng(seed)
    counts = g.integers(0, 40, 3001)
    counts[::5] = 0
    counts[17] = 300_001
    indptr = np.concatenate([[0], np.cumsum(counts)])
    m = int(indptr[-1])
    # nonnegative f32 bit patterns: zeros, denormals, 3e38 and above
    fbits = g.integers(0, 2**31, m).astype(np.int32)
    fbits[::97] = 0
    fbits[1::97] = np.arange(fbits[1::97].size) % 0x7FFFFF + 1
    fbits[2::97] = np.float32(3e38).view(np.int32)
    fbits[3::97] = np.finfo(np.float32).max.view(np.int32)
    # f32 gather inputs: zeros, denormals, 3e38; quantized: |x op w| < 2
    # with exact half-quantum ties (x = odd / 2**31, w = 1 or 0)
    xf = (g.random(1 << 12) * 1e3).astype(np.float32)
    xf[:8], xf[16:24] = 0.0, np.float32(3e38)
    xf[8:16] = np.arange(1, 9, dtype=np.int32).view(np.float32)
    xs = (g.random(1 << 12) * 2.6 - 1.3).astype(np.float32)
    xs[:64] = (2 * np.arange(64) + 1) / np.float32(2**31)
    ws = (g.random(m) * 2.6 - 1.3).astype(np.float32)
    ws[: m // 4] = 1.0
    arrays = {
        "xq": g.integers(-2**31, 2**31, 1 << 12).astype(np.int32),
        "slot_src": g.integers(0, 1 << 12, m).astype(np.int32),
        "contrib": g.integers(-2**31, 2**31, m).astype(np.int32),
        "fbits": fbits, "indptr": indptr, "xf": xf,
        "wf": (g.random(m) * 4).astype(np.float32), "xs": xs, "ws": ws,
        "ws_add": np.where(ws == 1.0, np.float32(0.0), ws * 0.5),
    }
    out = {k: torch.from_numpy(a).to(dev) for k, a in arrays.items()}
    for name in ("slot_src", "contrib", "fbits", "wf", "xq"):
        t = out[name]
        out[name + "_off1"] = torch.cat([t[:1], t])[1:]  # storage offset 1
    return out


def check_edge_cases(kernels, a, errs):
    """Every kernel against its plain version on the edge-case inputs,
    with K1 windows of none, part of and more than the 4,096 sources."""
    k = kernels
    for off in ("", "_off1"):
        xq, src = a["xq" + off], a["slot_src" + off]
        for h in (0, 1024, 8192):
            hold(errs, "k1_gather", k.k1_gather(xq, src, h),
                 k.k1_gather_plain(xq, src))
        c, ip = a["contrib" + off], a["indptr"]
        hold(errs, "k2_reduce", k.k2_reduce(c, ip), k.k2_reduce_plain(c, ip))
        for op, c in (("imin", c), ("min", a["fbits" + off])):
            hold(errs, "k2_reduce_min", k.k2_reduce_min(c, ip, op),
                 k.k2_reduce_min_plain(c, ip, op))
    cases = [(a["xf"], a["wf"], "add", False), (a["xf"], a["wf"], "mul", False),
             (a["xs"], a["ws"], "mul", True),
             (a["xs"], a["ws_add"], "add", True),
             (a["xf"], a["wf_off1"], "add", False)]
    for src in (a["slot_src"], a["slot_src_off1"]):
        for x, w, combine, quantize in cases:
            for h in (0, 1024, 8192):
                hold(errs, "k1_gather_weighted",
                     k.k1_gather_weighted(x, src, w, combine, quantize,
                                          window=h),
                     k.k1_gather_weighted_plain(x, src, w, combine,
                                                quantize))


def host_jacobi(src, dst, n, iters, damping):
    """float64 PageRank on the host: the plain reference for small graphs."""
    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1.0), 0.0)
    scores = np.full(n, 1.0 / n)
    for _ in range(iters):
        y = np.bincount(dst, weights=(scores * inv)[src], minlength=n)
        scores = (1.0 - damping) / n + damping * y
    return scores


def host_components(src, dst, n):
    """Each node's weak component as its least node id (scipy)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    a = sp.csr_matrix((np.ones(src.size, np.float32), (src, dst)),
                      shape=(n, n))
    _, lab = connected_components(a, directed=True, connection="weak")
    _, first = np.unique(lab, return_index=True)  # first = least id
    return first[lab]


def small_graph_checks(gtt, dev):
    """The port on the card against the host on small inputs: PageRank
    against a float64 Jacobi reference (within 1e-6) and the port's CPU
    path (same iteration count, scores within 1e-6); WCC labels and
    rounds and SSSP distances exactly equal to the CPU path."""
    from graph_tpu_torch.generate import host_rmat

    r12 = host_rmat(12, seed=3)
    out = {}
    for name, (src, dst, n) in {"wiki": (WIKI[:, 0], WIKI[:, 1], 13),
                                "rmat12": (*r12, 1 << 12)}.items():
        cfg = gtt.PageRankConfig(engine="plan", max_iterations=50,
                                 tolerance=1e-7)
        card = gtt.page_rank(gtt.build_directed(src, dst, node_count=n,
                                                device=dev), cfg)
        host = gtt.page_rank(gtt.build_directed(src, dst, node_count=n,
                                                device="cpu"), cfg)
        ref = host_jacobi(src, dst, n, card.ran_iterations, 0.85)
        err_ref = float(np.abs(card.scores_np() - ref).max())
        err_cpu = float(np.abs(card.scores_np() - host.scores_np()).max())
        check(card.ran_iterations == host.ran_iterations,
              f"{name}: {card.ran_iterations} iterations on the card, "
              f"{host.ran_iterations} on the CPU")
        check(err_ref <= 1e-6, f"{name}: scores off the float64 reference "
              f"by {err_ref}")
        check(err_cpu <= 1e-6, f"{name}: card and CPU scores differ by "
              f"{err_cpu}")
        plan = gtt.WccConfig(engine="plan")
        card_w = gtt.wcc(gtt.build_directed(src, dst, node_count=n,
                                            device=dev), plan)
        host_w = gtt.wcc(gtt.build_directed(src, dst, node_count=n,
                                            device="cpu"), plan)
        labels = card_w.components_np()
        check(np.array_equal(labels, host_w.components_np())
              and card_w.ran_iterations == host_w.ran_iterations,
              f"{name}: WCC on the card differs from the CPU path")
        check(np.array_equal(labels, host_components(src, dst, n)),
              f"{name}: WCC labels differ from scipy's components")
        out[name] = {"pagerank_iterations": card.ran_iterations,
                     "pagerank_max_abs_vs_f64": err_ref,
                     "pagerank_max_abs_vs_cpu": err_cpu,
                     "wcc_rounds": card_w.ran_iterations,
                     "wcc_components": int(np.unique(labels).size)}

    e = GOLDEN_EDGES
    golden = {d: gtt.build_directed(
        e[:, 0].astype(np.int64), e[:, 1].astype(np.int64),
        e[:, 2].astype(np.float32), node_count=6,
        layout=gtt.CsrLayout.DEDUPLICATED, device=d) for d in (dev, "cpu")}
    d_golden = gtt.delta_stepping(golden[dev], gtt.DeltaSteppingConfig(0, 3.0))
    check(d_golden.distances_np().tolist() == GOLDEN,
          f"SSSP golden: {d_golden.distances_np().tolist()} != {GOLDEN}")
    src, dst = r12
    w = np.random.default_rng(3).random(src.size).astype(np.float32) * 4
    start = int(np.bincount(src).argmax())
    cfg = gtt.DeltaSteppingConfig(start, 3.0)
    card_s = gtt.delta_stepping(gtt.build_directed(
        src, dst, w, node_count=1 << 12, device=dev), cfg)
    host_s = gtt.delta_stepping(gtt.build_directed(
        src, dst, w, node_count=1 << 12, device="cpu"), cfg)
    check(np.array_equal(card_s.distances_np(), host_s.distances_np())
          and card_s.ran_iterations == host_s.ran_iterations,
          "rmat12: SSSP distances on the card differ from the CPU path")
    reached = int((card_s.distances_np() < np.finfo(np.float32).max).sum())
    check(reached > 1, "rmat12: SSSP reached only its start node")
    out["sssp"] = {"golden": d_golden.distances_np().tolist(),
                   "rmat12_rounds": card_s.ran_iterations,
                   "rmat12_reached": reached}
    out["builder"] = builder_goldens(gtt, dev, {
        "wiki": ((WIKI[:, 0], WIKI[:, 1]), 13), "rmat12": (r12, 1 << 12)})
    return out


def builder_goldens(gtt, dev, graphs):
    """The goldens through GraphBuilder on the card: the wiki graph's
    converged PageRank against the CPU port (within 1e-6, same
    iterations) and the SSSP golden from GDL; then the degree relabel of
    each small graph, card against CPU, exactly."""
    cfg = gtt.PageRankConfig(max_iterations=200, tolerance=1e-6)
    wiki = {d: gtt.page_rank(gtt.GraphBuilder(device=d).edges(WIKI)
                             .build_directed(), cfg) for d in (dev, "cpu")}
    err = float(np.abs(wiki[dev].scores_np()
                       - wiki["cpu"].scores_np()).max())
    check(wiki[dev].ran_iterations == wiki["cpu"].ran_iterations,
          f"wiki (builder): {wiki[dev].ran_iterations} iterations on the "
          f"card, {wiki['cpu'].ran_iterations} on the CPU")
    check(err <= 1e-6, f"wiki (builder): card and CPU differ by {err}")
    golden = gtt.delta_stepping(
        gtt.GraphBuilder(device=dev).csr_layout(gtt.CsrLayout.DEDUPLICATED)
        .gdl(GOLDEN_GDL).build_directed(), gtt.DeltaSteppingConfig(0, 3.0))
    check(golden.distances_np().tolist() == GOLDEN,
          f"SSSP golden (GDL): {golden.distances_np().tolist()}")
    for name, ((src, dst), n) in graphs.items():
        rel = {d: gtt.make_degree_ordered(gtt.build_undirected(
            src, dst, node_count=n, node_values=np.arange(n, dtype=np.int64),
            device=d)) for d in (dev, "cpu")}
        for f in ("offsets", "sources", "targets"):
            check(torch_equal(getattr(rel[dev].csr, f),
                              getattr(rel["cpu"].csr, f)),
                  f"{name}: degree relabel's {f} differ, card and CPU")
        check(torch_equal(rel[dev].node_values, rel["cpu"].node_values),
              f"{name}: degree relabel's node values differ")
    return {"wiki_pagerank_iterations": wiki[dev].ran_iterations,
            "wiki_pagerank_max_abs_vs_cpu": err,
            "sssp_golden_gdl": golden.distances_np().tolist(),
            "relabel_equal_to_cpu": sorted(graphs)}


def torch_equal(a, b):
    """Equal shapes, dtypes and values, wherever the two tensors lie."""
    import torch

    return a.dtype == b.dtype and torch.equal(a, b.to(a.device))


def gate(eng, src, dst, n, dev):
    """spmv must equal the host quanta model on every row (bench.py's
    exactness gate): f32 quantize, int32 wraparound sum, exact /2**30."""
    import torch

    x = (np.random.default_rng(1).random(n) * 1e-5).astype(np.float32)
    q = np.round((x[src] * np.float32(1 << 30)).astype(np.float32))
    # float64 sums are exact below 2**53; the int32 wrap is explicit
    acc = np.bincount(dst, weights=q, minlength=n).astype(np.int64)
    y_exp = acc.astype(np.int32).astype(np.float32) / np.float32(1 << 30)
    x_t = torch.from_numpy(x).to(dev)
    y = eng.spmv(x_t)
    bad = int((y != torch.from_numpy(y_exp).to(dev)).sum())
    check(bad == 0, f"exactness gate: spmv differs on {bad}/{n} rows")
    return x_t, bad


def drive(kernels, path, fn, iterations_of):
    """Run one path with the launch counts set to 0 just before and read
    just after; each of its kernels must launch once per iteration."""
    kernels.reset_launches()
    res = fn()
    _sync()
    launches = dict(kernels.LAUNCHES)
    iters = iterations_of(res)
    for name in PATH_KERNELS[path]:
        check(launches[name] >= iters >= 1,
              f"{path}: {name} launched {launches[name]} times in "
              f"{iters} iterations")
    return res, launches


def wcc_phase(gtt, kernels, graph, src, dst, n):
    """WCC on the scale-22 graph; every label against scipy."""
    import torch
    from graph_tpu_torch.algos.wcc import _sym_engine

    t0 = time.perf_counter()
    sym = _sym_engine(graph)  # the engine wcc builds and caches
    _sync()
    build_s = time.perf_counter() - t0
    res, launches = drive(kernels, "wcc", lambda: gtt.wcc(graph),
                          lambda r: r.ran_iterations)
    runs, res = timed_runs(lambda: gtt.wcc(graph))
    labels = res.components
    check(tuple(labels.shape) == (n,) and labels.dtype == torch.int32,
          f"labels have shape {tuple(labels.shape)} {labels.dtype}")
    t0 = time.perf_counter()
    want = host_components(src, dst, n)
    bad = int((labels.cpu().numpy() != want).sum())
    check(bad == 0, f"WCC: {bad}/{n} labels differ from scipy's")
    best = min(runs)
    emit({"phase": "wcc", "scale": SCALE, "n": n, "m_sym": sym.plan.m,
          "sym_plan_build_s": build_s, "rounds": res.ran_iterations,
          "run_s": runs, "best_s": best,
          "per_round_ms": best / res.ran_iterations * 1e3,
          "launches": launches, "labels_differing_from_host": bad,
          "components": int(np.unique(want).size),
          "host_check_s": time.perf_counter() - t0,
          "max_in_degree": int(torch.diff(sym.plan.indptr).max())})
    return sym, launches, labels, res.ran_iterations


def sssp_phase(gtt, kernels, src, dst, n, dev):
    """SSSP with bench.py's weights from the node of largest out-degree;
    the f32 certificate on every edge and the unreached set against
    scipy's BFS."""
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import breadth_first_order

    from graph_tpu_torch.algos.sssp import INF, _weighted_engine

    w = sssp_weights(src.size)
    t0 = time.perf_counter()
    graph = gtt.build_directed(src, dst, w, node_count=n, device=dev)
    _sync()
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = _weighted_engine(graph)  # the engine delta_stepping builds
    _sync()
    build_s = time.perf_counter() - t0
    out_degree = np.bincount(src, minlength=n)
    start = int(out_degree.argmax())
    cfg = gtt.DeltaSteppingConfig(start, 3.0)
    res, launches = drive(kernels, "sssp",
                          lambda: gtt.delta_stepping(graph, cfg),
                          lambda r: r.ran_iterations)
    runs, res = timed_runs(lambda: gtt.delta_stepping(graph, cfg))
    dist_t = res.distances
    check(tuple(dist_t.shape) == (n,) and dist_t.dtype == torch.float32,
          f"distances have shape {tuple(dist_t.shape)} {dist_t.dtype}")
    t0 = time.perf_counter()
    dist = dist_t.cpu().numpy()
    reached = dist < INF
    check(dist[start] == 0.0, f"dist[start] = {dist[start]}")
    check(not np.isnan(dist).any() and (dist >= 0).all(),
          "distances not all nonnegative numbers")
    via = dist[src] + w  # f32, rounded as the kernel rounds
    over = int((dist[dst] > via).sum())
    check(over == 0, f"SSSP: {over} edges relax further (d > d[s] + w)")
    tight = (via == dist[dst]) & reached[src]
    has_tight = np.zeros(n, bool)
    has_tight[dst[tight]] = True
    need = reached.copy()
    need[start] = False
    loose = int((need & ~has_tight).sum())
    check(loose == 0, f"SSSP: {loose} reached nodes have no tight in-edge")
    a = sp.csr_matrix((np.ones(src.size, np.float32), (src, dst)),
                      shape=(n, n))
    bfs = np.zeros(n, bool)
    bfs[breadth_first_order(a, start, directed=True,
                            return_predecessors=False)] = True
    check(np.array_equal(bfs, reached),
          f"SSSP: {int((bfs != reached).sum())} nodes differ in "
          "reachability from scipy's BFS")
    best = min(runs)
    emit({"phase": "sssp", "scale": SCALE, "n": n, "m": int(src.size),
          "start_node": start, "start_out_degree": int(out_degree[start]),
          "node0_out_degree": int(out_degree[0]), "weights": "default_rng(3).random(m) * 4",
          "build_directed_s": graph_s, "weighted_plan_build_s": build_s,
          "rounds": res.ran_iterations, "run_s": runs, "best_s": best,
          "per_round_ms": best / res.ran_iterations * 1e3,
          "launches": launches, "reached": int(reached.sum()),
          "max_distance": float(dist[reached].max()),
          "host_check_s": time.perf_counter() - t0})
    return graph, start, eng, res, launches


def sssp_weights(m):
    """bench.py's SSSP weights (``bench.py:262``)."""
    return np.random.default_rng(3).random(m).astype(np.float32) * 4


def edge_text(src, dst):
    """``"src dst\\n"`` per edge as bytes: fixed-width digits, then the
    leading zeros dropped."""
    w = max(len(str(int(max(src.max(), dst.max())))), 1)
    pow10 = 10 ** np.arange(w - 1, -1, -1, dtype=np.int64)
    chars = np.empty((src.size, 2 * w + 2), np.uint8)
    keep = np.ones(chars.shape, bool)
    for col, v in ((0, src), (w + 1, dst)):
        digits = v[:, None] // pow10
        chars[:, col:col + w] = 48 + digits % 10
        keep[:, col:col + w - 1] = digits[:, :-1] > 0
    chars[:, w] = 32
    chars[:, -1] = 10
    return chars[keep]


def write_edge_text(path, src, dst, step=1 << 21):
    """The LDBC ``.e`` layout, chunks formatted on 8 threads, in order."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f, ThreadPoolExecutor(8) as ex:
        for buf in ex.map(lambda lo: edge_text(src[lo:lo + step],
                                               dst[lo:lo + step]),
                          range(0, src.size, step)):
            buf.tofile(f)
    os.replace(tmp, path)


def builder_phase(gtt, kernels, dev, card, src, dst, n, graph, pr_cfg,
                  pr_res, wcc_labels):
    """The front door at full scale: the RMAT written as a Graph500 file
    and as LDBC text, each loaded through the builder into PageRank and
    WCC, held to the phases above bit for bit; the host build against
    the card's; the degree relabel's invariants; a snapshot round trip.
    Each file is written once into .cache/ and reused."""
    import torch

    from graph_tpu_torch.io import edgelist
    from graph_tpu_torch.io.graph500 import write_graph500
    from graph_tpu_torch.native import edge_list_parser, host_csr

    cache = os.path.join(ROOT, ".cache", "builder")
    os.makedirs(cache, exist_ok=True)
    secs, out = {}, {}

    def timed(name, fn):
        _sync()
        t0 = time.perf_counter()
        res = fn()
        _sync()
        secs[name] = time.perf_counter() - t0
        return res

    def same_csr(got, want, what):
        for f in ("offsets", "sources", "targets"):
            check(torch_equal(getattr(got, f), getattr(want, f)),
                  f"{what}: {f} differ")

    # 1. Graph500 file -> build_directed -> page_rank, bit for bit
    g500 = os.path.join(cache, f"rmat_s{SCALE}.graph500")
    if not os.path.exists(g500):
        timed("graph500_write_s", lambda: write_graph500(g500, src, dst))
    b = gtt.GraphBuilder(device=dev).file_format(gtt.Graph500Input())
    timed("graph500_parse_s", lambda: b.path(g500))
    g = timed("graph500_build_directed_s", b.build_directed)
    check(g.node_count == n, f"Graph500 file: node_count {g.node_count}")
    same_csr(g.csr_out, graph.csr_out, "Graph500 file: out-CSR")
    same_csr(g.csr_in, graph.csr_in, "Graph500 file: in-CSR")
    res, out["pagerank_launches"] = drive(
        kernels, "builder_pagerank", lambda: gtt.page_rank(g, pr_cfg),
        lambda r: r.ran_iterations)
    check(res.ran_iterations == pr_res.ran_iterations
          and torch.equal(res.scores, pr_res.scores),
          "Graph500 file: PageRank differs from the pagerank phase's")
    # one run, on page_rank's own timer: the plan build is not in it
    out["pagerank_run_s"] = res.micros / 1e6
    del b, g, res
    free_device()

    # 2. LDBC text -> native parser -> undirected -> wcc, exactly
    datasets = os.path.join(cache, "datasets")
    e_path = os.path.join(datasets, f"graph-500-{SCALE}",
                          f"graph500-{SCALE}.e")
    if not os.path.exists(e_path):
        timed("text_write_s", lambda: write_edge_text(e_path, src, dst))
    out["text_bytes"] = os.path.getsize(e_path)
    # one load; the parse inside it is timed apart by wrapping the reader
    parse = edgelist.read_edge_list
    edgelist.read_edge_list = lambda *a: timed("text_parse_s",
                                               lambda: parse(*a))
    try:
        ug = timed("text_load_graph500_s",
                   lambda: gtt.load_graph500(SCALE, datasets=datasets,
                                             device=dev))
    finally:
        edgelist.read_edge_list = parse
    check("text_parse_s" in secs, "LDBC text: the edge-list reader not run")
    check(edge_list_parser.load_error() is None,
          f"LDBC text: pandas parsed it; the native parser: "
          f"{edge_list_parser.load_error()}")
    out["text_parser"] = "native"
    # an edge list's node count is its largest id + 1: the highest ids,
    # if isolated, are not in the file, and each is its own component
    nt = ug.node_count
    check(nt <= n and nt == int(max(src.max(), dst.max())) + 1
          and ug.edge_count == src.size,
          f"LDBC text: {nt} nodes, {ug.edge_count} edges")
    out["text_node_count"] = nt
    res, out["wcc_launches"] = drive(kernels, "builder_wcc",
                                     lambda: gtt.wcc(ug),
                                     lambda r: r.ran_iterations)
    check(torch.equal(res.components, wcc_labels[:nt]) and torch.equal(
        wcc_labels[nt:], torch.arange(nt, n, dtype=wcc_labels.dtype,
                                      device=wcc_labels.device)),
          "LDBC text: WCC labels differ from the wcc phase's")
    out["wcc_rounds"] = res.ran_iterations
    out["wcc_run_s"] = res.micros / 1e6
    del res

    # 3. host build against the card's; the degree relabel on the card
    hb = timed("host_build_undirected_sorted_s",
               lambda: gtt.build_undirected_host(
                   src, dst, node_count=n, layout=gtt.CsrLayout.SORTED))
    check(host_csr.load_error() is None,
          f"native host builder: {host_csr.load_error()}")
    cb = timed("card_build_undirected_sorted_s",
               lambda: gtt.build_undirected(
                   src, dst, node_count=n, layout=gtt.CsrLayout.SORTED,
                   device=dev))
    same_csr(hb.csr, cb.csr, "host build against the card's")
    del hb, cb
    free_device()
    ids = dataclasses.replace(
        ug, node_values=torch.arange(nt, dtype=torch.int64, device=dev))
    rel = timed("relabel_s", lambda: gtt.make_degree_ordered(ids))
    out["relabel"] = relabel_invariants(ids, rel)
    del ug, ids, rel
    free_device()

    # 4. snapshot round trip of the directed graph
    snap = os.path.join(cache, f"rmat_s{SCALE}.gtpu")
    timed("snapshot_write_s", lambda: gtt.save_graph(snap, graph))
    back = timed("snapshot_read_s", lambda: gtt.GraphBuilder(device=dev)
                 .file_format(gtt.BinaryInput()).path(snap).build_directed())
    same_csr(back.csr_out, graph.csr_out, "snapshot: out-CSR")
    same_csr(back.csr_in, graph.csr_in, "snapshot: in-CSR")
    check(back.layout is graph.layout, "snapshot: layout differs")
    out["snapshot_bytes"] = os.path.getsize(snap)
    del back
    os.remove(snap)
    free_device()
    emit({"phase": "builder", "scale": SCALE, "n": n, "m": int(src.size),
          "card": card, "setup_s": secs, **out})
    return out


def relabel_invariants(g, rel):
    """make_degree_ordered on the card: degrees non-increasing, ties in
    descending old id (node values carry the old ids), each node's
    degree kept, sorted neighbour lists, the edge count unchanged."""
    import torch

    deg, old = rel.degrees(), rel.node_values
    check(bool((deg[1:] <= deg[:-1]).all()), "relabel: degrees increase")
    tie = deg[1:] == deg[:-1]
    check(bool((old[1:][tie] < old[:-1][tie]).all()),
          "relabel: ties not in descending old id")
    check(torch.equal(torch.sort(old).values,
                      torch.arange(g.node_count, device=old.device)),
          "relabel: node values are not a permutation")
    check(torch.equal(deg, g.degrees()[old]), "relabel: degrees changed")
    s, t = rel.csr.sources, rel.csr.targets
    same_row = s[1:] == s[:-1]
    check(bool((t[1:][same_row] >= t[:-1][same_row]).all()),
          "relabel: neighbour lists not sorted")
    check(rel.edge_count == g.edge_count and rel.layout.name == "SORTED",
          f"relabel: {rel.edge_count} edges, layout {rel.layout}")
    return {"max_degree": int(deg[0]), "tied_pairs": int(tie.sum())}


def launches_of(*runs):
    """The launches of several runs of a path, added, kernel by kernel."""
    return {name: sum(r[name] for r in runs) for name in runs[0]}


def timed_runs(fn, reps=3):
    """Host seconds of each of ``reps`` synchronized calls, and the last
    result."""
    runs = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        res = fn()
        _sync()
        runs.append(time.perf_counter() - t0)
    return runs, res


def host_triangles(g):
    """Distinct triangles of a DEDUPLICATED graph on the host (scipy): U
    is the adjacency above the diagonal, and each triangle i < j < k is
    one product U[i,j] U[j,k] under U[i,k]."""
    import scipy.sparse as sp

    s, t = g.csr.sources.cpu().numpy(), g.csr.targets.cpu().numpy()
    up = s < t
    n = g.node_count
    u = sp.csr_matrix((np.ones(int(up.sum()), np.int64), (s[up], t[up])),
                      shape=(n, n))
    return int((u @ u).multiply(u).sum())


def host_multiset_triangles(g):
    """The reference's multiset count on a SORTED graph, on the host:
    M[u,v] counts the occurrences of v <= u in N(u), B is the distinct
    adjacency, and the count is the sum of (M @ M) under B."""
    import scipy.sparse as sp

    s = g.csr.sources.cpu().numpy().astype(np.int64)
    t = g.csr.targets.cpu().numpy().astype(np.int64)
    n = g.node_count
    low = t <= s
    m = sp.csr_matrix((np.ones(int(low.sum()), np.int64), (s[low], t[low])),
                      shape=(n, n))  # duplicates add up: occurrences
    b = sp.csr_matrix((np.ones(s.size, np.int64), (s, t)), shape=(n, n))
    b.data[:] = 1
    return int((m @ m).multiply(b).sum())


def triangles_phase(gtt, dev, src, dst, n):
    """Triangle count at scale 22 on the card (distinct, DEDUPLICATED),
    unchanged by the degree relabel; the two join designs timed on one
    full slab; at scale 16 the distinct count against scipy (and the
    sort join's count against the lookup join's) and the multiset count
    (SORTED, relabeled) against a host model.  Fails unless the native
    orientation library loaded."""
    import torch

    from graph_tpu_torch.algos import triangle_count as tc
    from graph_tpu_torch.generate import host_rmat
    from graph_tpu_torch.native import host_csr

    out = {}
    t0 = time.perf_counter()
    ug = gtt.build_undirected(src, dst, node_count=n, device=dev,
                              layout=gtt.CsrLayout.DEDUPLICATED)
    _sync()
    out["build_undirected_s"] = time.perf_counter() - t0
    # keep the host preparation the count makes, for the per-slab timing
    prepare, kept = tc._prepare_distinct, []
    tc._prepare_distinct = lambda *a: kept.append(prepare(*a)) or kept[-1]
    try:
        _sync()
        t0 = time.perf_counter()
        res = gtt.global_triangle_count(ug)
        _sync()
        out["count_s"] = time.perf_counter() - t0
    finally:
        tc._prepare_distinct = prepare
    check(host_csr.load_error() is None,
          f"triangles: the native orientation did not load: "
          f"{host_csr.load_error()}")
    check(res.triangles > 0, f"triangles: counted {res.triangles}")
    out.update(triangles=res.triangles, micros=res.micros, **res.phases)
    out["wedges_per_s_on_card"] = res.phases["wedges"] / res.phases["join_s"]

    # check 1: the degree relabel keeps the count
    rel = gtt.make_degree_ordered(ug)
    res_rel = gtt.global_triangle_count(rel)
    check(res_rel.triangles == res.triangles,
          f"triangles: {res_rel.triangles} after make_degree_ordered, "
          f"{res.triangles} before")
    out["relabeled"] = {"triangles": res_rel.triangles, **res_rel.phases}
    del rel, ug
    free_device()

    # the two joins on one full slab of the 64-wide class, same wedges
    mats, _, a, b = kept[0]
    mat = torch.from_numpy(mats[64]).to(dev)
    rows = max(1, tc.SLAB // (64 * 63 // 2))
    v, w = tc._emit_intra(mat[:rows], 64)
    keys = tc._edge_keys(a, b, dev)
    ev, ew = (torch.from_numpy(x).to(dev) for x in tc._pad_edge_keys(a, b))
    lookup = int(tc._lookup_count(v, w, keys))
    check(int(tc._join_count(v, w, ev, ew)) == lookup,
          "triangles: the sort join and the lookup join disagree on a slab")
    out["one_slab"] = {
        "wedge_slots": v.numel(), "matches": lookup,
        "lookup_ms": time_ms(lambda: tc._lookup_count(v, w, keys), reps=5),
        "sort_ms": time_ms(lambda: tc._join_count(v, w, ev, ew), reps=3),
        "edge_keys_sort_ms": time_ms(lambda: tc._edge_keys(a, b, dev),
                                     reps=3)}
    del mats, kept, mat, v, w, keys, ev, ew
    free_device()

    # checks 2 and 3 at TC_CHECK_SCALE (the multiset count's wedges)
    cn = 1 << TC_CHECK_SCALE
    c_src, c_dst = host_rmat(TC_CHECK_SCALE, seed=42)
    cg = gtt.build_undirected(c_src, c_dst, node_count=cn, device=dev,
                               layout=gtt.CsrLayout.DEDUPLICATED)
    distinct = gtt.global_triangle_count(cg)
    t0 = time.perf_counter()
    want = host_triangles(cg)
    host_s = time.perf_counter() - t0
    check(distinct.triangles == want,
          f"triangles at scale {TC_CHECK_SCALE}: {distinct.triangles}, "
          f"scipy {want}")
    prep = tc._prepare_distinct(cg, {})
    joins = {}
    for join in tc.JOINS:
        _sync()
        t0 = time.perf_counter()
        count = tc._run_join(*prep, device=dev, join=join)
        joins[join] = {"count": count, "s": time.perf_counter() - t0}
        check(count == want, f"triangles: the {join} join counts "
              f"{count}, scipy {want}")
    gs = gtt.make_degree_ordered(gtt.build_undirected(
        c_src, c_dst, node_count=cn, device=dev,
        layout=gtt.CsrLayout.SORTED))
    cm = gtt.global_triangle_count(gs)
    t0 = time.perf_counter()
    want_m = host_multiset_triangles(gs)
    host_m_s = time.perf_counter() - t0
    check(cm.triangles == want_m, f"multiset triangles: {cm.triangles}, "
          f"host model {want_m}")
    out["host_checks"] = {
        "scale": TC_CHECK_SCALE,
        "distinct": {"triangles": distinct.triangles, "host_check_s": host_s,
                     "joins": joins, **distinct.phases},
        "multiset": {"triangles": cm.triangles, "host_check_s": host_m_s,
                     "why_not_scale22": "scale 22 has about 51e9 "
                                        "multiset wedges", **cm.phases}}
    emit({"phase": "triangles", "scale": SCALE, "n": n, "m": int(src.size),
          **out})
    return out


def grid_edges(side):
    """bench.py's SSSP grid (bench.py:293-311): 4-neighbour, both
    directions, weights ``default_rng(9).uniform(0.1, 4.0)``."""
    gn = side * side
    ii = np.arange(gn, dtype=np.int64)
    right = ii[ii % side != side - 1]
    down = ii[ii < gn - side]
    src = np.concatenate([right, right + 1, down, down + side])
    dst = np.concatenate([right + 1, right, down + side, down])
    w = np.random.default_rng(9).uniform(0.1, 4.0, src.size).astype(
        np.float32)
    return src, dst, w, gn


def f64_jacobi(graph, iters, damping):
    """PageRank in float64 on the graph's device with ``index_add_``: the
    plain reference at scale 22 (numpy's takes seconds an iteration)."""
    import torch

    src = graph.csr_out.sources.long()
    dst = graph.csr_out.targets.long()
    n = graph.node_count
    outdeg = graph.out_degrees().double()
    inv = torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1.0), 0.0)
    scores = torch.full((n,), 1.0 / n, dtype=torch.float64,
                        device=src.device)
    for _ in range(iters):
        y = torch.zeros_like(scores).index_add_(0, dst, (scores * inv)[src])
        scores = (1.0 - damping) / n + damping * y
    return scores.cpu().numpy()


def engine_runs(fn, reps):
    """Seconds of ``reps`` runs and the result's reads and iterations."""
    runs, res = timed_runs(fn, reps)
    return {"run_s": runs, "best_s": min(runs),
            "iterations": res.ran_iterations,
            "host_reads": res.host_reads}, res


def engines_phase(gtt, kernels, dev, graph, wgraph, start, pr_res,
                  wcc_labels, sssp_res):
    """The segment-op engines on the scale-22 graphs, each held to the
    plan path's result; the logged plan PageRank; SSSP on bench.py's
    grid with all three engines; and each engine's seconds and host
    reads on RMAT 12, RMAT 22 and the grid, from which ``auto`` is
    decided."""
    import torch

    from graph_tpu_torch.generate import host_rmat

    out = {"pagerank": {}, "wcc": {}, "sssp_rmat": {}, "sssp_grid": {}}
    launches = {}
    cfg = {"max_iterations": ITERS, "tolerance": 0.0}
    # a float64 Jacobi (index_add_ in f64): scatter's f32 sums are held to
    # it; the int32 quanta of plan and cumsum are not (their rounding adds
    # up coherently where many in-neighbours send the same value)
    f64 = f64_jacobi(graph, ITERS, 0.85)
    out["pagerank"]["plan_max_abs_vs_f64"] = float(
        np.abs(pr_res.scores_np() - f64).max())
    for engine in ("cumsum", "scatter"):
        out["pagerank"][engine], res = engine_runs(lambda: gtt.page_rank(
            graph, gtt.PageRankConfig(engine=engine, **cfg)), 3)
        diff = float((res.scores - pr_res.scores).abs().max())
        delta = np.abs(res.scores_np() - f64)
        diff64 = float(delta.max())
        # scatter's limit per node, scaled to its score (1/n is 2.4e-7 at
        # scale 22): f32 sums in any order stay far inside 1e-4 of each
        over = delta - (SCATTER_RTOL * np.abs(f64) + SCATTER_ATOL)
        out["pagerank"][engine].update(
            max_abs_vs_f64=diff64, max_abs_vs_plan=diff,
            max_rel_vs_f64=float((delta / f64).max()),
            f64_at_max_abs=float(f64[delta.argmax()]),
            nodes_over_limit=int((over > 0).sum()))
        check(res.ran_iterations == ITERS, f"{engine}: {res.ran_iterations}"
              " iterations")
        if engine == "cumsum":
            check(torch.equal(res.scores, pr_res.scores),
                  f"PageRank cumsum differs from the plan path by {diff}")
        else:
            check(not (over > 0).any(), f"PageRank scatter: "
                  f"{int((over > 0).sum())} nodes off the float64 Jacobi by "
                  f"more than {SCATTER_RTOL}·|f64| + {SCATTER_ATOL} "
                  f"(max {diff64}; off the plan by {diff})")
    del f64, delta, over
    res, launches["pagerank_logged"] = drive(
        kernels, "engines_pagerank_logged", lambda: gtt.page_rank(
            graph, gtt.PageRankConfig(engine="plan", log_progress=True,
                                      **cfg)), lambda r: r.ran_iterations)
    check(torch.equal(res.scores, pr_res.scores) and res.host_reads == ITERS,
          f"logged PageRank: {res.host_reads} host reads, scores equal "
          f"{torch.equal(res.scores, pr_res.scores)}")
    out["pagerank"]["plan_logged"] = {"iterations": res.ran_iterations,
                                      "host_reads": res.host_reads,
                                      "run_s": res.micros / 1e6}
    out["pagerank"]["plan"], _ = engine_runs(lambda: gtt.page_rank(
        graph, gtt.PageRankConfig(engine="plan", **cfg)), 3)

    for engine in ("xla", "plan"):
        out["wcc"][engine], res = engine_runs(
            lambda: gtt.wcc(graph, gtt.WccConfig(engine=engine)), 3)
        check(torch.equal(res.components, wcc_labels),
              f"WCC {engine}: labels differ from the wcc phase's")
    del res

    # SSSP on the RMAT from the sssp phase's start, delta 3.0; the
    # frontier engine refuses its max out-degree
    def sssp(g, start_node, delta, engine):
        return lambda: gtt.delta_stepping(g, gtt.DeltaSteppingConfig(
            start_node, delta, engine=engine))

    out["sssp_rmat"]["xla"], res = engine_runs(
        sssp(wgraph, start, 3.0, "xla"), 2)
    check(torch.equal(res.distances, sssp_res.distances),
          "SSSP xla: distances differ from the sssp phase's (plan)")
    out["sssp_rmat"]["plan"], _ = engine_runs(
        sssp(wgraph, start, 3.0, "plan"), 3)
    out["sssp_rmat"]["frontier"] = frontier_runs(gtt, wgraph, start, 3.0)

    # bench.py's grid: plan, frontier and xla reach the same distances
    gsrc, gdst, gw, gn = grid_edges(GRID_SIDE)
    gg = gtt.build_directed(gsrc, gdst, gw, node_count=gn, device=dev)
    plan_res, launches["sssp_grid_plan"] = drive(
        kernels, "engines_sssp_grid", sssp(gg, 0, 2.0, "plan"),
        lambda r: r.ran_iterations)
    out["sssp_grid"]["plan"], _ = engine_runs(sssp(gg, 0, 2.0, "plan"), 2)
    for engine in ("frontier", "xla"):
        out["sssp_grid"][engine], res = engine_runs(
            sssp(gg, 0, 2.0, engine), 2)
        check(torch.equal(res.distances, plan_res.distances),
              f"grid SSSP: {engine} differs from plan")
    dist = plan_res.distances
    out["sssp_grid"].update(
        side=GRID_SIDE, n=gn, m=int(gsrc.size), delta=2.0,
        max_distance=float(dist.max()),
        corner_distance=float(dist[gn - 1]))
    del gg, res, plan_res, dist

    # smaller RMATs (seed 3), down to where launches, not bytes, set the
    # time: where each algorithm's engines cross over
    for scale in SWEEP_SCALES:
        s_, d_ = host_rmat(scale, seed=3)
        g_ = gtt.build_directed(s_, d_, sssp_weights(s_.size),
                                node_count=1 << scale, device=dev)
        hub = int(np.bincount(s_).argmax())
        rows = {"pagerank": {}, "wcc": {}, "sssp": {}}
        for engine in ("plan", "cumsum", "scatter"):
            rows["pagerank"][engine], _ = engine_runs(
                lambda: gtt.page_rank(g_, gtt.PageRankConfig(
                    engine=engine, **cfg)), 3)
        for engine in ("plan", "xla"):
            rows["wcc"][engine], _ = engine_runs(
                lambda: gtt.wcc(g_, gtt.WccConfig(engine=engine)), 3)
            rows["sssp"][engine], _ = engine_runs(
                sssp(g_, hub, 3.0, engine), 3)
        rows["sssp"]["frontier"] = frontier_runs(gtt, g_, hub, 3.0)
        out.update({f"rmat{scale}_{name}": {"m": int(s_.size), **r}
                    for name, r in rows.items()})
    out["fastest"] = {
        table: min((k for k, v in rows.items()
                    if isinstance(v, dict) and "best_s" in v),
                   key=lambda k: rows[k]["best_s"])
        for table, rows in out.items()}
    emit({"phase": "engines", "scale": SCALE, **out})
    return out, launches


def frontier_runs(gtt, g, start, delta, reps=3):
    """The frontier engine's runs where its padded adjacency, (n+1) x the
    max out-degree, stays below 2**31 slots; else its refusal."""
    from graph_tpu_torch.algos.sssp import _max_out_degree

    dmax = _max_out_degree(g)
    cfg = gtt.DeltaSteppingConfig(start, delta, engine="frontier")
    if (g.node_count + 1) * max(dmax, 1) < (1 << 31):
        runs, _ = engine_runs(lambda: gtt.delta_stepping(g, cfg), reps)
        return {**runs, "max_out_degree": dmax}
    try:
        gtt.delta_stepping(g, cfg)
    except ValueError as exc:  # the engine's own limit, named
        check("2^31" in str(exc), f"frontier: unexpected refusal {exc}")
        return {"refused": str(exc), "max_out_degree": dmax}
    raise SmokeFailure("frontier ran past its adjacency limit")


def copy_yardstick_ms(nbytes, dev):
    """A plain copy of ``nbytes`` from pinned host memory to the card,
    timed by CUDA events: the rate the out-of-core engine streams at."""
    import torch

    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return time_ms(lambda: card.copy_(host, non_blocking=True), reps=5)


def drive_ooc(kernels, path, fn, method, rounds):
    """Drive one out-of-core driver as :func:`drive` does, counting its
    calls of the engine's ``method`` and the slabs each call streams:
    each kernel of the path must launch once per slab and call, and the
    calls must be ``rounds``, the in-core phase's."""
    from graph_tpu_torch.engine.ooc import OocEdgeEngine

    real = getattr(OocEdgeEngine, method)
    slabs = []

    def counted(self, *args, **kwargs):
        slabs.append(len(self.slabs))
        return real(self, *args, **kwargs)

    setattr(OocEdgeEngine, method, counted)
    try:
        res, launches = drive(kernels, path, fn, lambda r: sum(slabs))
    finally:
        setattr(OocEdgeEngine, method, real)
    check(len(slabs) == rounds, f"{path}: {len(slabs)} calls of {method}, "
          f"{rounds} rounds in core")
    return res, launches, sum(slabs)


def ooc_phase(gtt, kernels, dev, errs, src, dst, w, n, start, x_host,
              sym, pr_res, wcc_labels, wcc_rounds, sssp_res):
    """The out-of-core engine at scale 22 with 8 slabs: one spmv,
    smin_int and relax each bit-exact against a resident engine on the
    same edges; K1 and K2 held to their plain versions on a slab; the
    three drivers against the pagerank, wcc and sssp phases; ms per call,
    bytes per call and the rate, beside a plain pinned copy of the same
    bytes; and the card's memory."""
    import torch

    from graph_tpu_torch.algos.sssp import INF as F32_MAX
    from graph_tpu_torch.engine import ooc

    k = kernels
    slabs = OOC_SLABS
    out, launches = {}, {}
    torch.cuda.reset_peak_memory_stats()
    peaks = []
    t0 = time.perf_counter()
    eng = ooc.OocEdgeEngine.build(src, dst, n, n_slabs=slabs, device=dev)
    out["build_s"] = time.perf_counter() - t0
    check(2 <= len(eng.slabs) <= slabs
          and eng.slabs[0].plan.slot_src.is_pinned(),
          f"ooc: {len(eng.slabs)} slabs, pinned "
          f"{eng.slabs[0].plan.slot_src.is_pinned()}")
    out["slabs"] = [{"d0": sl.d0, "rows": sl.rows, "m": sl.plan.m}
                    for sl in eng.slabs]
    resident = gtt.EdgeEngine.build(src, dst, n, device=dev)
    y = eng.spmv(x_host)
    check(torch.equal(y, resident.spmv(x_host.to(dev)).cpu()),
          "ooc spmv differs from the resident engine's")
    # K1 and K2 on the first slab, against their plain versions
    a = [t.to(dev) for t in eng.slabs[0].arrays()]
    xq = torch.round(x_host.to(dev) * float(1 << 30)).to(torch.int32)
    contrib = k.k1_gather_plain(xq, a[0])
    hold(errs, "k1_gather", k.k1_gather(xq, a[0]), contrib)
    hold(errs, "k2_reduce", k.k2_reduce(contrib, a[1], a[2]),
         k.k2_reduce_plain(contrib, a[1]))
    del resident, a, xq, contrib
    free_device()

    # one call's time and bytes, and the card memory it takes
    runs, _ = timed_runs(lambda: eng.spmv(x_host), 3)
    before = torch.cuda.memory_allocated()
    peaks.append(torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    eng.spmv(x_host)
    call_peak = torch.cuda.max_memory_allocated() - before
    # two buffers, each as large as the largest slab's arrays; K1's output
    # for a slab; x, its quanta, y as int32 and f32, and temporaries
    arrays = [sl.arrays() for sl in eng.slabs]
    buffers = 2 * sum(max(a[i].numel() for a in arrays)
                      * arrays[0][i].element_size()
                      for i in range(len(arrays[0])))
    transient = max(sl.plan.m for sl in eng.slabs) * 4 + 6 * 4 * n
    check(call_peak <= buffers + transient + (4 << 20),
          f"ooc: one call took {call_peak} bytes of the card; two slab "
          f"buffers are {buffers}, the rest {transient}")
    nbytes = eng.bytes_per_call
    best = min(runs)
    yard = copy_yardstick_ms(nbytes, dev)
    out["spmv"] = {"run_s": runs, "ms_per_call": best * 1e3,
                   "bytes_per_call": nbytes,
                   "vector_bytes_per_call": 2 * 4 * n,
                   "gb_per_s": nbytes / best / 1e9,
                   "pinned_copy_ms": yard,
                   "pinned_copy_gb_per_s": nbytes / yard / 1e6,
                   "share_of_copy_rate": yard / (best * 1e3),
                   "two_buffers_bytes": buffers,
                   "transient_bytes": transient,
                   "call_peak_bytes": call_peak}
    del eng
    free_device()

    # smin_int on the symmetrized edges, against the wcc phase's engine
    sym_src = np.concatenate([src, dst])
    sym_dst = np.concatenate([dst, src])
    t0 = time.perf_counter()
    seng = ooc.OocEdgeEngine.build(sym_src, sym_dst, n, n_slabs=slabs,
                                   device=dev)
    out["sym_build_s"] = time.perf_counter() - t0
    labels = torch.arange(n, dtype=torch.int32)
    check(torch.equal(seng.smin_int(labels),
                      sym.smin_int(labels.to(dev)).cpu()),
          "ooc smin_int differs from the resident engine's")
    a = [t.to(dev) for t in seng.slabs[0].arrays()]
    c = k.k1_gather_plain(labels.to(dev), a[0])
    hold(errs, "k2_reduce_min", k.k2_reduce_min(c, a[1], "imin", a[2]),
         k.k2_reduce_min_plain(c, a[1], "imin"))
    out["smin_int"] = {"ms_per_call": min(timed_runs(
        lambda: seng.smin_int(labels), 2)[0]) * 1e3,
        "bytes_per_call": seng.bytes_per_call}
    del seng, a, c, sym_src, sym_dst
    free_device()

    # relax on the weighted edges, against a resident engine (no relabel)
    weng = ooc.OocEdgeEngine.build(src, dst, n, values=w, n_slabs=slabs,
                                   device=dev)
    resident = gtt.EdgeEngine.build(src, dst, n, values=w, device=dev)
    dist = sssp_res.distances.clamp(max=k.INF).cpu()
    check(torch.equal(weng.relax(dist), resident.relax(dist.to(dev)).cpu()),
          "ooc relax differs from the resident engine's")
    a = [t.to(dev) for t in weng.slabs[0].arrays()]
    c = k.k1_gather_weighted_plain(dist.to(dev), a[0], a[3], "add", False)
    hold(errs, "k1_gather_weighted",
         k.k1_gather_weighted(dist.to(dev), a[0], a[3], "add", False), c)
    hold(errs, "k2_reduce_min",
         k.k2_reduce_min(c.view(torch.int32), a[1], "min", a[2]),
         k.k2_reduce_min_plain(c.view(torch.int32), a[1], "min"))
    out["relax"] = {"ms_per_call": min(timed_runs(
        lambda: weng.relax(dist), 2)[0]) * 1e3,
        "bytes_per_call": weng.bytes_per_call}
    del weng, resident, a, c
    free_device()

    # the three drivers, each building its own engine, against the
    # resident phases; each kernel launches once per slab and round, in
    # as many rounds as the in-core phase ran
    t0 = time.perf_counter()
    (scores, it, err), launches["pagerank"], streamed = drive_ooc(
        k, "ooc_pagerank", lambda: ooc.page_rank_ooc(
            src, dst, n, max_iterations=ITERS, tolerance=0.0,
            n_slabs=slabs, device=dev), "spmv", ITERS)
    # the in-core loop and arithmetic on the host: the same bits
    diff = float((scores - pr_res.scores.cpu()).abs().max())
    check(it == ITERS and torch.equal(scores, pr_res.scores.cpu()),
          f"page_rank_ooc: {it} iterations, {diff} off the pagerank phase")
    out["page_rank_ooc"] = {
        "s": time.perf_counter() - t0, "iterations": it, "error": err,
        "max_abs_vs_pagerank": diff, "slab_calls": streamed,
        "launches": launches["pagerank"]}
    t0 = time.perf_counter()
    comp, launches["wcc"], streamed = drive_ooc(
        k, "ooc_wcc", lambda: ooc.wcc_ooc(src, dst, n, n_slabs=slabs,
                                          device=dev), "smin_int", wcc_rounds)
    check(torch.equal(comp, wcc_labels.cpu()),
          "wcc_ooc labels differ from the wcc phase's")
    out["wcc_ooc"] = {"s": time.perf_counter() - t0, "rounds": wcc_rounds,
                      "slab_calls": streamed, "launches": launches["wcc"]}
    t0 = time.perf_counter()
    dist, launches["sssp"], streamed = drive_ooc(
        k, "ooc_sssp", lambda: ooc.sssp_ooc(src, dst, w, n, start,
                                            n_slabs=slabs, device=dev),
        "relax", sssp_res.ran_iterations)
    dist = dist.masked_fill(dist >= k.INF, float(F32_MAX))
    check(torch.equal(dist, sssp_res.distances.cpu()),
          "sssp_ooc distances differ from the sssp phase's")
    out["sssp_ooc"] = {"s": time.perf_counter() - t0,
                       "rounds": sssp_res.ran_iterations,
                       "slab_calls": streamed, "launches": launches["sssp"]}
    out["peak_mem_gb"] = max(peaks + [torch.cuda.max_memory_allocated()]) / 1e9
    emit({"phase": "ooc", "scale": SCALE, "n_slabs": slabs, **out})
    return out, launches


def free_device():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def bound_of(nbytes, nops):
    """(ms, "bytes" | "operations"): the larger of the two least times."""
    tb, to = nbytes / HBM_BYTES_PER_S, nops / SCALAR_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def row(name, path, source, replaces, launches, errs, run, plain,
        library, nbytes, nops, shapes, design):
    """One line of the kernel table; ``library`` is (what, call) or a
    string saying why there is no such call; ``design`` holds the
    design's facts (K2's tile, K1's window and the share it serves)."""
    bound, by = bound_of(nbytes, nops)
    lib_name, lib_call = (library, None) if isinstance(library, str) \
        else library
    return {"name": name, "path": path, "route": "cuda",
            "source": f"graph_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": time_ms(run),
            "plain_ms": time_ms(plain), "bound_ms": bound, "bound_by": by,
            "library_ms": None if lib_call is None else time_ms(lib_call),
            "library": lib_name, "bytes": nbytes, "shapes": shapes,
            **design}


def k1_design(window, slot_src):
    """K1's window and the share of slots it serves (from the plan)."""
    return {"window": window,
            "window_share": float((slot_src < window).double().mean())}


def k2_design(kernels, cuts):
    return {"tile_items": kernels.K2_TILE, "tiles": cuts.numel() - 1}


def window_probe(kernels, plan, xq, wplan, dist):
    """K1 at the PageRank shapes (4-byte) and the SSSP shapes (weighted
    add) with each of PROBE_WINDOWS, in this one process; every output
    held to the plain version first."""
    k = kernels
    want = k.k1_gather_plain(xq, plan.slot_src)
    want_w = k.k1_gather_weighted_plain(dist, wplan.slot_src, wplan.slot_w,
                                        "add", False)
    out = {"pagerank": {}, "sssp": {}}
    for h in PROBE_WINDOWS:
        check(bits_diff(k.k1_gather(xq, plan.slot_src, h), want) == 0,
              f"k1_gather with window {h} disagrees with its plain version")
        check(bits_diff(k.k1_gather_weighted(dist, wplan.slot_src,
                                             wplan.slot_w, "add", False,
                                             window=h), want_w) == 0,
              f"k1_gather_weighted with window {h} disagrees")
        out["pagerank"][h] = {
            "ms": time_ms(lambda: k.k1_gather(xq, plan.slot_src, h)),
            **k1_design(h, plan.slot_src)}
        out["sssp"][h] = {
            "ms": time_ms(lambda: k.k1_gather_weighted(
                dist, wplan.slot_src, wplan.slot_w, "add", False, window=h)),
            **k1_design(h, wplan.slot_src)}
    return out


def probe_edge_cases(dev, errs):
    """Every probe kernel against its plain version on arbitrary in-range
    input: the scripts' windows and depths, 1,000 rows (ragged against the
    kernels' 32-row chunks), x and t also at storage offset 1 (not 16-byte
    aligned), lanemap's stream with bits 7 and 15 set at random."""
    import torch

    from graph_tpu_torch.probes import k1_lanemap, kernels as p

    g = np.random.default_rng(21)
    shape = (1000, 128)
    for win in PROBE_SCRIPT_WINDOWS:
        idx = torch.from_numpy(g.integers(0, win, shape).astype(
            np.uint16)).to(dev)
        st = torch.from_numpy((g.integers(0, win // 128, shape) << 8
                               | g.integers(0, 256, shape)
                               | g.integers(0, 2, shape) << 15).astype(
            np.uint16)).to(dev)
        xs = torch.from_numpy(g.random(win + 1).astype(np.float32)).to(dev)
        for x in (xs[:win], xs[1:]):
            hold(errs, "probe_lanemap", p.lanemap(st, x),
                 p.lanemap_plain(st, x))
            hold(errs, "probe_sublane", p.sublane(idx, x),
                 p.sublane_plain(idx, x))
            for mode in p.MODES:
                hold(errs, "probe_window_gather",
                     p.window_gather(idx, x, mode),
                     p.window_gather_plain(idx, x, mode))
    idx = torch.from_numpy(g.integers(0, 1 << 16, shape).astype(
        np.uint16)).to(dev)
    for rows in k1_lanemap.ROWS:
        ts = torch.from_numpy(g.random(rows * 128 + 1).astype(
            np.float32)).to(dev)
        for t in (ts[:-1].view(rows, 128), ts[1:].view(rows, 128)):
            hold(errs, "probe_row_gather", p.row_gather(idx, t),
                 p.row_gather_plain(idx, t))


def k1_probes_phase(dev, errs):
    """The K1 gather probes through their entry points at the scripts'
    windows, depths and seeds, at 4,194,304 slots (the scripts' size) and
    67,108,864 (K1's at scale 22), each with the launch counts set to 0
    just before and read just after; every case exact against its plain
    version, the x[idx] shares of the scripts' findings, the bound and
    the library yardstick (timed here, on the case's inputs).  Returns
    the launches by size, the table rows' cases and the phase's line
    (emitted later, beside K1's own rate at each window)."""
    from graph_tpu_torch import profile
    from graph_tpu_torch.probes import (
        BLK, K1_NBLK, NBLK, k1_lanemap, k1_rowmatch, k1_sublane,
        kernels as p)

    table_case = {"probe_row_gather": ("rows", 128),
                  "probe_lanemap": ("win", 16384),
                  "probe_window_gather": ("win", 16384),
                  "probe_sublane": ("win", 8192)}
    cases, launches, out = {}, {}, {}

    def observe(res, inputs):
        idx, table = inputs
        res["bound_ms"], res["bound_by"] = bound_of(res["bytes"], 0)
        library = probe_library(res, idx, table)
        res["library_ms"] = None if library is None else time_ms(library)
        key, value = table_case[res["kernel"]]
        if (res["slots"] == K1_NBLK * BLK and res.get(key) == value
                and res.get("mode", "rowscan") in ("rowscan", "sublane")
                and res["kernel"] not in cases):
            cases[res["kernel"]] = (res, inputs, library)

    def drive_probes(nblk, **kw):
        res = k1_lanemap.depth_probe(nblk, dev, **kw)
        res += [k1_lanemap.lanemap_bench(win, nblk, dev, **kw)
                for win in k1_lanemap.WINDOWS]
        res += k1_rowmatch.bench(k1_rowmatch.WINDOWS, nblk, dev, **kw)
        res += k1_sublane.bench(k1_sublane.WINDOWS, nblk, dev, **kw)
        _sync()
        return res

    for nblk in (NBLK, K1_NBLK):
        p.reset_launches()
        t0 = time.perf_counter()
        res = drive_probes(nblk, observe=observe)
        launches[nblk] = dict(p.LAUNCHES)
        for name, n in launches[nblk].items():
            check(n >= 1, f"k1_probes: {name} launched {n} times at "
                  f"{nblk} blocks")
        for r in res:
            check(r["exact"], f"k1_probes: {r['label']} at {nblk} blocks "
                  "disagrees with its plain version")
            if r.get("mode") == "rowmatch":  # the script's row-matched input
                check(r["x_idx_share"] == 1.0, f"{r['label']}: x[idx] "
                      f"share {r['x_idx_share']}")
            if r.get("mode") == "sublane":  # reads the final lane's sublane
                check(0.08 < r["x_idx_share"] < 0.2, f"{r['label']}: x[idx] "
                      f"share {r['x_idx_share']}")
        out[f"{nblk * BLK}_slots"] = {
            "s": time.perf_counter() - t0,
            "cases": [{k: v for k, v in r.items() if k != "kernel"}
                      for r in res]}
    check(set(cases) == set(table_case),
          f"k1_probes: table cases {sorted(cases)}")
    # at the scripts' size a call's time is the host's (wrapper, ctypes,
    # launch): a traced pass gives each kernel's device time a launch
    with profile.trace(os.path.join(ROOT, ".cache", "profile")) as log_dir:
        drive_probes(NBLK, reps=5)
    busy = profile.device_busy(profile.newest_trace(log_dir))
    device_us = {}
    for name in p.LAUNCHES:
        kernel = f"::{name.removeprefix('probe_')}_kernel("
        hits = [(us, busy["device_calls_by_name"][k])
                for k, us in busy["device_us_by_name"].items() if kernel in k]
        calls = sum(c for _, c in hits)
        per_launch = sum(us for us, _ in hits) / calls if calls else None
        device_us[name] = {"launches_traced": calls,
                           "device_us_per_launch": per_launch}
    out[f"{NBLK * BLK}_slots"]["traced"] = device_us
    return launches, cases, out


def probe_library(res, idx, table):
    """The one PyTorch call that computes a probe case's function, where
    there is one: ``torch.take`` for rowscan (a gather from L2 with no
    staging), ``torch.gather`` for the depth probe; else None."""
    import torch

    if res["kernel"] == "probe_row_gather":
        return lambda: torch.gather(table, 0, (idx.to(torch.int32)
                                               % table.shape[0]).long())
    if res.get("mode") == "rowscan":
        return lambda: torch.take(table, idx.long())
    return None


def probe_rows(errs, launches, cases):
    """The four probe kernels' rows of the kernel table, at their 67 M-slot
    cases; each held once more against its plain version there."""
    from graph_tpu_torch.probes import BLK, k1_sublane, kernels as p

    replaces = {
        "probe_row_gather": "scripts/perf_k1_lanemap.py:28",
        "probe_lanemap": "scripts/perf_k1_lanemap.py:65",
        "probe_window_gather": "scripts/perf_k1_rowmatch.py:40",
        "probe_sublane": "scripts/perf_k1_sublane.py:36"}
    calls = {
        "probe_row_gather": (p.row_gather, p.row_gather_plain),
        "probe_lanemap": (p.lanemap, p.lanemap_plain),
        "probe_window_gather": (
            lambda i, x: p.window_gather(i, x, "rowscan"),
            lambda i, x: p.window_gather_plain(i, x, "rowscan")),
        "probe_sublane": (lambda i, x: k1_sublane.run("sublane", i, x),
                          lambda i, x: k1_sublane.plain("sublane", i, x))}
    total = launches_of(*launches.values())
    rows = []
    for name, (res, (idx, table), library) in cases.items():
        kernel, plain = calls[name]
        hold(errs, name, kernel(idx, table), plain(idx, table))
        design = {k: res[k] for k in ("rows", "win", "mode", "x_idx_share")
                  if k in res}
        t = row(name, "k1_probes", "k1_probes.cu", replaces[name], total,
                errs, lambda: kernel(idx, table), lambda: plain(idx, table),
                ("torch.gather" if name == "probe_row_gather"
                 else "torch.take", library) if library else
                "none: no single PyTorch call computes it",
                res["bytes"], 0, f"slots={res['slots']}", design)
        t["launches_by_path"] = {f"k1_probes ({n * BLK} slots)":
                                 runs[name] for n, runs in launches.items()}
        rows.append(t)
    return rows


def k2_probe_edge_cases(dev, errs):
    """Both stream kernels against their plain versions, bit for bit, on
    arbitrary input: 43 sections (odd) in mids of 1, 40 (longer than a
    piece: added pieces) and 2 sections; two and three passes; blocks
    never zeroed from a nonzero init, and a block never touched; every T,
    full and touched u16 and int32 sides, 640-wide touches, 1024-row
    steps; the f32 adds from init 0, NaN and 1.5."""
    import torch

    from graph_tpu_torch.probes import k2_kernels as kk, k2_layout as kl

    g = np.random.default_rng(31)
    sm = np.array([0] + [1] * 40 + [2] * 2, np.int32)
    rows = len(sm) * kl.SEC_R

    def dev_t(a):
        return torch.from_numpy(a).to(dev)

    v_round = dev_t((g.random((rows, 128)) * 3.8 - 1.9).astype(np.float32))
    v_trunc = dev_t((g.random((rows, 128)) * 6e3 - 3e3).astype(np.float32))
    u16 = [dev_t(g.integers(0, 1 << 16, (rows, 128)).astype(np.uint16))
           for _ in range(5)]
    i32 = [dev_t(g.integers(-2**31, 2**31, (rows, 128)).astype(np.int32))
           for _ in range(2)]
    k = np.arange(len(sm))
    never = kl.Steps(k * kl.SEC_R, sm.astype(np.int64),
                     np.zeros(len(sm), np.bool_), kl.SEC_R, 4, 2)
    cases = [  # (steps, v, sides, mode, read, init)
        (kl.acc_steps(sm, 3), v_round, u16, "round", "full", 0),
        (kl.k2_io4_multipass_steps(sm, 3, 3), v_round, u16, "round",
         "touch", 7),
        (never, v_trunc, u16[:3] + i32[:1], "trunc", "full", 12345),
        (never, v_round, i32 + u16[:1], "bitcast", "touch", -(1 << 31)),
        (kl.k2_io3_steps(sm, 3, "copy6w"), v_round, [torch.cat(u16, 1)],
         "round", "touch", -5),
        (kl.k2_io2_steps(sm, 3, "io2"), v_round, u16, "round", "touch", 0),
        (kl.k2_io3_steps(sm, 3, "copy1"), v_round, [], "bitcast", "touch",
         0),
        (kl.k2_io_steps(np.arange(32) // 16, "F", 3), v_trunc, u16[:3],
         "trunc", "full", 99)]
    for steps, v, sides, mode, read, init in cases:
        sched = kk.schedule(steps, dev)
        hold(errs, "probe_sec_stream",
             kk.sec_stream(v, sides, sched, mode, read, init),
             kk.sec_stream_plain(v, sides, steps, mode, read, init))
    f32_sides = [u16[0], i32[0], i32[1], u16[1]]
    for steps, init in ((kl.k2_streams_steps(sm, 3), 0.0),
                        (kl.k2_streams_steps(sm, 4), float("nan")),
                        (never, 1.5)):
        sched = kk.schedule(steps, dev, ordered=True)
        hold(errs, "probe_sec_stream_f32",
             kk.sec_stream_f32(v_round, f32_sides, sched, init),
             kk.sec_stream_f32_plain(v_round, f32_sides, steps, init))


#: Where each K2 stream kernel's table row is timed, and what it replaces.
K2_PROBE_ROWS = {"probe_sec_stream": ("k2_io5", "read6"),
                 "probe_sec_stream_f32": ("k2_streams",
                                          "6 streams (14B/slot)")}
K2_PROBE_REPLACES = {
    "probe_sec_stream": ", ".join(
        f"scripts/{site}" for site in (
            "perf_k2_io.py:102", "perf_k2_io.py:120", "perf_k2_io2.py:73",
            "perf_k2_io3.py:122", "perf_k2_io4.py:108",
            "perf_k2_io4.py:145", "perf_k2_io5.py:103")),
    "probe_sec_stream_f32": "scripts/perf_k2_streams.py:69"}


def device_copy_rate(dev, nbytes=1 << 30):
    """A 1 GB device-to-device ``copy_``: ms, and GB/s of the bytes read
    and written."""
    import torch

    a = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    b = torch.empty_like(a)
    ms = time_ms(lambda: b.copy_(a))
    del a, b
    return {"bytes": nbytes, "ms": ms, "gb_per_s": 2 * nbytes / ms / 1e6}


def k2_probes_phase(dev, card, errs, indptr, k2_own):
    """The K2 stream-floor probes through their six entry points at the
    scripts' sizes, with the launch counts set to 0 just before and read
    just after: ``perf_k2_io.py``'s synthetic streams (512 sections, 200
    passes a launch), the section layout of the scale-22 plan
    (``indptr``; one draw of contributions and side streams shared by the
    four RMAT scripts), ``perf_k2_streams.py``'s 1,024 sections.  Every
    variant exact against its plain version, with its bound, and for A the
    library call ``v.to(torch.int32)`` a pass; beside them K2's own ns a
    slot (``k2_own``: the kernel table's K2 rows) and a 1 GB copy.
    Returns the launches, each kernel row's case and the launches by
    entry point."""
    import torch

    from graph_tpu_torch.probes import (
        k2_io, k2_io2, k2_io3, k2_io4, k2_io5, k2_kernels as kk,
        k2_layout as kl, k2_streams)

    cases, out = {}, {}

    def observer(script):
        def observe(res, inputs):
            steps, v, _ = inputs
            res["bound_ms"], res["bound_by"] = bound_of(res["port_bytes"], 0)
            if res.get("variant") == "A":
                per_pass = time_ms(lambda: v.to(torch.int32))
                res["library"] = "v.to(torch.int32), a pass"
                res["library_ms"] = per_pass * steps.passes
            for name, where in K2_PROBE_ROWS.items():
                if where == (script, res["label"]):
                    cases[name] = (res, inputs)
        return observe

    kk.reset_launches()
    t0 = time.perf_counter()
    sec_mid, nmid = kl.sections(indptr)
    inputs = kl.rmat_inputs(len(sec_mid), dev)
    def on_layout(mod):
        return lambda o: mod.bench(sec_mid, nmid, dev, observe=o,
                                   inputs=inputs)

    runs = {"k2_io": lambda o: k2_io.bench(device=dev, observe=o),
            "k2_io2": on_layout(k2_io2), "k2_io3": on_layout(k2_io3),
            "k2_io4": on_layout(k2_io4), "k2_io5": on_layout(k2_io5),
            "k2_streams": lambda o: k2_streams.bench(device=dev, observe=o)}
    secs, by_script = {}, {}
    for name, run_script in runs.items():
        t1 = time.perf_counter()
        before = dict(kk.LAUNCHES)
        out[name] = run_script(observer(name))
        _sync()
        secs[name] = time.perf_counter() - t1
        by_script[name] = {k: kk.LAUNCHES[k] - before[k] for k in before}
    launches = dict(kk.LAUNCHES)
    for name, n in launches.items():
        check(n >= 1, f"k2_probes: {name} launched {n} times")
    for name, results in out.items():
        for r in results:
            check(r["exact"], f"k2_probes: {name} {r['label']} disagrees "
                  "with its plain version")
    check(set(cases) == set(K2_PROBE_ROWS),
          f"k2_probes: table cases {sorted(cases)}")
    del inputs
    free_device()
    copy = device_copy_rate(dev)
    reads = {r["label"]: r for r in out["k2_io5"]}
    floor = {label: {key: reads[label].get(key) for key in (
                 "ms", "device_ms", "ns_per_slot", "slope_ns_per_slot",
                 "port_gb_per_s", "device_gb_per_s")}
             for label in ("read1", "read2", "read6")}
    emit({"phase": "k2_probes", "card": card, "nsec": len(sec_mid),
          "nmid": nmid, "s": time.perf_counter() - t0, "script_s": secs,
          "launches": launches, "launches_by_script": by_script,
          "copy_1gb": copy,
          "k2_own": k2_own, "stream_floor": floor,
          "cases": {name: [{k: v for k, v in r.items() if k != "kernel"}
                           for r in results]
                    for name, results in out.items()}})
    return launches, cases, by_script


def k2_probe_rows(errs, launches, cases, by_script):
    """The two stream kernels' rows of the kernel table, each at its named
    variant, held once more against its plain version there; each row's
    launches by entry point."""
    from graph_tpu_torch.probes import k2_kernels as kk
    from graph_tpu_torch.probes.timing import graph_ms

    rows = []
    for name, (res, (steps, v, sides)) in cases.items():
        f32 = name == "probe_sec_stream_f32"
        sched = kk.schedule(steps, v.device, ordered=f32)
        if f32:
            def run(s=sched, v=v, sides=sides):
                return kk.sec_stream_f32(v, sides, s)

            def plain(steps=steps, v=v, sides=sides):
                return kk.sec_stream_f32_plain(v, sides, steps)
        else:
            def run(s=sched, v=v, sides=sides, r=res):
                return kk.sec_stream(v, sides, s, r["mode"], r["read"])

            def plain(steps=steps, v=v, sides=sides, r=res):
                return kk.sec_stream_plain(v, sides, steps, r["mode"],
                                           r["read"])
        hold(errs, name, run(), plain())
        slots = res["slots"]
        design = {k: res[k] for k in ("label", "mode", "read", "nsides",
                                      "passes", "steps", "h", "nout")}
        design["script"] = K2_PROBE_ROWS[name][0]
        rows.append(row(name, "k2_probes", "k2_probes.cu",
                        K2_PROBE_REPLACES[name], launches, errs, run, plain,
                        "none: no single PyTorch call computes it",
                        res["port_bytes"], slots * (1 + len(sides)),
                        f"slots={slots}", design))
        rows[-1]["device_ms"] = graph_ms(run, v.device, 20)
        rows[-1]["launches_by_path"] = {
            f"k2_probes ({script})": counts[name]
            for script, counts in by_script.items() if counts[name]}
    return rows


def k2_stage_edge_cases(dev, errs, routed):
    """Both stage kernels against their plain versions, bit for bit, on
    arbitrary input: one to three sections, a mid of one section, a block
    never touched, real routes (``routed``: ``k2_routes.sec128_inputs`` of
    two 512-row sections) and random ones (not permutations), blocks never
    zeroed from a nonzero init over two passes, the scans truncated (lane
    and row steps), the compaction with random windows, u8 middles, and
    two and four outputs; for both kernels also pieces of several steps
    (chains of six and ten into one block), one to four outputs, scans at
    both depths' ends ((0, 0), (7, 0), (0, R), (1, R), (7, R); R = 7 or
    9), prefix sums, f32 loads with a pad side by round and trunc, a load
    in layout 1, the transpose bodies, touches and constants, u8 sides
    only and u8 with u16, and all sides live at once."""
    import torch

    from graph_tpu_torch.probes import k2_routes as kr
    from graph_tpu_torch.probes import k2_stage_kernels as ks
    from graph_tpu_torch.probes.k2_layout import Steps, first_of_mid

    g = np.random.default_rng(41)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def steps(rows, sm, nout, zero=None, passes=1, first=0):
        sm = np.asarray(sm, np.int64)
        z = first_of_mid(sm) if zero is None else zero
        return Steps((first + np.arange(len(sm), dtype=np.int64)) * rows, sm,
                     np.asarray(z, np.bool_), rows, nout, passes)

    real512 = [t(routed[k]) for k in ("wa", "wb", "ss", "wa2", "wb2")]
    real128 = [t(routed[k]) for k in ("wa_2", "m1_2", "ss_2", "wa2_2",
                                      "m2_2")]
    rand = [t(g.integers(0, 1 << 16, (3 * 512, 128)).astype(np.uint16))
            for _ in range(5)]
    vf = t((g.random((3 * 512, 128)) * 3.8 - 1.9).astype(np.float32))
    vi = t(g.integers(-2**31, 2**31, (3 * 512, 128)).astype(np.int32))
    meta = kr.stages_meta(3).reshape(3, 129)
    meta[:, 1:65] = g.integers(0, 48, (3, 64)) * 1024
    meta[:, 65:] = g.integers(0, 3, (3, 64))
    meta = meta.reshape(-1)
    # (steps, init): one section; two into the second of two blocks; three
    # with a mid of one section; three never zeroed over two passes
    two = [(steps(512, [0], 1), 0), (steps(512, [1, 1], 2), 7)]
    three = two + [(steps(512, [0, 1, 1], 2), -3),
                   (steps(512, [0, 0, 1], 3, [False] * 3, 2), 12345)]
    programs = list(ks.STAGES.values()) + [
        ks.K2V2["full"], ks.FULL_INT, ks.ROUTE_OPS["c_roll"],
        ks.ROUTE_OPS["taa2"], ks.TRANSPOSE["t512x2"][1],
        ks.TRANSPOSE["taa512"][1],
        (("load", "round", 1), *ks.route(1, 2), ("scan", 3, 5, 1)),
        (("load", "round", 1), *ks.route(1, 2), ("scan", 3, 3, 0))]
    for sides, layouts in ((real512, two), (rand, three)):
        for program in programs:
            v = vi if program[0][1] == "int" else vf
            m = meta if any(op[0] == "compact" for op in program) else None
            for st, init in layouts:
                sched = ks.schedule([st], dev, m)
                hold(errs, "probe_sec_route",
                     ks.sec_route(v, sides, program, sched, init),
                     ks.stage_plain(v, sides, program, [st], sched.meta,
                                    init)[0])
    st = steps(512, [0], 1)
    hold(errs, "probe_sec_route",
         ks.sec_route(vi, real512[1:2], ks.C_ONLY, ks.schedule([st], dev)),
         ks.stage_plain(vi, real512[1:2], ks.C_ONLY, [st])[0])

    def layouts(rows):
        """One to four outputs; pieces of several steps (a chain of six
        into one block, one piece, so that the next section's v and sides
        are fetched; a chain of ten, pieces of eight and two, added),
        never-zeroed blocks."""
        quad = [steps(rows, [i], 4, first=i) for i in range(4)]
        ten = np.asarray([0] * 10 + [1] * 2, np.int64)
        chain10 = Steps(np.arange(12, dtype=np.int64) % 6 * rows, ten,
                        first_of_mid(ten), rows, 2, 1)
        return (([steps(rows, [0, 1, 1], 3)], 0),
                ([steps(rows, [1, 1], 2, [False] * 2, 2)], -5),
                ([steps(rows, [0] * 6 + [1] * 2, 2)], 3), ([chain10], 11),
                (quad[:2], -(1 << 31)), (quad, 1 << 30))

    # the 512-row kernel's boundaries, on eight sections: full at the
    # scans' depths, prefix sums alone and before the compaction, a load
    # in the Y layout, the transpose probe's bodies and the C stage alone,
    # every side added and masked, a trunc load with a pad side
    rand8 = [t(g.integers(0, 1 << 16, (8 * 512, 128)).astype(np.uint16))
             for _ in range(5)]
    vf8 = t((g.random((8 * 512, 128)) * 3.8 - 1.9).astype(np.float32))
    vi8 = t(g.integers(-2**31, 2**31, (8 * 512, 128)).astype(np.int32))
    meta8 = kr.stages_meta(8).reshape(8, 129)
    meta8[:, 1:65] = g.integers(0, 48, (8, 64)) * 1024
    meta8[:, 65:] = g.integers(0, 3, (8, 64))
    meta8 = meta8.reshape(-1)
    programs = [(("load", "round", 1), *ks.route(1, 2), ("scan", 3, *d),
                 *ks.route(4, 5), ("mask", 4))
                for d in ((7, 9), (0, 0), (7, 0), (0, 9), (1, 9))]
    programs += [
        (("load", "int"), ("psum",)),
        (("load", "int"), *ks.route(1, 2), ("psum",), ("compact", 3)),
        (("load", "int", 0, 1), ("ti",), ("gather", 2, 3), ("t",),
         ("gather", 0, 13), ("c", 1), ("ti",), ("add_touch", 5)),
        ks.TRANSPOSE["t512x2"][1], ks.TRANSPOSE["taa512"][1], ks.C_ONLY,
        (("load", "int"), *(("add_full", s) for s in range(1, 6)),
         *(("mask", s) for s in range(1, 5)), ("add_const", -7)),
        (("load", "trunc", 3), ("gather", 1, 7), ("mask", 3),
         ("add_touch", 2))]
    mixed8 = [rand8[0], rand8[1].to(torch.uint8), rand8[2], rand8[3],
              rand8[4].to(torch.uint8)]
    for sides in (rand8, mixed8, [s.to(torch.uint8) for s in rand8]):
        for program in programs:
            v = vi8 if program[0][1] == "int" else vf8
            m = meta8 if any(op[0] == "compact" for op in program) else None
            for sl, init in layouts(512):
                sched = ks.schedule(sl, dev, m)
                outs = ks.sec_route_outs(v, sides, program, sched, init)
                for got, want in zip(outs, ks.stage_plain(
                        v, sides, program, sl, sched.meta, init)):
                    hold(errs, "probe_sec_route", got, want)

    rand128 = [rand[0], rand[1].to(torch.uint8) & 127, rand[2], rand[3],
               rand[4].to(torch.uint8) & 127]
    # the 128-row kernel's boundaries: scans at the ends of both depths,
    # prefix sums, f32 loads with a pad side, a load in the Y layout, the
    # transpose probe's bodies, gathers by shift and touches, and four
    # sides live at once
    programs = [ks.sec128_program(*d) for d in (
        (4, 7, 7), (1, 7, 7), (2, 7, 7), (3, 7, 7), (4, 5, 1), (4, 7, 3),
        (3, 7, 0), (4, 0, 0), (4, 7, 0), (4, 0, 7), (4, 1, 7))]
    programs += [
        (("load", "int"), ("psum",), ("add_full", 1)),
        (("load", "int"), *ks.route128(1, 2), ("psum",), ("mask", 4)),
        (("load", "int", 0, 1), ("ti",), ("gather", 2, 3), ("t",),
         ("gather", 0, 13), ("ti",), ("add_touch", 5)),
        ks.TRANSPOSE["t128x8"][1], ks.TRANSPOSE["taa128x4"][1],
        (("load", "int"), ("add_full", 1), ("add_full", 2), ("add_full", 3),
         ("add_full", 4), ("mask", 1), ("mask", 2), ("mask", 3),
         ("mask", 4), ("add_const", -7))]
    f32_programs = [
        (("load", "round", 1), *ks.route128(2, 3), ("scan", 4, 7, 7)),
        (("load", "trunc", 3), ("gather", 1, 7), ("mask", 3),
         ("add_touch", 2))]
    u8_all = [s.to(torch.uint8) for s in rand128]
    for sides in (real128, rand128, u8_all):
        for program in programs + f32_programs:
            v = vi if program[0][1] == "int" else vf
            for sl, init in layouts(128):
                outs = ks.sec128(v, sides, program, ks.schedule(sl, dev),
                                 init)
                for got, want in zip(outs, ks.stage_plain(
                        v, sides, program, sl, None, init)):
                    hold(errs, "probe_sec128", got, want)


#: Each stage-probe site's table row: (kernel, entry point, case label,
#: the TPU kernel it replaces).
K2_STAGE_ROWS = (
    ("probe_sec_route", "k2_stages", "compact",
     "scripts/perf_k2_stages.py:66"),
    ("probe_sec_route", "k2v2_stages", "full",
     "scripts/perf_k2v2_stages.py:86"),
    ("probe_sec_route", "k2_route_ops", "both_routes",
     "scripts/perf_k2_route_ops.py:113"),
    ("probe_sec_route", "k2_route_ops", "c_only",
     "scripts/perf_k2_route_ops.py:167"),
    ("probe_sec128", "k2_sec128", "sec128",
     "scripts/perf_k2_sec128.py:159"),
    ("probe_sec128", "k2_sec128", "quad(7,7)",
     "scripts/perf_k2_sec128.py:218"),
    ("probe_sec_route", "transpose", "t512x2",
     "scripts/perf_transpose.py:33"))


#: The source of each stage-probe kernel.
K2_STAGE_SOURCES = {
    "probe_sec_route": "graph_tpu_torch/csrc/k2_sections.cu",
    "probe_sec128": "graph_tpu_torch/csrc/k2_sections.cu"}


def k2_stages_graph_free(dev, sec128_inputs, stages_inputs):
    """The stage probes that need no graph, through their entry points at
    the scripts' sizes, with the counts set to 0 just before and read just
    after: ``perf_k2_stages.py``'s 512 synthetic sections x 150 passes,
    ``perf_k2_sec128.py``'s 8 + 32 ``gen_keys`` sections,
    ``perf_transpose.py``'s 128 blocks.  Returns (results by entry point,
    each case's inputs by (entry point, label), launches, seconds by entry
    point, launches by entry point)."""
    from graph_tpu_torch.probes import (k2_sec128, k2_stage_kernels as ks,
                                        k2_stages, transpose)

    cases, out, secs, by_script = {}, {}, {}, {}

    def observer(script):
        def observe(res, inputs):
            cases[(script, res["label"])] = (res, inputs)
        return observe

    ks.reset_launches()
    for name, fn in (("k2_stages", lambda o: k2_stages.bench(
                         device=dev, observe=o, inputs=stages_inputs)),
                     ("k2_sec128", lambda o: k2_sec128.bench(
                         device=dev, observe=o, inputs=sec128_inputs)),
                     ("transpose", lambda o: transpose.bench(
                         device=dev, observe=o))):
        t1 = time.perf_counter()
        before = dict(ks.LAUNCHES)
        out[name] = fn(observer(name))
        _sync()
        secs[name] = time.perf_counter() - t1
        by_script[name] = {k: ks.LAUNCHES[k] - before[k] for k in before}
    return out, cases, dict(ks.LAUNCHES), secs, by_script


def k2_stages_phase(dev, card, graph_free, routing, indptr, k2_own):
    """The stage probes on the routed stand-in of the scale-22 plan
    (``routing``: the stand-in and the host thread routing it, started
    when the plan was built), with the counts set to 0 just before and
    read just after; then every result, ``graph_free``'s included,
    checked: each variant exact against its plain version, ``full`` equal
    to the port's K2 (``k2_reduce``) on every destination (``indptr``: the
    plan's), the C stage alone to numpy, both forms of
    ``perf_k2_sec128.py`` to numpy's sums and the port's K2.  Emits the
    phase's line and returns (launches, each case's inputs, the routed
    layout, launches by entry point)."""
    import torch

    from graph_tpu_torch.engine import kernels
    from graph_tpu_torch.probes import (k2_route_ops, k2_routes as kr,
                                        k2_stage_kernels as ks, k2v2_stages)

    t0 = time.perf_counter()
    out, cases, launches_a, secs, by_script = graph_free
    stand_in, fut = routing
    streams, route_s = fut.result()
    wait_s = time.perf_counter() - t0
    layout = kr.routed_layout(stand_in, streams, route_s, dev)
    del streams

    def observe_as(script):
        def observe(res, inputs):
            cases[(script, res["label"])] = (res, inputs)
        return observe

    ks.reset_launches()
    for name, mod in (("k2v2_stages", k2v2_stages),
                      ("k2_route_ops", k2_route_ops)):
        t1 = time.perf_counter()
        before = dict(ks.LAUNCHES)
        out[name] = mod.bench(layout, dev, reps=STAGE_RMAT_REPS,
                              observe=observe_as(name))
        _sync()
        secs[name] = time.perf_counter() - t1
        by_script[name] = {k: ks.LAUNCHES[k] - before[k] for k in before}
    launches = {k: launches_a[k] + ks.LAUNCHES[k] for k in launches_a}
    for name, n in launches.items():
        check(n >= 1, f"k2_stages: {name} launched {n} times")
    for name, results in out.items():
        for r in results:
            check(r["exact"], f"k2_stages: {name} {r['label']} disagrees "
                  "with its plain version")
    check(out["k2_route_ops"][0]["numpy_exact"],
          "k2_stages: the C stage alone disagrees with numpy")
    check(out["k2_sec128"][0]["numpy_exact"],
          "k2_stages: k2_sec128's forms disagree with numpy's sums")
    full = next(r for r in out["k2v2_stages"] if r["label"] == "full")
    n = indptr.numel() - 1
    y = full["result"][0].view(-1)
    check(torch.equal(y[:n], kernels.k2_reduce(
        kr.quanta_in_csr_order(layout), indptr)),
          "k2_stages: full disagrees with k2_reduce")
    check(bool((y[n:] == 0).all()),
          "k2_stages: full wrote past the last destination")
    for _, script, label, _ in K2_STAGE_ROWS:
        check((script, label) in cases, f"k2_stages: no case {label}")
    emit({"phase": "k2_stages", "card": card, "nsec": layout.nsec,
          "nmid": layout.nmid, "route_s": layout.route_s,
          "route_wait_s": wait_s, "s": time.perf_counter() - t0,
          "script_s": secs, "launches": launches,
          "launches_by_script": by_script, "k2_own": k2_own,
          "cases": {name: [{k: v for k, v in r.items()
                            if k not in ("run", "plain", "result",
                                         "inputs")} for r in rs]
                    for name, rs in out.items()}})
    return launches, cases, layout, by_script


def k2_stage_rows(errs, launches, cases, layout, stand_in, sec128_inputs,
                  by_script):
    """The seven stage-probe sites' rows of the kernel table, each at its
    named case, held once more against its plain version there, with
    each row's launches by entry point and the card's own time a call.
    The library yardstick, a call and on the card: ``index_add_`` of the
    quanta into the destinations for ``full``, ``k2_128`` and ``k2_quad``
    (the same sums; the quantization and routing are not in it),
    ``torch.gather`` by the precomputed rows for the C stage alone, the
    round trip of two ``transpose(1, 2).contiguous()`` for ``t512x2``."""
    import torch

    from graph_tpu_torch.probes.timing import graph_ms

    rows = []
    for kernel, script, label, replaces in K2_STAGE_ROWS:
        res, (_, v, sides, _) = cases[(script, label)]
        run, plain = res["run"], res["plain"]
        for got, want in zip(run(), plain()):
            hold(errs, kernel, got, want)
        what, call = library_call(label, v, sides, layout, stand_in,
                                  sec128_inputs)
        bound, by = bound_of(res["bytes"], res["ops"])
        rows.append({
            "name": kernel, "path": "k2_stages", "route": "cuda",
            "source": K2_STAGE_SOURCES[kernel],
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": errs[kernel], "ms": time_ms(run, 5),
            "plain_ms": time_ms(plain, 1), "bound_ms": bound,
            "bound_by": by,
            "library_ms": None if call is None else time_ms(call, 5),
            "library_device_ms": (None if call is None
                                  else graph_ms(call, v.device, 5)),
            "library": what, "bytes": res["bytes"], "ops": res["ops"],
            "shapes": f"slots={res['slots']}", "script": script,
            "label": label, "rows": res["rows"], "passes": res["passes"],
            "steps": res["steps"], "outputs": res["outputs"],
            "device_ms": graph_ms(run, v.device, 5),
            "launches_by_path": {f"k2_stages ({s})": c[kernel]
                                 for s, c in by_script.items() if c[kernel]}})
        torch.cuda.empty_cache()
    return rows


def _index_add(keys, sec_mid, mid, values, dev):
    """``index_add_`` of ``values`` (one a slot) into block ``sec_mid[k] *
    mid + key`` of each section k's keys (pads into one slot past the
    end): the call, timed as the yardstick."""
    import torch

    k = torch.from_numpy(np.ascontiguousarray(keys)).to(dev).view(
        len(sec_mid), -1).long()
    sm = torch.from_numpy(np.asarray(sec_mid)).to(dev).long()[:, None]
    size = (int(np.max(sec_mid)) + 1) * mid
    index = torch.where((k >= 0) & (k < mid), sm * mid + k, size).view(-1)
    vals = values.reshape(-1)
    return lambda: torch.zeros(size + 1, dtype=torch.int32,
                               device=dev).index_add_(0, index, vals)


def library_call(label, v, sides, layout, stand_in, z):
    """(what, call) of the one PyTorch call that computes a row's
    function, or (why not, None)."""
    import torch

    dev = v.device
    if label == "full":
        q = torch.round(layout.v * float(1 << 30)).to(torch.int32)
        return ("index_add_ of the quanta", _index_add(
            stand_in.keys, stand_in.sec_mid, 65536, q, dev))
    if label in ("sec128", "quad(7,7)"):
        return ("index_add_ of the contributions", _index_add(
            z["keys128"], np.arange(len(z["keys128"])), 16384, v, dev))
    if label == "c_only":
        r = torch.arange(512, device=dev)[:, None]
        idx = (r & ~3) | ((sides[0].to(torch.int64) >> 7) & 3)
        return ("torch.gather by the precomputed rows",
                lambda: torch.gather(v, 0, idx))
    if label == "t512x2":
        return ("the round trip, as t512x2: v.view(-1, 512, 128).transpose("
                "1, 2).contiguous().transpose(1, 2).contiguous(), two "
                "copies", lambda: v.view(-1, 512, 128).transpose(
                    1, 2).contiguous().transpose(1, 2).contiguous())
    return ("none: no single PyTorch call computes it", None)


def profile_phase(gtt, graph, cfg, card):
    """One ``graph_tpu_torch.profile.trace`` of the 20-iteration PageRank
    on the scale-22 plan (each iteration annotated by the port): the
    trace's size, the kernels that took the most device time, and the
    device's busy share over the run and over the whole trace."""
    from graph_tpu_torch import profile
    from graph_tpu_torch.algos.pagerank import ITERATION

    gtt.page_rank(graph, cfg)  # warm: the engine is built and cached
    with profile.trace(os.path.join(ROOT, ".cache", "profile")) as log_dir:
        with profile.annotate("pagerank_run"):
            res = gtt.page_rank(graph, cfg)
    path = profile.newest_trace(log_dir)
    with open(path) as f:
        iterations = sum(e.get("name") == ITERATION
                         and e.get("cat") == "user_annotation"
                         for e in json.load(f)["traceEvents"])
    check(iterations == res.ran_iterations == ITERS,
          f"profile: {iterations} annotated iterations")
    run = profile.device_busy(path, region="pagerank_run")
    whole = profile.device_busy(path)
    check(run["busy_us"] > 0, "profile: no device activity in the trace")
    top = list(run["device_us_by_name"].items())[:8]
    emit({"phase": "profile", "card": card, "trace_bytes":
          os.path.getsize(path), "iterations": res.ran_iterations,
          "run_s": res.micros / 1e6, "run_window_us": run["window_us"],
          "run_busy_us": run["busy_us"],
          "run_busy_share": run["busy_share"],
          "trace_window_us": whole["window_us"],
          "trace_busy_share": whole["busy_share"],
          "top_device_us": dict(top),
          "port_kernels_seen": sorted(
              name for name in run["device_us_by_name"]
              if "k1_" in name or "k2_" in name)})


class RmatProcess:
    """Graph500 RMAT at ``scale`` generated into ``cache_dir`` by a
    process of its own, so that its host time overlaps the steps that need
    no graph; :meth:`stop` ends it whatever happened."""

    def __init__(self, scale, cache_dir):
        self.scale, self.cache_dir = scale, cache_dir
        ctx = multiprocessing.get_context("spawn")
        self.seconds = ctx.Value("d", -1.0)
        self.proc = ctx.Process(target=generate_rmat,
                                args=(scale, cache_dir, self.seconds))
        self.started = False

    def start(self):
        self.proc.start()
        self.started = True

    def result(self):
        """(src, dst, seconds waited, seconds the generation took)."""
        from graph_tpu_torch.generate import cached_rmat

        t0 = time.perf_counter()
        self.proc.join()
        check(self.proc.exitcode == 0,
              f"RMAT generation exited {self.proc.exitcode}")
        wait_s = time.perf_counter() - t0
        src, dst = cached_rmat(self.scale, self.cache_dir)
        return src, dst, wait_s, self.seconds.value

    def stop(self):
        if self.started:
            if self.proc.is_alive():
                self.proc.terminate()
            self.proc.join()


def generate_rmat(scale, cache_dir, seconds):
    """:class:`RmatProcess`'s target: the cached RMAT, its seconds into
    the shared ``seconds``."""
    sys.path.insert(0, ROOT)
    from graph_tpu_torch.generate import cached_rmat

    t0 = time.perf_counter()
    cached_rmat(scale, cache_dir)
    seconds.value = time.perf_counter() - t0


def run(rmat):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import graph_tpu_torch as gtt
        from graph_tpu_torch.algos.pagerank import _graph_engine
        from graph_tpu_torch.engine import _build, kernels
        from graph_tpu_torch.native.build import build_library
        from graph_tpu_torch.probes import k2_kernels as k2_probes
        from graph_tpu_torch.probes import k2_routes
        from graph_tpu_torch.probes import k2_stage_kernels as k2_stage
        from graph_tpu_torch.probes import kernels as probes
    except ImportError as exc:
        print(f"chip_smoke: graph_tpu_torch not found next to this script "
              f"({exc})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    k = kernels

    # 1. RMAT scale 22 generated on the host in a process of its own while
    # the graph-free steps run; card and kernel build (one nvcc per
    # source, all started together, and beside them one g++ per host C++
    # source)
    rmat.start()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(HOST_SOURCES)) as ex:
        host = [ex.submit(build_library, name) for name in HOST_SOURCES]
        built = _build.build()
        host_built = [os.path.basename(f.result()) for f in host]
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels_built": built, "host_libraries": host_built,
          "build_s": time.perf_counter() - t0,
          "ptxas": {src: _build.ptxas_usage(log)
                    for src, log in sorted(_build.LOGS.items())},
          "active_clusters": {
              name: _build.load("probe_sec_clusters")(rows)
              for name, rows in (("probe_sec_route", 512),
                                 ("probe_sec128", 128))}})

    # 2. kernels against their plain versions at edge-case shapes, then
    # the algorithms on small graphs against the CPU path
    errs = {name: 0 for name in k.LAUNCHES}
    for seed in (13, 14):
        check_edge_cases(k, edge_cases(dev, seed), errs)
    emit({"phase": "kernels_edge_cases", "max_abs_err": dict(errs)})
    emit({"phase": "small_graphs", **small_graph_checks(gtt, dev)})

    # 3. what needs no graph, while RMAT is generated: the K1 gather
    # probes (their edge cases first, not counted; the phase's line is
    # printed in step 9, beside K1's own rate) and the K2 stream probes'
    # edge cases (not counted)
    probe_errs = {name: 0 for name in probes.LAUNCHES}
    probe_edge_cases(dev, probe_errs)
    probe_launches, cases, k1_out = k1_probes_phase(dev, probe_errs)
    k1_rows = probe_rows(probe_errs, probe_launches, cases)
    del cases
    k2_errs = {name: 0 for name in k2_probes.LAUNCHES}
    k2_probe_edge_cases(dev, k2_errs)
    free_device()
    # the K2 stage probes' edge cases (not counted), then the three entry
    # points that need no graph (their line is printed in step 9)
    stage_errs = {name: 0 for name in k2_stage.LAUNCHES}
    k2_stage_edge_cases(dev, stage_errs, k2_routes.sec128_inputs(2))
    sec128_in = k2_routes.sec128_inputs()
    stage_graph_free = k2_stages_graph_free(dev, sec128_in,
                                            k2_routes.stages_inputs())
    free_device()

    # 4. the PageRank path
    n = 1 << SCALE
    t0 = time.perf_counter()
    src, dst, rmat_wait_s, rmat_gen_s = rmat.result()
    rmat_s = time.perf_counter() - t0
    m = int(src.size)
    t0 = time.perf_counter()
    graph = gtt.build_directed(src, dst, node_count=n, device=dev)
    _sync()
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = _graph_engine(graph)  # the engine page_rank builds and caches
    _sync()
    plan_s = time.perf_counter() - t0
    # the K2 stage probes' stand-in of the plan's routed sections: its
    # keys on the card, routed on the host by a thread of its own (the
    # native router releases the GIL) while the next steps run
    stand_in = k2_routes.stand_in_keys(eng.plan.indptr, eng.plan.slot_src)
    route_pool = ThreadPoolExecutor(1)
    routing = (stand_in, route_pool.submit(
        k2_routes.route_stand_in, stand_in, max(1, (os.cpu_count() or 2) - 1)))
    route_pool.shutdown(wait=False)
    x_t, bad = gate(eng, src, dst, n, dev)

    cfg = gtt.PageRankConfig(engine="plan", max_iterations=ITERS,
                             tolerance=0.0)
    res, pr_launches = drive(k, "pagerank", lambda: gtt.page_rank(graph, cfg),
                             lambda r: r.ran_iterations)
    runs, res = timed_runs(lambda: gtt.page_rank(graph, cfg))
    best = min(runs)
    scores = res.scores
    check(res.ran_iterations == ITERS, f"ran {res.ran_iterations} iterations")
    check(tuple(scores.shape) == (n,) and scores.dtype == torch.float32,
          f"scores have shape {tuple(scores.shape)} {scores.dtype}")
    check(bool(torch.isfinite(scores).all()) and bool((scores > 0).all()),
          "scores not finite and positive")
    total = float(scores.double().sum())
    check(0.0 < total <= 1.0 + 1e-4, f"scores sum to {total}")
    gteps = m * ITERS / best / 1e9
    emit({"phase": "pagerank", "scale": SCALE, "n": n, "m": m,
          "rmat_s": rmat_s, "rmat_wait_s": rmat_wait_s,
          "rmat_generate_s": rmat_gen_s, "build_directed_s": graph_s,
          "plan_build_s": plan_s, "gate_bad_rows": bad,
          "iterations": res.ran_iterations, "error": res.error,
          "score_sum": total, "run_s": runs, "best_s": best,
          "gteps": gteps,
          "roofline_gteps_12B_per_edge": HBM_BYTES_PER_S / BYTES_PER_EDGE / 1e9,
          "launches": pr_launches})

    # 5. the WCC and SSSP paths, on the same RMAT edges
    sym, wcc_launches, wcc_labels, wcc_rounds = wcc_phase(
        gtt, k, graph, src, dst, n)
    wgraph, start, weng, sssp_res, sssp_launches = sssp_phase(
        gtt, k, src, dst, n, dev)

    # 6. the same graph from files, through the builder
    bld = builder_phase(gtt, k, dev, card, src, dst, n, graph, cfg, res,
                        wcc_labels)
    emit({"phase": "memory",
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    # 7. triangle count; the segment-op engines; the out-of-core engine
    triangles_phase(gtt, dev, src, dst, n)
    _, eng_launches = engines_phase(gtt, k, dev, graph, wgraph, start, res,
                                    wcc_labels, sssp_res)
    del wgraph
    _, ooc_launches = ooc_phase(
        gtt, k, dev, errs, src, dst, sssp_weights(m), n, start, x_t.cpu(),
        sym, res, wcc_labels, wcc_rounds, sssp_res)
    del wcc_labels
    free_device()

    # 8. each kernel at its path's shapes: exactness, then times.  Each
    # row counts every run of its path: the phase's own, the builder's,
    # the engines phase's plan runs and the out-of-core drivers'.
    by_path = {
        "pagerank": {"pagerank": pr_launches,
                     "builder": bld["pagerank_launches"],
                     "engines (log_progress)": eng_launches["pagerank_logged"],
                     "ooc (page_rank_ooc)": ooc_launches["pagerank"]},
        "wcc": {"wcc": wcc_launches, "builder": bld["wcc_launches"],
                "ooc (wcc_ooc)": ooc_launches["wcc"]},
        "sssp": {"sssp": sssp_launches,
                 "engines (grid, plan)": eng_launches["sssp_grid_plan"],
                 "ooc (sssp_ooc)": ooc_launches["sssp"]}}
    pr_launches = launches_of(*by_path["pagerank"].values())
    wcc_launches = launches_of(*by_path["wcc"].values())
    sssp_launches = launches_of(*by_path["sssp"].values())
    table = []
    plan, h, cuts = eng.plan, eng.window, eng.k2_cuts
    xq = torch.round(eng.to_internal(x_t) * float(1 << 30)).to(torch.int32)
    contrib = k.k1_gather_plain(xq, plan.slot_src)
    hold(errs, "k1_gather", k.k1_gather(xq, plan.slot_src, h), contrib)
    hold(errs, "k2_reduce", k.k2_reduce(contrib, plan.indptr, cuts),
         k.k2_reduce_plain(contrib, plan.indptr))
    rows = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.diff(plan.indptr))
    check(torch.equal(torch.zeros(n, dtype=torch.int32, device=dev)
                      .index_add_(0, rows, contrib),
                      k.k2_reduce_plain(contrib, plan.indptr)),
          "index_add_ yardstick disagrees with k2_reduce")
    pr_shapes = f"n={n}, m={m}"
    table.append(row(
        "k1_gather", "pagerank", "k1_gather.cu",
        "graph_tpu/engine/kernels.py:253", pr_launches, errs,
        lambda: k.k1_gather(xq, plan.slot_src, h),
        lambda: k.k1_gather_plain(xq, plan.slot_src),
        ("index_select", lambda: torch.index_select(xq, 0, plan.slot_src)),
        8 * m + 4 * n, 0, pr_shapes, k1_design(h, plan.slot_src)))
    table.append(row(
        "k2_reduce", "pagerank", "k2_reduce.cu",
        "graph_tpu/engine/kernels.py:603", pr_launches, errs,
        lambda: k.k2_reduce(contrib, plan.indptr, cuts),
        lambda: k.k2_reduce_plain(contrib, plan.indptr),
        ("index_add_", lambda: torch.zeros(
            n, dtype=torch.int32, device=dev).index_add_(0, rows, contrib)),
        4 * m + 8 * (n + 1) + 4 * n, m, pr_shapes, k2_design(k, cuts)))
    del rows, contrib

    # WCC shapes: the first round's hook, labels = node ids
    sp_, sh, scuts = sym.plan, sym.window, sym.k2_cuts
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    c_sym = k.k1_gather_plain(labels, sp_.slot_src)
    hold(errs, "k1_gather", k.k1_gather(labels, sp_.slot_src, sh), c_sym)
    hold(errs, "k2_reduce_min",
         k.k2_reduce_min(c_sym, sp_.indptr, "imin", scuts),
         k.k2_reduce_min_plain(c_sym, sp_.indptr, "imin"))
    rows = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.diff(sp_.indptr))
    ms_ = sp_.m
    wcc_shapes = f"n={n}, m_sym={ms_}"
    table.append(row(
        "k1_gather", "wcc", "k1_gather.cu",
        "graph_tpu/engine/kernels.py:253", wcc_launches, errs,
        lambda: k.k1_gather(labels, sp_.slot_src, sh),
        lambda: k.k1_gather_plain(labels, sp_.slot_src),
        ("index_select",
         lambda: torch.index_select(labels, 0, sp_.slot_src)),
        8 * ms_ + 4 * n, 0, wcc_shapes, k1_design(sh, sp_.slot_src)))
    table.append(row(
        "k2_reduce_min", "wcc (op=imin)", "k2_reduce.cu",
        "graph_tpu/engine/kernels.py:603", wcc_launches, errs,
        lambda: k.k2_reduce_min(c_sym, sp_.indptr, "imin", scuts),
        lambda: k.k2_reduce_min_plain(c_sym, sp_.indptr, "imin"),
        ("scatter_reduce_ amin", lambda: torch.full(
            (n,), k.IMAX, dtype=torch.int32, device=dev).scatter_reduce_(
                0, rows, c_sym, "amin")),
        4 * ms_ + 8 * (n + 1) + 4 * n, ms_, wcc_shapes,
        k2_design(k, scuts)))
    del rows, c_sym, labels

    # SSSP shapes: a relax of the final distances (internal order)
    wp, wh, wcuts = weng.plan, weng.window, weng.k2_cuts
    dist = weng.to_internal(sssp_res.distances).clamp(max=k.INF)
    c_w = k.k1_gather_weighted_plain(dist, wp.slot_src, wp.slot_w, "add",
                                     False)
    hold(errs, "k1_gather_weighted",
         k.k1_gather_weighted(dist, wp.slot_src, wp.slot_w, "add", False,
                              window=wh),
         c_w)
    c_bits = c_w.view(torch.int32)
    hold(errs, "k2_reduce_min",
         k.k2_reduce_min(c_bits, wp.indptr, "min", wcuts),
         k.k2_reduce_min_plain(c_bits, wp.indptr, "min"))
    rows = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.diff(wp.indptr))
    sssp_shapes = f"n={n}, m={m}"
    table.append(row(
        "k1_gather_weighted", "sssp (combine=add)", "k1_gather.cu",
        "graph_tpu/engine/kernels.py:253", sssp_launches, errs,
        lambda: k.k1_gather_weighted(dist, wp.slot_src, wp.slot_w, "add",
                                     False, window=wh),
        lambda: k.k1_gather_weighted_plain(dist, wp.slot_src, wp.slot_w,
                                           "add", False),
        "none: no single PyTorch call gathers and adds",
        12 * m + 4 * n, m, sssp_shapes, k1_design(wh, wp.slot_src)))
    table.append(row(
        "k2_reduce_min", "sssp (op=min)", "k2_reduce.cu",
        "graph_tpu/engine/kernels.py:603", sssp_launches, errs,
        lambda: k.k2_reduce_min(c_bits, wp.indptr, "min", wcuts),
        lambda: k.k2_reduce_min_plain(c_bits, wp.indptr, "min"),
        ("scatter_reduce_ amin", lambda: torch.full(
            (n,), k.INF_BITS, dtype=torch.int32, device=dev).scatter_reduce_(
                0, rows, c_bits, "amin")),
        4 * m + 8 * (n + 1) + 4 * n, m, sssp_shapes, k2_design(k, wcuts)))
    wprobe = window_probe(k, plan, xq, wp, dist)
    emit({"phase": "window_probe", "card": card, **wprobe})
    del xq
    for t in table:  # the exactness of every kernel, edge cases included
        t["max_abs_err"] = errs[t["name"]]
        t["launches_by_path"] = {
            path: runs[t["name"]]
            for path, runs in by_path[t["path"].split()[0]].items()}

    # 9. the K1 gather probes' line (step 3), with K1's own rate at each
    # window beside them; the K2 stream probes, with K2's own rate beside
    # them; a profiler trace of the PageRank run
    k1_window = {h: {**r, "ns_per_slot": r["ms"] * 1e6 / m,
                     "gb_per_s": (8 * m + 4 * n) / r["ms"] / 1e6}
                 for h, r in wprobe["pagerank"].items()}
    emit({"phase": "k1_probes", "card": card, **k1_out,
          "k1_window_probe_pagerank": k1_window})
    table += k1_rows
    slots_of = {"pagerank": m, "wcc (op=imin)": ms_, "sssp (op=min)": m}
    k2_own = {t["path"]: {"ms": t["ms"],
                          "ns_per_slot": t["ms"] * 1e6 / slots_of[t["path"]],
                          "gb_per_s": t["bytes"] / t["ms"] / 1e6}
              for t in table if t["path"] in slots_of
              and t["name"].startswith("k2_")}
    k2_launches, k2_cases, k2_by_script = k2_probes_phase(
        dev, card, k2_errs, plan.indptr, k2_own)
    table += k2_probe_rows(k2_errs, k2_launches, k2_cases, k2_by_script)
    del k2_cases
    free_device()
    st_launches, st_cases, st_layout, st_by = k2_stages_phase(
        dev, card, stage_graph_free, routing, plan.indptr, k2_own)
    del stage_graph_free
    table += k2_stage_rows(stage_errs, st_launches, st_cases, st_layout,
                           routing[0], sec128_in, st_by)
    del st_cases, st_layout, routing
    free_device()
    profile_phase(gtt, graph, cfg, card)

    iter_ms = best / ITERS * 1e3
    emit({"phase": "kernel_detail",
          "gb_per_s": {f"{t['name']}/{t['path']}": t["bytes"] / t["ms"] / 1e6
                       for t in table},
          "pagerank_iteration_ms": iter_ms,
          "k1_k2_share_of_pagerank_iteration": (table[0]["ms"]
                                                + table[1]["ms"]) / iter_ms,
          "max_in_degree": int(torch.diff(plan.indptr).max())})
    print(card, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main():
    rmat = RmatProcess(SCALE, os.path.join(ROOT, ".cache", "rmat"))
    try:
        return run(rmat)
    except Exception:  # any failed phase: report it and print no result
        traceback.print_exc()
        return 1
    finally:
        rmat.stop()


if __name__ == "__main__":
    sys.exit(main())
