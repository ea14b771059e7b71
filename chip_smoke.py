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
  has no out-edge in this graph) on the plan engine, every edge held to
  the f32 shortest-path certificate and the unreached set to scipy's
  BFS; then ``auto`` (the near/far queues of ``csrc/sssp_frontier.cu``)
  timed against the plan engine there and on bench.py's 1024 x 1024 grid,
  its distances bit for bit the plan's, its steps, buckets, relaxed arcs
  and launches;
* the builder: the same edges written as a packed Graph500 file, loaded
  with ``GraphBuilder`` and held to ``build_directed``'s CSRs and to the
  ``page_rank`` scores bit for bit; written as the LDBC text layout
  (``graph-500-22/graph500-22.e``), parsed by the native parser through
  ``load_graph500`` and held to the ``wcc`` labels; built in host memory
  by the native radix builder and held to the card's SORTED build;
  relabeled by degree on the card (its invariants checked); and written
  and read back as a binary snapshot.  Its set-up seconds are printed
  with the card's name and power limit;
* the user's surfaces on that Graph500 file, with no device given:
  ``api.Graph.load`` into ``wcc()`` and ``api.DiGraph.load`` into
  ``page_rank()``, a ``server.service.GraphService`` create / list /
  compute / remove (its stored column cut into 420 batches of 10,000
  rows), the same over Flight where pyarrow is installed, and
  ``cli.main(["page-rank", ...])`` in this process, each held to the
  ``pagerank`` and ``wcc`` phases bit for bit; the API's PageRank writes
  its plan to a cache of the phase's own, and the CLI reads it back;
* ``global_triangle_count`` on the same edges built DEDUPLICATED on the
  card (distinct triangles), unchanged by ``make_degree_ordered``, with
  its preparation and card seconds and its one launch of the join kernel
  (``tc_count``); the kernel timed alone on the count's forward CSR
  beside its plain version, with its bounds, and four head ranges adding
  up to its count; at
  scale 16 the distinct count and the kernel alone against scipy and the
  SORTED multiset count against a host model;
* the multi-device paths on a mesh of four shards sharing the card
  (``Mesh([cuda] * 4)``): the row-block engines of PageRank, WCC and
  SSSP built (partition, halo and plans timed) and their ``spmv``,
  ``smin_int`` and ``relax`` held bit for bit to the single-device
  engines'; ``page_rank``, ``wcc``, ``delta_stepping`` and
  ``global_triangle_count`` through ``use_mesh``, held to the phases
  above (PageRank to the same iterations and 1e-6, the rest exactly),
  with K1 and K2 launched exactly once a shard an iteration and
  ``tc_count`` once a shard a count; and both
  PageRank routes timed, ``page_rank_rowblock`` against
  ``page_rank_sharded`` (blocking and ring, bit-equal to each other);
* the segment-op engines (PageRank ``cumsum``/``scatter``, the logged
  plan PageRank, WCC ``xla``, SSSP ``xla``), each held to the plan
  path's result, and SSSP ``plan``/``frontier``/``xla`` on bench.py's
  1024 x 1024 grid; every engine's seconds and host reads, there and on
  RMAT 12 to 18, from which the ``auto`` rules are decided (SSSP's
  ``frontier``, the near/far queues on the card, on every graph);
* the device loops: each single-device driver's loop runs on the card as
  one CUDA graph with a conditional WHILE node
  (``graph_tpu_torch.engine.loop``), held to its host loop on the card
  (``host_while``): PageRank plan at the default tolerance and at 0, WCC
  plan, SSSP plan on RMAT 22 and on the grid, delta-stepping
  (``frontier``, the near/far queues) on the grid; equal bits and
  iterations (the near/far queues: bits; their steps meet in an order of
  the card's threads), one host read (and the relaxed arcs' after it),
  K1 and K2 once an iteration, ms a run both ways (best of 3), capture
  and instantiation seconds apart; ``max_iterations=0`` returns the
  initial scores;
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
trace of the PageRank run (``benchmark.trace.traced``), as the device
loop and as its host loop, gives the device's busy share, the kernels
that took the most time and the share of K1 and K2 launches the trace
reported; the device loop's ``loop.run`` span gives the graph's CUDA-event
time and its launches.
It prints one JSON line per phase; the line before the last lists the
kernels, with each design's facts (K2's tile, K1's window and the share
of slots it serves, a probe's window or depth, the triangle join's tiles),
and the last line is
``{"ok": true, "device": {...}}``.
Any failed check exits non-zero without that line, as does a machine
without a CUDA device.
"""

import contextlib
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
#: The builder phase's Graph500 file of the RMAT edges, which the
#: api_server phase loads again through the user's surfaces.
GRAPH500_FILE = os.path.join(ROOT, ".cache", "builder",
                             f"rmat_s{SCALE}.graph500")
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
#: Shards of the mesh phase's mesh, all on the one card.
MESH_SHARDS = 4
#: PageRank's kernels on the plan engine's device loop: K1, K2 and the
#: Jacobi tails around them (logging, out of core and the mesh keep the
#: op-chain body).
PLAN_PAGERANK = ("k1_gather", "k2_reduce", "jacobi_quantize", "jacobi_update")
#: The kernels each path must launch at least once per iteration.
PATH_KERNELS = {"pagerank": PLAN_PAGERANK,
                "wcc": ("k1_gather", "k2_reduce_min"),
                "sssp": ("k1_gather_weighted", "k2_reduce_min"),
                "builder_pagerank": PLAN_PAGERANK,
                "builder_wcc": ("k1_gather", "k2_reduce_min"),
                "api_pagerank": PLAN_PAGERANK,
                "api_wcc": ("k1_gather", "k2_reduce_min"),
                "server_pagerank": PLAN_PAGERANK,
                "flight_pagerank": PLAN_PAGERANK,
                "cli_pagerank": PLAN_PAGERANK,
                "engines_pagerank_logged": ("k1_gather", "k2_reduce"),
                "engines_sssp_grid": ("k1_gather_weighted", "k2_reduce_min"),
                "ooc_pagerank": ("k1_gather", "k2_reduce"),
                "ooc_wcc": ("k1_gather", "k2_reduce_min"),
                "ooc_sssp": ("k1_gather_weighted", "k2_reduce_min"),
                "mesh_pagerank": ("k1_gather", "k2_reduce"),
                "mesh_wcc": ("k1_gather", "k2_reduce_min"),
                "mesh_sssp": ("k1_gather_weighted", "k2_reduce_min")}
#: The paths whose loop runs on the card as a conditional CUDA graph
#: (``graph_tpu_torch.engine.loop``); logged PageRank, out of core and
#: the mesh keep host loops.
LOOP_PATHS = {"pagerank", "wcc", "sssp", "builder_pagerank", "builder_wcc",
              "api_pagerank", "api_wcc", "server_pagerank",
              "flight_pagerank", "cli_pagerank", "engines_sssp_grid"}
#: How the kernel rows count the launches of the LOOP_PATHS.
LOOP_LAUNCHES = ("on the paths that run as device loops, launches "
                 "captured per body (held against the kernel nodes of the "
                 "captured graph) times the bodies the card counted")
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
    # the Jacobi tails: a ragged n over three steps of the grid-stride
    # loop at the most blocks, halfway quanta ((2k+1) / 2**31 with inv =
    # 1), nodes without out-edges, sums that wrap int32
    nj = 2 * 4096 * 1024 + 4099
    jac_scores = (g.random(nj) * 2.0 / nj).astype(np.float32)
    jac_scores[:64] = (2 * np.arange(64) + 1) / np.float32(2**31)
    deg = g.integers(0, 50, nj)
    jac_inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0).astype(
        np.float32)
    jac_inv[:64] = 1.0
    arrays = {
        "jac_scores": jac_scores, "jac_inv": jac_inv,
        "jac_acc": g.integers(-2**31, 2**31, nj).astype(np.int32),
        "xq": g.integers(-2**31, 2**31, 1 << 12).astype(np.int32),
        "slot_src": g.integers(0, 1 << 12, m).astype(np.int32),
        "contrib": g.integers(-2**31, 2**31, m).astype(np.int32),
        "fbits": fbits, "indptr": indptr, "xf": xf,
        "wf": (g.random(m) * 4).astype(np.float32), "xs": xs, "ws": ws,
        "ws_add": np.where(ws == 1.0, np.float32(0.0), ws * 0.5),
    }
    out = {k: torch.from_numpy(a).to(dev) for k, a in arrays.items()}
    for name in ("slot_src", "contrib", "fbits", "wf", "xq", "jac_scores",
                 "jac_inv", "jac_acc"):
        t = out[name]
        out[name + "_off1"] = torch.cat([t[:1], t])[1:]  # storage offset 1
    return out


def check_edge_cases(kernels, a, errs):
    """Every kernel against its plain version on the edge-case inputs,
    with K1 windows of none, part of and more than the 4,096 sources; the
    Jacobi update's residual within 1e-6 relative of the plain one's."""
    k = kernels
    for off in ("", "_off1"):
        s, inv, acc = (a[name + off] for name in ("jac_scores", "jac_inv",
                                                  "jac_acc"))
        hold(errs, "jacobi_quantize", k.jacobi_quantize(s, inv),
             k.jacobi_quantize_plain(s, inv))
        base, d = float(np.float32(0.15) / np.float32(s.numel())), 0.85
        new, err = k.jacobi_update(acc, s, base, d)
        want, want_err = k.jacobi_update_plain(acc, s, base, d)
        hold(errs, "jacobi_update", new, want)
        rel = abs(float(err) - float(want_err)) / float(want_err)
        check(rel <= 1e-6, f"jacobi_update's residual {float(err)} is "
              f"{rel} off the plain one's {float(want_err)}")
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
    cfg = gtt.DeltaSteppingConfig(start, 3.0, engine="plan")
    card_g = gtt.build_directed(src, dst, w, node_count=1 << 12, device=dev)
    host_g = gtt.build_directed(src, dst, w, node_count=1 << 12,
                                device="cpu")
    card_s = gtt.delta_stepping(card_g, cfg)
    host_s = gtt.delta_stepping(host_g, cfg)
    check(np.array_equal(card_s.distances_np(), host_s.distances_np())
          and card_s.ran_iterations == host_s.ran_iterations,
          "rmat12: SSSP distances on the card differ from the CPU path")
    nf_cfg = gtt.DeltaSteppingConfig(start, 3.0, engine="frontier")
    check(np.array_equal(gtt.delta_stepping(card_g, nf_cfg).distances_np(),
                         gtt.delta_stepping(host_g, nf_cfg).distances_np()),
          "rmat12: SSSP frontier distances on the card differ from the CPU "
          "path")
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
    just after; each of its kernels must launch once per iteration, and a
    path that runs as a device loop must launch its graph."""
    from graph_tpu_torch.engine import loop

    kernels.reset_launches()
    loop.reset_launches()
    res = fn()
    _sync()
    launches = {**kernels.LAUNCHES, **loop.LAUNCHES}
    iters = iterations_of(res)
    for name in PATH_KERNELS[path]:
        check(launches[name] >= iters >= 1,
              f"{path}: {name} launched {launches[name]} times in "
              f"{iters} iterations")
    if path in LOOP_PATHS:
        check(launches["device_loop"] >= 1,
              f"{path}: the device loop's graph was not launched")
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
    cfg = gtt.DeltaSteppingConfig(start, 3.0, engine="plan")
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
    check_s = time.perf_counter() - t0
    gsrc, gdst, gw, gn = grid_edges(GRID_SIDE)
    grid = gtt.build_directed(gsrc, gdst, gw, node_count=gn, device=dev)
    grid_plan = gtt.delta_stepping(grid, gtt.DeltaSteppingConfig(
        0, 2.0, engine="plan"))
    near_far = {
        "rmat": near_far_runs(gtt, kernels, graph, gtt.build_directed(
            src, dst, w, node_count=n, device="cpu"), start, 3.0, res),
        "grid": near_far_runs(gtt, kernels, grid, gtt.build_directed(
            gsrc, gdst, gw, node_count=gn, device="cpu"), 0, 2.0,
            grid_plan)}
    del grid, grid_plan
    emit({"phase": "sssp", "scale": SCALE, "n": n, "m": int(src.size),
          "start_node": start, "start_out_degree": int(out_degree[start]),
          "node0_out_degree": int(out_degree[0]), "weights": "default_rng(3).random(m) * 4",
          "build_directed_s": graph_s, "weighted_plan_build_s": build_s,
          "rounds": res.ran_iterations, "run_s": runs, "best_s": best,
          "per_round_ms": best / res.ran_iterations * 1e3,
          "launches": launches, "reached": int(reached.sum()),
          "max_distance": float(dist[reached].max()),
          "host_check_s": check_s, "near_far": near_far})
    return graph, start, eng, res, launches, near_far_rows(kernels, near_far)


NEAR_FAR_KERNELS = ("sssp_frontier_reset", "sssp_frontier_relax",
                    "sssp_frontier_advance")


@contextlib.contextmanager
def near_far_timed(kernels, on_card):
    """While the block runs, every call of the three near/far wrappers is
    timed (on the card by CUDA events around its launch, queued behind a
    half-millisecond spin so that the events time the kernel and not the
    host's launch; on the CPU by the wall clock) and the far-pile entries
    each advance reads are counted (read before the call, outside its
    time).  Yields ({kernel: [ms or event pair, ...]}, [entries, ...])."""
    import torch

    saved = {name: getattr(kernels, name) for name in NEAR_FAR_KERNELS}
    times = {name: [] for name in NEAR_FAR_KERNELS}
    far = []

    def wrap(name, fn):
        def timed(st, *args):
            if name == "sssp_frontier_advance":
                fc = int(st.ctrl[kernels.FC])
                far.append(int(st.ctrl[kernels.FAR_COUNT + fc]))
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                torch.cuda._sleep(1 << 20)
                ev[0].record()
                fn(st, *args)
                ev[1].record()
                times[name].append(ev)
            else:
                t0 = time.perf_counter()
                fn(st, *args)
                times[name].append((time.perf_counter() - t0) * 1e3)
        return timed

    for name, fn in saved.items():
        setattr(kernels, name, wrap(name, fn))
    try:
        yield times, far
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def near_far_schedule(gtt, kernels, g, start, delta, on_card):
    """One run of the near/far schedule under the host loop, each kernel
    call timed (``near_far_timed``): on the card its kernels, on the CPU
    their plain versions.  Returns the result, the wall seconds, the arcs
    relaxed (the ``sssp.run`` span's count), and for each kernel its calls
    and summed ms, the far entries read."""
    from graph_tpu_torch import profile
    from graph_tpu_torch.algos import sssp

    cfg = gtt.DeltaSteppingConfig(start, delta)
    profile.spans(clear=True)
    with host_loops(), near_far_timed(kernels, on_card) as (times, far), \
            profile.record():
        t0 = time.perf_counter()
        res = sssp._sssp_near_far(g, cfg)
        if on_card:
            _sync()
        wall_s = time.perf_counter() - t0
    relaxed = [s for s in profile.spans(clear=True)
               if s["name"] == "sssp.run"][-1]["counters"]["relaxed"]
    ms = {name: sum(e[0].elapsed_time(e[1]) for e in t) if on_card
          else sum(t) for name, t in times.items()}
    return res, wall_s, relaxed, {
        name: {"calls": len(times[name]), "ms": ms[name]}
        for name in NEAR_FAR_KERNELS}, sum(far)


def near_far_runs(gtt, kernels, g, host_g, start, delta, want, reps=3):
    """``auto`` on the card, the near/far queues of
    ``csrc/sssp_frontier.cu``, from ``start``: its distances bit for bit
    against the plan engine's (``want``) and against the kernels' plain
    versions run through the same schedule on ``host_g``, a CPU copy of
    the graph; its settle steps, buckets and relaxed arcs (the
    ``sssp.run`` span's counters), its launches (a reset a run, a relax a
    step, an advance a bucket, one device loop), and its seconds against
    the plan engine's (``reps`` runs each, in turn); then each kernel's
    ms in a run under the host loop against its plain version's, with
    the bytes its bound reads: 12 B a node for the reset, 8 B an arc
    relaxed (target, weight) and 8 B a far entry filtered (id, distance)."""
    import torch

    from graph_tpu_torch import profile
    from graph_tpu_torch.engine import loop

    cfg = gtt.DeltaSteppingConfig(start, delta)
    plan_cfg = gtt.DeltaSteppingConfig(start, delta, engine="plan")
    profile.spans(clear=True)
    kernels.reset_launches()
    loop.reset_launches()
    with profile.record():
        res = gtt.delta_stepping(g, cfg)
    _sync()
    launches = {k: v for k, v in {**kernels.LAUNCHES,
                                  **loop.LAUNCHES}.items() if v}
    run = [s for s in profile.spans(clear=True)
           if s["name"] == "sssp.run"][-1]["counters"]
    check(torch.equal(res.distances.view(torch.int32),
                      want.distances.view(torch.int32)),
          f"near/far SSSP from {start}: distances differ from the plan "
          f"engine's (max {bits_diff(res.distances, want.distances)})")
    check(launches == {"sssp_frontier_reset": 1,
                       "sssp_frontier_relax": run["rounds"],
                       "sssp_frontier_advance": run["buckets"],
                       "device_loop": 1},
          f"near/far SSSP: launches {launches} for {run}")
    check(res.host_reads == 2, f"near/far SSSP: {res.host_reads} host reads")
    times = {"near_far": [], "plan": []}
    for _ in range(reps):
        for name, c in (("near_far", cfg), ("plan", plan_cfg)):
            t, got = timed_runs(lambda: gtt.delta_stepping(g, c), 1)
            times[name] += t
            check(torch.equal(got.distances, want.distances),
                  f"near/far SSSP: {name} run differs")
    card, card_s, card_relaxed, card_k, card_far = near_far_schedule(
        gtt, kernels, g, start, delta, True)
    plain, plain_s, plain_relaxed, plain_k, plain_far = near_far_schedule(
        gtt, kernels, host_g, start, delta, False)
    got, host = res.distances.double().cpu(), plain.distances.double()
    err = float((got - host).abs().max())
    check(torch.equal(res.distances.view(torch.int32).cpu(),
                      plain.distances.view(torch.int32))
          and torch.equal(card.distances, res.distances),
          f"near/far SSSP from {start}: distances differ from the plain "
          f"versions' on the CPU (max {err})")
    nbytes = {"sssp_frontier_reset": 12 * g.node_count,
              "sssp_frontier_relax": 8 * card_relaxed,
              "sssp_frontier_advance": 8 * card_far}
    per_kernel = {
        name: {"launches": card_k[name]["calls"], "ms": card_k[name]["ms"],
               "plain_calls": plain_k[name]["calls"],
               "plain_ms": plain_k[name]["ms"], "bytes": nbytes[name]}
        for name in NEAR_FAR_KERNELS}
    return {"delta": delta, "steps": run["rounds"], "buckets": run["buckets"],
            "relaxed": run["relaxed"], "sweeps": run["relaxed"] / g.edge_count,
            "plan_rounds": want.ran_iterations, "launches": launches,
            "host_reads": res.host_reads, "run_s": times["near_far"],
            "best_s": min(times["near_far"]), "plan_run_s": times["plan"],
            "plan_best_s": min(times["plan"]),
            "speedup": min(times["plan"]) / min(times["near_far"]),
            "host_loop_s": card_s, "plain_s": plain_s,
            "host_loop_steps": card.ran_iterations,
            "host_loop_relaxed": card_relaxed,
            "plain_steps": plain.ran_iterations,
            "plain_relaxed": plain_relaxed, "far_entries": card_far,
            "plain_far_entries": plain_far, "max_abs_err": err,
            "shapes": f"n={g.node_count}, m={g.edge_count}",
            "kernels": per_kernel}


def near_far_rows(kernels, near_far):
    """The kernel table's rows of the three near/far kernels: times, plain
    times and bytes at the RMAT graph's shapes (the grid's beside them),
    each bound by the bytes its run read."""
    rmat = near_far["rmat"]
    rows = []
    for name in NEAR_FAR_KERNELS:
        k = rmat["kernels"][name]
        bound, by = bound_of(k["bytes"], 0)
        rows.append({
            "name": name, "path": "sssp (near/far)", "route": "cuda",
            "source": "graph_tpu_torch/csrc/sssp_frontier.cu",
            "replaces": "none: graph_tpu's frontier engine is XLA ops "
                        "(graph_tpu/algos/sssp.py:137-192); no "
                        "pl.pallas_call",
            "launches_by_path": {f"sssp near/far ({graph})": r["launches"][
                name] for graph, r in near_far.items()},
            "launches": sum(r["launches"][name] for r in near_far.values()),
            "max_abs_err": max(r["max_abs_err"] for r in near_far.values()),
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": None,
            "library": "none: no PyTorch call relaxes a queue's out-arcs",
            "bytes": k["bytes"], "shapes": rmat["shapes"],
            "timed": "one run under the host loop, launches summed",
            "calls": k["launches"], "plain_calls": k["plain_calls"],
            "grid": {**near_far["grid"]["kernels"][name],
                     "shapes": near_far["grid"]["shapes"]}})
    return rows


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
    g500 = GRAPH500_FILE
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


def api_server_phase(kernels, card, n, m, pr_cfg, pr_res, wcc_labels,
                     wcc_rounds):
    """The user's surfaces at full scale, on the builder phase's Graph500
    file, each with no device given (so on the card): ``Graph.load`` into
    ``wcc()`` and ``DiGraph.load`` into ``page_rank()`` through the API,
    a ``GraphService`` create / list / compute / remove, the same over
    Flight where pyarrow is installed, and the CLI's page-rank in this
    process.  Each is held to the pagerank and wcc phases bit for bit.
    The API's PageRank writes its relabel plan to a plan cache of the
    phase's own and the CLI (``--plan-cache``) loads it; the service and
    Flight build theirs, since a build on the card takes a few hundredths
    of a second and a cache hit seconds (the host hashes the edges)."""
    import importlib.util
    import logging
    import shutil
    import tempfile

    import torch
    from graph_tpu_torch import cli
    from graph_tpu_torch.api import DiGraph, FileFormat, Graph
    from graph_tpu_torch.engine.plan import PLAN_CACHE_ENV
    from graph_tpu_torch.server import catalog
    from graph_tpu_torch.server.service import GraphService

    want = pr_res.scores.cpu().numpy()
    iters = pr_res.ran_iterations
    pr_kw = {"max_iterations": pr_cfg.max_iterations,
             "tolerance": pr_cfg.tolerance,
             "damping_factor": pr_cfg.damping_factor}
    secs, out, launches = {}, {}, {"pagerank": {}, "wcc": {}}
    torch.cuda.reset_peak_memory_stats()

    def timed(name, fn):
        _sync()
        t0 = time.perf_counter()
        res = fn()
        _sync()
        secs[name] = time.perf_counter() - t0
        return res

    def same_scores(got, what):
        check(got.dtype == np.float32 and np.array_equal(
            got.view(np.uint32), want.view(np.uint32)),
            f"{what}: PageRank scores differ from the pagerank phase's")

    cache = tempfile.mkdtemp(prefix="plans-", dir=os.path.join(ROOT, ".cache"))
    saved = os.environ.pop(PLAN_CACHE_ENV, None)
    try:
        # 1. API WCC, without the plan cache
        ug = timed("api_graph_load_s", lambda: Graph.load(
            GRAPH500_FILE, file_format=FileFormat.Graph500))
        check(ug.device.type == "cuda", f"Graph.load: graph on {ug.device}")
        check((ug.node_count(), ug.edge_count()) == (n, m),
              f"Graph.load: {ug.node_count()} nodes, {ug.edge_count()} edges")
        w, launches["wcc"]["api"] = drive(
            kernels, "api_wcc", lambda: timed("api_wcc_s", ug.wcc),
            lambda r: wcc_rounds)
        check(np.array_equal(w.components(), wcc_labels.cpu().numpy()),
              "API: WCC components differ from the wcc phase's")
        out["api_wcc_run_s"] = w.micros / 1e6
        del ug, w
        free_device()

        # 2. API PageRank: builds the relabel plan and writes it to the cache
        os.environ[PLAN_CACHE_ENV] = cache
        dg = timed("api_digraph_load_s", lambda: DiGraph.load(
            GRAPH500_FILE, file_format=FileFormat.Graph500))
        check(dg.device.type == "cuda", f"DiGraph.load: graph on {dg.device}")
        pr, launches["pagerank"]["api"] = drive(
            kernels, "api_pagerank",
            lambda: timed("api_pagerank_s", lambda: dg.page_rank(**pr_kw)),
            lambda r: r.ran_iterations)
        check(pr.ran_iterations == iters,
              f"API: PageRank ran {pr.ran_iterations} iterations")
        same_scores(pr.scores(), "API")
        out["api_pagerank_run_s"] = pr.micros / 1e6
        check(len(os.listdir(cache)) == 1,
              f"plan cache: {os.listdir(cache)} (one relabel plan expected)")
        del dg, pr
        free_device()
        del os.environ[PLAN_CACHE_ENV]

        # 3. the service, on the card by default
        svc = GraphService()
        check(svc.device.type == "cuda", f"GraphService on {svc.device}")
        created = timed("service_create_s", lambda: svc.action(
            "create", json.dumps({"graph_name": "rmat",
                                  "file_format": "Graph500",
                                  "path": GRAPH500_FILE,
                                  "orientation": "Directed"}).encode()))
        check((created["node_count"], created["edge_count"]) == (n, m),
              f"service create: {created}")
        check(svc.catalog.get("rmat").device.type == "cuda",
              "service: graph not on the card")
        listed = timed("service_list_s", lambda: svc.action("list", b"{}"))
        check(listed == {"graph_infos": [{
            "graph_name": "rmat", "graph_type": "Directed",
            "node_count": n, "edge_count": m}]}, f"service list: {listed}")
        compute = json.dumps({"graph_name": "rmat",
                              "algorithm": {"PageRank": pr_kw},
                              "property_key": "page_rank"}).encode()
        r, launches["pagerank"]["server"] = drive(
            kernels, "server_pagerank",
            lambda: timed("service_compute_s",
                          lambda: svc.action("compute", compute)),
            lambda r: r["algo_result"]["iterations"])
        check(r["algo_result"]["iterations"] == iters,
              f"service: PageRank ran {r['algo_result']['iterations']}")
        field, values = svc.properties.get("rmat", "page_rank")
        check(field == "page_rank", f"service: the column is {field!r}")
        same_scores(values, "service")
        out["service_batches"] = len(catalog.chunks(values))
        check(out["service_batches"] == -(-n // catalog.CHUNK_SIZE),
              f"service: {out['service_batches']} batches of "
              f"{catalog.CHUNK_SIZE} rows for {n} nodes")
        removed = timed("service_remove_s", lambda: svc.action(
            "remove", json.dumps({"graph_name": "rmat"}).encode()))
        check(removed["graph_name"] == "rmat" and not svc.catalog.list(),
              f"service remove: {removed}")
        del svc, values
        free_device()

        # 4. the same over Flight, where pyarrow is installed
        if importlib.util.find_spec("pyarrow") is None:
            out["flight"] = "not run: pyarrow is not installed on this machine"
        else:
            out["flight"], launches["pagerank"]["flight"] = flight_round_trip(
                kernels, compute, iters, same_scores, timed, n)
            free_device()

        # 5. the CLI in this process with its defaults (the pagerank
        # phase's error after 20 iterations is above 1e-4, so it runs 20
        # too), loading the API's plan from the cache; its log records
        # are kept, and the root logger its basicConfig sets up restored
        argv = ["page-rank", "-p", GRAPH500_FILE, "-f", "graph500",
                "-r", "1", "-w", "0", "--plan-cache", cache]
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        port_log, root = logging.getLogger("graph_tpu_torch"), logging.getLogger()
        root_state = (root.level, root.handlers[:])
        port_log.addHandler(handler)
        port_log.setLevel(logging.INFO)
        try:
            rc, launches["pagerank"]["cli"] = drive(
                kernels, "cli_pagerank",
                lambda: timed("cli_s", lambda: cli.main(argv)),
                lambda rc: sum(r.args[0] for r in records
                               if r.msg.startswith("PageRank ran")))
        finally:
            port_log.removeHandler(handler)
            port_log.setLevel(logging.NOTSET)
            root.setLevel(root_state[0])
            root.handlers[:] = root_state[1]
        ran = [r.args for r in records if r.msg.startswith("PageRank ran")]
        check(rc == 0 and ran == [(iters, pr_res.error)],
              f"CLI: rc {rc}, logged PageRank runs {ran}")
        check(any(r.msg.startswith("EdgePlan cache hit") for r in records),
              "CLI: the API's plan was not loaded from the cache")
        out["cli_iterations"], out["cli_error"] = ran[0]
        # the CLI's one run, the plan cache hit in it
        out["cli_run_s"] = [r.args[2] for r in records
                            if r.msg.startswith("Run ")][0]
        free_device()
    finally:
        if saved is None:
            os.environ.pop(PLAN_CACHE_ENV, None)
        else:
            os.environ[PLAN_CACHE_ENV] = saved
        shutil.rmtree(cache)
    emit({"phase": "api_server", "card": card, "scale": SCALE, "n": n,
          "m": m, "iterations": iters, "wcc_rounds": wcc_rounds,
          "seconds": secs, **out, "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def flight_round_trip(kernels, compute, iters, same_scores, timed, n):
    """create / compute / do_get / remove through a ``pyarrow.flight``
    client against a ``GraphFlightServer`` on loopback (on the card).
    Returns the line's entry and the compute's launches."""
    import pyarrow.flight as flight
    from graph_tpu_torch.server.flight import GraphFlightServer

    def action(client, name, body):
        res = client.do_action(flight.Action(name, body))
        return json.loads(next(iter(res)).body.to_pybytes())

    server = GraphFlightServer("grpc://localhost:0")
    try:
        client = flight.connect(f"grpc://localhost:{server.port}")
        try:
            timed("flight_create_s", lambda: action(client, "create", json.dumps(
                {"graph_name": "rmat", "file_format": "Graph500",
                 "path": GRAPH500_FILE}).encode()))
            r, launches = drive(
                kernels, "flight_pagerank",
                lambda: timed("flight_compute_s",
                              lambda: action(client, "compute", compute)),
                lambda r: r["algo_result"]["iterations"])
            check(r["algo_result"]["iterations"] == iters,
                  f"Flight: PageRank ran {r['algo_result']['iterations']}")
            ticket = flight.Ticket(json.dumps(r["property_id"]).encode())
            table = timed("flight_get_s",
                          lambda: client.do_get(ticket).read_all())
            batches = len(table.to_batches())
            same_scores(table.column("page_rank").to_numpy(), "Flight")
            action(client, "remove", json.dumps({"graph_name": "rmat"}).encode())
        finally:
            client.close()
    finally:
        server.shutdown()
    check(batches == -(-n // 10_000), f"Flight: {batches} record batches")
    return {"batches": batches}, launches


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


def tc_count_reads(offsets, targets):
    """The bytes ``kernels.tc_count`` reads from memory over all heads of
    a forward CSR, by its scheme: for each scheduled head, its two offsets
    and its list, once; for each of its tiles, the neighbours that may
    close a wedge in it (each N+(u)[i] with i + 1 below the tile's end and
    below d+(u)), each with its id, two offsets and whole list."""
    import torch

    from graph_tpu_torch.engine import kernels

    deg = torch.diff(offsets)
    n = deg.numel()
    heads = torch.repeat_interleave(torch.arange(n, device=deg.device), deg)
    tl = torch.where(deg > kernels.TC_LONG, kernels.TC_TILE,
                     kernels.TC_WARP_TILE)
    d, t = deg[heads], tl[heads]
    pos = torch.arange(heads.numel(), device=deg.device) - offsets[:-1][heads]
    # the tiles that N+(u)[i] meets: those past the one that holds i + 1
    tiles = torch.where(pos + 1 < d, (d + t - 1) // t - (pos + 1) // t, 0)
    nd = deg.index_select(0, targets.long())
    sched = deg >= 2
    staged = int((16 * sched + 4 * deg * sched).sum())
    return staged + int((tiles * (20 + 4 * nd)).sum())


def triangles_phase(gtt, dev, src, dst, n):
    """Triangle count at scale 22 on the card (distinct, DEDUPLICATED; the
    Graph500 Kronecker edges made undirected and deduplicated, GAP's kron
    graph), unchanged by the degree relabel; the join kernel timed alone
    on the count's forward CSR beside its plain version (the emission and
    ``searchsorted`` join), with two bounds (the forward CSR read once,
    and the bytes the kernel's scheme reads, each over the HBM rate), and
    the head ranges of ``MESH_SHARDS`` shards adding up to its count; at
    scale 16 the distinct count and the kernel alone against scipy, and
    the multiset count (SORTED, relabeled) against a host model.  Returns
    the scale-22 count, its DEDUPLICATED graph and the kernel's row of the
    kernel table (the count's launches under ``launches_by_path``)."""
    import torch

    from graph_tpu_torch.algos import triangle_count as tc
    from graph_tpu_torch.engine import kernels
    from graph_tpu_torch.generate import host_rmat
    from graph_tpu_torch.parallel.tc import head_ranges

    out = {}
    t0 = time.perf_counter()
    ug = gtt.build_undirected(src, dst, node_count=n, device=dev,
                              layout=gtt.CsrLayout.DEDUPLICATED)
    _sync()
    out["build_undirected_s"] = time.perf_counter() - t0
    # keep the preparation the count makes, for the kernel's timing
    prepare, kept = tc._prepare_distinct, []
    tc._prepare_distinct = lambda *a: kept.append(prepare(*a)) or kept[-1]
    kernels.reset_launches()
    try:
        _sync()
        t0 = time.perf_counter()
        res = gtt.global_triangle_count(ug)
        _sync()
        out["count_s"] = time.perf_counter() - t0
    finally:
        tc._prepare_distinct = prepare
    check(res.triangles > 0, f"triangles: counted {res.triangles}")
    used = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(used == {"tc_count": 1},
          f"triangles: the count launched {used}, not tc_count once")
    out.update(triangles=res.triangles, micros=res.micros, **res.phases)
    out["wedges_per_s_on_card"] = res.phases["wedges"] / res.phases["join_s"]

    # check 1: the degree relabel keeps the count
    rel = gtt.make_degree_ordered(ug)
    res_rel = gtt.global_triangle_count(rel)
    check(res_rel.triangles == res.triangles,
          f"triangles: {res_rel.triangles} after make_degree_ordered, "
          f"{res.triangles} before")
    out["relabeled"] = {"triangles": res_rel.triangles, **res_rel.phases}
    del rel
    free_device()

    # the join kernel alone on the count's forward CSR: the whole, then
    # the shards' head ranges, against the count; its time beside the
    # plain version's
    fwd = kept[0]
    del kept
    kernels.reset_launches()
    count = int(kernels.tc_count(*fwd))
    check(count == res.triangles, f"triangles: the kernel counts {count}, "
          f"the count {res.triangles}")
    bounds = head_ranges(fwd.offsets, MESH_SHARDS)
    parts = [int(kernels.tc_count(*fwd, lo, hi))
             for lo, hi in zip(bounds, bounds[1:])]
    check(sum(parts) == count, f"triangles: {MESH_SHARDS} head ranges "
          f"count {parts}, the whole {count}")
    launches = kernels.LAUNCHES["tc_count"]
    check(launches == 1 + MESH_SHARDS,
          f"triangles: {launches} kernel launches for {1 + MESH_SHARDS} "
          "ranges")
    plain = int(kernels.tc_count_plain(fwd.offsets, fwd.targets, 0, n))
    check(plain == count, f"triangles: the plain join counts {plain}, the "
          f"kernel {count}")
    m_f = fwd.targets.numel()
    csr_bytes = 8 * (n + 1) + 4 * m_f
    scheme_bytes = tc_count_reads(fwd.offsets, fwd.targets)
    out["join_kernel"] = {
        "forward_edges": m_f, "long_heads": fwd.long_heads.numel(),
        "short_heads": fwd.short_heads.numel(),
        "max_forward_degree": int(torch.diff(fwd.offsets).max()),
        "ms": time_ms(lambda: kernels.tc_count(*fwd), reps=5),
        "plain_ms": time_ms(lambda: kernels.tc_count_plain(
            fwd.offsets, fwd.targets, 0, n), reps=1),
        "bound_ms_csr_once": csr_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_ms_scheme": scheme_bytes / HBM_BYTES_PER_S * 1e3,
        "csr_bytes": csr_bytes, "scheme_bytes": scheme_bytes,
        "count": count, "plain_count": plain,
        "shards": {"ranges": bounds, "counts": parts},
        "launches": launches}
    jk = out["join_kernel"]
    tc_row = {
        "name": "tc_count", "path": "triangles", "route": "cuda",
        "source": "graph_tpu_torch/csrc/tc_count.cu",
        "replaces": "none: graph_tpu's join is an XLA sort of wedges and "
                    "edge keys (graph_tpu/algos/triangle_count.py:100 "
                    "_join_count); no pl.pallas_call",
        "launches_by_path": {"triangles": used["tc_count"]},
        "max_abs_err": abs(count - plain), "ms": jk["ms"],
        "plain_ms": jk["plain_ms"], "bound_ms": jk["bound_ms_csr_once"],
        "bound_by": "bytes (the forward CSR read once)",
        "bound_ms_scheme": jk["bound_ms_scheme"], "library_ms": None,
        "library": "none: no PyTorch call counts triangles",
        "bytes": csr_bytes, "scheme_bytes": scheme_bytes,
        "shapes": f"n={n}, forward_edges={m_f}",
        "tile": kernels.TC_TILE, "warp_tile": kernels.TC_WARP_TILE,
        "long_class_above": kernels.TC_LONG}
    del fwd
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
    fwd = tc._prepare_distinct(cg, {}, dev)
    _sync()
    t0 = time.perf_counter()
    count = int(kernels.tc_count(*fwd))
    join = {"count": count, "s": time.perf_counter() - t0}
    check(count == want, f"triangles: the kernel counts {count}, scipy "
          f"{want}")
    del fwd
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
                     "join": join, **distinct.phases},
        "multiset": {"triangles": cm.triangles, "host_check_s": host_m_s,
                     "why_not_scale22": "scale 22 has about 51e9 "
                                        "multiset wedges", **cm.phases}}
    emit({"phase": "triangles", "scale": SCALE, "n": n, "m": int(src.size),
          **out})
    return res.triangles, ug, tc_row


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

    # SSSP on the RMAT from the sssp phase's start, delta 3.0
    def sssp(g, start_node, delta, engine):
        return lambda: gtt.delta_stepping(g, gtt.DeltaSteppingConfig(
            start_node, delta, engine=engine))

    out["sssp_rmat"]["xla"], res = engine_runs(
        sssp(wgraph, start, 3.0, "xla"), 2)
    check(torch.equal(res.distances, sssp_res.distances),
          "SSSP xla: distances differ from the sssp phase's (plan)")
    out["sssp_rmat"]["plan"], _ = engine_runs(
        sssp(wgraph, start, 3.0, "plan"), 3)
    out["sssp_rmat"]["frontier"], res = engine_runs(
        sssp(wgraph, start, 3.0, "frontier"), 3)
    check(torch.equal(res.distances, sssp_res.distances),
          "SSSP frontier: distances differ from the sssp phase's (plan)")

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
    del res, plan_res, dist

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
        rows["sssp"]["frontier"], _ = engine_runs(
            sssp(g_, hub, 3.0, "frontier"), 3)
        out.update({f"rmat{scale}_{name}": {"m": int(s_.size), **r}
                    for name, r in rows.items()})
    out["fastest"] = {
        table: min((k for k, v in rows.items()
                    if isinstance(v, dict) and "best_s" in v),
                   key=lambda k: rows[k]["best_s"])
        for table, rows in out.items()}
    emit({"phase": "engines", "scale": SCALE, **out})
    return out, launches, gg


@contextlib.contextmanager
def host_loops():
    """Every single-device driver's ``device_while`` replaced by
    ``host_while``, its plain version (the Python loop that reads the
    condition back every iteration), while the block runs."""
    import importlib

    from graph_tpu_torch.engine.loop import host_while

    mods = [importlib.import_module(f"graph_tpu_torch.algos.{name}")
            for name in ("pagerank", "wcc", "sssp")]
    saved = [mod.device_while for mod in mods]
    for mod in mods:
        mod.device_while = lambda body, state, cond, **_: host_while(
            body, state, cond)
    try:
        yield
    finally:
        for mod, fn in zip(mods, saved):
            mod.device_while = fn


@contextlib.contextmanager
def other_loops(side, pair):
    """Every driver's device loop captured into ``side`` (keyed by the
    engine's cache and the driver's key) with a one-step body on two sets
    of buffers if ``pair``, else on one set that each round copies its
    outputs back into, whatever the state's size, while the block runs."""
    import importlib

    from graph_tpu_torch.engine import loop

    def routed(body, state, cond, cache=None, key=None):
        return loop.device_while(body, state, cond, cache=side,
                                 key=(id(cache), key))

    mods = [importlib.import_module(f"graph_tpu_torch.algos.{name}")
            for name in ("pagerank", "wcc", "sssp")]
    saved = [mod.device_while for mod in mods], loop.PAIR_MIN_BYTES
    for mod in mods:
        mod.device_while = routed
    loop.PAIR_MIN_BYTES = 0 if pair else 1 << 62
    try:
        yield
    finally:
        for mod, fn in zip(mods, saved[0]):
            mod.device_while = fn
        loop.PAIR_MIN_BYTES = saved[1]


def loop_path(kernels, name, fn, cache, key, path_kernels, reps,
              any_order=False):
    """One driver's device loop against its host loop on the card: capture
    and instantiation seconds apart (the cached loop dropped first); 3
    runs with their launches and host reads held; then ``reps`` rounds of
    one run each way in turn (and, for a one-step body, one the other way
    its state can go, two sets of buffers or one, ``other_loops``), bits
    and iterations held, seconds and the graphs' card times kept.
    ``any_order``: the loop's steps meet in an order of the card's threads
    (the near/far queues), so bits are held and not iterations, and a run
    reads back one value more after its loop."""
    import statistics

    import torch

    from graph_tpu_torch.engine import loop

    cache.pop(key, None)
    _sync()
    t0 = time.perf_counter()
    fn()  # captures, instantiates and runs
    _sync()
    first_s = time.perf_counter() - t0
    captured = cache[key]
    kernels.reset_launches()
    loop.reset_launches()
    runs, res = timed_runs(fn)
    launches = {**kernels.LAUNCHES, **loop.LAUNCHES}
    graph_ms = captured.graph_ms()  # the card's time of the last run
    iters, n_runs = res.ran_iterations, len(runs)
    for kname in path_kernels:
        check(launches[kname] == n_runs * iters,
              f"device loop {name}: {kname} launched {launches[kname]} "
              f"times in {n_runs} runs of {iters} iterations")
    check(launches["device_loop"] == n_runs
          and res.host_reads == 1 + any_order,
          f"device loop {name}: {launches['device_loop']} graph launches "
          f"in {n_runs} runs, {res.host_reads} host reads")
    modes = {"device": contextlib.nullcontext, "host": host_loops}
    graphs = {"device": captured}  # each mode's loop, for its card time
    pair = captured.other is not None  # the device loop's two buffers
    if captured.one_step:
        side, other = {}, "copy" if pair else "pair"
        modes[other] = lambda: other_loops(side, not pair)
        with modes[other]():
            fn()  # captures
        graphs[other] = side[(id(cache), key)]
    times, results = {m: [] for m in modes}, {}
    card_ms = {m: [] for m in graphs}
    for _ in range(reps):
        for mode, ctx in modes.items():
            with ctx():
                t, results[mode] = timed_runs(fn, 1)
            times[mode] += t
            if mode in graphs:
                card_ms[mode].append(graphs[mode].graph_ms())
    field = next(f for f in ("scores", "distances", "components")
                 if hasattr(res, f))
    want = results["host"]
    err = 0
    for mode, got in (("device", res), *results.items()):
        got_t, want_t = getattr(got, field), getattr(want, field)
        err = max(err, bits_diff(got_t, want_t))
        check(got_t.dtype == want_t.dtype and torch.equal(got_t, want_t),
              f"device loop {name} ({mode}): {field} differ from the host "
              f"loop's (max {bits_diff(got_t, want_t)})")
        check(any_order or got.ran_iterations == want.ran_iterations,
              f"device loop {name} ({mode}): {got.ran_iterations} "
              f"iterations, the host loop {want.ran_iterations}")
        if field == "scores":
            check(got.error == want.error, f"device loop {name} ({mode}): "
                  f"error {got.error}, the host loop's {want.error}")
    out = {"iterations": iters, "host_reads": res.host_reads,
           "host_loop_reads": want.host_reads, "max_abs_err": err,
           "launches_a_run": {k: v // n_runs for k, v in launches.items()
                              if v},
           "graph_ms": graph_ms, "graph_share": graph_ms / (runs[-1] * 1e3),
           "capture_s": captured.capture_s,
           "instantiate_s": captured.instantiate_s,
           "first_run_s": first_s, "pieces": len(captured.graphs),
           "buffers": 2 if pair else 1, "rounds": reps}
    for mode, ts in times.items():
        out[f"{mode}_run_s"] = ts
        out[f"{mode}_ms"] = min(ts) * 1e3
        out[f"{mode}_median_ms"] = statistics.median(ts) * 1e3
    for mode, ms in card_ms.items():
        out[f"{mode}_graph_ms"] = ms
        out[f"{mode}_graph_median_ms"] = statistics.median(ms)
    return out


def device_loop_phase(gtt, kernels, card, graph, wgraph, start, grid):
    """Each single-device driver's loop as one conditional CUDA graph
    (``graph_tpu_torch.engine.loop.device_while``) against its host loop,
    on the RMAT 22 graphs and bench.py's grid: PageRank plan at the
    default tolerance and at 0, WCC plan, SSSP plan on both graphs and
    delta-stepping (``frontier``, the near/far queues) on the grid.
    Returns the kernel row of the device loop, at the PageRank path's 20
    iterations."""
    import torch

    from graph_tpu_torch.algos.pagerank import _graph_engine
    from graph_tpu_torch.algos.sssp import _weighted_engine
    from graph_tpu_torch.algos.wcc import _sym_engine
    from graph_tpu_torch.engine.engine import engine_for

    eng = _graph_engine(graph)
    pr_key = ("page_rank", "plan", float(np.float32(0.85)))
    pr_tol0 = gtt.PageRankConfig(engine="plan", max_iterations=ITERS,
                                 tolerance=0.0)
    # rounds of one run each way: 10 where a run takes milliseconds, fewer
    # where the host loop takes 0.3 s (the grid's SSSP) or 3 s (frontier)
    paths = {
        "pagerank_tol_1e-4": (lambda: gtt.page_rank(
            graph, gtt.PageRankConfig(engine="plan")), eng.loops, pr_key,
            PATH_KERNELS["pagerank"], 10),
        "pagerank_tol_0": (lambda: gtt.page_rank(graph, pr_tol0),
                           eng.loops, pr_key, PATH_KERNELS["pagerank"], 10),
        "wcc_plan": (lambda: gtt.wcc(graph), _sym_engine(graph).loops,
                     "wcc", PATH_KERNELS["wcc"], 10),
        "sssp_plan_rmat": (lambda: gtt.delta_stepping(
            wgraph, gtt.DeltaSteppingConfig(start, 3.0, engine="plan")),
            _weighted_engine(wgraph).loops, "sssp", PATH_KERNELS["sssp"],
            10),
        "sssp_plan_grid": (lambda: gtt.delta_stepping(
            grid, gtt.DeltaSteppingConfig(0, 2.0, engine="plan")),
            _weighted_engine(grid).loops, "sssp", PATH_KERNELS["sssp"], 5),
        "delta_stepping_frontier_grid": (lambda: gtt.delta_stepping(
            grid, gtt.DeltaSteppingConfig(0, 2.0, engine="frontier")),
            engine_for(grid, "loops", dict), ("near_far", 2.0), (), 3,
            True),
    }
    out = {name: loop_path(kernels, name, *spec)
           for name, spec in paths.items()}
    # max_iterations=0: no body runs; the initial scores come back
    zero = gtt.page_rank(graph, gtt.PageRankConfig(engine="plan",
                                                   max_iterations=0))
    n = graph.node_count
    init = float(np.float32(1.0) / np.float32(n))
    check(zero.ran_iterations == 0 and zero.host_reads == 1
          and torch.equal(zero.scores, torch.full_like(zero.scores, init)),
          f"device loop, max_iterations=0: {zero.ran_iterations} "
          "iterations, scores not the initial 1/n")
    out["pagerank_max_iterations_0"] = {
        "iterations": zero.ran_iterations, "host_reads": zero.host_reads,
        "error": zero.error}
    emit({"phase": "device_loop", "card": card, **out})
    # the device loop's kernel row: one PageRank run at the path's 20
    # iterations; its bound, the bytes each iteration must move (the
    # plan's slot sources and offsets once, and five n-vectors: the
    # gathered and old scores and the 1/outdeg in, new scores and
    # out-scores out)
    pr = out["pagerank_tol_0"]
    m = eng.plan.m
    nbytes = ITERS * (4 * m + 8 * (n + 1) + 20 * n)
    bound, by = bound_of(nbytes, 0)
    run = lambda: gtt.page_rank(graph, pr_tol0)  # noqa: E731
    with host_loops():
        plain_ms = time_ms(run, reps=3)
    return {"name": "device_loop", "path": "pagerank (plan, 20 iterations)",
            "route": "cuda", "source": "graph_tpu_torch/csrc/device_loop.cu",
            "replaces": "graph_tpu/algos/pagerank.py:430 (jax.lax.while_loop"
                        "'s device loop; no pl.pallas_call)",
            "max_abs_err": pr["max_abs_err"], "ms": time_ms(run, reps=3),
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
            "library": "none: no single PyTorch call runs a loop",
            "bytes": nbytes, "shapes": f"n={n}, m={m}, {ITERS} iterations",
            "design": "a WHILE node over the captured body; one-thread "
                      "condition kernels"}


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


def mesh_check(what, got, want, launches, shards):
    """A one-shot row-block op against the single-device engine's, bit
    for bit; its launches: one of each of two kernels a shard."""
    _sync()
    e = bits_diff(got, want)
    check(e == 0, f"mesh: row-block {what} differs from the single "
          f"engine's (max {e})")
    used = {k: v for k, v in launches.items() if v}
    check(len(used) == 2 and set(used.values()) == {shards},
          f"mesh: row-block {what} launched {launches}")
    return {"bits_differing": e, "launches": used}


def drive_mesh(kernels, path, fn, iterations_of, shards):
    """:func:`drive` for a sharded path: each of its kernels must launch
    exactly once a shard an iteration."""
    res, launches = drive(kernels, path, fn, iterations_of)
    iters = iterations_of(res)
    for name in PATH_KERNELS[path]:
        check(launches[name] == shards * iters,
              f"{path}: {name} launched {launches[name]} times, "
              f"{shards} shards x {iters} iterations")
    return res, launches


def mesh_phase(gtt, kernels, dev, card, graph, wgraph, start, ug, x_t,
               pr_res, wcc_labels, sssp_res, triangles):
    """The multi-device paths at RMAT 22 on a mesh of MESH_SHARDS shards
    that share this card: the three row-block engines built (their
    stages timed) and held bit for bit to the single-device engines
    (``spmv``, ``smin_int``, ``relax``); ``page_rank``, ``wcc``,
    ``delta_stepping`` and ``global_triangle_count`` through ``use_mesh``
    held to the earlier phases' results, with K1/K2 launched once a shard
    an iteration and ``tc_count`` once a shard; and both PageRank routes
    timed, ``page_rank_rowblock``
    against ``page_rank_sharded`` (blocking and ring)."""
    import torch

    from graph_tpu_torch.algos.pagerank import _graph_engine
    from graph_tpu_torch.algos.sssp import _weighted_engine
    from graph_tpu_torch.algos.wcc import _sym_engine
    from graph_tpu_torch.engine import engine as engine_mod
    from graph_tpu_torch.parallel import pagerank as ppr
    from graph_tpu_torch.parallel import sssp as pss
    from graph_tpu_torch.parallel import wcc as pwcc
    from graph_tpu_torch.parallel.mesh import Mesh, mesh_key, use_mesh

    free_device()
    mesh = Mesh([dev] * MESH_SHARDS)
    P_, n = mesh.size, graph.node_count
    out = {"shards": P_, "devices": [str(d) for d in mesh.devices]}

    # 1. the row-block engines the routes build, built here (timed) and
    # put into the routes' caches
    builders = {"rowblock": (graph, ppr.shard_graph_plan),
                "rowblock-sym": (graph, pwcc.shard_hook_graph_plan),
                "rowblock-w": (wgraph, pss.shard_weighted_graph_plan)}
    engines, builds = {}, {}
    for kind, (g, build) in builders.items():
        _sync()
        t0 = time.perf_counter()
        rbe = build(g, mesh)
        _sync()
        engines[kind] = engine_mod.engine_for(
            g, (kind,) + mesh_key(mesh), lambda rbe=rbe: rbe)
        builds[kind] = {
            "build_s": time.perf_counter() - t0, **rbe.build_s,
            "rows_per": rbe.rows_per, "H": rbe.halo_bytes // (4 * P_),
            "halo_bytes": rbe.halo_bytes, "gather_bytes": rbe.gather_bytes,
            "slots": [e.plan.m for e in rbe.engines]}
    out["rowblock_builds"] = builds

    # 2. one op of each engine against the single-device engine's
    labels = torch.from_numpy(np.random.default_rng(2).permutation(n).astype(
        np.int32)).to(dev)
    checks = {}
    for op, kind, x, single in (
            ("spmv", "rowblock", x_t, _graph_engine(graph)),
            ("smin_int", "rowblock-sym", labels, _sym_engine(graph)),
            ("relax", "rowblock-w", sssp_res.distances,
             _weighted_engine(wgraph))):
        kernels.reset_launches()
        y = getattr(engines[kind], op)(x)
        _sync()
        launched = dict(kernels.LAUNCHES)
        checks[op] = mesh_check(op, y, getattr(single, op)(x), launched, P_)
    out["rowblock_ops"] = checks
    del y, labels

    # 3. the algorithms through the default mesh
    launches, runs = {}, {}
    cfg = gtt.PageRankConfig(max_iterations=ITERS, tolerance=0.0)
    with use_mesh(mesh):
        res, launches["pagerank"] = drive_mesh(
            kernels, "mesh_pagerank", lambda: gtt.page_rank(graph, cfg),
            lambda r: r.ran_iterations, P_)
        runs["pagerank"], res = timed_runs(lambda: gtt.page_rank(graph, cfg))
        check(res.ran_iterations == pr_res.ran_iterations,
              f"mesh: PageRank ran {res.ran_iterations} iterations, the "
              f"pagerank phase {pr_res.ran_iterations}")
        err = float((res.scores - pr_res.scores).abs().max())
        check(err <= 1e-6, f"mesh: PageRank scores {err} from the pagerank "
              "phase's")
        out["pagerank"] = {"iterations": res.ran_iterations,
                           "error": res.error, "max_abs_diff": err,
                           "bits_differing": bits_diff(res.scores,
                                                       pr_res.scores)}
        res, launches["wcc"] = drive_mesh(
            kernels, "mesh_wcc", lambda: gtt.wcc(graph),
            lambda r: r.ran_iterations, P_)
        runs["wcc"], res = timed_runs(lambda: gtt.wcc(graph))
        check(torch_equal(res.components, wcc_labels),
              "mesh: WCC labels differ from the wcc phase's")
        out["wcc"] = {"rounds": res.ran_iterations}
        scfg = gtt.DeltaSteppingConfig(start, 3.0)
        res, launches["sssp"] = drive_mesh(
            kernels, "mesh_sssp", lambda: gtt.delta_stepping(wgraph, scfg),
            lambda r: r.ran_iterations, P_)
        runs["sssp"], res = timed_runs(
            lambda: gtt.delta_stepping(wgraph, scfg))
        check(torch_equal(res.distances, sssp_res.distances),
              "mesh: SSSP distances differ from the sssp phase's")
        out["sssp"] = {"rounds": res.ran_iterations, "start_node": start}
        kernels.reset_launches()
        _sync()
        t0 = time.perf_counter()
        tc = gtt.global_triangle_count(ug)
        runs["triangles"] = [time.perf_counter() - t0]
        check(tc.triangles == triangles,
              f"mesh: {tc.triangles} triangles, the triangles phase "
              f"{triangles}")
        launches["triangles"] = {k: v for k, v in kernels.LAUNCHES.items()
                                 if v}
        check(launches["triangles"] == {"tc_count": P_},
              f"mesh: the count launched {launches['triangles']}, not "
              f"tc_count once a shard ({P_})")
        out["triangles"] = {"triangles": tc.triangles, **tc.phases}
    out["run_s"] = runs
    out["launches"] = launches
    rbe = engines["rowblock"]
    for kind in builders:  # the routes' caches: free the engines
        g = builders[kind][0]
        engine_mod._GRAPH_ENGINES.pop((id(g), (kind,) + mesh_key(mesh)))
    del engines, res, tc
    free_device()

    # 4. both PageRank routes, timed: the row-block engine against the
    # segment-op shards, blocking and ring
    _sync()
    t0 = time.perf_counter()
    sg = ppr.shard_graph(graph, mesh)
    _sync()
    routes = {"shard_graph_s": time.perf_counter() - t0,
              "shard_graph_H": sg.halo_bytes // (4 * P_),
              "shard_graph_halo_bytes": sg.halo_bytes,
              "shard_graph_gather_bytes": sg.gather_bytes}
    found = {}
    for name, fn in (
            ("rowblock", lambda: ppr.page_rank_rowblock(rbe, cfg)),
            ("sharded_blocking",
             lambda: ppr.page_rank_sharded(sg, mesh, cfg, ring=False)),
            ("sharded_ring",
             lambda: ppr.page_rank_sharded(sg, mesh, cfg, ring=True))):
        t, r = timed_runs(fn)
        check(r.ran_iterations == pr_res.ran_iterations,
              f"mesh: {name} ran {r.ran_iterations} iterations")
        err = float((r.scores - pr_res.scores).abs().max())
        check(err <= 1e-6, f"mesh: {name} scores {err} from the pagerank "
              "phase's")
        found[name] = r.scores
        routes[name] = {"run_s": t, "best_s": min(t),
                        "per_iteration_ms": min(t) / ITERS * 1e3,
                        "max_abs_diff": err}
    check(bits_diff(found["sharded_ring"], found["sharded_blocking"]) == 0,
          "mesh: the ring's scores differ from the blocking exchange's")
    out["pagerank_routes"] = routes
    del sg, rbe, found
    free_device()
    emit({"phase": "mesh", "card": card, "scale": SCALE, **out})
    return launches


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


def tails_rows(kernels, eng, graph, res, launches, errs):
    """The rows of PageRank's Jacobi tail kernels at the PageRank path's
    shapes, over its final scores in the engine's order: each kernel
    held to its plain version (the op chain it replaced, timed as
    ``plain_ms``), the update's residual within 1e-6 relative; bound
    12·n bytes each (8 read and 4 written a node)."""
    import torch

    from graph_tpu_torch.algos.pagerank import _inv_outdeg, _scalars

    k = kernels
    scores = eng.to_internal(res.scores)
    inv = eng.to_internal(_inv_outdeg(graph.out_degrees()))
    n = scores.numel()
    _, base, d = _scalars(n, 0.85)
    xq = k.jacobi_quantize_plain(scores, inv)
    hold(errs, "jacobi_quantize", k.jacobi_quantize(scores, inv), xq)
    acc = eng.sum_quanta(xq)
    work = k.jacobi_work(n, scores.device)
    new, err = k.jacobi_update(acc, scores, base, d, work=work)
    want, want_err = k.jacobi_update_plain(acc, scores, base, d)
    hold(errs, "jacobi_update", new, want)
    rel = abs(float(err) - float(want_err)) / float(want_err)
    check(rel <= 1e-6, f"jacobi_update's residual {float(err)} is {rel} "
          f"off the plain one's {float(want_err)} at n={n}")
    replaces = ("none: XLA fuses this work around the spmv "
                "(graph_tpu/algos/pagerank.py:423-428); no pl.pallas_call")
    design = {"threads": k.JACOBI_THREADS, "blocks": k.jacobi_blocks(n),
              "residual_rel_vs_plain": rel, "timing": COLD_TIMING}
    none = "none: no single PyTorch call computes it"
    shapes = f"n={n}"
    # four sets of inputs, 201 MB, so that each call finds its own cold
    sets = [(scores.clone(), inv.clone(), acc.clone()) for _ in range(4)]
    runs = {
        "jacobi_quantize": (lambda s, i, a: k.jacobi_quantize(s, i),
                            lambda s, i, a: k.jacobi_quantize_plain(s, i)),
        "jacobi_update": (
            lambda s, i, a: k.jacobi_update(a, s, base, d, work=work),
            lambda s, i, a: k.jacobi_update_plain(a, s, base, d))}
    rows = []
    for name, (run, plain) in runs.items():
        r = row(name, "pagerank", "jacobi_tails.cu", replaces, launches,
                errs, lambda: run(*sets[0]), lambda: plain(*sets[0]), none,
                12 * n, 0, shapes, design)
        r["ms"], r["plain_ms"] = cold_graph_ms(run, sets), \
            cold_graph_ms(plain, sets)
        rows.append(r)
    return rows


#: How :func:`cold_graph_ms` times a kernel of a few microseconds.
COLD_TIMING = ("20 calls captured in a CUDA graph, each on the next of four "
               "sets of inputs (larger than the L2 together), replayed 10 "
               "times, by CUDA events: no host time, inputs cold")


def cold_graph_ms(fn, sets, reps=20, replays=10):
    """ms a call of ``fn(*sets[i % len(sets)])``, as :data:`COLD_TIMING`
    says."""
    import torch

    fn(*sets[0])
    _sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*sets[i % len(sets)])
    graph.replay()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


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
    from benchmark.trace import traced
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
    with traced() as box:
        drive_probes(NBLK, reps=5)
    durations = box[0].durations
    device_us = {}
    for name in p.LAUNCHES:
        kernel = f"::{name.removeprefix('probe_')}_kernel("
        hits = [d for k, ds in durations.items() if kernel in k for d in ds]
        device_us[name] = {
            "launches_traced": len(hits),
            "device_us_per_launch": (sum(hits) / len(hits) * 1e6
                                     if hits else None)}
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


def profile_phase(gtt, kernels, graph, cfg, card):
    """Traces (``benchmark.trace.traced``) of the 20-iteration PageRank on
    the scale-22 plan, once as the device loop and once as its host loop
    (``host_loops``), each with K1 and K2 launched once an iteration by
    the wrappers' counts.  The host loop's iterations are 20
    ``page_rank.iteration`` spans; the device loop is one graph launch,
    one ``loop.run`` span whose counters hold the graph's CUDA-event time,
    its bodies and its launches.  CUPTI does not report every kernel of
    either run, least of all inside the conditional graph, so the kernel
    events are recorded beside the launches (``kernel_events_share``),
    not held to them.  For each: the kernels that took the most device
    time and the device's busy share over the run (a lower bound: the
    kernels CUPTI missed count as idle)."""
    from benchmark.trace import traced
    from graph_tpu_torch import profile
    from graph_tpu_torch.algos.pagerank import ITERATION
    from graph_tpu_torch.engine import loop

    gtt.page_rank(graph, cfg)  # warm: the engine and its loop are cached
    out = {}
    for name in ("device_loop", "host_loop"):
        kernels.reset_launches()
        loop.reset_launches()
        profile.spans(clear=True)
        with host_loops() if name == "host_loop" else \
                contextlib.nullcontext():
            with traced() as box:
                res = gtt.page_rank(graph, cfg)
        _sync()
        tr = box[0]
        spans = profile.spans(clear=True)
        launches = {**kernels.LAUNCHES, **loop.LAUNCHES}
        annotated = sum(s["name"] == ITERATION for s in spans)
        runs = [s["counters"] for s in spans if s["name"] == "loop.run"]
        events = {name: sum(len(ds) for k, ds in tr.durations.items()
                            if kernel in k)
                  for name, kernel in (("k1_gather", "k1_gather_kernel"),
                                       ("k2_reduce", "k2_tile_kernel"))}
        check(res.ran_iterations == ITERS and all(
            launches[k] == ITERS for k in PATH_KERNELS["pagerank"]),
            f"profile ({name}): {launches} launches in "
            f"{res.ran_iterations} iterations")
        check(len(runs) == 1 and runs[0]["bodies"] == [ITERS] and all(
            runs[0]["launches"].get(k) == ITERS
            for k in PATH_KERNELS["pagerank"]),
            f"profile ({name}): loop.run spans {runs}")
        if name == "host_loop":
            check(annotated == ITERS,
                  f"profile (host loop): {annotated} annotated iterations")
        else:
            check(launches["device_loop"] == 1 and res.host_reads == 1
                  and runs[0]["device_ms"] > 0,
                  f"profile (device loop): {launches['device_loop']} graph"
                  f" launches, {res.host_reads} host reads, {runs}")
        check(tr.busy_s > 0, "profile: no device activity in the trace")
        ops = sorted(((k, sum(ds) * 1e6) for k, ds in tr.durations.items()),
                     key=lambda kv: -kv[1])
        out[name] = {
            "iterations": res.ran_iterations, "host_reads": res.host_reads,
            "launches": {k: v for k, v in launches.items() if v},
            "annotated_iterations": annotated, "loop_run": runs[0],
            "kernel_events": events,
            "kernel_events_share": {k: v / ITERS for k, v in events.items()},
            "run_s": res.micros / 1e6, "run_window_us": tr.window_s * 1e6,
            "run_busy_us": tr.busy_s * 1e6,
            "run_busy_share": tr.busy_s / tr.window_s,
            "top_device_us": dict(ops[:8]),
            "port_kernels_seen": sorted(
                k for k in tr.durations
                if "k1_" in k or "k2_" in k or "loop_cond" in k)}
    emit({"phase": "profile", "card": card, **out})


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
    wgraph, start, weng, sssp_res, sssp_launches, nf_rows = sssp_phase(
        gtt, k, src, dst, n, dev)

    # 6. the same graph from files, through the builder
    bld = builder_phase(gtt, k, dev, card, src, dst, n, graph, cfg, res,
                        wcc_labels)
    emit({"phase": "memory",
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    # the user's surfaces on the builder phase's Graph500 file
    api = api_server_phase(k, card, n, m, cfg, res, wcc_labels, wcc_rounds)

    # 7. triangle count; the segment-op engines; the out-of-core engine
    triangles, ug, tc_row = triangles_phase(gtt, dev, src, dst, n)
    # the multi-device paths on a mesh of shards sharing the card
    mesh_launches = mesh_phase(gtt, k, dev, card, graph, wgraph, start, ug,
                               x_t, res, wcc_labels, sssp_res, triangles)
    del ug
    _, eng_launches, grid = engines_phase(gtt, k, dev, graph, wgraph, start,
                                          res, wcc_labels, sssp_res)
    # each loop as a conditional CUDA graph against its host loop
    loop_row = device_loop_phase(gtt, k, card, graph, wgraph, start, grid)
    del wgraph, grid
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
                     **api["pagerank"],
                     "engines (log_progress)": eng_launches["pagerank_logged"],
                     "ooc (page_rank_ooc)": ooc_launches["pagerank"],
                     "mesh (page_rank_rowblock)": mesh_launches["pagerank"]},
        "wcc": {"wcc": wcc_launches, "builder": bld["wcc_launches"],
                **api["wcc"],
                "ooc (wcc_ooc)": ooc_launches["wcc"],
                "mesh (wcc_rowblock)": mesh_launches["wcc"]},
        "sssp": {"sssp": sssp_launches,
                 "engines (grid, plan)": eng_launches["sssp_grid_plan"],
                 "ooc (sssp_ooc)": ooc_launches["sssp"],
                 "mesh (sssp_rowblock)": mesh_launches["sssp"]}}
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
    table += tails_rows(k, eng, graph, res, pr_launches, errs)

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
        t["launches_counted"] = LOOP_LAUNCHES
    # the device loop's graph: one launch a run of every path it drives
    loop_row["launches_by_path"] = {
        f"{group}: {path}": runs["device_loop"]
        for group, paths in by_path.items() for path, runs in paths.items()}
    loop_row["launches"] = sum(loop_row["launches_by_path"].values())
    check(loop_row["launches"] > 0, "the device loop was never launched")
    # the triangle join's kernel: one launch a count, one a shard on the mesh
    tc_row["launches_by_path"]["mesh"] = mesh_launches["triangles"][
        "tc_count"]
    tc_row["launches"] = sum(tc_row["launches_by_path"].values())
    table.append(tc_row)
    table += nf_rows

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
    profile_phase(gtt, k, graph, cfg, card)

    iter_ms = best / ITERS * 1e3
    emit({"phase": "kernel_detail",
          "gb_per_s": {f"{t['name']}/{t['path']}": t["bytes"] / t["ms"] / 1e6
                       for t in table},
          "pagerank_iteration_ms": iter_ms,
          "k1_k2_share_of_pagerank_iteration": (table[0]["ms"]
                                                + table[1]["ms"]) / iter_ms,
          "max_in_degree": int(torch.diff(plan.indptr).max())})
    print(card, flush=True)
    emit({"kernels": table + [loop_row]})
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
