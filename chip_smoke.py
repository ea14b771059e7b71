#!/usr/bin/env python3
"""On-card check of graph_tpu_torch: plan-engine PageRank at RMAT scale 22.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``graph_tpu_torch/csrc``, holds each
against its plain PyTorch version bit for bit (edge cases, then the
scale-22 shapes), drives the port's main path through its public entry
points (``build_directed`` and ``page_rank``) on a Graph500 RMAT graph
of scale 22 (n = 4,194,304, m = 67,108,864, seed 42), checks spmv
against a host model of the int32 quanta on every row, and times the
PageRank run and each kernel.  It prints one JSON line per phase; the
line before the last lists the kernels, and the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without that line, as does a machine without a CUDA device.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SCALE = 22
ITERS = 20
#: H100 SXM data sheet: HBM3 rate, and the float32 rate outside the
#: tensor cores (the table's entry for scalar arithmetic; K2's int32
#: additions are counted against it).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
#: bench.py's traffic model of one pull iteration: 4 B source id + 4 B
#: gathered score + amortized index and score writes, per edge.
BYTES_PER_EDGE = 12.0


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


def max_abs_diff(a, b):
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def edge_cases(dev, seed):
    """Inputs for K1/K2 with empty rows, a hub row longer than a block,
    sums that wrap int32, and m not a multiple of the block size."""
    import torch

    g = np.random.default_rng(seed)
    counts = g.integers(0, 40, 3001)
    counts[::5] = 0
    counts[17] = 300_001
    indptr = np.concatenate([[0], np.cumsum(counts)])
    m = int(indptr[-1])
    arrays = (g.integers(-2**31, 2**31, 1 << 12).astype(np.int32),  # xq
              g.integers(0, 1 << 12, m).astype(np.int32),           # slot_src
              g.integers(-2**31, 2**31, m).astype(np.int32),        # contrib
              indptr)
    return [torch.from_numpy(a).to(dev) for a in arrays]


def compare_kernels(kernels, xq, slot_src, contrib, indptr, errs):
    """Kernel vs plain version on the same inputs; records max |diff|."""
    got1, want1 = kernels.k1_gather(xq, slot_src), kernels.k1_gather_plain(
        xq, slot_src)
    got2, want2 = kernels.k2_reduce(contrib, indptr), kernels.k2_reduce_plain(
        contrib, indptr)
    _sync()
    e1, e2 = max_abs_diff(got1, want1), max_abs_diff(got2, want2)
    errs["k1_gather"] = max(errs["k1_gather"], e1)
    errs["k2_reduce"] = max(errs["k2_reduce"], e2)
    check(e1 == 0, f"k1_gather disagrees with its plain version (max {e1})")
    check(e2 == 0, f"k2_reduce disagrees with its plain version (max {e2})")


def host_jacobi(src, dst, n, iters, damping):
    """float64 PageRank on the host: the plain reference for small graphs."""
    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1.0), 0.0)
    scores = np.full(n, 1.0 / n)
    for _ in range(iters):
        y = np.bincount(dst, weights=(scores * inv)[src], minlength=n)
        scores = (1.0 - damping) / n + damping * y
    return scores


def small_graph_checks(gtt, dev):
    """The port on the card against the host on small inputs: a float64
    Jacobi reference (within 1e-6) and the port's CPU path (same
    iteration count, scores within 1e-6)."""
    from graph_tpu_torch.generate import host_rmat

    wiki = np.array([(1, 2), (2, 1), (4, 0), (4, 1), (5, 4), (5, 1), (5, 6),
                     (6, 1), (6, 5), (7, 1), (7, 5), (8, 1), (8, 5), (9, 1),
                     (9, 5), (10, 1), (10, 5), (11, 5), (12, 5)])
    out = {}
    for name, (src, dst, n) in {
            "wiki": (wiki[:, 0], wiki[:, 1], 13),
            "rmat12": (*host_rmat(12, seed=3), 1 << 12)}.items():
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
        out[name] = {"iterations": card.ran_iterations,
                     "max_abs_vs_f64": err_ref, "max_abs_vs_cpu": err_cpu}
    return out


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


def run():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import graph_tpu_torch as gtt
        from graph_tpu_torch.algos.pagerank import _graph_engine
        from graph_tpu_torch.engine import _build, kernels
        from graph_tpu_torch.generate import cached_rmat
    except ImportError as exc:
        print(f"chip_smoke: graph_tpu_torch not found next to this script "
              f"({exc})", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    # 1. card and kernel build (one nvcc per source, all started together)
    t0 = time.perf_counter()
    built = _build.build()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels_built": built,
          "build_s": time.perf_counter() - t0})

    # 2. kernels against their plain versions at edge-case shapes
    errs = {"k1_gather": 0, "k2_reduce": 0}
    for seed in (13, 14):
        compare_kernels(kernels, *edge_cases(dev, seed), errs)
    emit({"phase": "kernels_edge_cases", "max_abs_err": dict(errs)})
    emit({"phase": "small_graphs", **small_graph_checks(gtt, dev)})

    # 3. the main path
    n = 1 << SCALE
    t0 = time.perf_counter()
    src, dst = cached_rmat(SCALE, os.path.join(ROOT, ".cache", "rmat"))
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
    x_t, bad = gate(eng, src, dst, n, dev)

    cfg = gtt.PageRankConfig(engine="plan", max_iterations=ITERS,
                             tolerance=0.0)
    kernels.reset_launches()
    res = gtt.page_rank(graph, cfg)
    launches = dict(kernels.LAUNCHES)
    for name, count in launches.items():
        check(count >= ITERS, f"{name} launched {count} times in one "
              f"PageRank run, expected at least {ITERS}")
    runs = []
    for _ in range(3):
        _sync()
        t0 = time.perf_counter()
        res = gtt.page_rank(graph, cfg)
        _sync()
        runs.append(time.perf_counter() - t0)
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
          "rmat_s": rmat_s, "build_directed_s": graph_s,
          "plan_build_s": plan_s, "gate_bad_rows": bad,
          "iterations": res.ran_iterations, "error": res.error,
          "score_sum": total, "run_s": runs, "best_s": best,
          "gteps": gteps,
          "roofline_gteps_12B_per_edge": HBM_BYTES_PER_S / BYTES_PER_EDGE / 1e9,
          "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    # 4. the kernels at the main path's shapes: exactness, then times
    plan = eng.plan
    xq = torch.round(eng.to_internal(x_t) * float(1 << 30)).to(torch.int32)
    contrib = kernels.k1_gather_plain(xq, plan.slot_src)
    compare_kernels(kernels, xq, plan.slot_src, contrib, plan.indptr, errs)
    rows = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.diff(plan.indptr))
    lib2 = torch.zeros(n, dtype=torch.int32, device=dev)
    lib2.index_add_(0, rows, contrib)
    check(torch.equal(lib2, kernels.k2_reduce_plain(contrib, plan.indptr)),
          "index_add_ yardstick disagrees with k2_reduce")

    def k2_library():
        torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, rows, contrib)

    bytes1 = 4 * m + 4 * m + 4 * n
    bytes2 = 4 * m + 8 * (n + 1) + 4 * n
    bound1 = bytes1 / HBM_BYTES_PER_S * 1e3
    bound2 = max(bytes2 / HBM_BYTES_PER_S, m / SCALAR_OPS_PER_S) * 1e3
    table = [
        {"name": "k1_gather", "route": "cuda",
         "source": "graph_tpu_torch/csrc/k1_gather.cu",
         "replaces": "graph_tpu/engine/kernels.py:253",
         "launches": launches["k1_gather"],
         "max_abs_err": errs["k1_gather"],
         "ms": time_ms(lambda: kernels.k1_gather(xq, plan.slot_src)),
         "plain_ms": time_ms(
             lambda: kernels.k1_gather_plain(xq, plan.slot_src)),
         "bound_ms": bound1, "bound_by": "bytes",
         "library_ms": time_ms(
             lambda: torch.index_select(xq, 0, plan.slot_src))},
        {"name": "k2_reduce", "route": "cuda",
         "source": "graph_tpu_torch/csrc/k2_reduce.cu",
         "replaces": "graph_tpu/engine/kernels.py:603",
         "launches": launches["k2_reduce"],
         "max_abs_err": errs["k2_reduce"],
         "ms": time_ms(lambda: kernels.k2_reduce(contrib, plan.indptr)),
         "plain_ms": time_ms(
             lambda: kernels.k2_reduce_plain(contrib, plan.indptr)),
         "bound_ms": bound2,
         "bound_by": ("bytes" if bytes2 / HBM_BYTES_PER_S
                      >= m / SCALAR_OPS_PER_S else "operations"),
         "library_ms": time_ms(k2_library)},
    ]
    iter_ms = best / ITERS * 1e3
    emit({"phase": "kernel_detail", "bytes": {"k1_gather": bytes1,
                                              "k2_reduce": bytes2},
          "gb_per_s": {t["name"]: (bytes1 if t["name"] == "k1_gather"
                                   else bytes2) / t["ms"] / 1e6
                       for t in table},
          "pagerank_iteration_ms": iter_ms,
          "k1_k2_share_of_iteration": (table[0]["ms"] + table[1]["ms"])
          / iter_ms,
          "max_in_degree": int(torch.diff(plan.indptr).max())})
    print(card, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main():
    try:
        return run()
    except Exception:  # any failed phase: report it and print no result
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
