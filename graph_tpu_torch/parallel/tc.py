"""Multi-device triangle count: row blocks of the wedge chunks joined on
every shard.

Counterpart of ``graph_tpu.parallel.tc``.  The join counts wedges
additively, so any disjoint partition of the wedge-emitting chunk rows
is valid: each shard joins its contiguous block of every degree-class
matrix (and of the cross-chunk pairs) against the edge keys, with the
single-device join (:func:`~graph_tpu_torch.algos.triangle_count._run_join`),
and the per-shard counts add up exactly.  The preparation (orientation
and packing) is the single-device path's, made where a one-device count
would run (:func:`~graph_tpu_torch.device.run_device`); each shard takes
its blocks from there.
"""

from __future__ import annotations

import time

from graph_tpu_torch.algos.triangle_count import (
    TriangleCountResult, _prepare_distinct, _prepare_multiset, _run_join)
from graph_tpu_torch.device import run_device
from graph_tpu_torch.graph.csr import CsrLayout, UndirectedCsrGraph
from graph_tpu_torch.parallel.mesh import NODES_AXIS, Mesh


def _block(mat, p: int, P_: int):
    """Shard p's contiguous block of the rows of ``mat``."""
    rows = -(-mat.shape[0] // P_)
    return mat[p * rows: (p + 1) * rows]


def _sharded_join(mesh: Mesh, mats, cross, ev, ew, cross_full=None, *,
                  phases: dict) -> int:
    """Each shard joins its row block of every matrix on its device;
    the counts add up (one host read a shard).  ``phases`` gets the
    wedge slots, join steps and shards."""
    P_ = mesh.size
    count, slots, steps = 0, 0, 0
    for p, dev in enumerate(mesh.devices):
        part = {}
        count += _run_join(
            {cap: _block(m, p, P_) for cap, m in (mats or {}).items()},
            None if cross is None else tuple(_block(m, p, P_) for m in cross),
            ev, ew,
            None if cross_full is None
            else tuple(_block(m, p, P_) for m in cross_full),
            device=dev, phases=part)
        slots += part["wedge_slots"]
        steps += part["slabs"]
    phases.update(wedge_slots=slots, slabs=steps, shards=P_)
    return count


def triangle_count_sharded(graph: UndirectedCsrGraph, mesh: Mesh,
                           axis: str = NODES_AXIS) -> TriangleCountResult:
    """Triangle count over a mesh; the same count as the single-device
    entry.  Semantics follow the layout as there: DEDUPLICATED counts
    distinct triangles, SORTED the reference's multiset."""
    del axis
    start = time.perf_counter()
    phases = {}
    count = 0
    if graph.layout is CsrLayout.SORTED:
        prep = _prepare_multiset(graph, phases)
        if prep is not None:
            A, B, eu, ew = prep
            t0 = time.perf_counter()
            count = _sharded_join(mesh, {}, None, eu, ew, cross_full=(A, B),
                                  phases=phases)
            phases["join_s"] = time.perf_counter() - t0
    elif graph.layout is CsrLayout.DEDUPLICATED:
        prep = _prepare_distinct(graph, phases, run_device(graph))
        if prep is not None:
            mats, cross, a, b = prep
            t0 = time.perf_counter()
            count = _sharded_join(mesh, mats, cross, a, b, phases=phases)
            phases["join_s"] = time.perf_counter() - t0
    else:
        raise ValueError("triangle_count_sharded requires CsrLayout.SORTED "
                         "or CsrLayout.DEDUPLICATED")
    return TriangleCountResult(
        triangles=count, micros=int((time.perf_counter() - start) * 1e6),
        phases=phases)
