"""Multi-device triangle count: the join split over the shards.

Counterpart of ``graph_tpu.parallel.tc``.  The join counts wedges
additively, so any disjoint partition of them is valid, and the counts
of the parts add up exactly:

* DEDUPLICATED: each shard counts a contiguous range of heads of the
  forward CSR (about an equal share of the wedges) on its device with
  the one-device join (:func:`~graph_tpu_torch.engine.kernels.tc_count`).
* SORTED: each shard joins its contiguous block of rows of the multiset
  count's chunk-row matrices against the edge keys
  (:func:`~graph_tpu_torch.engine.tc_join._run_join`).

The preparation (orientation and the forward CSR, or the multiset
matrices) is the single-device path's, made where a one-device count
would run (:func:`~graph_tpu_torch.device.run_device`); each shard takes
what it reads from there.
"""

from __future__ import annotations

import time

import torch

from graph_tpu_torch.algos.triangle_count import (
    Forward, TriangleCountResult, _prepare_distinct, _prepare_multiset)
from graph_tpu_torch.device import run_device
from graph_tpu_torch.engine import kernels
from graph_tpu_torch.engine.tc_join import _run_join
from graph_tpu_torch.graph.csr import CsrLayout, UndirectedCsrGraph
from graph_tpu_torch.parallel.mesh import NODES_AXIS, Mesh


def _block(mat, p: int, P_: int):
    """Shard p's contiguous block of the rows of ``mat``."""
    rows = -(-mat.shape[0] // P_)
    return mat[p * rows: (p + 1) * rows]


def head_ranges(offsets: torch.Tensor, parts: int) -> list:
    """``parts`` + 1 head bounds from 0 to n that cut the forward CSR's
    heads into contiguous ranges of about equal wedges."""
    deg = torch.diff(offsets)
    cum = torch.cumsum(deg * (deg - 1) // 2, 0)
    total = cum[-1:]
    # a part ends before the first head whose wedges up to and including
    # its own reach the part's share
    share = total * torch.arange(1, parts, device=cum.device) // parts
    cuts = torch.searchsorted(cum, share)
    return [0, *(int(c) for c in cuts), deg.numel()]


def _distinct_join(mesh: Mesh, fwd: Forward, *, phases: dict) -> int:
    """Each shard counts its range of heads on its device; the counts add
    up (one host read a shard).  ``phases`` gets the join's calls and
    shards."""
    P_ = mesh.size
    bounds = head_ranges(fwd.offsets, P_)
    count = 0
    for p, dev in enumerate(mesh.devices):
        count += int(kernels.tc_count(*(t.to(dev) for t in fwd),
                                      bounds[p], bounds[p + 1]))
    phases.update(wedge_slots=phases["wedges"], slabs=P_, shards=P_)
    return count


def _multiset_join(mesh: Mesh, A, B, eu, ew, *, phases: dict) -> int:
    """Each shard joins its row block of the chunk-row matrices on its
    device; the counts add up (one host read a shard).  ``phases`` gets
    the wedge slots, join steps and shards."""
    P_ = mesh.size
    count, slots, steps = 0, 0, 0
    for p, dev in enumerate(mesh.devices):
        part = {}
        count += _run_join({}, None, eu, ew,
                           (_block(A, p, P_), _block(B, p, P_)),
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
            t0 = time.perf_counter()
            count = _multiset_join(mesh, *prep, phases=phases)
            phases["join_s"] = time.perf_counter() - t0
    elif graph.layout is CsrLayout.DEDUPLICATED:
        fwd = _prepare_distinct(graph, phases, run_device(graph))
        if fwd is not None:
            t0 = time.perf_counter()
            count = _distinct_join(mesh, fwd, phases=phases)
            phases["join_s"] = time.perf_counter() - t0
    else:
        raise ValueError("triangle_count_sharded requires CsrLayout.SORTED "
                         "or CsrLayout.DEDUPLICATED")
    return TriangleCountResult(
        triangles=count, micros=int((time.perf_counter() - start) * 1e6),
        phases=phases)
