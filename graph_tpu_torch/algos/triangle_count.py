"""Global triangle count: orient, then intersect forward lists on the
device.

Counterpart of ``graph_tpu.algos.triangle_count`` (reference analog:
``global_triangle_count``, crates/algos/src/triangle_count.rs:22-86).
The distinct count takes three steps, all where the join runs (the card,
or the CPU when asked for):

1. **Orient**: rank nodes by ascending degree (ties by id) and keep each
   edge from its lower to its higher rank, sorted by (rank, rank)
   (:func:`_orient`).  Forward degree is then bounded by about sqrt(m),
   so the wedge count W = sum C(d+, 2) stays near 50 m on power-law
   graphs.
2. **Pack**: the forward edges as a CSR in rank space, the offsets of
   the forward lists beside their sorted targets, and the join's schedule
   of heads by class (:func:`_forward_csr`,
   :func:`~graph_tpu_torch.engine.kernels.tc_schedule`).
3. **Join**: :func:`~graph_tpu_torch.engine.kernels.tc_count`, which
   counts, for every forward edge (u, v), the targets N+(u) and N+(v)
   share.  On a card it is one hand-written kernel (``csrc/tc_count.cu``)
   that stages each forward list on chip and intersects it with its
   neighbours' lists: no wedge is written and no key searched for.  On the
   CPU it is its plain version, ``graph_tpu``'s scheme of wedges packed,
   emitted and looked up among the edge keys
   (:mod:`graph_tpu_torch.engine.tc_join`).

Layout semantics (the reference's):

* DEDUPLICATED: distinct triangles, each counted once.
* SORTED: the reference's merge loop over lists with duplicates and
  self-loops counts wedge occurrences: for every occurrence pair
  ``v in N(u), v <= u`` and ``w in N(v), w <= v``, add 1 if ``w in
  N(u)``.  The mate golden (scale 8 -> 227,874) is this multiset count,
  computed as G(v) x F(v) occurrence cross products joined against the
  distinct adjacency keys; its preparation is on the host.
* UNSORTED: rejected (the reference's merge assumes sorted lists).

Spans (:mod:`graph_tpu_torch.profile`, DEDUPLICATED path on one
device): ``triangle_count.run`` around the timed region (counters
``forward_edges``, ``wedges``, ``wedge_slots``, ``slabs``, as in the
result's ``phases``); inside it ``triangle_count.orient``
(``forward_edges``, and ``on_card``: 1 where the device is a card),
``triangle_count.pack`` (``wedges``, ``heads`` scheduled, of them
``long_heads``), each ending once its device work has, and
``triangle_count.join`` (``wedge_slots``: the wedges the join covers, W
without pads; ``slabs``: its calls, one kernel launch each on a card; and
``device_ms`` from CUDA events on a card).

Under a default mesh of more than one shard
(:func:`graph_tpu_torch.parallel.use_mesh`) the DEDUPLICATED count
joins on every shard (:mod:`graph_tpu_torch.parallel.tc`), unless a
``device`` is given; the SORTED multiset count stays on one device, as
in ``graph_tpu``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from graph_tpu_torch import profile
from graph_tpu_torch.device import concrete_device, run_device, synchronize
from graph_tpu_torch.engine import kernels
from graph_tpu_torch.engine.tc_join import CLASS_CAPS, SENT, _run_join
from graph_tpu_torch.graph.csr import Csr, CsrLayout, UndirectedCsrGraph

#: The ``phases`` entries that the ``triangle_count.run`` span counts.
RUN_COUNTERS = ("forward_edges", "wedges", "wedge_slots", "slabs")


@dataclasses.dataclass(frozen=True)
class TriangleCountResult:
    """Reference analog: mate's ``TriangleCountResult``
    (crates/mate/src/triangle_count.rs:29-52)."""

    triangles: int
    micros: int
    #: where the time went: orientation and packing seconds, join
    #: seconds, forward edges, wedges, wedge slots and join steps (slabs):
    #: on the DEDUPLICATED path the wedges the join covers and its calls
    #: (kernel launches on a card), on the SORTED one the slots emitted
    #: (with pads) and their steps
    phases: Optional[dict] = None


class Forward(NamedTuple):
    """The oriented graph as a CSR in rank space, with the join's
    schedule (:func:`~graph_tpu_torch.engine.kernels.tc_schedule`): all
    tensors on the join's device."""

    offsets: torch.Tensor  # (n+1,) int64: where each forward list starts
    targets: torch.Tensor  # int32: the lists, each sorted
    long_heads: torch.Tensor  # int32
    short_heads: torch.Tensor  # int32


# ---------------------------------------------------------------------------
# preparation (where the join runs)


def _orient(csr: Csr, m_real: int, device: torch.device):
    """Rank nodes by ascending degree, ties by id (a stable sort, as
    ``graph_tpu``'s counting sort ranks them), and keep the edges whose
    source ranks below their target, sorted by (rank(src), rank(dst)).

    Reads the real edges ``[:m_real]`` of ``csr`` on ``device``.  Returns
    (a, b): the forward edges' ranks, int64 and int32 tensors there."""
    n = csr.node_count
    deg = torch.diff(csr.offsets.to(device))
    order = torch.sort(deg, stable=True).indices
    rank = torch.empty(n, dtype=torch.int32, device=device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=device)
    a = rank.index_select(0, csr.sources[:m_real].to(device))
    b = rank.index_select(0, csr.targets[:m_real].to(device))
    # ranks lie below SENT = 2**29, so one key holds the pair; a
    # DEDUPLICATED graph's keys are distinct, so any sort orders them
    key = torch.sort(((a.long() << 30) | b)[a < b]).values
    return key >> 30, (key & ((1 << 30) - 1)).to(torch.int32)


def _forward_csr(a: torch.Tensor, b: torch.Tensor, n: int):
    """The forward edges (a, b) of :func:`_orient` as a :class:`Forward`
    on their device, and the forward degrees (n,)."""
    deg = torch.bincount(a, minlength=n)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=a.device)
    torch.cumsum(deg, 0, out=offsets[1:])
    return Forward(offsets, b, *kernels.tc_schedule(offsets)), deg


# ---------------------------------------------------------------------------
# public entry


def global_triangle_count(graph: UndirectedCsrGraph, *,
                          device=None) -> TriangleCountResult:
    """Count triangles of an undirected graph, joining on ``device`` (by
    default where the graph lies; a host-resident graph joins on the
    card, see :func:`graph_tpu_torch.device.run_device`).

    Mirrors ``global_triangle_count(&g) -> u64`` (triangle_count.rs:22);
    see the module docstring for per-layout semantics and the design.

    >>> from graph_tpu_torch import (CsrLayout, build_undirected,
    ...                              global_triangle_count)
    >>> g = build_undirected([0, 1, 2, 2], [1, 2, 0, 3], device="cpu",
    ...                      layout=CsrLayout.DEDUPLICATED)
    >>> global_triangle_count(g).triangles
    1
    """
    if graph.layout is CsrLayout.SORTED:
        return _multiset_triangle_count(graph, device)
    if graph.layout is not CsrLayout.DEDUPLICATED:
        raise ValueError(
            "global_triangle_count requires CsrLayout.SORTED or "
            "CsrLayout.DEDUPLICATED (the reference's merge intersection "
            "assumes sorted neighbor lists)")
    from graph_tpu_torch.parallel.mesh import _default_mesh

    mesh = _default_mesh()
    if mesh is not None and device is None:
        from graph_tpu_torch.parallel.tc import triangle_count_sharded

        return triangle_count_sharded(graph, mesh)
    device = concrete_device(run_device(graph, device))
    with profile.span("triangle_count.run") as sp:
        start = time.perf_counter()
        phases = {}
        fwd = _prepare_distinct(graph, phases, device)
        count = 0
        if fwd is not None:
            t0 = time.perf_counter()
            with profile.span("triangle_count.join") as jp:
                jp.cuda_events(device)
                count = int(kernels.tc_count(*fwd))  # the one host read
                phases.update(wedge_slots=phases["wedges"], slabs=1)
                if jp:
                    jp.count(wedge_slots=phases["wedge_slots"],
                             slabs=phases["slabs"])
            phases["join_s"] = time.perf_counter() - t0
        micros = int((time.perf_counter() - start) * 1e6)
        if sp:
            sp.count(**{k: phases[k] for k in RUN_COUNTERS if k in phases})
    return TriangleCountResult(triangles=count, micros=micros, phases=phases)


def _check_node_count(n: int) -> None:
    if n >= SENT:
        raise ValueError(f"triangle count supports node_count < 2^29, got {n}")


def _prepare_distinct(graph: UndirectedCsrGraph, phases: dict,
                      device: torch.device) -> Optional[Forward]:
    """Preparation for distinct counting on ``device``: orient, then the
    forward CSR and the join's schedule (:class:`Forward`); None for an
    empty graph.  Each phase ends once its device work has; records their
    seconds, forward edges and wedges in ``phases``."""
    t0 = time.perf_counter()
    n = graph.node_count
    # a padded graph carries a sentinel tail: the real edge count is
    # offsets[-1], as graph_tpu trims it
    m_real = int(graph.csr.offsets[-1])
    if n == 0 or m_real == 0:
        return None
    _check_node_count(n)
    with profile.span("triangle_count.orient") as sp:
        # ascending-degree rank bounds forward degree by the arboricity
        a, b = _orient(graph.csr, m_real, device)
        synchronize(device)
        sp.count(forward_edges=int(a.numel()),
                 on_card=int(device.type == "cuda"))
    t1 = time.perf_counter()
    with profile.span("triangle_count.pack") as sp:
        fwd, fdeg = _forward_csr(a, b, n)
        del a
        wedges = int((fdeg * (fdeg - 1) // 2).sum())
        synchronize(device)
        sp.count(wedges=wedges, heads=int(fwd.long_heads.numel()
                                          + fwd.short_heads.numel()),
                 long_heads=int(fwd.long_heads.numel()))
    phases.update(orient_s=t1 - t0, pack_s=time.perf_counter() - t1,
                  forward_edges=int(b.numel()), wedges=wedges)
    return fwd


def _multiset_triangle_count(graph: UndirectedCsrGraph,
                             device=None) -> TriangleCountResult:
    """Reference merge-loop semantics on SORTED lists (see module doc)."""
    device = run_device(graph, device)
    start = time.perf_counter()
    phases = {}
    prep = _prepare_multiset(graph, phases)
    count = 0
    if prep is not None:
        A, B, eu, ew = prep
        t0 = time.perf_counter()
        count = _run_join({}, None, eu, ew, cross_full=(A, B),
                          device=device, phases=phases)
        phases["join_s"] = time.perf_counter() - t0
    return TriangleCountResult(
        triangles=count, micros=int((time.perf_counter() - start) * 1e6),
        phases=phases)


def _prepare_multiset(graph: UndirectedCsrGraph, phases: dict):
    """Host preparation for SORTED multiset counting: G(v) x F(v)
    chunk-row matrices and the distinct membership keys.

    Returns (A, B, edge_u, edge_w) or None when no wedges exist; records
    its seconds and wedges in ``phases``."""
    t0 = time.perf_counter()
    n = graph.node_count
    if n == 0 or graph.csr.edge_count == 0:
        return None
    _check_node_count(n)
    srcs = graph.csr.sources.cpu().numpy().astype(np.int64)
    tgts = graph.csr.targets.cpu().numpy().astype(np.int64)

    # occurrence prefixes: F(v) = {w in N(v), w <= v} (with duplicates)
    mask = tgts <= srcs
    u1 = srcs[mask]
    v1 = tgts[mask]
    # wedges = G(v) x F(v) where G(v) = {u occurrences with v in F(u)};
    # both grouped by v, emitted as outer products of 64-wide chunks
    go = np.argsort(v1, kind="stable")
    g_heads, g_items = v1[go], u1[go].astype(np.int32)  # G lists by v
    f_heads, f_items = u1, v1.astype(np.int32)          # F lists by v

    top = CLASS_CAPS[-1]

    def chunk_rows(heads, items):
        degc = np.bincount(heads, minlength=n).astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(degc)])
        pos = np.arange(items.size, dtype=np.int64) - starts[heads]
        nchunks = -(-degc // top)
        row_start = np.concatenate([[0], np.cumsum(nchunks)])
        mat = np.full((int(row_start[-1]), top), SENT, np.int32)
        mat[row_start[heads] + pos // top, pos % top] = items
        return mat, nchunks, row_start, degc

    gm, gnc, grs, gdeg = chunk_rows(g_heads, g_items)
    fm, fnc, frs, fdeg = chunk_rows(f_heads, f_items)
    # chunk-pair expansion grouped by the (gnc, fnc) shape so each
    # distinct shape is one broadcast
    pa, pb = [], []
    both = (gnc > 0) & (fnc > 0)
    shape_key = gnc * (fnc.max() + 1) + fnc
    for key in np.unique(shape_key[both]):
        sel = both & (shape_key == key)
        nodes = np.nonzero(sel)[0]
        gv, fv = int(gnc[nodes[0]]), int(fnc[nodes[0]])
        ia, ib = np.meshgrid(np.arange(gv), np.arange(fv), indexing="ij")
        pa.append((grs[nodes][:, None] + ia.ravel()[None, :]).ravel())
        pb.append((frs[nodes][:, None] + ib.ravel()[None, :]).ravel())
    if not pa:
        return None
    A = gm[np.concatenate(pa)]
    B = fm[np.concatenate(pb)]

    # membership keys: distinct (u, w) adjacency pairs, both directions
    uniq = np.ones(srcs.size, bool)
    if srcs.size > 1:
        uniq[1:] = ~((srcs[1:] == srcs[:-1]) & (tgts[1:] == tgts[:-1]))
    phases.update(prepare_s=time.perf_counter() - t0,
                  wedges=int((gdeg * fdeg).sum()))
    return A, B, srcs[uniq], tgts[uniq]
