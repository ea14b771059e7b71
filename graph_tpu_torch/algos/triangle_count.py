"""Global triangle count: orient on the host, join wedges on the device.

Counterpart of ``graph_tpu.algos.triangle_count`` (reference analog:
``global_triangle_count``, crates/algos/src/triangle_count.rs:22-86).
The work is ``graph_tpu``'s, in three steps:

1. **Orient** (host): rank nodes by ascending degree and keep each edge
   from its lower to its higher rank (``tc_orient_native``, numpy without
   the library).  Forward degree is then bounded by about sqrt(m), so the
   wedge count W = sum C(d+, 2) stays near 50 m on power-law graphs.
2. **Pack** (host): forward lists packed into per-degree-class chunk
   matrices (rows padded with ``SENT`` to caps 4/8/16/32/64; longer lists
   split into 64-wide chunks whose cross pairs are outer products).
3. **Emit and join** (device), about ``SLAB`` wedges per step: wedges are
   emitted by slices and broadcasts (:func:`_emit_intra`,
   :func:`_emit_cross`), and a wedge (v, w) counts when (v, w) is an edge.

The join differs from ``graph_tpu``'s, with the same count.  A TPU
sorts fast and gathers slowly, so ``graph_tpu`` sorts every slab's
wedges together with all edge keys (:func:`_join_count`, kept here as
``join="sort"``).  A GPU searches well: the edge keys are sorted once
and each wedge is looked up with ``torch.searchsorted``
(:func:`_lookup_count`, ``join="lookup"``, the default).  Per-slab counts
stay on the device; the host reads the total once.

Layout semantics (the reference's):

* DEDUPLICATED: distinct triangles, each counted once.
* SORTED: the reference's merge loop over lists with duplicates and
  self-loops counts wedge occurrences: for every occurrence pair
  ``v in N(u), v <= u`` and ``w in N(v), w <= v``, add 1 if ``w in
  N(u)``.  The mate golden (scale 8 -> 227,874) is this multiset count,
  computed as G(v) x F(v) occurrence cross products joined against the
  distinct adjacency keys.
* UNSORTED: rejected (the reference's merge assumes sorted lists).

Spans (:mod:`graph_tpu_torch.profile`, DEDUPLICATED path on one
device): ``triangle_count.run`` around the timed region (counters
``forward_edges``, ``wedges``, ``wedge_slots``, ``slabs``, as in the
result's ``phases``); inside it ``triangle_count.orient`` (the read-back
and the orientation; ``forward_edges``, ``native``) with
``triangle_count.to_host`` (the two copies; ``bytes``),
``triangle_count.pack`` (``wedges``, ``rows``) and
``triangle_count.join`` (``wedge_slots``, ``slabs``, ``bytes`` sent to
the device, and ``device_ms`` from CUDA events on a card).

Under a default mesh of more than one shard
(:func:`graph_tpu_torch.parallel.use_mesh`) the DEDUPLICATED count
joins on every shard (:mod:`graph_tpu_torch.parallel.tc`), unless a
``device`` is given; the SORTED multiset count stays on one device, as
in ``graph_tpu``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from graph_tpu_torch import profile
from graph_tpu_torch.algos.pagerank import _default_mesh
from graph_tpu_torch.device import run_device
from graph_tpu_torch.graph.csr import CsrLayout, UndirectedCsrGraph
from graph_tpu_torch.native.host_csr import tc_orient_native

#: Degree-class caps; lists longer than the last cap split into chunks.
CLASS_CAPS = (4, 8, 16, 32, 64)
#: Sentinel id (sorts after any real id; never matches an edge key).
SENT = 1 << 29
#: Wedge slots per join step.
SLAB = 1 << 25
#: How a wedge finds its edge: "lookup" (sorted keys, searchsorted) or
#: "sort" (graph_tpu's sort of wedges with edge keys).
JOINS = ("lookup", "sort")
#: The ``phases`` entries that the ``triangle_count.run`` span counts.
RUN_COUNTERS = ("forward_edges", "wedges", "wedge_slots", "slabs")


@dataclasses.dataclass(frozen=True)
class TriangleCountResult:
    """Reference analog: mate's ``TriangleCountResult``
    (crates/mate/src/triangle_count.rs:29-52)."""

    triangles: int
    micros: int
    #: where the time went: host orientation and packing seconds, device
    #: join seconds, forward edges, wedges, wedge slots (with pads) and
    #: join steps (slabs)
    phases: Optional[dict] = None


# ---------------------------------------------------------------------------
# device pieces


def _emit_intra(chunk: torch.Tensor, cap: int):
    """All ordered pairs (i < j) within each row, via slices."""
    vs = [chunk[:, : cap - s].reshape(-1) for s in range(1, cap)]
    ws = [chunk[:, s:].reshape(-1) for s in range(1, cap)]
    return torch.cat(vs), torch.cat(ws)


def _emit_cross(rows_a: torch.Tensor, rows_b: torch.Tensor):
    """Full outer products rows_a[i] x rows_b[i], via broadcasting."""
    r, c = rows_a.shape
    shape = (r, c, rows_b.shape[1])
    v = rows_a[:, :, None].expand(shape)
    w = rows_b[:, None, :].expand(shape)
    return v.reshape(-1), w.reshape(-1)


def _join_count(v: torch.Tensor, w: torch.Tensor, ev: torch.Tensor,
                ew: torch.Tensor) -> torch.Tensor:
    """Count wedges (v, w) for which an edge (ev, ew) exists, by sorting
    them together (``graph_tpu``'s join).

    One int64 key ``vv << 31 | ww`` sorts as (vv, ww) does: ``vv <=
    SENT + 1`` and ``ww = 2w + 1 <= 2**30 + 3 < 2**31``.  The tag bit
    (edges 0, wedges 1) sorts edges before same-pair wedges.  A wedge
    matches iff its pair's run holds an edge, i.e. the last edge position
    is at or after the run's start: two running maxima.  Returns a 0-dim
    int64 tensor on the inputs' device.
    """
    vv = torch.cat([v, ev]).long()
    ww = torch.cat([w.long() * 2 + 1, ew.long() * 2])
    key = torch.sort((vv << 31) | ww).values
    is_edge = (key & 1) == 0
    pair = key >> 1
    idx = torch.arange(key.numel(), device=key.device)
    boundary = torch.ones_like(is_edge)
    boundary[1:] = pair[1:] != pair[:-1]
    run_start = torch.cummax(torch.where(boundary, idx, 0), 0).values
    last_edge = torch.cummax(torch.where(is_edge, idx, -1), 0).values
    return ((~is_edge) & (last_edge >= run_start)).sum()


def _edge_keys(ev, ew, device: torch.device) -> torch.Tensor:
    """Edge pairs as sorted int64 keys ``v << 30 | w`` on ``device``
    (ids below ``SENT`` = 2**29, so a key holds both)."""
    ev = torch.as_tensor(np.asarray(ev), device=device).long()
    ew = torch.as_tensor(np.asarray(ew), device=device).long()
    return torch.sort((ev << 30) | ew).values


def _lookup_count(v: torch.Tensor, w: torch.Tensor,
                  keys: torch.Tensor) -> torch.Tensor:
    """Count wedges (v, w) whose key is among the sorted edge ``keys``
    (:func:`_edge_keys`).  A wedge with a ``SENT`` end has a key no edge
    has.  Returns a 0-dim int64 tensor on the inputs' device."""
    q = (v.long() << 30) | w.long()
    i = torch.searchsorted(keys, q, out_int32=True)
    return (keys[i.clamp_(max=keys.numel() - 1)] == q).sum()


# ---------------------------------------------------------------------------
# host-side packing


def _pack_chunks(heads: np.ndarray, items: np.ndarray):
    """Pack ragged lists (grouped by ``heads``, already sorted) into
    per-degree-class chunk matrices.

    Returns {cap: (rows, cap) int32 matrix} plus, for lists longer than
    the top cap, the (pairs_a, pairs_b) chunk-row matrices whose outer
    products cover cross-chunk pairs.
    """
    top = CLASS_CAPS[-1]
    n = heads.max() + 1 if heads.size else 0
    deg = np.bincount(heads, minlength=n).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(deg)])
    pos = np.arange(items.size, dtype=np.int64) - starts[heads]

    mats = {}
    prev = 1  # lists of length < 2 have no pairs
    for cap in CLASS_CAPS[:-1]:
        sel = (deg > prev) & (deg <= cap)
        prev = cap
        nodes = np.nonzero(sel)[0]
        if nodes.size == 0:
            continue
        row_of = np.full(n, -1, np.int64)
        row_of[nodes] = np.arange(nodes.size)
        mask = sel[heads]
        mat = np.full((nodes.size, cap), SENT, np.int32)
        mat[row_of[heads[mask]], pos[mask]] = items[mask]
        mats[cap] = mat

    # top class: chunk rows of width `top`, one node spans several rows
    sel = deg > CLASS_CAPS[-2]
    nodes = np.nonzero(sel)[0]
    cross = None
    if nodes.size:
        nchunks = -(-deg[nodes] // top)
        row_start = np.concatenate([[0], np.cumsum(nchunks)])
        row_of = np.full(n, -1, np.int64)
        row_of[nodes] = row_start[:-1]
        mask = sel[heads]
        rows = int(row_start[-1])
        mat = np.full((rows, top), SENT, np.int32)
        p = pos[mask]
        mat[row_of[heads[mask]] + p // top, p % top] = items[mask]
        mats[top] = mat
        # cross-chunk row pairs (a < b) per node, grouped by chunk count
        # so the pair expansion is one broadcast per distinct count
        pa, pb = [], []
        for v in np.unique(nchunks):
            if v < 2:
                continue
            r0s = row_start[:-1][nchunks == v]
            ia, ib = np.triu_indices(int(v), k=1)
            pa.append((r0s[:, None] + ia[None, :]).ravel())
            pb.append((r0s[:, None] + ib[None, :]).ravel())
        if pa:
            pa = np.concatenate(pa)
            pb = np.concatenate(pb)
            cross = (mat[pa], mat[pb])
    return mats, cross


def _nbytes(*arrays) -> int:
    return sum(int(x.nbytes) for x in arrays)


def _pad_edge_keys(ev, ew):
    """Pad edge keys to a 2^20 multiple with a sentinel distinct from the
    wedge pad (so pad wedges never match pad edges), as ``graph_tpu``
    does for its sort join's shapes."""
    unit = 1 << 20
    me = max(unit, -(-int(ev.size) // unit) * unit)
    ev = np.pad(np.asarray(ev, np.int64), (0, me - ev.size),
                constant_values=SENT + 1)
    ew = np.pad(np.asarray(ew, np.int64), (0, me - ew.size),
                constant_values=SENT + 1)
    return ev.astype(np.int32), ew.astype(np.int32)


def _groups(pairs_per_row: int, rows: int):
    """Row ranges of about ``SLAB`` wedge slots each."""
    rows_per = max(1, SLAB // max(pairs_per_row, 1))
    return [(r, min(r + rows_per, rows)) for r in range(0, rows, rows_per)]


def _run_join(mats, cross, ev, ew, cross_full=None, *,
              device: torch.device, join: str = "lookup",
              phases: Optional[dict] = None) -> int:
    """Emit wedges group by group on ``device`` and join them against the
    edge keys (ev, ew).

    ``mats``/``cross`` hold the intra-list pairs (distinct path);
    ``cross_full`` (multiset path) are (A, B) matrices whose outer
    products are the wedges G(v) x F(v).  Each matrix goes to the device
    once; each group of rows emits about ``SLAB`` wedge slots and joins
    them (``join``: see :data:`JOINS`).  Counts add up on the device and
    the host reads the total once.  ``phases``, when given, gets the
    wedge slots and join steps.
    """
    if join == "lookup":
        keys = _edge_keys(ev, ew, device)
        count = lambda v, w: _lookup_count(v, w, keys)  # noqa: E731
    elif join == "sort":
        pev, pew = (torch.from_numpy(a).to(device)
                    for a in _pad_edge_keys(ev, ew))
        count = lambda v, w: _join_count(v, w, pev, pew)  # noqa: E731
    else:
        raise ValueError(f"join must be one of {JOINS}, got {join!r}")
    total = torch.zeros((), dtype=torch.int64, device=device)
    slots = steps = 0
    for cap, mat in (mats or {}).items():
        mat_d = torch.from_numpy(mat).to(device)
        for r0, r1 in _groups(cap * (cap - 1) // 2, mat.shape[0]):
            v, w = _emit_intra(mat_d[r0:r1], cap)
            total += count(v, w)
            slots, steps = slots + v.numel(), steps + 1
    for pair in (cross, cross_full):
        if pair is None:
            continue
        a_d, b_d = (torch.from_numpy(m).to(device) for m in pair)
        per_row = a_d.shape[1] * b_d.shape[1]
        for r0, r1 in _groups(per_row, a_d.shape[0]):
            v, w = _emit_cross(a_d[r0:r1], b_d[r0:r1])
            total += count(v, w)
            slots, steps = slots + v.numel(), steps + 1
    if phases is not None:
        phases.update(wedge_slots=slots, slabs=steps)
    return int(total)  # the one host read


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
    mesh = _default_mesh()
    if mesh is not None and device is None:
        from graph_tpu_torch.parallel.tc import triangle_count_sharded

        return triangle_count_sharded(graph, mesh)
    device = run_device(graph, device)
    with profile.span("triangle_count.run") as sp:
        start = time.perf_counter()
        phases = {}
        prep = _prepare_distinct(graph, phases)
        count = 0
        if prep is not None:
            mats, cross, a, b = prep
            t0 = time.perf_counter()
            with profile.span("triangle_count.join") as jp:
                jp.cuda_events(device)
                count = _run_join(mats, cross, a, b, device=device,
                                  phases=phases)
                if jp:
                    jp.count(wedge_slots=phases["wedge_slots"],
                             slabs=phases["slabs"],
                             bytes=_nbytes(a, b, *mats.values(),
                                           *(cross or ())))
            phases["join_s"] = time.perf_counter() - t0
        micros = int((time.perf_counter() - start) * 1e6)
        if sp:
            sp.count(**{k: phases[k] for k in RUN_COUNTERS if k in phases})
    return TriangleCountResult(triangles=count, micros=micros, phases=phases)


def _check_node_count(n: int) -> None:
    if n >= SENT:
        raise ValueError(f"triangle count supports node_count < 2^29, got {n}")


def _prepare_distinct(graph: UndirectedCsrGraph, phases: dict):
    """Host preparation for distinct counting: orient, then pack.

    Returns (mats, cross, a, b): the degree-class chunk matrices, the
    cross-chunk row pairs and the oriented edge keys; or None for an
    empty graph.  Records its seconds, forward edges and wedges in
    ``phases``."""
    t0 = time.perf_counter()
    n = graph.node_count
    # a padded graph carries a sentinel tail: the real edge count is
    # offsets[-1], as graph_tpu trims it
    m_real = int(graph.csr.offsets[-1])
    if n == 0 or m_real == 0:
        return None
    _check_node_count(n)
    with profile.span("triangle_count.orient") as sp:
        with profile.span("triangle_count.to_host") as cp:
            # ids below 2**29 fit int32: cast where the graph lies, copy half
            srcs = graph.csr.sources[:m_real].to(torch.int32).cpu().numpy()
            tgts = graph.csr.targets[:m_real].to(torch.int32).cpu().numpy()
            cp.count(bytes=_nbytes(srcs, tgts))
        # ascending-degree rank bounds forward degree by the arboricity
        nat = tc_orient_native(srcs, tgts, n)
        if nat is not None:
            a, b = nat[0].astype(np.int64), nat[1]
        else:
            srcs, tgts = srcs.astype(np.int64), tgts.astype(np.int64)
            deg = np.bincount(srcs, minlength=n)
            order = np.argsort(deg, kind="stable")
            rank = np.empty(n, np.int64)
            rank[order] = np.arange(n)
            a = rank[srcs]
            b = rank[tgts]
            fwd = a < b  # each edge once; self-loops drop (equal rank)
            a, b = a[fwd], b[fwd]
            o = np.lexsort((b, a))
            a, b = a[o], b[o].astype(np.int32)
        sp.count(forward_edges=int(a.size), native=int(nat is not None))
    t1 = time.perf_counter()
    with profile.span("triangle_count.pack") as sp:
        mats, cross = _pack_chunks(a, b.astype(np.int32))
        fdeg = np.bincount(a).astype(np.int64)
        wedges = int((fdeg * (fdeg - 1) // 2).sum())
        sp.count(wedges=wedges,
                 rows=sum(m.shape[0] for m in mats.values()))
    phases.update(orient_s=t1 - t0, pack_s=time.perf_counter() - t1,
                  forward_edges=int(a.size), wedges=wedges)
    return mats, cross, a, b


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
