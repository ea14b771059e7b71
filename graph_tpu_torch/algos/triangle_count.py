"""Global triangle count: orient, pack and join wedges on the device.

Counterpart of ``graph_tpu.algos.triangle_count`` (reference analog:
``global_triangle_count``, crates/algos/src/triangle_count.rs:22-86).
The work is ``graph_tpu``'s, in three steps, all where the join runs
(the card, or the CPU when asked for):

1. **Orient**: rank nodes by ascending degree (ties by id) and keep each
   edge from its lower to its higher rank, sorted by (rank, rank)
   (:func:`_orient`).  Forward degree is then bounded by about sqrt(m),
   so the wedge count W = sum C(d+, 2) stays near 50 m on power-law
   graphs.
2. **Pack**: forward lists packed into per-degree-class chunk matrices
   (rows padded with ``SENT`` to caps 4/8/16/32/64; longer lists split
   into 64-wide chunks whose cross pairs are outer products;
   :func:`_pack_chunks`), bit for bit ``graph_tpu``'s host packing.
3. **Emit and join**, about ``SLAB`` wedges per step: wedges are
   emitted by slices and broadcasts (:func:`_emit_intra`,
   :func:`_emit_cross`), and a wedge (v, w) counts when (v, w) is an edge.

The join differs from ``graph_tpu``'s, with the same count.  A TPU
sorts fast and gathers slowly, so ``graph_tpu`` sorts every slab's
wedges together with all edge keys (its ``_join_count``).  A GPU
searches well: the edge keys are sorted once and each wedge is looked
up with ``torch.searchsorted`` (:func:`_lookup_count`).  Per-slab counts
stay on the device; the host reads sizes and the total once.

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
``triangle_count.pack`` (``wedges``, ``rows``), each ending once its
device work has, and ``triangle_count.join`` (``wedge_slots``,
``slabs``, and ``device_ms`` from CUDA events on a card).

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
from graph_tpu_torch.device import concrete_device, run_device, synchronize
from graph_tpu_torch.graph.csr import Csr, CsrLayout, UndirectedCsrGraph

#: Degree-class caps; lists longer than the last cap split into chunks.
CLASS_CAPS = (4, 8, 16, 32, 64)
#: Sentinel id (sorts after any real id; never matches an edge key).
SENT = 1 << 29
#: Wedge slots per join step.
SLAB = 1 << 25
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


def _edge_keys(ev, ew, device: torch.device) -> torch.Tensor:
    """Edge pairs as sorted int64 keys ``v << 30 | w`` on ``device``
    (ids below ``SENT`` = 2**29, so a key holds both)."""
    ev = torch.as_tensor(ev, device=device).long()
    ew = torch.as_tensor(ew, device=device).long()
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
# preparation (where the join runs)


def _ragged(counts: torch.Tensor):
    """For segments of lengths ``counts``, each element's segment and its
    place in it, over all ``counts.sum()`` elements in segment order."""
    seg = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    return seg, torch.arange(seg.numel(), device=seg.device) - first[seg]


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


def _pack_chunks(heads: torch.Tensor, items: torch.Tensor, n: int):
    """Pack ragged lists (grouped by ``heads`` below ``n``, already
    sorted) into per-degree-class chunk matrices, on their device.

    ``graph_tpu``'s ``_pack_chunks``, bit for bit: a list of length d,
    2 <= d <= 32, is one row of the smallest cap at least d; a longer one
    is ceil(d / 64) rows of 64; rows follow their heads' order and pad
    with ``SENT``.  All matrices are views of one buffer, filled by one
    scatter.  Returns ({cap: (rows, cap) int32 matrix}, the (pairs_a,
    pairs_b) chunk-row matrices whose outer products cover the cross-chunk
    pairs of the long lists, or None, and the lists' lengths (n,))."""
    dev = heads.device
    top = CLASS_CAPS[-1]
    deg = torch.bincount(heads, minlength=n)
    # a node's class: 0 for lists of length < 2 (no pairs), else
    # 1 + the index of its cap in CLASS_CAPS
    cls = torch.bucketize(deg, torch.tensor((1,) + CLASS_CAPS[:-1],
                                            device=dev))
    caps = torch.tensor((0,) + CLASS_CAPS, device=dev)[cls]
    rows = torch.where(cls == len(CLASS_CAPS), (deg + top - 1) // top,
                       (cls > 0).long())
    # slots laid out class by class, nodes in order within a class
    by_class = torch.sort(cls, stable=True).indices
    slots = (rows * caps)[by_class]
    base = torch.empty_like(deg)
    base[by_class] = torch.cumsum(slots, 0) - slots
    per_class = torch.zeros(len(CLASS_CAPS) + 1, dtype=torch.int64,
                            device=dev).index_add_(0, cls, rows).tolist()
    total = sum(r * c for r, c in zip(per_class[1:], CLASS_CAPS))
    flat = torch.full((total,), SENT, dtype=torch.int32, device=dev)
    starts = torch.cumsum(deg, 0) - deg
    keep = cls.index_select(0, heads) > 0
    at = (torch.arange(heads.numel(), device=dev)
          + (base - starts).index_select(0, heads))
    flat[at[keep]] = items[keep]

    mats, off = {}, 0
    for r, cap in zip(per_class[1:], CLASS_CAPS):
        if r:
            mats[cap] = flat[off: off + r * cap].view(r, cap)
        top_base, off = off, off + r * cap
    cross = None
    if top in mats:
        # cross-chunk row pairs (i < j) of each long list: lists grouped
        # by chunk count, in head order within a group, pairs row-major
        long_ = torch.nonzero((cls == len(CLASS_CAPS)) & (rows > 1))[:, 0]
        if long_.numel():
            nc = rows[long_]
            group = torch.sort(nc, stable=True).indices
            nc = nc[group]
            r0 = (base[long_[group]] - top_base) // top
            k, i = _ragged(nc - 1)
            r, dj = _ragged(nc[k] - 1 - i)
            pa = (r0[k] + i)[r]
            mat = mats[top]
            cross = (mat[pa], mat[pa + 1 + dj])
    return mats, cross, deg


def _groups(pairs_per_row: int, rows: int):
    """Row ranges of about ``SLAB`` wedge slots each."""
    rows_per = max(1, SLAB // max(pairs_per_row, 1))
    return [(r, min(r + rows_per, rows)) for r in range(0, rows, rows_per)]


def _run_join(mats, cross, ev, ew, cross_full=None, *,
              device: torch.device, phases: Optional[dict] = None) -> int:
    """Emit wedges group by group on ``device`` and look them up among
    the edge keys (ev, ew).

    ``mats``/``cross`` hold the intra-list pairs (distinct path);
    ``cross_full`` (multiset path) are (A, B) matrices whose outer
    products are the wedges G(v) x F(v).  Tensors or host arrays: each
    matrix not on the device goes there once; each group of rows emits
    about ``SLAB`` wedge slots and counts the matches
    (:func:`_lookup_count`).  Counts add up on the device and the host
    reads the total once.  ``phases``, when given, gets the wedge slots
    and join steps.
    """
    keys = _edge_keys(ev, ew, device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    slots = steps = 0
    for cap, mat in (mats or {}).items():
        mat_d = torch.as_tensor(mat, device=device)
        for r0, r1 in _groups(cap * (cap - 1) // 2, mat.shape[0]):
            v, w = _emit_intra(mat_d[r0:r1], cap)
            total += _lookup_count(v, w, keys)
            slots, steps = slots + v.numel(), steps + 1
    for pair in (cross, cross_full):
        if pair is None:
            continue
        a_d, b_d = (torch.as_tensor(m, device=device) for m in pair)
        per_row = a_d.shape[1] * b_d.shape[1]
        for r0, r1 in _groups(per_row, a_d.shape[0]):
            v, w = _emit_cross(a_d[r0:r1], b_d[r0:r1])
            total += _lookup_count(v, w, keys)
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
    from graph_tpu_torch.parallel.mesh import _default_mesh

    mesh = _default_mesh()
    if mesh is not None and device is None:
        from graph_tpu_torch.parallel.tc import triangle_count_sharded

        return triangle_count_sharded(graph, mesh)
    device = concrete_device(run_device(graph, device))
    with profile.span("triangle_count.run") as sp:
        start = time.perf_counter()
        phases = {}
        prep = _prepare_distinct(graph, phases, device)
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
                      device: torch.device):
    """Preparation for distinct counting on ``device``: orient, then pack.

    Returns (mats, cross, a, b), tensors on ``device``: the degree-class
    chunk matrices, the cross-chunk row pairs and the oriented edge keys;
    or None for an empty graph.  Each phase ends once its device work
    has; records their seconds, forward edges and wedges in ``phases``."""
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
        mats, cross, fdeg = _pack_chunks(a, b, n)
        wedges = int((fdeg * (fdeg - 1) // 2).sum())
        synchronize(device)
        sp.count(wedges=wedges,
                 rows=sum(m.shape[0] for m in mats.values()))
    phases.update(orient_s=t1 - t0, pack_s=time.perf_counter() - t1,
                  forward_edges=int(a.numel()), wedges=wedges)
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
