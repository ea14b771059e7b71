"""The emission join: triangle count's wedges written out and looked up.

The plain version of the card's intersection kernel
(:func:`~graph_tpu_torch.engine.kernels.tc_count_plain`) and the SORTED
multiset count's join (:mod:`graph_tpu_torch.algos.triangle_count`).  It
follows ``graph_tpu``'s scheme: ragged lists packed into per-degree-class
chunk matrices (rows padded with ``SENT`` to caps 4/8/16/32/64; longer
lists split into 64-wide chunks whose cross pairs are outer products;
:func:`_pack_chunks`, bit for bit ``graph_tpu``'s), about ``SLAB`` wedges
emitted a step by slices and broadcasts (:func:`_emit_intra`,
:func:`_emit_cross`), and a wedge (v, w) counted when (v, w) is an edge
(:func:`_run_join`).

The lookup differs from ``graph_tpu``'s, with the same count.  A TPU sorts
fast and gathers slowly, so ``graph_tpu`` sorts every slab's wedges
together with all edge keys (its ``_join_count``).  Here the edge keys are
sorted once and each wedge is looked up with ``torch.searchsorted``
(:func:`_lookup_count`).  Counts stay on the device; the host reads the
total once.
"""

from __future__ import annotations

from typing import Optional

import torch


#: Degree-class caps; lists longer than the last cap split into chunks.
CLASS_CAPS = (4, 8, 16, 32, 64)
#: Sentinel id (sorts after any real id; never matches an edge key).
SENT = 1 << 29
#: Wedge slots per join step.
SLAB = 1 << 25


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




def _ragged(counts: torch.Tensor):
    """For segments of lengths ``counts``, each element's segment and its
    place in it, over all ``counts.sum()`` elements in segment order."""
    seg = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    return seg, torch.arange(seg.numel(), device=seg.device) - first[seg]




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
