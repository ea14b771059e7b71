"""CSR construction from COO edge streams, on the device or the host.

Counterpart of ``graph_tpu.graph.build`` (reference analog: the parallel
CSR builder, crates/builder/src/graph/csr.rs:124-221).  No atomics and
no scatter races — every step of the device build is a sort:

1. a stable ``torch.sort`` by row (UNSORTED keeps each row's input
   order), or by col and then by row for the (row, col) order;
2. ``offsets`` by ``torch.searchsorted`` of each row id in the sorted
   rows;
3. DEDUPLICATED: first-of-run mask without self-loops, then compaction
   (one host sync for the kept count).

:func:`build_undirected_host` builds the same undirected CSR in host
memory, through the native radix builder (``native/host_csr.cpp``) for
int32 ids and numpy otherwise.

:func:`build_directed` and :func:`build_undirected` are ``graph.build``
spans (:mod:`graph_tpu_torch.profile`); in them each copy of a host
array is a ``graph.build.host`` span, and each transfer of one to the
card a ``graph.build.h2d`` span with counters ``bytes`` and
``device_ms`` (a CUDA-event pair).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from graph_tpu_torch import profile
from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.dtypes import (
    canonical_id_dtype, check_node_count_fits, torch_id_dtype)
from graph_tpu_torch.graph.csr import (
    Csr, CsrLayout, DirectedCsrGraph, UndirectedCsrGraph)

#: The native builder's layout codes (and the binary snapshot's).
LAYOUT_CODES = {CsrLayout.UNSORTED: 0, CsrLayout.SORTED: 1,
                CsrLayout.DEDUPLICATED: 2}


def _as_tensor(a, device: torch.device, dtype=None) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        with profile.span("graph.build.host"):
            a = torch.from_numpy(np.ascontiguousarray(a))
    if a.device.type != "cpu" or device.type == "cpu":
        return a.to(device=device, dtype=dtype)
    with profile.span("graph.build.h2d") as sp:
        if sp:
            sp.count(bytes=a.numel() * a.element_size())
            sp.cuda_events(device)
        return a.to(device=device, dtype=dtype)


def _id_dtype_of(rows, id_dtype) -> np.dtype:
    if id_dtype is not None:
        return canonical_id_dtype(id_dtype)
    if hasattr(rows, "dtype"):
        return canonical_id_dtype(rows.dtype)
    return np.dtype(np.int32)


def csr_from_coo(
    rows,
    cols,
    values=None,
    *,
    node_count: int,
    layout: CsrLayout = CsrLayout.UNSORTED,
    id_dtype=None,
    device=None,
) -> Csr:
    """Build one CSR direction from a COO edge stream on ``device``."""
    device = resolve_device(device)
    dt = _id_dtype_of(rows, id_dtype)
    check_node_count_fits(node_count, dt)
    tdt = torch_id_dtype(dt)

    rows = _as_tensor(rows, device, torch.int64)
    cols = _as_tensor(cols, device, torch.int64)
    if values is not None:
        values = _as_tensor(values, device)

    if layout is CsrLayout.UNSORTED:
        order = torch.sort(rows, stable=True).indices
    else:  # (row, col) lexicographic, stable among equal pairs
        order = torch.sort(cols, stable=True).indices
        order = order[torch.sort(rows[order], stable=True).indices]
    rows_s, cols_s = rows[order], cols[order]
    vals_s = None if values is None else values[order]

    if layout is CsrLayout.DEDUPLICATED and rows_s.numel() > 0:
        keep = torch.ones_like(rows_s, dtype=torch.bool)
        keep[1:] = (rows_s[1:] != rows_s[:-1]) | (cols_s[1:] != cols_s[:-1])
        keep &= rows_s != cols_s
        rows_s, cols_s = rows_s[keep], cols_s[keep]
        if vals_s is not None:
            vals_s = vals_s[keep]

    probes = torch.arange(node_count + 1, dtype=torch.int64, device=device)
    offsets = torch.searchsorted(rows_s, probes, side="left")
    return Csr(offsets=offsets.to(tdt), sources=rows_s.to(tdt),
               targets=cols_s.to(tdt), values=vals_s)


def _infer_node_count(src, dst, node_count: Optional[int]) -> int:
    if node_count is not None:
        return int(node_count)
    # Reference: EdgeList::max_node_id() (input/edgelist.rs:84-90);
    # node_count = max id + 1.
    if len(src) == 0:
        return 0
    hi = [s.max().item() if isinstance(s, torch.Tensor) else np.max(s)
          for s in (src, dst)]
    return int(max(hi)) + 1


def build_directed(
    src,
    dst,
    values=None,
    *,
    node_count: Optional[int] = None,
    layout: CsrLayout = CsrLayout.UNSORTED,
    id_dtype=np.int32,
    node_values=None,
    device=None,
) -> DirectedCsrGraph:
    """Build a directed graph (out-CSR + in-CSR) on ``device``.

    Reference analog: ``DirectedCsrGraph::from((edge_list, layout))``
    (csr.rs:522-544) — one CSR pass per direction.
    """
    device = resolve_device(device)
    with profile.span("graph.build"):
        n = _infer_node_count(src, dst, node_count)
        csr_out = csr_from_coo(src, dst, values, node_count=n,
                               layout=layout, id_dtype=id_dtype,
                               device=device)
        csr_in = csr_from_coo(dst, src, values, node_count=n, layout=layout,
                              id_dtype=id_dtype, device=device)
        nv = None if node_values is None else _as_tensor(node_values,
                                                         device)
        return DirectedCsrGraph(csr_out=csr_out, csr_in=csr_in,
                                node_values=nv, layout=layout)


def build_undirected(
    src,
    dst,
    values=None,
    *,
    node_count: Optional[int] = None,
    layout: CsrLayout = CsrLayout.UNSORTED,
    id_dtype=np.int32,
    node_values=None,
    device=None,
) -> UndirectedCsrGraph:
    """Build an undirected graph on ``device``: both directions in one CSR.

    Reference analog: undirected CSR construction feeding each input edge
    in both directions (csr.rs:658-690); ``edge_count`` stays the input
    edge count (targets/2).
    """
    device = resolve_device(device)
    with profile.span("graph.build"):
        n = _infer_node_count(src, dst, node_count)
        id_dtype = _id_dtype_of(src, id_dtype)  # before the int64 widening
        src = _as_tensor(src, device, torch.int64)
        dst = _as_tensor(dst, device, torch.int64)
        vals = None
        if values is not None:
            values = _as_tensor(values, device)
            vals = torch.cat([values, values])
        csr = csr_from_coo(torch.cat([src, dst]), torch.cat([dst, src]),
                           vals, node_count=n, layout=layout,
                           id_dtype=id_dtype, device=device)
        nv = None if node_values is None else _as_tensor(node_values,
                                                         device)
        return UndirectedCsrGraph(csr=csr, node_values=nv, layout=layout)


def _host_array(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_undirected_host(
    src,
    dst,
    values=None,
    *,
    node_count: Optional[int] = None,
    layout: CsrLayout = CsrLayout.UNSORTED,
    id_dtype=np.int32,
    node_values=None,
) -> UndirectedCsrGraph:
    """Host-resident undirected build: the CSR as CPU tensors, marked
    ``host`` (see :class:`UndirectedCsrGraph`).

    For pipelines whose next step reads the edge list back on the host,
    so that the graph never makes a round trip through the card.  An
    algorithm given the result still runs on the card unless its caller
    passes ``device="cpu"``.  Results are
    identical to :func:`build_undirected`'s: UNSORTED rows keep their
    input order, as the device build's stable sort does.
    """
    n = _infer_node_count(src, dst, node_count)
    dt = canonical_id_dtype(id_dtype)
    check_node_count_fits(n, dt)
    src, dst = _host_array(src), _host_array(dst)
    if values is not None:
        values = _host_array(values)
    nv = None if node_values is None else torch.from_numpy(
        np.ascontiguousarray(_host_array(node_values)))

    native = None
    if dt == np.int32:  # the C++ radix builder emits int32 ids
        from graph_tpu_torch.native.host_csr import build_undirected_native

        native = build_undirected_native(src, dst, values, n,
                                         LAYOUT_CODES[layout])
    if native is not None:
        offsets, rows, cols, vals = native
    else:
        rows = np.concatenate([src, dst]).astype(np.int64)
        cols = np.concatenate([dst, src]).astype(np.int64)
        vals = None if values is None else np.concatenate([values, values])
        if layout is CsrLayout.UNSORTED:
            order = np.argsort(rows, kind="stable")
        else:
            order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        if vals is not None:
            vals = vals[order]
        if layout is CsrLayout.DEDUPLICATED and rows.size:
            keep = np.ones(rows.size, bool)
            keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            keep &= rows != cols
            rows, cols = rows[keep], cols[keep]
            if vals is not None:
                vals = vals[keep]
        offsets = np.searchsorted(rows, np.arange(n + 1)).astype(dt)
        rows, cols = rows.astype(dt), cols.astype(dt)
        if vals is not None:
            vals = vals.astype(np.float32)
    csr = Csr(offsets=torch.from_numpy(offsets),
              sources=torch.from_numpy(rows), targets=torch.from_numpy(cols),
              values=None if vals is None else torch.from_numpy(vals))
    return UndirectedCsrGraph(csr=csr, node_values=nv, layout=layout,
                              host=True)
