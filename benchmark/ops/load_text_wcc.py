"""A fresh LDBC Graphalytics snapshot answered once: ``Graph.load`` of
the ``.e`` text that set-up wrote (:mod:`benchmark.ops.ldbc_text`) with
``FileFormat.EdgeList``, then ``.wcc()`` with its defaults and
``.components()``; the graph is dropped after the answer.  ``load_s`` is
the load up to a synchronize, ``wcc_s`` the WCC call (which returns once
the card has the labels); ``nodes`` and ``edges`` are the loaded graph's
counts."""

from __future__ import annotations

import itertools
import os
import time

import torch

from benchmark.ops import Answer, graphs, ldbc_text, refs
from graph_tpu_torch import api
from graph_tpu_torch.native import edge_list_parser

KIND = "wcc"
SOURCE = False
#: Lines of the file the native parser reads in set-up.
PROBE_LINES = 1000


def text(cell) -> ldbc_text.TextFile:
    """The cell's edges as the dataset's ``.e`` file; beside it, its first
    lines parsed by the native parser, so that the parser's build (g++)
    falls in set-up, and a cell never measures the pandas fallback."""
    d = cell.data
    out = ldbc_text.write(d.src, d.dst, int(cell.config["scale"]))
    probe = os.path.join(os.path.dirname(out.path), "probe.e")
    with open(out.path, "rb") as f, open(probe, "wb") as p:
        p.writelines(itertools.islice(f, PROBE_LINES))
    if edge_list_parser.parse(probe, False) is None:
        raise RuntimeError("the native edge-list parser is unavailable: "
                           f"{edge_list_parser.load_error()}")
    return out


GRAPH = text


def call(cell, req, mark) -> Answer:
    path = cell.graph(GRAPH).path
    t0 = time.perf_counter()
    g = api.Graph.load(path, file_format=api.FileFormat.EdgeList,
                       device=cell.device)
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    t1 = time.perf_counter()
    res = g.wcc(**req.params)
    t2 = time.perf_counter()
    mark("call")
    labels = res.components()
    extra = {"load_s": t1 - t0, "wcc_s": t2 - t1,
             "nodes": g.node_count(), "edges": g.edge_count()}
    del g
    return Answer(labels, micros=res.micros, extra=extra)


def nodes(cell) -> int:
    """The largest id plus one, as an edge list without a ``.v`` file
    gives it."""
    return cell.memo(graphs.api_nodes)


def ref_key(req):
    return (KIND,)


def reference(cell, req, dtype):
    return refs.components(cell, nodes(cell), dtype)
