"""A fresh snapshot answered once: ``DiGraph.from_numpy`` of the host
edge array, ``.page_rank(...)``, ``.scores()``; the graph is dropped
after the answer.  ``build_s`` is the build up to a synchronize,
``first_run_s`` the first ``page_rank`` on the new graph (plan, relabel,
loop capture and run)."""

from __future__ import annotations

import time

import torch

from benchmark.ops import Answer, graphs, refs
from graph_tpu_torch import api

KIND = "page_rank"
GRAPH = graphs.edges_host
SOURCE = False


def call(cell, req, mark) -> Answer:
    t0 = time.perf_counter()
    g = api.DiGraph.from_numpy(cell.graph(GRAPH), device=cell.device)
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
    t1 = time.perf_counter()
    res = g.page_rank(**req.params)
    t2 = time.perf_counter()
    mark("call")
    scores = res.scores()
    del g, res
    return Answer(scores, extra={"build_s": t1 - t0, "first_run_s": t2 - t1})


def nodes(cell) -> int:
    return cell.memo(graphs.api_nodes)


def ref_key(req):
    return (KIND, tuple(sorted(req.params.items())))


def reference(cell, req, dtype):
    return refs.page_rank(cell, nodes(cell), req.params, dtype)
