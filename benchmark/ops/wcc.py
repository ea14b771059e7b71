"""``graph_tpu_torch.algos.wcc.wcc`` on the weighted graph built in
set-up, the components copied to the host."""

from __future__ import annotations

import importlib

from benchmark.ops import Answer, graphs, refs

# the module (``graph_tpu_torch.algos`` exports its function as ``wcc``)
wcc = importlib.import_module("graph_tpu_torch.algos.wcc")

KIND = "wcc"
GRAPH = graphs.weighted
SOURCE = False


def call(cell, req, mark) -> Answer:
    res = wcc.wcc(cell.graph(GRAPH), wcc.WccConfig(**req.params))
    mark("call")
    return Answer(res.components_np(), micros=res.micros,
                  iterations=res.ran_iterations)


def nodes(cell) -> int:
    return cell.data.n


def ref_key(req):
    return (KIND,)


def reference(cell, req, dtype):
    return refs.components(cell, nodes(cell), dtype)
