"""The server's request path, without a transport.

Holds the bodies of ``graph_tpu.server.flight``'s handlers (reference
analog: ``FlightServiceImpl``, crates/server/src/server.rs:34-576): the
JSON actions ``create``, ``list``, ``remove``, ``compute``,
``to_relabeled`` and ``to_undirected``, and the build step of
``do_put``.  Each action takes the same JSON bytes and returns the same
dict as ``graph_tpu``'s handler.

It is split from the Flight transport (:mod:`.flight`) because the
machines that hold the card may have no pyarrow: this module imports
none, so a :class:`GraphService` answers requests wherever PyTorch runs,
and Flight is a thin layer over it where pyarrow is installed.

Graphs are built on the service's device (the card unless the caller
names another) and results are copied to the host once, into the
:class:`~.catalog.PropertyStore`.
"""

from __future__ import annotations

import json
import logging
import time

import numpy as np

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.errors import GraphError
from graph_tpu_torch.server import actions as act
from graph_tpu_torch.server.catalog import GraphCatalog, PropertyStore

log = logging.getLogger("graph_tpu_torch.server")

#: The errors a request can raise that a client is told about.
REQUEST_ERRORS = (GraphError, act.ProtocolError, KeyError, FileNotFoundError)


def _millis(t0: float) -> int:
    return int((time.perf_counter() - t0) * 1e3)


class GraphService:
    """Named graphs and their computed properties, on one device."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.catalog = GraphCatalog()
        self.properties = PropertyStore()
        self._actions = {
            "create": self.create,
            "list": self.list,
            "remove": self.remove,
            "compute": self.compute,
            "to_relabeled": self.to_relabeled,
            "to_undirected": self.to_undirected,
        }

    def action(self, action_type: str, body: bytes) -> dict:
        """Run one JSON action; raises :class:`~.actions.ProtocolError`
        for an unknown type."""
        log.info("Received action %r", action_type)
        try:
            handler = self._actions[action_type]
        except KeyError:
            raise act.ProtocolError(f"Unknown action type: {action_type}")
        return handler(body)

    def create(self, body: bytes) -> dict:
        cfg = act.CreateGraphFromFileConfig.from_json(body)
        from graph_tpu_torch.builder import GraphBuilder
        from graph_tpu_torch.graph.csr import (
            DirectedCsrGraph, UndirectedCsrGraph)
        from graph_tpu_torch.io.edgelist import EdgeListInput
        from graph_tpu_torch.io.graph500 import Graph500Input

        fmt = {
            "EdgeList": lambda: EdgeListInput(weighted=False),
            "EdgeListWeighted": lambda: EdgeListInput(weighted=True),
            "Graph500": Graph500Input,
        }[cfg.file_format]()
        t0 = time.perf_counter()
        builder = (GraphBuilder(device=self.device).csr_layout(cfg.csr_layout)
                   .file_format(fmt).path(cfg.path))
        target = (
            UndirectedCsrGraph if cfg.orientation == "Undirected" else DirectedCsrGraph
        )
        g = builder.build(target)
        self.catalog.insert(cfg.graph_name, g)
        millis = _millis(t0)
        log.info("Created graph '%s' in %dms", cfg.graph_name, millis)
        return {
            "node_count": g.node_count,
            "edge_count": g.edge_count,
            "create_millis": millis,
        }

    def list(self, body: bytes) -> dict:
        return {
            "graph_infos": [
                {
                    "graph_name": name,
                    "graph_type": gtype,
                    "node_count": n,
                    "edge_count": m,
                }
                for name, gtype, n, m in self.catalog.list()
            ]
        }

    def remove(self, body: bytes) -> dict:
        name = json.loads(body)["graph_name"]
        rname, gtype, n, m = self.catalog.remove(name)
        # The reference returns the removed graph's GraphInfo
        # (server.rs:333-339, catalog.rs:191-205) so clients can confirm
        # what was dropped.
        return {
            "graph_name": rname,
            "graph_type": gtype,
            "node_count": n,
            "edge_count": m,
        }

    def to_relabeled(self, body: bytes) -> dict:
        from graph_tpu_torch.graph.ops import make_degree_ordered

        name = json.loads(body)["graph_name"]
        g = self.catalog.get(name)
        t0 = time.perf_counter()
        self.catalog.insert(name, make_degree_ordered(g))
        return {"to_relabeled_millis": _millis(t0)}

    def to_undirected(self, body: bytes) -> dict:
        from graph_tpu_torch.graph.ops import to_undirected

        d = json.loads(body)
        g = self.catalog.get(d["graph_name"])
        layout = act.parse_layout(d.get("csr_layout"))
        t0 = time.perf_counter()
        self.catalog.insert(d["graph_name"], to_undirected(g, layout))
        return {"to_undirected_millis": _millis(t0)}

    def compute(self, body: bytes) -> dict:
        cfg = act.ComputeConfig.from_json(body)
        g = self.catalog.get(cfg.graph_name)
        pid = act.property_id(cfg.graph_name, cfg.property_key)
        t0 = time.perf_counter()

        def store(field_name, values):
            self.properties.insert(cfg.graph_name, cfg.property_key,
                                   field_name, values)

        if cfg.algorithm_name == "PageRank":
            from graph_tpu_torch.algos.pagerank import page_rank

            res = page_rank(g, cfg.page_rank_config())
            store("page_rank", res.scores_np().astype(np.float32))
            algo_result = {
                "iterations": res.ran_iterations,
                "error": res.error,
                "compute_millis": _millis(t0),
            }
        elif cfg.algorithm_name == "Wcc":
            from graph_tpu_torch.algos.wcc import wcc

            res = wcc(g, cfg.wcc_config())
            store("component", res.components_np().astype(np.uint64))
            algo_result = {"compute_millis": _millis(t0)}
        elif cfg.algorithm_name == "Sssp":
            from graph_tpu_torch.algos.sssp import delta_stepping

            res = delta_stepping(g, cfg.sssp_config())
            store("distance", res.distances.cpu().numpy().astype(np.float32))
            algo_result = {"compute_millis": _millis(t0)}
        elif cfg.algorithm_name == "TriangleCount":
            from graph_tpu_torch.algos.triangle_count import (
                global_triangle_count)

            res = global_triangle_count(g)
            store("triangle_count",
                  np.asarray([res.triangles], dtype=np.uint64))
            algo_result = {
                "triangle_count": res.triangles,
                "compute_millis": _millis(t0),
            }
        else:
            raise act.ProtocolError(f"unknown algorithm {cfg.algorithm_name!r}")

        return {"property_id": pid, "algo_result": algo_result}

    def put(self, command: bytes, src: np.ndarray, dst: np.ndarray) -> dict:
        """``do_put``'s build step: the edges a client streamed, as int64
        arrays, built into the graph its ``CreateGraphCommand`` names."""
        from graph_tpu_torch.graph.build import build_directed, build_undirected

        cmd = act.CreateGraphCommand.from_json(command)
        log.info("Received PUT request with command: %s", cmd)
        t0 = time.perf_counter()
        build = build_undirected if cmd.orientation == "Undirected" else build_directed
        g = build(np.asarray(src, np.int64), np.asarray(dst, np.int64),
                  layout=cmd.csr_layout, device=self.device)
        self.catalog.insert(cmd.graph_name, g)
        result = {
            "node_count": g.node_count,
            "edge_count": g.edge_count,
            "create_millis": _millis(t0),
        }
        log.info("Created graph '%s': %s", cmd.graph_name, result)
        return result
