"""JSON action protocol.

Counterpart of ``graph_tpu.server.actions``, JSON and dataclasses only
(no pyarrow).  Reference analog: crates/server/src/actions.rs:8-329 —
byte-compatible with the reference's serde encoding (externally tagged
``Algorithm`` enum, e.g. ``{"PageRank": {"max_iterations": 20, ...}}``
and the unit variant ``"TriangleCount"``), so the reference's pyarrow
example clients (crates/server/examples/*.py) work unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

from graph_tpu_torch.algos.pagerank import PageRankConfig
from graph_tpu_torch.algos.sssp import DeltaSteppingConfig
from graph_tpu_torch.algos.wcc import WccConfig
from graph_tpu_torch.graph.csr import CsrLayout

ACTION_TYPES = [
    ("create", "Create a new graph."),
    ("list", "List all graphs."),
    ("remove", "Remove a graph."),
    ("compute", "Compute a graph algorithm on a graph."),
    ("to_relabeled", "Relabels the node ids of a graph in degree-descending order"),
    ("to_undirected", "Converts a directed graph to an undirected graph"),
]

_LAYOUTS = {
    "Sorted": CsrLayout.SORTED,
    "Unsorted": CsrLayout.UNSORTED,
    "Deduplicated": CsrLayout.DEDUPLICATED,
}


class ProtocolError(ValueError):
    pass


def parse_layout(obj: Optional[str]) -> CsrLayout:
    if obj is None:
        return CsrLayout.UNSORTED
    try:
        return _LAYOUTS[obj]
    except KeyError:
        raise ProtocolError(f"unknown csr_layout: {obj!r}")


@dataclasses.dataclass
class CreateGraphFromFileConfig:
    graph_name: str
    file_format: str  # EdgeList | EdgeListWeighted | Graph500
    path: str
    csr_layout: CsrLayout
    orientation: str  # Directed | Undirected

    @staticmethod
    def from_json(body: bytes) -> "CreateGraphFromFileConfig":
        d = json.loads(body)
        return CreateGraphFromFileConfig(
            graph_name=d["graph_name"],
            file_format=d["file_format"],
            path=d["path"],
            csr_layout=parse_layout(d.get("csr_layout")),
            orientation=d.get("orientation", "Directed"),
        )


@dataclasses.dataclass
class CreateGraphCommand:
    """do_put descriptor command (actions.rs:130-139)."""

    graph_name: str
    edge_count: int
    csr_layout: CsrLayout
    orientation: str

    @staticmethod
    def from_json(body: bytes) -> "CreateGraphCommand":
        d = json.loads(body)
        return CreateGraphCommand(
            graph_name=d["graph_name"],
            edge_count=int(d["edge_count"]),
            csr_layout=parse_layout(d.get("csr_layout")),
            orientation=d.get("orientation", "Directed"),
        )


@dataclasses.dataclass
class ComputeConfig:
    graph_name: str
    algorithm_name: str  # PageRank | TriangleCount | Sssp | Wcc
    algorithm_config: Dict[str, Any]
    property_key: str

    @staticmethod
    def from_json(body: bytes) -> "ComputeConfig":
        d = json.loads(body)
        algo = d["algorithm"]
        if isinstance(algo, str):  # unit variant, e.g. "TriangleCount"
            name, cfg = algo, {}
        elif isinstance(algo, dict) and len(algo) == 1:
            name, cfg = next(iter(algo.items()))
        else:
            raise ProtocolError(f"malformed algorithm: {algo!r}")
        return ComputeConfig(
            graph_name=d["graph_name"],
            algorithm_name=name,
            algorithm_config=cfg or {},
            property_key=d["property_key"],
        )

    def page_rank_config(self) -> PageRankConfig:
        c = self.algorithm_config
        return PageRankConfig(
            max_iterations=c.get("max_iterations", PageRankConfig.DEFAULT_MAX_ITERATIONS),
            tolerance=c.get("tolerance", PageRankConfig.DEFAULT_TOLERANCE),
            damping_factor=c.get("damping_factor", PageRankConfig.DEFAULT_DAMPING_FACTOR),
        )

    def wcc_config(self) -> WccConfig:
        c = self.algorithm_config
        return WccConfig(
            chunk_size=c.get("chunk_size", WccConfig.DEFAULT_CHUNK_SIZE),
            neighbor_rounds=c.get("neighbor_rounds", WccConfig.DEFAULT_NEIGHBOR_ROUNDS),
            sampling_size=c.get("sampling_size", WccConfig.DEFAULT_SAMPLING_SIZE),
        )

    def sssp_config(self) -> DeltaSteppingConfig:
        c = self.algorithm_config
        return DeltaSteppingConfig(start_node=c["start_node"], delta=c["delta"])


def property_id(graph_name: str, property_key: str) -> Dict[str, str]:
    """PropertyId wire format (catalog.rs:215-233)."""
    return {"graph_name": graph_name, "property_key": property_key}


def to_json(obj) -> bytes:
    return json.dumps(obj).encode()
