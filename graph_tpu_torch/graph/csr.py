"""CSR graph containers as frozen dataclasses of tensors.

Counterpart of ``graph_tpu.graph.csr`` (reference analog: ``Csr`` /
``DirectedCsrGraph``, crates/builder/src/graph/csr.rs:58-61,364-368).
Structure-of-arrays: ``offsets`` / ``sources`` / ``targets`` / ``values``
tensors on one device, where ``sources`` is the row id of every edge,
ascending (the sorted COO row array).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch


class CsrLayout(enum.Enum):
    """Neighbor-list organization within the CSR target array.

    Mirrors ``CsrLayout`` (crates/builder/src/graph/csr.rs:34-45):

    * ``UNSORTED`` — per-node lists keep input order (default).
    * ``SORTED`` — per-node lists sorted by target id; duplicates kept.
    * ``DEDUPLICATED`` — sorted, duplicate targets removed, self-loops
      removed (csr.rs:897-948).
    """

    UNSORTED = "unsorted"
    SORTED = "sorted"
    DEDUPLICATED = "deduplicated"


@dataclasses.dataclass(frozen=True)
class Csr:
    """One adjacency direction in compressed-sparse-row form.

    ``offsets[u] : offsets[u+1]`` is node ``u``'s slice of ``targets``.
    ``sources[e]`` is the row owning edge ``e`` (ascending).  ``values``
    is the optional per-edge value array (reference ``EV``).
    """

    offsets: torch.Tensor  # (n+1,) id dtype
    sources: torch.Tensor  # (m,)   id dtype, ascending
    targets: torch.Tensor  # (m,)   id dtype
    values: Optional[torch.Tensor] = None  # (m,) value dtype

    @property
    def node_count(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def edge_count(self) -> int:
        return self.targets.shape[0]

    @property
    def id_dtype(self) -> torch.dtype:
        return self.targets.dtype

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def degrees(self) -> torch.Tensor:
        """Per-node degree vector (reference: csr.rs degree via offsets)."""
        return torch.diff(self.offsets)

    def degree(self, node: int) -> torch.Tensor:
        return self.offsets[node + 1] - self.offsets[node]

    def neighbors_np(self, node: int) -> np.ndarray:
        """Host copy of one neighbor list."""
        lo, hi = self.offsets[node : node + 2].tolist()
        return self.targets[lo:hi].cpu().numpy()


@dataclasses.dataclass(frozen=True)
class DirectedCsrGraph:
    """Directed graph: out-CSR + in-CSR (+ optional node values).

    Reference analog: ``DirectedCsrGraph`` (csr.rs:364-368).  ``csr_out``
    rows are sources, targets are destinations; ``csr_in`` rows are
    destinations, targets are sources.
    """

    csr_out: Csr
    csr_in: Csr
    node_values: Optional[torch.Tensor] = None
    layout: CsrLayout = CsrLayout.UNSORTED

    @property
    def node_count(self) -> int:
        return self.csr_out.node_count

    @property
    def edge_count(self) -> int:
        # Reference: directed edge_count == out-CSR target length
        # (csr.rs Graph impl for DirectedCsrGraph).
        return self.csr_out.edge_count

    @property
    def device(self) -> torch.device:
        return self.csr_out.device

    def out_degrees(self) -> torch.Tensor:
        return self.csr_out.degrees()

    def in_degrees(self) -> torch.Tensor:
        return self.csr_in.degrees()


@dataclasses.dataclass(frozen=True)
class UndirectedCsrGraph:
    """Undirected graph: one CSR holding both edge directions.

    Reference analog: ``UndirectedCsrGraph`` (csr.rs:658-690) — every
    input edge ``(u, v)`` appears as both ``u→v`` and ``v→u``;
    ``edge_count`` is ``targets.len() / 2`` (csr.rs:687-689).

    ``host`` marks a host-resident graph (``build_undirected_host``): its
    tensors lie in host memory and it has no device of its own, so an
    algorithm given it runs on the device its caller names, the card by
    default (:func:`graph_tpu_torch.device.run_device`).
    """

    csr: Csr
    node_values: Optional[torch.Tensor] = None
    layout: CsrLayout = CsrLayout.UNSORTED
    host: bool = False

    @property
    def node_count(self) -> int:
        return self.csr.node_count

    @property
    def edge_count(self) -> int:
        return self.csr.edge_count // 2

    @property
    def device(self) -> torch.device:
        return self.csr.device

    def degrees(self) -> torch.Tensor:
        return self.csr.degrees()
