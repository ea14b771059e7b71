"""Graph generators, one module per family, found by the ``generator``
name of a configuration.

Each module has ``make(config, gen) -> GraphData`` (the edges and, where
the configuration gives them, the weights, on ``gen``'s device) and
``sources(data, count, gen)`` (``count`` start nodes, drawn as the family
draws them).  ``gen`` is a ``torch.Generator`` seeded from ``--seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class GraphData:
    """An edge list as the benchmark hands it to the program and to the
    reference: ``src``/``dst`` int64 and ``weights`` float32 (or None),
    all on one device, and the node count ``n``."""

    src: torch.Tensor
    dst: torch.Tensor
    n: int
    weights: Optional[torch.Tensor] = None

    @property
    def m(self) -> int:
        return int(self.src.numel())


def uniform_weights(m: int, low: float, high: float,
                    gen: torch.Generator) -> torch.Tensor:
    """``m`` float32 weights uniform in [low, high), drawn on ``gen``'s
    device (computed in float64 and rounded once)."""
    r = torch.rand(m, generator=gen, device=gen.device, dtype=torch.float64)
    return (low + (high - low) * r).to(torch.float32)
