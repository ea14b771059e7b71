"""EdgeEngine — plan-compiled edge traversal on an NVIDIA Hopper card.

The port of ``graph_tpu.engine``: an edge list is compiled once into a
destination-sorted plan (:mod:`.plan`), and the engine (:mod:`.engine`)
runs sums and mins over it, optionally edge-weighted, through the
hand-written CUDA kernels K1 and K2 (:mod:`.kernels`, sources in
``graph_tpu_torch/csrc``).  The out-of-core engine (:mod:`.ooc`) streams
destination slabs of rectangular plans from pinned host memory through
the same kernels.
"""

from graph_tpu_torch.engine.engine import EdgeEngine, engine_for
from graph_tpu_torch.engine.ooc import OocEdgeEngine
from graph_tpu_torch.engine.plan import (
    EdgePlan, build_plan, load_or_build_plan, plan_cache_path,
    plan_from_numpy)

__all__ = ["EdgeEngine", "EdgePlan", "OocEdgeEngine", "build_plan",
           "engine_for", "load_or_build_plan", "plan_cache_path",
           "plan_from_numpy"]
