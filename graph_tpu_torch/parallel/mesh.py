"""Device meshes: a 1-D tuple of devices, one entry per shard.

Counterpart of ``graph_tpu.parallel.mesh``.  ``graph_tpu`` is one
program over a ``jax.sharding.Mesh``: ``shard_map`` runs a body on every
device and XLA's collectives join them.  The port keeps that single
controller: one process holds a list with one tensor per shard, each on
its shard's device, and :mod:`graph_tpu_torch.parallel.collectives`
joins the lists.  So a mesh is just its devices, in shard order.

A device may appear more than once; then several shards share one card
(or the CPU).  That is the port's counterpart of XLA's virtual host
devices, which ``graph_tpu``'s tests use, and what lets one card run the
sharded paths: ``use_mesh(Mesh([torch.device("cuda")] * 4))``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from graph_tpu_torch.device import concrete_device
from graph_tpu_torch.engine.engine import engine_for

NODES_AXIS = "nodes"


class Mesh:
    """A 1-D mesh: ``devices[p]`` holds shard ``p``."""

    def __init__(self, devices: Sequence, axis_names=(NODES_AXIS,)):
        self.devices: Tuple[torch.device, ...] = tuple(
            concrete_device(d) for d in devices)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(self.axis_names) != 1:
            raise ValueError(f"a mesh has one axis, got {self.axis_names}")
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({list(map(str, self.devices))}, {self.axis_names})"


_DEFAULT_MESH: Optional[Mesh] = None


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    """Install a mesh that ``page_rank``/``wcc``/``delta_stepping``/
    ``global_triangle_count`` route through."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def get_default_mesh() -> Optional[Mesh]:
    return _DEFAULT_MESH


def _default_mesh() -> Optional[Mesh]:
    """The installed default mesh, if it has more than one shard: the
    mesh ``page_rank``/``wcc``/``delta_stepping``/
    ``global_triangle_count`` route through unless their caller pins a
    path (a one-shard mesh is no mesh)."""
    mesh = get_default_mesh()
    if mesh is not None and mesh.size > 1:
        return mesh
    return None


def _rowblock_route(graph, mesh: Mesh) -> bool:
    """Whether a meshed algorithm takes the row-block EdgeEngine (K1 and
    K2 on every shard) rather than the segment-op shards: from 2**21
    edges on a mesh of cards, ``graph_tpu``'s rule with its TPU test
    read as a CUDA one.  CPU meshes take the segment-op shards, as
    ``graph_tpu``'s CPU tests do."""
    return graph.edge_count >= (1 << 21) and mesh.devices[0].type == "cuda"


def run_meshed(graph, mesh: Mesh, rowblock: tuple, sharded: tuple):
    """Run an algorithm over ``mesh`` by one of its two routes:
    ``rowblock`` where :func:`_rowblock_route` holds, else ``sharded``,
    each (the kind its shards are cached under, build(graph, mesh) ->
    shards, run(shards) -> result).  The shards are built once per
    (graph, kind, mesh) and kept with the graph's engines."""
    kind, build, run = rowblock if _rowblock_route(graph, mesh) else sharded
    return run(engine_for(graph, (kind,) + mesh_key(mesh),
                          lambda: build(graph, mesh)))


def mesh_key(mesh: Mesh) -> tuple:
    """Stable identity for per-graph cache keys: the axis names, the
    shape and each shard's device type and index, so that equal meshes
    share an entry and ``Mesh([cuda:0] * 4)`` never shares one with
    ``Mesh([cuda:0] * 2)``."""
    return (mesh.axis_names, tuple(mesh.shape.items()),
            tuple((d.type, d.index) for d in mesh.devices))


class use_mesh:
    """Context manager: route algorithms through ``mesh`` inside."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._prev = None

    def __enter__(self):
        self._prev = _DEFAULT_MESH
        set_default_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_default_mesh(self._prev)
        return False


def make_mesh(n_devices: Optional[int] = None,
              axis: str = NODES_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` CUDA devices (all of them by
    default).  Raises when no card is present or too few are; a mesh on
    the CPU, or of shards sharing a card, is built with :class:`Mesh`."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "make_mesh spans CUDA devices and none is available; build "
            "Mesh([torch.device('cpu')] * k) to shard on the CPU")
    if n_devices is None:
        n_devices = count
    if n_devices > count:
        raise ValueError(
            f"requested {n_devices} devices, only {count} available")
    return Mesh([torch.device("cuda", i) for i in range(n_devices)], (axis,))
