"""Multi-device EdgeEngines: edge-range and row-block sharding over a mesh.

Counterpart of ``graph_tpu.engine.shard``.  Both engines keep one
:class:`~graph_tpu_torch.engine.engine.EdgeEngine` per mesh entry, on
that entry's device, so every shard runs the K1 and K2 kernels on its
own plan:

* :class:`ShardedEdgeEngine` splits the edge list into contiguous
  ranges and replicates x; ``spmv`` merges the per-shard y with
  ``psum``, ``smin`` and ``relax`` with ``pmin``.
* :class:`RowBlockEdgeEngine` partitions by destination row block: each
  shard owns ``rows_per`` rows and the edges into them, gathers from a
  halo buffer (:mod:`graph_tpu_torch.parallel.halo`) through a
  rectangular plan (``n = rows_per``, ``n_src = P·H``), and needs no
  output collective: each destination's reduction lies wholly on its
  shard, so the results equal the single-device engine's bit for bit.

``graph_tpu`` stacks the per-device plans into arrays of one shape for
``shard_map``, so it pads every plan to the same section count
(``_pad_plan``) and pins one K1 window class on every device.  The
port's shards are separate engines, each free to have its own plan
size and kernel shape, so neither is needed.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np
import torch

from graph_tpu_torch.device import synchronize
from graph_tpu_torch.engine.engine import EdgeEngine
from graph_tpu_torch.engine.kernels import IMAX, INF
from graph_tpu_torch.engine.plan import build_plan
from graph_tpu_torch.parallel.collectives import pmin, psum
from graph_tpu_torch.parallel.halo import build_halo, exchange
from graph_tpu_torch.parallel.mesh import Mesh


def _check_engines(engines, mesh: Mesh) -> None:
    if len(engines) != mesh.size:
        raise ValueError(f"{len(engines)} engines for a mesh of {mesh.size}")
    for p, (e, d) in enumerate(zip(engines, mesh.devices)):
        if e.device != d:
            raise ValueError(f"shard {p}'s engine is on {e.device}, its "
                             f"mesh entry is {d}")


def _as_tensor(a, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """An array as a tensor, on its own device if it is a tensor, else
    on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)


class ShardedEdgeEngine:
    """EdgeEngine sharded by edge ranges over a 1-D mesh ("edges")."""

    def __init__(self, engines: Sequence[EdgeEngine], mesh: Mesh,
                 axis: str = "edges"):
        _check_engines(engines, mesh)
        self.engines: List[EdgeEngine] = list(engines)
        self.mesh = mesh
        self.axis = axis

    @classmethod
    def build(cls, src, dst, n, mesh: Mesh, values=None,
              axis: str = "edges") -> "ShardedEdgeEngine":
        """Partition the edges contiguously and build one plan per shard,
        on its device (plans on node ids, as ``graph_tpu``'s)."""
        m = len(src)
        bounds = [(m * d) // mesh.size for d in range(mesh.size + 1)]
        engines = []
        for d, dev in enumerate(mesh.devices):
            lo, hi = bounds[d], bounds[d + 1]
            engines.append(EdgeEngine(build_plan(
                src[lo:hi], dst[lo:hi], n, device=dev,
                values=None if values is None else values[lo:hi])))
        return cls(engines, mesh, axis=axis)

    def _sharded(self, op: str, x: torch.Tensor) -> torch.Tensor:
        ys = [getattr(e, op)(x.to(e.device)) for e in self.engines]
        return (psum if op == "spmv" else pmin)(ys)[0].to(x.device)

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """Replicated x -> y = A^T x, the shards' f32 partials added in
        shard order."""
        return self._sharded("spmv", x)

    def smin(self, x: torch.Tensor) -> torch.Tensor:
        return self._sharded("smin", x)

    def relax(self, dist: torch.Tensor) -> torch.Tensor:
        return self._sharded("relax", dist)


class RowBlockEdgeEngine:
    """Row-block (destination-partitioned) sharded EdgeEngine.

    Shard p owns rows ``[p·rows_per, (p+1)·rows_per)`` and the edges into
    them; its engine's rectangular plan reduces into its ``rows_per``
    rows from the ``P·H`` positions of its halo buffer.  The halo buffer
    is also an active-source compression: each shard gathers from a
    dense list of the sources it references.
    """

    def __init__(self, engines: Sequence[EdgeEngine], send_idx, mesh: Mesh,
                 axis: str, rows_per: int, node_count: int,
                 halo_bytes: int = 0, gather_bytes: int = 0):
        _check_engines(engines, mesh)
        self.engines: List[EdgeEngine] = list(engines)
        self.mesh = mesh
        self.axis = axis
        self.rows_per = rows_per
        self.node_count = node_count
        self.halo_bytes = halo_bytes
        self.gather_bytes = gather_bytes
        #: (P, H) per shard: what it sends to each peer, local row ids
        self.send_idx = [send_idx[p].to(d)
                         for p, d in enumerate(mesh.devices)]
        #: seconds of :meth:`build`'s stages: partition, halo, plans
        self.build_s = {}

    @classmethod
    def build(cls, src, dst, n, mesh: Mesh, values=None,
              axis: str = "nodes") -> "RowBlockEdgeEngine":
        """Partition by destination row block and compile the halo.

        src, dst (and values) are tensors, partitioned on their device,
        or numpy arrays, partitioned on the mesh's first device."""
        dev = src.device if isinstance(src, torch.Tensor) else \
            mesh.devices[0]
        t0 = time.perf_counter()
        src = _as_tensor(src, dev, torch.int64)
        dst = _as_tensor(dst, dev, torch.int64).to(src.device)
        P_ = mesh.size
        rows_per = -(-n // P_)
        owner = torch.div(dst, rows_per, rounding_mode="floor")
        order = torch.sort(owner, stable=True).indices
        src_s, dst_s = src[order], dst[order]
        val_s = None if values is None else \
            _as_tensor(values, dev, torch.float32).to(src.device)[order]
        counts = torch.bincount(owner, minlength=P_).tolist()
        starts = np.concatenate([[0], np.cumsum(counts)]).tolist()
        # build_halo wants the (P, m_pad) matrix of GLOBAL source ids
        tgt = torch.zeros((P_, max(max(counts), 1)), dtype=torch.int64,
                          device=src.device)
        for p in range(P_):
            tgt[p, : counts[p]] = src_s[starts[p]:starts[p + 1]]
        synchronize(src.device)
        t1 = time.perf_counter()
        halo = build_halo(tgt, counts, rows_per)
        del tgt
        synchronize(src.device)
        t2 = time.perf_counter()
        engines = []
        for p, d in enumerate(mesh.devices):
            lo, hi = starts[p], starts[p + 1]
            engines.append(EdgeEngine(build_plan(
                halo.tgt_remap[p, : counts[p]], dst_s[lo:hi] - p * rows_per,
                rows_per, device=d, n_src=P_ * halo.H,
                values=None if val_s is None else val_s[lo:hi])))
        for d in set(mesh.devices):
            synchronize(d)
        rbe = cls(engines, halo.send_idx, mesh, axis, rows_per, n,
                  halo_bytes=halo.halo_bytes, gather_bytes=halo.gather_bytes)
        rbe.build_s = {"partition": t1 - t0, "halo": t2 - t1,
                       "plans": time.perf_counter() - t2}
        return rbe

    # -- building blocks for the drivers

    def local_dev(self, p: int) -> EdgeEngine:
        """Shard p's engine (``graph_tpu``'s strips the shard axis of the
        stacked plan arrays inside ``shard_map``)."""
        return self.engines[p]

    def split(self, x: torch.Tensor, fill) -> List[torch.Tensor]:
        """A global (n,) vector as the shards' (rows_per,) blocks, each on
        its device, the padded tail set to ``fill``."""
        xp = torch.full((self.rows_per * self.mesh.size,), fill,
                        dtype=x.dtype, device=x.device)
        xp[: self.node_count] = x
        return [b.to(d) for b, d in zip(xp.split(self.rows_per),
                                        self.mesh.devices)]

    def join(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The shards' blocks as one (n,) vector on the first device."""
        dev = self.mesh.devices[0]
        return torch.cat([b.to(dev) for b in blocks])[: self.node_count]

    # -- one-shot sharded ops (x and y are global vectors)

    def _run(self, op: str, x: torch.Tensor, fill) -> torch.Tensor:
        halos = exchange(self.split(x, fill), self.send_idx)
        ys = [getattr(e, op)(h, internal=True)
              for e, h in zip(self.engines, halos)]
        return self.join(ys).to(x.device)

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A^T x; bit-identical to the single-device engine (each
        destination's int32 sum lies on its shard)."""
        return self._run("spmv", x, 0.0)

    def smin(self, x: torch.Tensor) -> torch.Tensor:
        return self._run("smin", x, INF)

    def smin_int(self, x: torch.Tensor) -> torch.Tensor:
        return self._run("smin_int", x, IMAX)

    def relax(self, dist: torch.Tensor) -> torch.Tensor:
        return self._run("relax", dist, INF)
