"""Multi-device WCC: row-block sharded min-label propagation.

Counterpart of ``graph_tpu.parallel.wcc``.  Each shard owns a block of
node rows and the edges leaving them; hooks pull labels across ragged
halo exchanges (:mod:`graph_tpu_torch.parallel.halo`: only the boundary
label segments travel), pointer jumping all-gathers the label vector
(jump targets are label values, unknowable at build time), and the loop
(:func:`~graph_tpu_torch.engine.loop.host_while` on a ``Flag``) stops
when the psum of the shards' change flags is 0 (one host read a round).

* :func:`wcc_sharded` hooks with two segment-mins a round, one per CSR
  direction (:func:`shard_hook_graph`);
* :func:`wcc_rowblock` hooks with one ``smin_int`` of a
  :class:`~graph_tpu_torch.engine.shard.RowBlockEdgeEngine` over the
  symmetrized edges: K1 and K2 ``imin`` on every shard.

``jump_every=k`` runs the O(n) all-gather jump only every k-th round;
hooks alone converge, so the labels are the same.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import torch

from graph_tpu_torch.algos.wcc import WccConfig, WccResult
from graph_tpu_torch.device import synchronize
from graph_tpu_torch.engine.loop import Flag, host_while
from graph_tpu_torch.graph.csr import UndirectedCsrGraph
from graph_tpu_torch.ops.segment import segment_min_sorted
from graph_tpu_torch.parallel.collectives import all_gather, psum
from graph_tpu_torch.parallel.halo import HaloPlan, build_halo, exchange
from graph_tpu_torch.parallel.mesh import NODES_AXIS, Mesh, run_meshed


@dataclasses.dataclass(frozen=True)
class ShardedHookGraph:
    """Row-block sharded out-CSR and in-CSR for hook steps; one entry per
    shard, on its device."""

    fwd_targets: List[torch.Tensor]  # (m_p,) int32 halo-buffer positions
    fwd_offsets: List[torch.Tensor]  # (rows_per+1,) int64
    fwd_send: List[torch.Tensor]     # (P, Hf) int32 halo send lists
    bwd_targets: List[torch.Tensor]
    bwd_offsets: List[torch.Tensor]
    bwd_send: List[torch.Tensor]     # (P, Hb)
    node_count: int
    halo_bytes: int = 0
    gather_bytes: int = 0

    @property
    def rows_per_shard(self) -> int:
        return self.fwd_offsets[0].numel() - 1


def _block_csr(offsets: torch.Tensor, targets: torch.Tensor, n: int,
               P_: int, rows_per: int):
    """A CSR cut into P row blocks of ``rows_per`` rows, with its halo.

    Returns (targets, offsets, halo): per shard its edges' halo-buffer
    positions (int32) and its local (rows_per+1,) int64 offsets (flat
    past the last real row), on the CSR's device, and the HaloPlan."""
    offsets = offsets.long()
    rows = [min(p * rows_per, n) for p in range(P_ + 1)]
    starts = offsets[rows].tolist()
    counts = [starts[p + 1] - starts[p] for p in range(P_)]
    tgt = torch.zeros((P_, max(max(counts), 1)), dtype=targets.dtype,
                      device=targets.device)
    offs = []
    for p in range(P_):
        tgt[p, : counts[p]] = targets[starts[p]:starts[p + 1]]
        local = offsets[rows[p]: rows[p + 1] + 1] - starts[p]
        off = torch.full((rows_per + 1,), counts[p], dtype=torch.int64,
                         device=offsets.device)
        off[: local.numel()] = local
        offs.append(off)
    halo = build_halo(tgt, counts, rows_per)
    return ([halo.tgt_remap[p, : counts[p]] for p in range(P_)], offs,
            halo)


def _placed(tensors: Sequence[torch.Tensor], mesh: Mesh):
    """tensors[p] moved to shard p's device."""
    return [t.to(d) for t, d in zip(tensors, mesh.devices)]


def _sends(halo: HaloPlan, mesh: Mesh):
    return _placed(list(halo.send_idx), mesh)


def shard_hook_graph(graph, mesh: Mesh,
                     axis: str = NODES_AXIS) -> ShardedHookGraph:
    """Partition a graph's CSRs into row blocks on ``mesh`` (an
    undirected graph's one CSR serves both directions), on the graph's
    device, and place each shard on its device."""
    P_ = mesh.shape[axis]
    n = graph.node_count
    rows_per = -(-n // P_)
    if isinstance(graph, UndirectedCsrGraph):
        fwd = bwd = graph.csr
    else:
        fwd, bwd = graph.csr_out, graph.csr_in
    ft, fo, fh = _block_csr(fwd.offsets, fwd.targets, n, P_, rows_per)
    bt, bo, bh = _block_csr(bwd.offsets, bwd.targets, n, P_, rows_per)
    return ShardedHookGraph(
        fwd_targets=_placed(ft, mesh), fwd_offsets=_placed(fo, mesh),
        fwd_send=_sends(fh, mesh), bwd_targets=_placed(bt, mesh),
        bwd_offsets=_placed(bo, mesh), bwd_send=_sends(bh, mesh),
        node_count=n, halo_bytes=fh.halo_bytes + bh.halo_bytes,
        gather_bytes=fh.gather_bytes + bh.gather_bytes)


def _segment_min_by_offsets(vals: torch.Tensor, offsets: torch.Tensor,
                            rows: int) -> torch.Tensor:
    """Per-row min over offset-delimited edge slices (``vals`` holds
    exactly ``offsets[-1]`` entries); an empty row gets the dtype's max
    (+inf for floats), as ``jax.ops.segment_min``."""
    row_ids = torch.repeat_interleave(
        torch.arange(rows, device=vals.device), torch.diff(offsets))
    return segment_min_sorted(vals, row_ids, rows)


def _min_label_loop(hook: Callable, mesh: Mesh, rows_per: int,
                    jump_every: int):
    """Min-label propagation over per-shard label blocks, its state the
    round, each shard's labels and the psum of the change flags.

    ``hook(comp)`` -> per shard the min label over its rows' edges.
    Labels start at the global row ids (padded rows too, as in
    ``graph_tpu``).  Returns (labels per shard, rounds, host reads)."""
    comp = [p * rows_per + torch.arange(rows_per, dtype=torch.int32,
                                        device=d)
            for p, d in enumerate(mesh.devices)]

    def body(state):
        it, comp = state[0], state[1:-1]
        new = [torch.minimum(c, h) for c, h in zip(comp, hook(comp))]
        if it % jump_every == jump_every - 1:
            # pointer jumping on the global vector: full[full[new]]
            full = all_gather(new)
            new = [f[f[x.long()].long()] for f, x in zip(full, new)]
        flags = psum([(x != c).any().to(torch.int32)
                      for x, c in zip(new, comp)])
        return (it + 1, *new, flags[0])

    run = host_while(body, (0, *comp, 1), Flag(len(comp) + 1))
    return list(run.state[1:-1]), run.iterations, run.host_reads


def _result(comp, mesh: Mesh, n: int, iters: int, reads: int,
            start: float) -> WccResult:
    dev = mesh.devices[0]
    labels = torch.cat([c.to(dev) for c in comp])[:n]
    synchronize(dev)
    return WccResult(components=labels, ran_iterations=iters,
                     micros=int((time.perf_counter() - start) * 1e6),
                     host_reads=reads)


def wcc_sharded(sg: ShardedHookGraph, mesh: Mesh,
                config: Optional[WccConfig] = None,
                axis: str = NODES_AXIS, jump_every: int = 1) -> WccResult:
    """Min-label WCC on segment-min shards; int32 labels."""
    del config, axis
    rows_per = sg.rows_per_shard

    def hook(comp):
        fh = exchange(comp, sg.fwd_send)
        bh = exchange(comp, sg.bwd_send)
        return [torch.minimum(
            _segment_min_by_offsets(f[ft.long()], fo, rows_per),
            _segment_min_by_offsets(b[bt.long()], bo, rows_per))
            for f, b, ft, fo, bt, bo in zip(
                fh, bh, sg.fwd_targets, sg.fwd_offsets, sg.bwd_targets,
                sg.bwd_offsets)]

    start = time.perf_counter()
    comp, iters, reads = _min_label_loop(hook, mesh, rows_per, jump_every)
    return _result(comp, mesh, sg.node_count, iters, reads, start)


def shard_hook_graph_plan(graph, mesh: Mesh, axis: str = NODES_AXIS):
    """Row-block sharded EdgeEngine over the SYMMETRIZED edges: one
    ``smin_int`` covers both hook directions, as the single-device plan
    WCC's engine does; labels stay int32 end to end."""
    from graph_tpu_torch.engine.shard import RowBlockEdgeEngine

    if isinstance(graph, UndirectedCsrGraph):
        src, dst = graph.csr.sources, graph.csr.targets
    else:
        s, t = graph.csr_out.sources, graph.csr_out.targets
        src, dst = torch.cat([s, t]), torch.cat([t, s])
    return RowBlockEdgeEngine.build(src, dst, graph.node_count, mesh,
                                    axis=axis)


def wcc_rowblock(rbe, config: Optional[WccConfig] = None,
                 jump_every: int = 1) -> WccResult:
    """Min-label WCC on the row-block sharded EdgeEngine: each round's
    hook is K1 and K2 ``imin`` on every shard behind the ragged halo."""
    del config

    def hook(comp):
        halos = exchange(comp, rbe.send_idx)
        return [e.smin_int(h, internal=True)
                for e, h in zip(rbe.engines, halos)]

    start = time.perf_counter()
    comp, iters, reads = _min_label_loop(hook, rbe.mesh, rbe.rows_per,
                                         jump_every)
    return _result(comp, rbe.mesh, rbe.node_count, iters, reads, start)


def wcc_meshed(graph, mesh: Mesh,
               config: Optional[WccConfig] = None) -> WccResult:
    """``wcc``'s default-mesh route: :func:`wcc_rowblock` or
    :func:`wcc_sharded`, as :func:`~graph_tpu_torch.parallel.mesh.run_meshed`
    picks; labels in the graph's id dtype, as the single-device paths
    give them."""
    res = run_meshed(
        graph, mesh,
        ("rowblock-sym", shard_hook_graph_plan,
         lambda rbe: wcc_rowblock(rbe, config)),
        ("sharded-hook", shard_hook_graph,
         lambda sg: wcc_sharded(sg, mesh, config)))
    ids = (graph.csr.targets if isinstance(graph, UndirectedCsrGraph)
           else graph.csr_out.targets)
    return dataclasses.replace(res, components=res.components.to(ids.dtype))
