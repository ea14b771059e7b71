"""Ragged boundary (halo) exchange for row-block sharded iterations.

Counterpart of ``graph_tpu.parallel.halo``.  Shard p owns ``rows_per``
node rows and the edges into them; those edges reference a set of
distinct sources, which split by owning shard q into the segments
S[q->p] (sorted source ids, q-local).  Every iteration shard q gathers
its values at S[q->p] and an ``all_to_all`` puts segment q into slot q
of p's halo buffer.  p's edge sources are rewritten at build time to
index that buffer directly, so the iteration body gathers the same
values in the same order as a single device would.

Segments are padded to the longest one, H, as ``graph_tpu`` pads them
for XLA's static shapes: per-iteration traffic is P·H values per shard
instead of n.  The build runs with torch ops (``unique``, ``searchsorted``)
on the device of the edge arrays.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Sequence

import numpy as np
import torch

from graph_tpu_torch.parallel.collectives import all_to_all

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """The exchange of one row-block partition."""

    send_idx: torch.Tensor   # (P, P, H) int32: [q, p] = q-local ids q -> p
    tgt_remap: torch.Tensor  # same shape as tgt, int32; indexes (P*H,) halo
    H: int
    halo_bytes: int          # per shard per iteration (padded)
    gather_bytes: int        # the all_gather volume this replaces


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def build_halo(tgt, edge_counts, rows_per: int) -> HaloPlan:
    """Compute the ragged exchange for row-block shards.

    tgt: (P, m_pad) GLOBAL source ids per shard (padded tails ignored),
    a tensor or numpy array; edge_counts: per-shard real edge counts;
    rows_per: rows per shard.  The plan's tensors lie on tgt's device;
    ``tgt_remap``'s padded tails are 0, as in ``graph_tpu``.
    """
    tgt = _as_tensor(tgt)
    P_ = tgt.shape[0]
    dev = tgt.device
    counts = [int(c) for c in edge_counts]
    shard = torch.arange(P_, device=dev)
    uniqs, invs, owners, starts, sizes = [], [], [], [], []
    for p in range(P_):
        uniq, inv = torch.unique(tgt[p, : counts[p]], sorted=True,
                                 return_inverse=True)
        owner = torch.div(uniq, rows_per, rounding_mode="floor")
        start = torch.searchsorted(owner, shard)
        end = torch.searchsorted(owner, shard, right=True)
        uniqs.append(uniq)
        invs.append(inv)
        owners.append(owner)
        starts.append(start)
        sizes.append(end - start)
    sizes = torch.stack(sizes, 1)  # (q, p) segment sizes
    H = max(1, int(sizes.max()))

    send_idx = torch.zeros((P_, P_, H), dtype=torch.int32, device=dev)
    remap = torch.zeros(tgt.shape, dtype=torch.int32, device=dev)
    col = torch.arange(H, device=dev)
    for p in range(P_):
        uniq, start, size = uniqs[p], starts[p], sizes[:, p]
        if not uniq.numel():
            continue  # a shard without edges sends and remaps nothing
        # slot h of segment q holds uniq[start[q] + h] for h < size[q]
        pos = start[:, None] + col[None, :]
        live = col[None, :] < size[:, None]
        local = uniq[pos.clamp(max=uniq.numel() - 1)] - \
            shard[:, None] * rows_per
        send_idx[:, p] = torch.where(live, local, 0).to(torch.int32)
        rank = invs[p]
        own = owners[p][rank]
        remap[p, : counts[p]] = (own * H + rank - start[own]).to(torch.int32)

    plan = HaloPlan(send_idx=send_idx, tgt_remap=remap, H=H,
                    halo_bytes=P_ * H * 4, gather_bytes=P_ * rows_per * 4)
    logger.info(
        "halo exchange: H=%d, %.2f MB/shard/iter vs %.2f MB all_gather "
        "(%.1fx)", H, plan.halo_bytes / 1e6, plan.gather_bytes / 1e6,
        plan.gather_bytes / max(plan.halo_bytes, 1))
    return plan


def exchange(values: Sequence[torch.Tensor],
             send_idx: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One ragged halo exchange over the mesh.

    values[q]: (rows_per,) shard q's local values; send_idx[q]: (P, H)
    what shard q sends to each peer (``HaloPlan.send_idx[q]``).  Returns
    the (P*H,) halo buffer of each shard, on its device, that its
    remapped sources index.
    """
    sends = [v[s.long()] for v, s in zip(values, send_idx)]  # (P, H) each
    return [h.reshape(-1) for h in all_to_all(sends, 0, 0, tiled=True)]
