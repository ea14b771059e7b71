"""The collectives of ``shard_map`` code, over lists of per-shard tensors.

``graph_tpu`` calls ``jax.lax`` collectives inside ``shard_map``; the
port runs one process that holds one tensor per shard (``xs[p]`` on its
shard's device) and joins them here.  Each function takes such a list
and returns one, with ``out[p]`` on the device of ``xs[p]``, and has
``jax.lax``'s semantics for a 1-D mesh.

Reductions go in shard order, 0 to P-1, so an f32 ``psum`` is the same
on every run.  Copies between distinct devices are
``.to(device, non_blocking=True)``; shards on one device share the
result tensor, so callers treat the outputs as read-only.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _on_each(value: torch.Tensor, xs: Sequence[torch.Tensor]
             ) -> List[torch.Tensor]:
    """``value`` placed on the device of each shard of ``xs``."""
    return [value.to(x.device, non_blocking=True) for x in xs]


def _reduce(xs: Sequence[torch.Tensor], op) -> torch.Tensor:
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x.to(acc.device, non_blocking=True))
    return acc


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``jax.lax.psum``: every shard gets ``xs[0] + ... + xs[P-1]``,
    added in that order."""
    return _on_each(_reduce(xs, torch.add), xs)


def pmin(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``jax.lax.pmin``: every shard gets the elementwise minimum."""
    return _on_each(_reduce(xs, torch.minimum), xs)


def all_gather(xs: Sequence[torch.Tensor],
               tiled: bool = True) -> List[torch.Tensor]:
    """``jax.lax.all_gather`` (tiled): every shard gets the shards in
    order, concatenated on axis 0."""
    if not tiled:
        raise ValueError("all_gather supports tiled=True only")
    dev = xs[0].device
    return _on_each(torch.cat([x.to(dev, non_blocking=True) for x in xs]),
                    xs)


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int = 0,
               concat_axis: int = 0,
               tiled: bool = True) -> List[torch.Tensor]:
    """``jax.lax.all_to_all`` (tiled): shard p cuts its tensor into P
    equal chunks along ``split_axis``; shard q gets chunk q of every
    shard, concatenated in shard order along ``concat_axis``."""
    if not tiled:
        raise ValueError("all_to_all supports tiled=True only")
    n = len(xs)
    if xs[0].shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} of size "
                         f"{xs[0].shape[split_axis]} does not split into "
                         f"{n} chunks")
    chunks = [torch.chunk(x, n, dim=split_axis) for x in xs]
    return [torch.cat([c[q].to(xs[q].device, non_blocking=True)
                       for c in chunks], dim=concat_axis)
            for q in range(n)]


def ppermute(xs: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``jax.lax.ppermute``: for each (src, dst) pair shard dst gets
    ``xs[src]``; a shard no pair sends to gets zeros."""
    out = [None] * len(xs)
    for s, d in perm:
        if out[d] is not None:
            raise ValueError(f"perm sends twice to shard {d}: {perm}")
        out[d] = xs[s].to(xs[d].device, non_blocking=True)
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]
