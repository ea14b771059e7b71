"""The yardstick's fixed counts: bytes each kernel and each iteration
has to move, and the card's peak.

The byte counts are functions of the graph's node count ``n`` and edge
count ``m`` alone, so they read the same work whatever implements it:
each input byte read once, each output byte written once.

* K1 gather: 4-byte source ids of the m slots read, 4-byte values
  written, the n-vector read: ``8 m + 4 n``.
* K2 segment sum: the m 4-byte contributions read, the (n + 1) 8-byte
  row offsets read, n 4-byte sums written: ``4 m + 12 n + 8``.
* One Jacobi iteration of PageRank: the m 4-byte slot sources, the
  (n + 1) 8-byte offsets, and five n-sized 4-byte vectors (scores read,
  out-degree reciprocals read, new scores written, and the gathered and
  summed vectors once each): ``4 m + 8 (n + 1) + 20 n``.
"""

from __future__ import annotations

#: HBM bandwidth of one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data
#: sheet, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12


def k1_gather_bytes(n: int, m: int) -> int:
    return 8 * m + 4 * n


def k2_reduce_bytes(n: int, m: int) -> int:
    return 4 * m + 12 * n + 8


def jacobi_iteration_bytes(n: int, m: int) -> int:
    return 4 * m + 8 * (n + 1) + 20 * n


def bound_s(nbytes: int) -> float:
    """The least time the card can take to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
