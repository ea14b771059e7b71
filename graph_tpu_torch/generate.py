"""Seeded edge lists on the host (numpy only).

``host_rmat`` is a bit-for-bit copy of the JAX package's benchmark
generator (``bench.py:host_rmat``), and ``uniform_edge_list`` of
``graph_tpu.generate``'s, so that both packages see the same edge lists
from the same seed.
"""

from __future__ import annotations

import os

from typing import Tuple

import numpy as np


def host_rmat(scale, edge_factor=16, seed=42):
    """Graph500 RMAT on the host (for plan building without transfers).

    float32 draws + int32 bit accumulation: scale-24 generation is
    memory-bound on a small host (same distribution, same seed stream,
    but NOT bit-identical to the float64 original)."""
    rng = np.random.default_rng(seed)
    m = edge_factor << scale
    src = np.zeros(m, np.int32)
    dst = np.zeros(m, np.int32)
    # quadrant probabilities a=0.57 b=0.19 c=0.19 d=0.05
    for b in range(scale):
        r1 = rng.random(m, dtype=np.float32)
        r2 = rng.random(m, dtype=np.float32)
        src_bit = r1 > np.float32(0.57 + 0.19)
        dst_bit = np.where(src_bit, r2 > np.float32(0.19 / (0.19 + 0.05)),
                           r2 > np.float32(0.57 / (0.57 + 0.19)))
        src |= np.left_shift(src_bit.view(np.int8).astype(np.int32), b)
        dst |= np.left_shift(dst_bit.view(np.int8).astype(np.int32), b)
    perm = rng.permutation(1 << scale).astype(np.int64)
    return perm[src], perm[dst]


def cached_rmat(scale, cache_dir, edge_factor=16, seed=42):
    """:func:`host_rmat` through an npz cache in ``cache_dir``.

    Scale 22 takes tens of seconds of host time to generate; a cached
    file is read back in about a second.
    """
    path = os.path.join(cache_dir, f"rmat_s{scale}_ef{edge_factor}_{seed}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["src"], z["dst"]
    src, dst = host_rmat(scale, edge_factor, seed)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, src=src, dst=dst)
    os.replace(tmp, path)
    return src, dst


def uniform_edge_list(
    node_count: int, edge_count: int, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded uniform random edge list.

    Reference analog: ``uniform_edge_list``
    (benches/common/mod.rs:88-108) with SMALL/MEDIUM/LARGE =
    1k/10k/100k nodes × 10 average degree.
    """
    rng = np.random.default_rng(seed)
    src = rng.integers(0, node_count, edge_count, dtype=np.int64)
    dst = rng.integers(0, node_count, edge_count, dtype=np.int64)
    return src, dst


# Reference bench sizes (benches/common/mod.rs:71-86).
SMALL = (1_000, 10_000)
MEDIUM = (10_000, 100_000)
LARGE = (100_000, 1_000_000)
