"""K1 "lanemap" gather and the depth probe, on the card.

Counterpart of ``scripts/perf_k1_lanemap.py``.  The depth probe asks what
the gather ``out[r,j] = t[idx[r,j] mod R, j]`` costs by table depth R
(8, 16, 32, 128); the lanemap gather reads a window row per lane from the
stream, ``out[r,j] = x[128*A[r, lo[r,j]] + lo[r,j]]``, at windows 1024
to 16384.  On the TPU the first is Mosaic's sublane gather; here both are
shared-memory gathers (:mod:`graph_tpu_torch.probes.kernels`).

    python -m graph_tpu_torch.probes.k1_lanemap [--blocks N] [--device D]
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import numpy as np
import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import BLK, NBLK, kernels
from graph_tpu_torch.probes.timing import REPS, header, measure, parse_args

ROWS = (8, 16, 32, 128)
WINDOWS = (1024, 2048, 8192, 16384)


def depth_input(rows: int, nblk: int = NBLK):
    """The depth probe's (idx, t) for R = ``rows``, as the script draws
    them (seed 0 for each R)."""
    rng = np.random.default_rng(0)
    ridx = rng.integers(0, rows, (nblk * BLK // 128, 128)).astype(np.uint16)
    t = rng.random((rows, 128)).astype(np.float32)
    return ridx, t


def lanemap_input(win: int, nblk: int = NBLK):
    """The lanemap stream and window, as the script draws them (seed 1):
    a random window row A per lane and a random lane lo per slot,
    ``st = lo | A << 8``."""
    rng = np.random.default_rng(1)
    nrows = nblk * BLK // 128
    a = rng.integers(0, win // 128, (nrows, 128)).astype(np.uint16)
    lo = rng.integers(0, 128, (nrows, 128)).astype(np.uint16)
    st = lo | (a << 8)
    x = rng.random(win).astype(np.float32)
    return st, x


def depth_probe(nblk: int = NBLK, device=None, reps: int = REPS,
                observe: Optional[Callable] = None) -> list:
    """The row gather at each depth R; one result a case.  ``observe(res,
    (idx, t))`` is called after each."""
    dev = resolve_device(device)
    out = []
    for rows in ROWS:
        ridx, t = depth_input(rows, nblk)
        idx = torch.from_numpy(ridx).to(dev)
        tt = torch.from_numpy(t).to(dev)
        res = measure(f"taa0 rows={rows}",
                      lambda: kernels.row_gather(idx, tt),
                      lambda: kernels.row_gather_plain(idx, tt), dev,
                      tt.numel(), reps)
        res.update(kernel="probe_row_gather", rows=rows)
        if observe:
            observe(res, (idx, tt))
        out.append(res)
    return out


def lanemap_bench(win: int, nblk: int = NBLK, device=None, reps: int = REPS,
                  observe: Optional[Callable] = None) -> dict:
    """The lanemap gather at window ``win``.  ``observe(res, (st, x))`` is
    called after it."""
    dev = resolve_device(device)
    st_np, x_np = lanemap_input(win, nblk)
    st = torch.from_numpy(st_np).to(dev)
    x = torch.from_numpy(x_np).to(dev)
    res = measure(f"lanemap win={win}", lambda: kernels.lanemap(st, x),
                  lambda: kernels.lanemap_plain(st, x), dev, win, reps)
    res.update(kernel="probe_lanemap", win=win)
    if observe:
        observe(res, (st, x))
    return res


def main(argv=None) -> int:
    args = parse_args(argv, "k1_lanemap", __doc__.splitlines()[0], False)
    header("k1_lanemap", args.device, args.blocks)
    results = depth_probe(args.blocks, args.device)
    results += [lanemap_bench(win, args.blocks, args.device)
                for win in WINDOWS]
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
