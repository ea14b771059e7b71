"""K1 sublane-then-lane gather against the window-row scan, on the card.

Counterpart of ``scripts/perf_k1_sublane.py``.  Its ``"sublane"`` mode is
not ``x[idx]``, whatever the script's docstring says: the second gather
reads the sublane index at the final lane, so it computes
``x[128*(8*(hi[r,j]>>3) + (hi[r, lo[r,j]] & 7)) + lo[r,j]]`` with
``hi = idx >> 7`` and ``lo = idx & 127``, equal to ``x[idx]`` on about one
slot in eight; the share of slots equal to ``x[idx]`` says so.
``"rowscan"`` is the window gather's (one kernel for both scripts).

    python -m graph_tpu_torch.probes.k1_sublane [win ...] [--blocks N]
        [--device D]
"""

from __future__ import annotations

import sys
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import BLK, NBLK, kernels
from graph_tpu_torch.probes.timing import REPS, header, measure, parse_args

WINDOWS = (1024, 2048, 8192)
MODES = ("rowscan", "sublane")


def sublane_inputs(wins, nblk: int = NBLK) -> Iterator[tuple]:
    """(win, idx, x) for each window, as the script draws them: one
    generator (seed 0) for all windows, indices uniform below win."""
    rng = np.random.default_rng(0)
    rows = nblk * BLK // 128
    for win in wins:
        idx = rng.integers(0, win, size=(rows, 128)).astype(np.uint16)
        x = rng.random(win).astype(np.float32)
        yield win, idx, x


def run(mode: str, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One pass of the kernel of ``mode`` over the stream."""
    if mode == "sublane":
        return kernels.sublane(idx, x)
    return kernels.window_gather(idx, x, "rowscan")


def plain(mode: str, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if mode == "sublane":
        return kernels.sublane_plain(idx, x)
    return kernels.window_gather_plain(idx, x, "rowscan")


def bench(wins=WINDOWS, nblk: int = NBLK, device=None, reps: int = REPS,
          observe: Optional[Callable] = None) -> list:
    """Both modes at each window; one result a case, ``"sublane"`` with
    its ``x[idx]`` share.  ``observe(res, (idx, x))`` is called after
    each."""
    dev = resolve_device(device)
    out = []
    for win, idx_np, x_np in sublane_inputs(wins, nblk):
        idx = torch.from_numpy(idx_np).to(dev)
        x = torch.from_numpy(x_np).to(dev)
        x_idx = plain("rowscan", idx, x)
        for mode in MODES:
            res = measure(f"win={win} {mode}", lambda: run(mode, idx, x),
                          lambda: plain(mode, idx, x), dev, win, reps,
                          x_idx if mode == "sublane" else None)
            res.update(kernel="probe_sublane" if mode == "sublane"
                       else "probe_window_gather", win=win, mode=mode)
            if observe:
                observe(res, (idx, x))
            out.append(res)
    return out


def main(argv=None) -> int:
    args = parse_args(argv, "k1_sublane", __doc__.splitlines()[0], True)
    header("k1_sublane", args.device, args.blocks)
    results = bench(args.win or WINDOWS, args.blocks, args.device)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
