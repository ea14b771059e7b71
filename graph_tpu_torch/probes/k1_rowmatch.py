"""K1 row-matched lane gather against the window-row scan, on the card.

Counterpart of ``scripts/perf_k1_rowmatch.py``.  Its input places every
slot row-matched (stream row r draws window rows equal to r mod 8), where
``"rowmatch"`` equals ``"rowscan"``'s ``x[idx]``; on other in-range input
it computes ``x[128*(8*(idx>>10) + r mod 8) + (idx & 127)]``, and the
share of slots equal to ``x[idx]`` says so.  Both modes are one kernel
(:func:`graph_tpu_torch.probes.kernels.window_gather`).

    python -m graph_tpu_torch.probes.k1_rowmatch [win ...] [--blocks N]
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

WINDOWS = (1024, 2048, 4096, 8192, 16384)
MODES = kernels.MODES


def rowmatch_inputs(wins, nblk: int = NBLK) -> Iterator[tuple]:
    """(win, idx, x) for each window, as the script draws them: one
    generator (seed 0) for all windows, in order."""
    rng = np.random.default_rng(0)
    rows = nblk * BLK // 128
    r3 = (np.arange(rows, dtype=np.uint16) % 8)[:, None] << 7
    for win in wins:
        grp = rng.integers(0, win // 1024, size=(rows, 128))
        lo = rng.integers(0, 128, size=(rows, 128))
        # the script's (grp * 8 + r3) * 128 + lo, as disjoint bit fields
        idx = grp.astype(np.uint16) << 10 | r3 | lo.astype(np.uint16)
        x = rng.random(win).astype(np.float32)
        yield win, idx, x


def run(mode: str, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One pass of the kernel in ``mode`` over the stream."""
    return kernels.window_gather(idx, x, mode)


def bench(wins=WINDOWS, nblk: int = NBLK, device=None, reps: int = REPS,
          observe: Optional[Callable] = None) -> list:
    """Both modes at each window; one result a case, ``"rowmatch"`` with
    its ``x[idx]`` share.  ``observe(res, (idx, x))`` is called after
    each."""
    dev = resolve_device(device)
    out = []
    for win, idx_np, x_np in rowmatch_inputs(wins, nblk):
        idx = torch.from_numpy(idx_np).to(dev)
        x = torch.from_numpy(x_np).to(dev)
        x_idx = kernels.window_gather_plain(idx, x, "rowscan")
        for mode in MODES:
            res = measure(
                f"win={win} {mode}", lambda: run(mode, idx, x),
                lambda: kernels.window_gather_plain(idx, x, mode), dev, win,
                reps, x_idx if mode == "rowmatch" else None)
            res.update(kernel="probe_window_gather", win=win, mode=mode)
            if observe:
                observe(res, (idx, x))
            out.append(res)
    return out


def main(argv=None) -> int:
    args = parse_args(argv, "k1_rowmatch", __doc__.splitlines()[0], True)
    header("k1_rowmatch", args.device, args.blocks)
    results = bench(args.win or WINDOWS, args.blocks, args.device)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
