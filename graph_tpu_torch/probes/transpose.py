"""The route's transposes and lane gather, alone, on the card.

Counterpart of ``scripts/perf_transpose.py``: 128 blocks of (512, 128)
int32 (``default_rng(0)`` integers 0-99), each body through the K2 stage
kernels' own machinery: ``copy`` (v + 1), ``t512x2`` (the (512, 128) to
(128, 512) transpose and back, a cluster of eight blocks a section, as
route 1's T and T'), ``t128x8`` (each 128-row quarter transposed twice,
+ 1, a cluster of two blocks a quarter), ``taa512`` and ``taa128x4`` (a
lane gather, ``(lane + 5) % 128``, on 512- and 128-row sections).  Each
block is written once.

    python -m graph_tpu_torch.probes.transpose [--reps N] [--device D]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

import numpy as np
import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import k2_routes
from graph_tpu_torch.probes import k2_stage_kernels as ks
from graph_tpu_torch.probes.k2_layout import LANES, SEC_R
from graph_tpu_torch.probes.timing import REPS, card_name, stage_case

NSEC = 128
BODIES = tuple(ks.TRANSPOSE)


def transpose_input(nsec: int = NSEC) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.integers(0, 100, size=(nsec * SEC_R, LANES),
                        dtype=np.int64).astype(np.int32)


def bench(nsec: int = NSEC, device=None, reps: int = REPS,
          observe: Optional[Callable] = None) -> list:
    """Every body; one result a body.  ``observe(res, (steps, v, sides,
    None))`` is called after each."""
    dev = resolve_device(device)
    v = torch.from_numpy(transpose_input(nsec)).to(dev)
    print(f"transpose on {card_name(dev)}: nsec={nsec} reps={reps}",
          flush=True)
    out = []
    for name in BODIES:
        rows, program = ks.TRANSPOSE[name]
        steps = k2_routes.section_steps(nsec * SEC_R // rows, rows)
        res = stage_case(name, program, [steps], v, [], device=dev,
                         reps=reps)
        if observe:
            observe(res, (steps, v, [], None))
        out.append(res)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="transpose",
                                description=__doc__.splitlines()[0])
    p.add_argument("--nsec", type=int, default=NSEC)
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    results = bench(args.nsec, args.device, args.reps)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
