"""K2 IO floor by stream count at 14 B a slot, f32, on the card.

Counterpart of ``scripts/perf_k2_streams.py``: NSEC sections (default
1024, 18 a mid, ``nmid = NSEC // 18 + 1``), f32 contributions ``random *
1e-5`` and integer side streams in 0-99 from ``default_rng(0)``, split as
6 streams (five u16), 4 (int32, int32, u16) or 2 (int32, int32: 12 B a
slot).  Each step adds ``acc = v + f(t0) + f(t1) + ...`` in f32, in stream
order, with ``f(t) = float32(int32(t))`` of each side's touched element,
into the mid's block (:func:`graph_tpu_torch.probes.k2_kernels.
sec_stream_f32`).  The script draws every case from a fresh
``default_rng(0)``, so the cases share their draws: the port draws v and
the five integer streams once and casts them.

    python -m graph_tpu_torch.probes.k2_streams [nsec] [--reps N]
        [--device D]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

import numpy as np
import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import k2_layout
from graph_tpu_torch.probes.k2_layout import LANES, SEC_R
from graph_tpu_torch.probes.timing import card_name, stream_case

NSEC = 1024
#: Calls a case (the script's fori_loop of 20).
REPS = 20
#: Side stream dtypes of each case, after v (f32).
CASES = ((6, (torch.uint16,) * 5),
         (4, (torch.int32, torch.int32, torch.uint16)),
         (2, (torch.int32, torch.int32)))


def streams_inputs(nsec: int = NSEC) -> tuple:
    """(v, [X1 .. X5]) as numpy, as the script draws each case: v =
    ``random * 1e-5`` as f32, then ``integers(0, 100)`` for each side
    (int32 here; each case casts the first few)."""
    rng = np.random.default_rng(0)
    shape = (nsec * SEC_R, LANES)
    v = (rng.random(shape) * 1e-5).astype(np.float32)
    return v, [rng.integers(0, 100, shape).astype(np.int32)
               for _ in range(5)]


def bench(nsec: int = NSEC, device=None, reps: int = REPS,
          observe: Optional[Callable] = None) -> list:
    """The three cases; one result a case.  ``observe(res, (steps, v,
    sides))`` is called after each."""
    dev = resolve_device(device)
    v_np, ints_np = streams_inputs(nsec)
    v = torch.from_numpy(v_np).to(dev)
    ints = [torch.from_numpy(x).to(dev) for x in ints_np]
    sec_mid, nmid = k2_layout.streams_layout(nsec)
    steps = k2_layout.k2_streams_steps(sec_mid, nmid)
    print(f"k2_streams on {card_name(dev)}: nsec={nsec} nmid={nmid} "
          f"reps={reps}", flush=True)
    out = []
    for nstreams, dtypes in CASES:
        sides = [x.to(dt) for x, dt in zip(ints, dtypes)]
        b_slot = 4 + sum(s.element_size() for s in sides)
        res = stream_case(f"{nstreams} streams ({b_slot}B/slot)", steps, v,
                          sides, mode="float", read="touch", device=dev,
                          reps=reps, script_b_per_slot=b_slot)
        res["streams"] = nstreams
        if observe:
            observe(res, (steps, v, sides))
        out.append(res)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="k2_streams",
                                description=__doc__.splitlines()[0])
    p.add_argument("nsec", type=int, nargs="?", default=NSEC)
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    results = bench(args.nsec, args.device, args.reps)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
