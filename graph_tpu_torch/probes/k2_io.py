"""K2 IO floor on synthetic streams, r passes in one launch, on the card.

Counterpart of ``scripts/perf_k2_io.py``: K2's stream shapes (f32
contributions and three u16 streams wa, wb, ci of 512 sections x 512 rows
x 128 lanes, 16 sections a mid) with trivial compute, ``trunc`` of v plus
the streams, 200 grid passes in one launch.  Variants: A a copy
f32->int32 (out block k), B four streams into the revisited out block
``sec_mid[k]``, C the same written per step, D v alone revisited, E B
again (the script's VMEM limit has no counterpart: a second run of B's
launch), F B on 2-section blocks.  B, D, E and F zero only blocks 0 and 16
(``sec_mid[k] % 16 == 0``): the others accumulate over every pass from
``init`` (0 here; the TPU leaves them undefined), and F never touches
blocks 16-31.  The script draws from the unseeded global ``np.random``;
the port seeds ``default_rng(0)`` and draws each stream in its final
dtype.

    python -m graph_tpu_torch.probes.k2_io [--nsec N] [--passes R]
        [--reps N] [--device D]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

import numpy as np
import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import k2_layout
from graph_tpu_torch.probes.k2_layout import IO_MID_EVERY, LANES, SEC_R
from graph_tpu_torch.probes.timing import card_name, stream_case

NSEC = 512
PASSES = 200
#: Timed calls a variant (the script's best of 3).
REPS = 3
#: (label, variant, side streams) as the script prints them.
VARIANTS = (("A copy f32->int32", "A", 0),
            ("B 4-stream, out revisited", "B", 3),
            ("C 4-stream, out per-step", "C", 3),
            ("D 1-stream, out revisited", "D", 0),
            ("E B + vmem 100MB", "E", 3),
            ("F B + 2-section blocks", "F", 3))


def io_inputs(nsec: int = NSEC) -> tuple:
    """(v, wa, wb, ci, sec_mid) as numpy: v uniform f32 in [0, 1), the
    streams u16 below 2^14, ``sec_mid = arange(nsec) // 16``."""
    rng = np.random.default_rng(0)
    shape = (nsec * SEC_R, LANES)
    v = rng.random(shape, dtype=np.float32)
    streams = [rng.integers(0, 1 << 14, shape, dtype=np.uint16)
               for _ in range(3)]
    return (v, *streams, np.arange(nsec, dtype=np.int32) // IO_MID_EVERY)


def bench(nsec: int = NSEC, passes: int = PASSES, device=None,
          reps: int = REPS, observe: Optional[Callable] = None) -> list:
    """Every variant, ``passes`` passes a launch; one result a variant.
    ``observe(res, (steps, v, sides))`` is called after each."""
    dev = resolve_device(device)
    v_np, *streams_np, sec_mid = io_inputs(nsec)
    v = torch.from_numpy(v_np).to(dev)
    streams = [torch.from_numpy(s).to(dev) for s in streams_np]
    print(f"k2_io on {card_name(dev)}: nsec={nsec} passes={passes} "
          f"reps={reps}", flush=True)
    out = []
    for label, variant, nsides in VARIANTS:
        steps = k2_layout.k2_io_steps(sec_mid, variant, passes)
        sides = streams[:nsides]
        res = stream_case(label, steps, v, sides, mode="trunc", read="full",
                          device=dev, reps=reps,
                          script_b_per_slot=4 + 2 * nsides,
                          note=("(a second run of B's launch)"
                                if variant == "E" else ""))
        res["variant"] = variant
        if observe:
            observe(res, (steps, v, sides))
        out.append(res)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="k2_io",
                                description=__doc__.splitlines()[0])
    p.add_argument("--nsec", type=int, default=NSEC)
    p.add_argument("--passes", type=int, default=PASSES)
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    results = bench(args.nsec, args.passes, args.device, args.reps)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
