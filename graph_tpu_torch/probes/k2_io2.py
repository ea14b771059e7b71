"""K2 IO floor by stream count and block height, on the card.

Counterpart of ``scripts/perf_k2_io2.py`` on the section layout of RMAT
(default scale 22, degree relabel; :func:`graph_tpu_torch.probes.
k2_layout.sections`): ``round(v * 2^30)`` of the contributions plus a
touch of each side stream (its element at the step's first row), into the
out block of the section's mid, zeroed at each mid's first section.
Variants: ``io1`` (5 side streams), ``io1_fixout`` (every step into block
0), ``io1_4s`` (3), ``io1_2s`` (1), ``io2`` (1024-row steps into block
``sec_mid[2k] // 2``).  The script counts 4 B a slot of v and 2 B of each
side; a touch moves one element a step, which is why the port prints both
byte counts.

    python -m graph_tpu_torch.probes.k2_io2 [scale] [relabel] [--reps N]
        [--device D]
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import k2_layout
from graph_tpu_torch.probes.timing import (layout_header, parse_rmat_args,
                                           stream_case)

#: (mode, side streams) as the script runs them.
MODES = (("io1", 5), ("io1_fixout", 5), ("io1_4s", 3), ("io1_2s", 1),
         ("io2", 5))


def bench(sec_mid, nmid: int, device=None, reps: Optional[int] = None,
          observe: Optional[Callable] = None,
          inputs: Optional[tuple] = None) -> list:
    """Every mode on the layout ``(sec_mid, nmid)``; ``inputs`` is
    ``(v, sides)`` (default :func:`k2_layout.rmat_inputs`).  One result a
    mode; ``observe(res, (steps, v, sides))`` is called after each."""
    dev = resolve_device(device)
    v, sides = inputs or k2_layout.rmat_inputs(len(sec_mid), dev)
    reps = reps or k2_layout.script_reps(v.numel())
    layout_header("k2_io2", dev, sec_mid, nmid, reps)
    out = []
    for mode, nsides in MODES:
        steps = k2_layout.k2_io2_steps(sec_mid, nmid, mode)
        res = stream_case(mode, steps, v, sides[:nsides], mode="round",
                          read="touch", device=dev, reps=reps,
                          script_b_per_slot=4 + 2 * nsides)
        if observe:
            observe(res, (steps, v, sides[:nsides]))
        out.append(res)
    return out


def main(argv=None) -> int:
    args = parse_rmat_args(argv, "k2_io2", __doc__.splitlines()[0], True)
    sec_mid, nmid = k2_layout.rmat_sections(args.scale, args.relabel,
                                            args.device)
    results = bench(sec_mid, nmid, args.device, args.reps)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
