"""K2 IO floor: merged, deep and per-step variants, on the card.

Counterpart of ``scripts/perf_k2_io3.py`` on the RMAT section layout (as
:mod:`graph_tpu_torch.probes.k2_io2`).  Variants: ``copy1`` (the f32 bits
of v, written to block ``k % max(nmid, 2)`` every step), ``copy6``
(``round(v * 2^30)`` plus a touch of five side streams, into the mid's
block), ``copy6w`` (the five merged into one (rows, 640) u16 stream, whose
touch reads wa's element), ``copy6deep`` (steps of 2048 rows of which 512
are computed, into block ``sec_mid[4k]``), ``copy6sk`` (written per step)
and ``copy6noq`` (the bits of v, no rounding).  The TPU copied the deep
steps' 2048 rows and wrote per-step blocks every step; the port reads the
512 rows computed on and writes each block once.

    python -m graph_tpu_torch.probes.k2_io3 [scale] [relabel] [--reps N]
        [--device D]
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import k2_layout
from graph_tpu_torch.probes.timing import (layout_header, parse_rmat_args,
                                           stream_case)

#: (variant, T, side streams ("merged": the one 640-wide stream), the
#: script's bytes a slot).
VARIANTS = (("copy1", "bitcast", 0, 8), ("copy6", "round", 5, 14),
            ("copy6w", "round", "merged", 14),
            ("copy6deep", "round", 5, 14), ("copy6sk", "round", 5, 14),
            ("copy6noq", "bitcast", 5, 14))


def bench(sec_mid, nmid: int, device=None, reps: Optional[int] = None,
          observe: Optional[Callable] = None,
          inputs: Optional[tuple] = None) -> list:
    """Every variant on the layout ``(sec_mid, nmid)``; as
    :func:`graph_tpu_torch.probes.k2_io2.bench`."""
    dev = resolve_device(device)
    v, sides = inputs or k2_layout.rmat_inputs(len(sec_mid), dev)
    reps = reps or k2_layout.script_reps(v.numel())
    layout_header("k2_io3", dev, sec_mid, nmid, reps)
    merged = None
    out = []
    for variant, mode, nsides, b_slot in VARIANTS:
        if nsides == "merged":
            if merged is None:
                merged = torch.cat(list(sides), dim=1)
            use = [merged]
        else:
            use = list(sides[:nsides])
        steps = k2_layout.k2_io3_steps(sec_mid, nmid, variant)
        res = stream_case(variant, steps, v, use, mode=mode, read="touch",
                          device=dev, reps=reps, script_b_per_slot=b_slot)
        if observe:
            observe(res, (steps, v, use))
        out.append(res)
    return out


def main(argv=None) -> int:
    args = parse_rmat_args(argv, "k2_io3", __doc__.splitlines()[0], True)
    sec_mid, nmid = k2_layout.rmat_sections(args.scale, args.relabel,
                                            args.device)
    results = bench(sec_mid, nmid, args.device, args.reps)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
