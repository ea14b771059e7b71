"""K2's cost stage by stage, on synthetic sections, on the card.

Counterpart of ``scripts/perf_k2_stages.py``: 512 sections of 512 rows x
128 lanes (f32 ``v``, u16 ``wa``, ``wb``, ``ci`` below 2^14, 16 sections
a mid), 150 grid passes in one launch, each variant adding one stage of
the TPU's K2 to the last (``probe_sec_route``):

* ``io``: ``trunc(v) + wa + wb + ci``, the four streams alone;
* ``route``: route 1 (the Benes stages, ``wa``/``wb`` drawn at random: not
  permutations) on v, pads of ``wa`` masked, ``trunc`` of it + ``ci``;
* ``mxucsum``: the routed quanta's wrapping prefix sum + ``ci``;
* ``segscan``: the masked log-shift segmented scan of the routed quanta
  with segment starts ``ci``;
* ``compact``: the prefix sum through the window compaction of ``meta``
  (64 tiles of 8 rows, two 8-row sub-blocks each).

Each adds into the revisited out block ``sec_mid[k]``, zeroed only where
``sec_mid[k] % 16 == 0`` (blocks 0 and 16): the other 30 accumulate over
every pass from ``init`` (0 here; the TPU leaves them undefined).  The
script draws from the unseeded global ``np.random``; the port seeds
``default_rng(0)``.  The last line gives the stage deltas in ns a slot.

    python -m graph_tpu_torch.probes.k2_stages [--nsec N] [--passes R]
        [--reps N] [--device D]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import k2_layout, k2_routes
from graph_tpu_torch.probes import k2_stage_kernels as ks
from graph_tpu_torch.probes.timing import card_name, deltas, stage_case

NSEC = 512
PASSES = 150
#: Timed calls a variant (the script's best of 3).
REPS = 3
VARIANTS = tuple(ks.STAGES)
#: The script's closing line: each stage against the one it adds to.
DELTAS = (("route", "io"), ("mxucsum", "route"), ("segscan", "route"),
          ("compact", "mxucsum"))


def bench(nsec: int = NSEC, passes: int = PASSES, device=None,
          reps: int = REPS, observe: Optional[Callable] = None,
          inputs: Optional[tuple] = None) -> list:
    """Every variant, ``passes`` passes a launch; one result a variant.
    ``inputs``: :func:`graph_tpu_torch.probes.k2_routes.stages_inputs` of
    ``nsec``, drawn once; ``observe(res, (steps, v, sides, meta))`` is
    called after each."""
    dev = resolve_device(device)
    v_np, *streams_np, sec_mid, meta = inputs or k2_routes.stages_inputs(nsec)
    v = torch.from_numpy(v_np).to(dev)
    sides = [torch.from_numpy(s).to(dev) for s in streams_np]
    steps = k2_layout.k2_io_steps(sec_mid, "B", passes)
    print(f"k2_stages on {card_name(dev)}: nsec={len(sec_mid)} "
          f"passes={passes} reps={reps}", flush=True)
    out = []
    for name in VARIANTS:
        m = meta if name == "compact" else None
        res = stage_case(name, ks.STAGES[name], [steps], v, sides,
                         device=dev, reps=reps, meta=m)
        if observe:
            observe(res, (steps, v, sides, m))
        out.append(res)
    print(deltas(out, DELTAS), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="k2_stages",
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
