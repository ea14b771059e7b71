"""K2's cost stage by stage on a graph's routed sections, on the card.

Counterpart of ``scripts/perf_k2v2_stages.py``: the TPU plan's K2 streams
of RMAT (default scale 22, degree relabel) stand in for by
:func:`graph_tpu_torch.probes.k2_routes.stand_in_keys` (the port's plan
routes nothing: its in-edges per mid in source order, cut into sections
of one lead pad and 65,535 edges, routed by the native router), with
``default_rng(1)`` contributions.  Cumulative variants
(``probe_sec_route``): ``io`` reads every stream, ``round(v * 2^30)`` (pads
masked) plus a touched element of ``wb``, ``sstart``, ``wa2``, ``wb2``;
``route1`` adds the Benes route 1; ``scan`` the segmented scan; ``full``
route 2 and the present mask (K2 ``sum``; no touch), into the mid's block
zeroed at its first section.  Each line gives ns a slot and its delta from
the line before.

    python -m graph_tpu_torch.probes.k2v2_stages [scale] [relabel]
        [--reps N] [--device D]
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import k2_layout, k2_routes
from graph_tpu_torch.probes import k2_stage_kernels as ks
from graph_tpu_torch.probes.timing import (layout_header, parse_rmat_args,
                                           stage_case)

MODES = tuple(ks.K2V2)


def bench(layout: k2_routes.RoutedLayout, device=None,
          reps: Optional[int] = None, observe: Optional[Callable] = None,
          modes=MODES) -> list:
    """Every mode on a routed layout; one result a mode.
    ``observe(res, (steps, v, sides, None))`` is called after each."""
    dev = resolve_device(device)
    reps = reps or k2_layout.script_reps(layout.v.numel())
    layout_header("k2v2_stages", dev, layout.sec_mid, layout.nmid, reps)
    print(f"routed {layout.nsec} sections in {layout.route_s:.2f} s",
          flush=True)
    steps = k2_routes.route_steps(layout.sec_mid, layout.nmid)
    out, last = [], 0.0
    for mode in modes:
        res = stage_case(mode, ks.K2V2[mode], [steps], layout.v,
                         layout.sides, device=dev, reps=reps)
        print(f"         delta {res['ns_per_slot'] - last:+.5f}", flush=True)
        last = res["ns_per_slot"]
        if observe:
            observe(res, (steps, layout.v, layout.sides, None))
        out.append(res)
    return out


def main(argv=None) -> int:
    args = parse_rmat_args(argv, "k2v2_stages", __doc__.splitlines()[0],
                           True)
    layout = k2_routes.rmat_layout(args.scale, args.relabel, args.device)
    results = bench(layout, args.device, args.reps)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
