"""The Benes route's op classes, one at a time, on the card.

Counterpart of ``scripts/perf_k2_route_ops.py``, on the routed stand-in of
:mod:`graph_tpu_torch.probes.k2v2_stages` (no pad mask): cumulative
variants of route 1 (``probe_sec_route``) over ``round(v * 2^30)`` plus a
touched element of ``sstart``, ``wa2``, ``wb2``: ``io``; ``taa1`` the lane
gather A; ``taa2`` a second lane gather by ``wb`` in the same layout;
``transpose`` A, the transpose and B; ``c_roll`` and ``c_taa`` + the C
stage (on the TPU seven rolled selects or a grouped sublane gather; one
function on int32); ``route1`` the whole route; ``route2only`` route 2
alone (+ a touch of ``wb``); ``both_routes`` route 1 then route 2 (+ a
touch of ``sstart``).  First, as the script, the C stage alone on an int32
section (``arange``) by the first section's ``wb``, held to numpy.

    python -m graph_tpu_torch.probes.k2_route_ops [scale] [relabel]
        [--reps N] [--device D]
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import numpy as np
import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import k2_layout, k2_routes
from graph_tpu_torch.probes import k2_stage_kernels as ks
from graph_tpu_torch.probes.k2_layout import LANES, SEC_R
from graph_tpu_torch.probes.timing import (layout_header, parse_rmat_args,
                                           stage_case)

MODES = tuple(ks.ROUTE_OPS)


def c_stage_case(wb: torch.Tensor, device, reps: int) -> dict:
    """The script's exactness probe (``perf_k2_route_ops.py:159-173``):
    ``y0 = arange`` as a (512, 128) int32 section through the C stage by
    ``wb``'s first section, against numpy's ``take_along_axis``; the
    case's ``inputs`` are (steps, y0, [wb], None)."""
    y0 = np.arange(SEC_R * LANES, dtype=np.int32).reshape(SEC_R, LANES)
    wb0 = wb[:SEC_R].cpu().numpy().astype(np.int32)
    exp = np.take_along_axis(
        y0, (np.arange(SEC_R)[:, None] & ~3) | ((wb0 >> 7) & 3), axis=0)
    steps = k2_routes.section_steps(1, SEC_R)
    y = torch.from_numpy(y0).to(device)
    res = stage_case("c_only", ks.C_ONLY, [steps], y, [wb[:SEC_R]],
                     device=device, reps=reps)
    res["inputs"] = (steps, y, [wb[:SEC_R]], None)
    res["numpy_exact"] = bool(np.array_equal(res["result"][0].cpu().numpy(),
                                             exp))
    print(f"c_taa exactness: {'OK' if res['numpy_exact'] else 'MISMATCH'}",
          flush=True)
    return res


def bench(layout: k2_routes.RoutedLayout, device=None,
          reps: Optional[int] = None, observe: Optional[Callable] = None,
          modes=MODES) -> list:
    """The C-stage probe, then every mode on a routed layout; one result
    each.  ``observe(res, (steps, v, sides, None))`` is called after
    each."""
    dev = resolve_device(device)
    reps = reps or k2_layout.script_reps(layout.v.numel())
    layout_header("k2_route_ops", dev, layout.sec_mid, layout.nmid, reps)
    c_only = c_stage_case(layout.sides[1], dev, reps)
    if observe:
        observe(c_only, c_only["inputs"])
    steps = k2_routes.route_steps(layout.sec_mid, layout.nmid)
    out, last = [c_only], 0.0
    for mode in modes:
        res = stage_case(mode, ks.ROUTE_OPS[mode], [steps], layout.v,
                         layout.sides, device=dev, reps=reps)
        print(f"             delta {res['ns_per_slot'] - last:+.5f}",
              flush=True)
        last = res["ns_per_slot"]
        if observe:
            observe(res, (steps, layout.v, layout.sides, None))
        out.append(res)
    return out


def main(argv=None) -> int:
    args = parse_rmat_args(argv, "k2_route_ops", __doc__.splitlines()[0],
                           True)
    layout = k2_routes.rmat_layout(args.scale, args.relabel, args.device)
    results = bench(layout, args.device, args.reps)
    ok = all(r["exact"] for r in results) and results[0]["numpy_exact"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
