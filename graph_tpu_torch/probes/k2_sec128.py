"""K2 on sections of 512 rows against sections of 128 rows, on the card.

Counterpart of ``scripts/perf_k2_sec128.py``: ``nsec512`` sections of
``gen_keys`` (geometric segments of mean 16 on sorted random destinations,
one lead pad, tail pads, shuffled; ``default_rng(7)``) routed by the
native router at 512 rows, four times as many at 128 rows (each route's
middle a single gather), the same int32 contributions, one section a
block.  First the script's check: both forms' per-destination sums against
numpy, on every section; beside it the port's own K2 (``k2_reduce``,
merge-path) on the same keys.  Then ``sec512`` (K2 ``sum`` on int32 quanta
through ``probe_sec_route``'s route 1, scan, route 2 and mask), ``sec128``
(``k2_128`` through ``probe_sec128``), the 128 form's stage ablation
(``128 io`` .. ``128 +r2``) and scan truncations, and ``k2_quad``'s four
sub-streams a step into four outputs (lane and row steps (7,7), (7,3),
(5,1)).

    python -m graph_tpu_torch.probes.k2_sec128 [nsec512] [--reps N]
        [--device D]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

import numpy as np
import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.engine import kernels as engine_kernels
from graph_tpu_torch.probes import k2_layout, k2_routes, route as R
from graph_tpu_torch.probes import k2_stage_kernels as ks
from graph_tpu_torch.probes.timing import (REPS, card_name, stage_case,
                                           time_ms)

NSEC512 = 8
#: (label, stages, lane_steps, row_steps) of the 128 form, as ``main``.
CASES128 = (("sec128", 4, 7, 7), ("128 io", 1, 7, 7), ("128 +r1", 2, 7, 7),
            ("128 +scan", 3, 7, 7), ("128 +r2", 4, 7, 7),
            ("128 (5,1)", 4, 5, 1), ("128 (7,3)", 4, 7, 3))
QUAD = ((7, 7), (7, 3), (5, 1))


def quad_steps(sec_mid: np.ndarray, nmid: int) -> list:
    """``k2_quad``'s four outputs: step k of output i reads section k +
    i * nsec / 4 into block ``sm[k + off]``, zeroed where ``k == 0 |
    sm[k + off] != sm[max(k + off - 1, 0)]``."""
    sm = np.asarray(sec_mid, np.int64)
    steps = len(sm) // 4
    k = np.arange(steps)
    out = []
    for i in range(4):
        j = k + i * steps
        zero = (k == 0) | (sm[j] != sm[np.maximum(j - 1, 0)])
        out.append(k2_layout.Steps(j * R.SEC_R2, sm[j], zero, R.SEC_R2,
                                   int(nmid)))
    return out


def csr_of(keys: np.ndarray, contrib: np.ndarray, mid: int) -> tuple:
    """The keys' edges as a destination-sorted CSR over ``nsec * mid``
    rows (section k's destinations at ``k * mid``): (contributions in
    that order, indptr), numpy."""
    nsec, sec = keys.shape
    ok = ((keys >= 0) & (keys < mid)).reshape(-1)
    dst = (np.arange(nsec)[:, None] * mid + keys).reshape(-1)[ok]
    order = np.argsort(dst, kind="stable")
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        dst, minlength=nsec * mid))]).astype(np.int64)
    return contrib.reshape(-1)[ok][order], indptr


def bench(nsec512: int = NSEC512, device=None, reps: int = REPS,
          observe: Optional[Callable] = None,
          inputs: Optional[dict] = None) -> list:
    """The check, then every case; one result a case (the port's K2
    first).  ``observe(res, (steps_list, v, sides, None))`` is called
    after each kernel case."""
    dev = resolve_device(device)
    z = inputs or k2_routes.sec128_inputs(nsec512)
    nsec512 = len(z["keys512"])
    nsec128 = 4 * nsec512
    nslots = nsec512 * R.SEC

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    contrib = t(z["contrib"])
    sides512 = [t(z[k]) for k in ("wa", "wb", "ss", "wa2", "wb2")]
    sides128 = [t(z[k]) for k in ("wa_2", "m1_2", "ss_2", "wa2_2", "m2_2")]
    print(f"k2_sec128 on {card_name(dev)}: nsec512={nsec512} "
          f"nsec128={nsec128} nslots={nslots} reps={reps}", flush=True)

    # the port's merge-path K2 on the 512 form's keys, against numpy
    c_csr, indptr = csr_of(z["keys512"], z["contrib"], R.MID)
    c_csr, indptr = t(c_csr), t(indptr)
    want512 = t(k2_routes.per_destination_sums(z["keys512"], z["contrib"],
                                               R.MID))
    got = engine_kernels.k2_reduce(c_csr, indptr)
    own = {"label": "k2_reduce", "kernel": "k2_reduce", "slots": nslots,
           "exact": bool(torch.equal(got, want512)),
           "ms": time_ms(lambda: engine_kernels.k2_reduce(c_csr, indptr),
                         dev, reps)}
    own["ns_per_slot"] = own["ms"] * 1e6 / nslots
    print(f"{'k2_reduce':12s}: {own['ms']:9.4f} ms -> "
          f"{own['ns_per_slot']:.5f} ns/slot (the port's K2, merge-path) "
          f"exact={own['exact']}", flush=True)
    out = [own]

    def case(label, program, steps_list, v, sides):
        res = stage_case(label, program, steps_list, v, sides, device=dev,
                         reps=reps)
        if observe:
            observe(res, (steps_list, v, sides, None))
        out.append(res)
        return res

    res = case("sec512", ks.FULL_INT, [k2_routes.section_steps(nsec512, 512)],
               contrib, sides512)
    ok512 = torch.equal(res["result"][0].view(-1), want512)
    want128 = t(k2_routes.per_destination_sums(z["keys128"], z["contrib"],
                                               R.MID2))
    one = k2_routes.section_steps(nsec128, R.SEC_R2)
    for label, stages, ls, rs in CASES128:
        res = case(label, ks.sec128_program(stages, ls, rs), [one], contrib,
                   sides128)
        if label == "sec128":
            ok128 = torch.equal(res["result"][0].view(-1), want128)
    print("correctness " + ("ok (both forms match numpy per-dst int32 sums)"
                            if ok512 and ok128 else
                            f"MISMATCH (512: {ok512}, 128: {ok128})"),
          flush=True)
    out[0]["numpy_exact"] = bool(ok512 and ok128)
    print(f"speedup: {out[1]['ns_per_slot'] / out[2]['ns_per_slot']:.2f}x",
          flush=True)
    qsteps = quad_steps(np.arange(nsec128), nsec128)
    for ls, rs in QUAD:
        case(f"quad({ls},{rs})", ks.sec128_program(4, ls, rs), qsteps,
             contrib, sides128)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="k2_sec128",
                                description=__doc__.splitlines()[0])
    p.add_argument("nsec512", type=int, nargs="?", default=NSEC512)
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    results = bench(args.nsec512, args.device, args.reps)
    ok = all(r["exact"] for r in results) and results[0]["numpy_exact"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
