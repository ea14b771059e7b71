"""K2 IO floor: r passes in one launch against r launches, on the card.

Counterpart of ``scripts/perf_k2_io4.py`` on the RMAT section layout (as
:mod:`graph_tpu_torch.probes.k2_io2`, always relabeled by degree):
``ctrl_carry`` is the script's timing loop alone (``c[0, 0] += 1e-30``,
``reps`` times: plain PyTorch, no kernel); ``multipass6`` and
``multipass1`` run ``r = max(4, reps)`` grid passes in one launch, with
five touched side streams or none (every pass zeroes each mid's block at
its first section afresh); ``onepass6`` is ``perf_k2_io3.py``'s
``copy6``, ``reps`` launches.

    python -m graph_tpu_torch.probes.k2_io4 [scale] [--reps N]
        [--device D]
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import k2_layout
from graph_tpu_torch.probes.timing import (layout_header, parse_rmat_args,
                                           stream_case, time_ms)

#: Timed calls of a multipass launch (the script's best of 3).
MULTIPASS_REPS = 3


def ctrl_carry(v, reps: int, device) -> dict:
    """The script's carry update alone, ``reps`` times on a copy of v:
    ms for the loop."""
    c = v.clone()

    def loop():
        for _ in range(reps):
            c[0, 0] += 1e-30

    ms = time_ms(loop, device, 1)
    print(f"{'ctrl_carry':12s}: {ms:9.4f} ms for {reps} updates", flush=True)
    return {"label": "ctrl_carry", "ms": ms, "updates": reps,
            "exact": True}


def bench(sec_mid, nmid: int, device=None, reps: Optional[int] = None,
          observe: Optional[Callable] = None,
          inputs: Optional[tuple] = None) -> list:
    """``ctrl_carry``, then each kernel variant on the layout ``(sec_mid,
    nmid)``; as :func:`graph_tpu_torch.probes.k2_io2.bench`."""
    dev = resolve_device(device)
    v, sides = inputs or k2_layout.rmat_inputs(len(sec_mid), dev)
    reps = reps or k2_layout.script_reps(v.numel())
    layout_header("k2_io4", dev, sec_mid, nmid, reps)
    out = [ctrl_carry(v, reps, dev)]
    r = max(4, reps)
    cases = (("multipass6", k2_layout.k2_io4_multipass_steps(
                  sec_mid, nmid, r), 5, 14, MULTIPASS_REPS),
             ("multipass1", k2_layout.k2_io4_multipass_steps(
                  sec_mid, nmid, r), 0, 4, MULTIPASS_REPS),
             ("onepass6", k2_layout.acc_steps(sec_mid, nmid), 5, 14, reps))
    for label, steps, nsides, b_slot, calls in cases:
        res = stream_case(label, steps, v, sides[:nsides], mode="round",
                          read="touch", device=dev, reps=calls,
                          script_b_per_slot=b_slot)
        if observe:
            observe(res, (steps, v, sides[:nsides]))
        out.append(res)
    return out


def main(argv=None) -> int:
    args = parse_rmat_args(argv, "k2_io4", __doc__.splitlines()[0], False)
    sec_mid, nmid = k2_layout.rmat_sections(args.scale, args.relabel,
                                            args.device)
    results = bench(sec_mid, nmid, args.device, args.reps)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
