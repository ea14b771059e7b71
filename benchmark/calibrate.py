"""Readings that set the limits of ``correct``: for each seed, one short
run of a cell on the card, its sampled answers held against the plain
reference (the program's numbers), and the same answers worked out by
the control, the reference one precision lower (the control's numbers).

    python3 benchmark/calibrate.py --workload graph500-s22.pagerank \
        --seconds 3 --seeds 11 12 13

One JSON line per seed on standard output.  All seeds run in one
process, so the kernels are built and loaded once.  The benchmark's own
runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from benchmark import harness
    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    for seed in args.seeds:
        t = time.perf_counter()
        res = harness.run_cell(bench, args.workload, seed, args.seconds,
                               False, device="cuda", control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "numbers": res["numbers"],
                          "control": res["control_numbers"],
                          "metrics": res["metrics"],
                          "memory_peak_bytes":
                              res["device"]["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
