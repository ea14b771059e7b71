"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 benchmark/run.py --workload graph500-s22.pagerank --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout.  Set-up (imports, kernel build and
load, the graph made on the card from the seed, the program's graphs,
warm-up) is printed part by part on standard error; the last lines
there are the numbers compared against the plain reference, each beside
its limit.  The last line on standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

Exits 2 without printing a result where there is no card or fewer cards
than the cell asks for, and 3 where JAX or the JAX package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
#: Top-level module names that must not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "graph_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # each request builds its own plan, as a new snapshot would
    os.environ.pop("GRAPH_TPU_TORCH_PLAN_CACHE", None)
    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    spec = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if spec is None:
        print(f"no workload named {args.workload!r}", file=sys.stderr)
        return 2
    t = time.perf_counter()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(spec["chips"]):
        print(f"{args.workload} needs {spec['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    sys.path.insert(0, str(REPO))
    from benchmark import harness
    import graph_tpu_torch  # noqa: F401
    phases = {"imports": time.perf_counter() - t}
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              started=STARTED, phases=phases)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
