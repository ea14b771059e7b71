"""Time the parts of a checkout's ``chip_smoke.py`` run.

    python3 smoke_times.py CHECKOUT FUNCTION [FUNCTION ...]

Imports ``CHECKOUT/chip_smoke.py`` (with ``CHECKOUT`` first on the path,
so that it runs that checkout's package), wraps each named module-level
function with a wall-clock timer, and runs its ``main()`` in this process:
the same phases in the same order as ``python3 chip_smoke.py`` run from
``CHECKOUT``.  After chip_smoke's own output it prints one JSON line,
``{"checkout": ..., "rc": ..., "total_s": ..., "seconds": {function:
[seconds of each call]}}``.  Comparing two checkouts (a commit and its
parent) is fair only within one machine and one run of this script each.
"""
import functools
import json
import os
import sys
import time


def main(argv):
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    checkout = os.path.abspath(argv[0])
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import chip_smoke

    seconds = {name: [] for name in argv[1:]}
    for name in argv[1:]:
        fn = getattr(chip_smoke, name)

        @functools.wraps(fn)
        def timed(*args, _fn=fn, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                seconds[_name].append(time.perf_counter() - t0)
        setattr(chip_smoke, name, timed)
    t0 = time.perf_counter()
    rc = chip_smoke.main()
    print(json.dumps({"checkout": checkout, "rc": rc,
                      "total_s": time.perf_counter() - t0,
                      "seconds": seconds}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
