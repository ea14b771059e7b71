"""SSSP's work per answer in sweeps of the graph: the arc slots the
``sssp.run`` spans relaxed (counter ``relaxed``) over their count times
the cell's arcs, traced window; None where the program counts none."""

from benchmark import spans


def read(run):
    relaxed = [s["counters"]["relaxed"]
               for s in spans.named(spans.recorded(), "sssp.run")
               if "relaxed" in s["counters"]]
    if not relaxed:
        return None
    return sum(relaxed) / (len(relaxed) * run.cell.data.m)
