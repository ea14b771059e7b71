"""The graph build of each load (the ``graph.build`` spans directly under
an ``api.load`` span: the transfers to the card and the CSR), summed a
load and averaged over the traced window's loads; None where the
program records no ``api.load`` span."""

from benchmark import spans


def read(run):
    recorded = spans.recorded()
    loads = {s["id"] for s in spans.named(recorded, "api.load")}
    per_load: dict = {}
    for s in spans.named(recorded, "graph.build"):
        if s["parent"] in loads:
            per_load[s["parent"]] = (per_load.get(s["parent"], 0.0)
                                     + spans.duration_ms(s))
    return sum(per_load.values()) / len(per_load) if per_load else None
