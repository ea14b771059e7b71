"""The graph build's transfers to the card: the bytes of the
``graph.build.h2d`` spans over their CUDA-event time, traced window."""

from benchmark import spans


def read(run):
    return spans.gbps(spans.recorded(), "graph.build.h2d")
