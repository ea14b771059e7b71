"""The plan of each new graph (``engine.build`` spans: the relabel, the
sort, K2's cuts), mean over the traced window's builds."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.recorded(), "engine.build")
