"""SSSP's time per relaxation round: the results' summed ``micros`` over
their summed rounds."""

from benchmark.readers import round_us


def read(run):
    return round_us(run.of("delta_stepping"))
