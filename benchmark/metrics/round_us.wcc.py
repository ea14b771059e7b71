"""WCC's time per round (hook and two jumps): the results' summed
``micros`` over their summed rounds."""

from benchmark.readers import round_us


def read(run):
    return round_us(run.of("wcc"))
