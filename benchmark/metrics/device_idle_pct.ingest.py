"""The card's idle share between requests that each build their graph."""

from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run)
