"""The card's idle share between requests on graphs built in set-up."""

from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run)
