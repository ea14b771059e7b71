"""Graph answers per second as LDBC Graphalytics counts them (EVPS),
in billions, on graphs built in set-up."""

from benchmark.readers import gevps


def read(run):
    return gevps(run)
