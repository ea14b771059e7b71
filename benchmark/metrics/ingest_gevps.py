"""Fresh snapshots loaded and answered per second, as LDBC Graphalytics
counts them (EVPS), in billions: each request's graph is built in the
request."""

from benchmark.readers import gevps


def read(run):
    return gevps(run)
