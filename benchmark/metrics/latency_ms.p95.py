"""The 95th percentile of every request's time in the window, from its
call to its answer on the host (host clock)."""

from benchmark.stats import percentile


def read(run):
    if not run.records:
        return None
    return percentile([r.latency_s for r in run.records], 95) * 1e3
