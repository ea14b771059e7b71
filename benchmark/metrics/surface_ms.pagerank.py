"""The API's own time per ``DiGraph.page_rank()`` request: the host time
of the request less the result's ``micros`` (the wrapper and the copy of
the scores to the host), mean over the window."""

from benchmark.readers import mean_ms


def read(run):
    return mean_ms([r.latency_s - r.micros * 1e-6
                    for r in run.of("api_page_rank")])
