"""The first ``page_rank()`` on each new graph (plan build, relabel, loop
capture and the run), mean over the window's requests."""

from benchmark.readers import mean_ms


def read(run):
    return mean_ms([r.extra["first_run_s"]
                    for r in run.of("ingest_page_rank")])
