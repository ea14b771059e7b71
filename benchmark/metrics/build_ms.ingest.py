"""``DiGraph.from_numpy`` of the host edge array, to a synchronize, mean
over the window's requests."""

from benchmark.readers import mean_ms


def read(run):
    return mean_ms([r.extra["build_s"] for r in run.of("ingest_page_rank")])
