"""One Jacobi iteration's bytes (``benchmark.work``) over the HBM
bandwidth, divided by the time of an iteration: the CUDA-event time of
the window's ``page_rank`` calls over the iterations they ran, in %."""

from benchmark import work


def read(run):
    recs = run.of("api_page_rank")
    busy = sum(r.device["call"] - r.device["start"] for r in recs)
    if not recs or busy <= 0:
        return None
    bound = sum(work.bound_s(work.jacobi_iteration_bytes(r.nodes, r.edges))
                * r.iterations for r in recs)
    return bound / busy * 100.0
