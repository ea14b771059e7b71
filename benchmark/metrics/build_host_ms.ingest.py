"""The host copies of each graph build (``graph.build.host`` spans: the
int64 cast of the edge array and the column copies), their self time
summed a request and averaged over the traced window's requests."""

from benchmark import spans


def read(run):
    return spans.per_request_ms(spans.recorded(), "graph.build.host",
                                own=True)
