"""The edge-list parser's rate: the file bytes of the ``io.parse`` spans
(counter ``bytes``) over their host time, in GB/s, traced window; None
where the program records no such span."""

from benchmark import spans


def read(run):
    parses = [s for s in spans.named(spans.recorded(), "io.parse")
              if "bytes" in s["counters"]]
    seconds = sum(spans.duration_ms(s) for s in parses) * 1e-3
    if not parses or seconds <= 0:
        return None
    return sum(s["counters"]["bytes"] for s in parses) / seconds / 1e9
