"""Triangle count's orientation on the host (``triangle_count.orient``
spans: the read-back of the CSR's sources and targets and the
orientation), mean over the traced window's counts."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.recorded(), "triangle_count.orient")
