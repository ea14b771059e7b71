"""Triangle count's packing of the forward lists into degree-class
matrices on the host (``triangle_count.pack`` spans), mean over the
traced window's counts."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.recorded(), "triangle_count.pack")
