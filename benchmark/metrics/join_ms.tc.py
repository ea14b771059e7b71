"""Triangle count's join on the card (``triangle_count.join`` spans: the
matrices and keys sent, the wedges emitted and looked up, to the one
host read), mean over the traced window's counts."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.recorded(), "triangle_count.join")
