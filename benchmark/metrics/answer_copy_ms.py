"""The copy of an answer to a host array (``result.to_host`` spans:
``scores()``, ``components_np()``, ``distances_np()``), mean over the
traced window's copies."""

from benchmark import spans


def read(run):
    return spans.mean_ms(spans.recorded(), "result.to_host")
