"""K1's share of its bound at the PageRank shape, in %: ``8 m + 4 n``
bytes over the HBM bandwidth, divided by the mean time of the
``k1_gather_kernel`` events the trace reported."""

from benchmark import work
from benchmark.readers import kernel_roofline


def read(run):
    return kernel_roofline(
        run, "api_page_rank", work.k1_gather_bytes,
        lambda name: "k1_gather_kernel" in name and "weighted" not in name)
