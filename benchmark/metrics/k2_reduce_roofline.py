"""K2's (sum) share of its bound at the PageRank shape, in %: ``4 m +
12 n + 8`` bytes over the HBM bandwidth, divided by the mean time of a
call, its tile kernel's and its carry kernel's mean times added."""

from benchmark import work
from benchmark.readers import kernel_roofline


def read(run):
    return kernel_roofline(
        run, "api_page_rank", work.k2_reduce_bytes,
        lambda name: "k2_tile_kernel" in name and "SumOp" in name,
        lambda name: "k2_carry_kernel" in name and "SumOp" in name)
